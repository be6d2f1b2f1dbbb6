"""numpy arrays in, tensors out, and back.

Carries state between the JAX side and the port: inputs are made once in
numpy and handed to both. bfloat16 travels as its raw 16-bit pattern
(``int16`` view), so this module needs no ``ml_dtypes``: a numpy bf16
array is recognised by its dtype name, and the way back returns the raw
bits unless the caller names the numpy bf16 dtype to view them as.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A tensor holding ``arr``'s values; bf16 arrays keep every bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """``t`` as a numpy array on the host. A bf16 tensor comes back as its
    ``uint16`` bit pattern, or viewed as ``bf16_dtype`` when one is given
    (e.g. ``ml_dtypes.bfloat16`` on the JAX side)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy()
