"""numpy arrays in, tensors out, and back; global arrays into each rank's
shard.

Carries state between the JAX side and the port: inputs are made once in
numpy and handed to both. The multi-device workloads take the JAX
package's global arrays (its parameters and inputs before ``device_put``)
and give each rank the block its ``NamedSharding`` would have put on that
device (``shard``, ``burnin_shards``). bfloat16 travels as its raw 16-bit pattern
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


def shard(arr: np.ndarray, axis: int, index: int, parts: int) -> np.ndarray:
    """Block ``index`` of ``arr`` cut into ``parts`` equal blocks along
    ``axis``: the device ``index`` of a mesh axis of size ``parts`` holds it
    under a ``PartitionSpec`` naming that axis at ``axis``."""
    size = arr.shape[axis]
    if size % parts:
        raise ValueError(f"axis {axis} of size {size} does not split into {parts}")
    step = size // parts
    block = [slice(None)] * arr.ndim
    block[axis] = slice(index * step, (index + 1) * step)
    return arr[tuple(block)]


def burnin_shards(params: dict, data, dp: int, tp: int, rank: int):
    """The burn-in rank ``(rank // tp, rank % tp)``'s slices of the
    reference's ``params`` (``w1`` column-parallel, ``P(None, "tp")``;
    ``w2`` row-parallel, ``P("tp", None)``) and of ``data`` ``(x, y)``
    (batch over ``dp``, ``P("dp", None)``)."""
    d, t = rank // tp, rank % tp
    x, y = data
    return (
        {"w1": shard(params["w1"], 1, t, tp), "w2": shard(params["w2"], 0, t, tp)},
        (shard(x, 0, d, dp), shard(y, 0, d, dp)),
    )
