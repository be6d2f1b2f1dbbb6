"""The validator's matmul chain: ``x <- bf16((x @ b) / size)``, ``depth`` times.

Each product is summed in f32 and scaled by ``1/size`` (a power of two,
so exact), then rounded once to bf16, which the next product reads.
"""

from __future__ import annotations

import torch

from benchmark.reference import exact_matmuls, lower as low


def chain(a, b, depth: int, lower: bool = False):
    """The chain's bf16 output from bf16 ``a`` and ``b``. ``lower`` is the
    control: both operands rounded through fp8 before every product."""
    exact_matmuls()
    size = a.shape[0]
    cast = low.fp8 if lower else (lambda t: t.float())
    bf = cast(b)
    x = a
    for _ in range(depth):
        x = (torch.matmul(cast(x), bf) * (1.0 / size)).bfloat16()
    return x


def rel_gap(out, ref) -> float:
    """The largest absolute difference over the reference's largest magnitude."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max())
