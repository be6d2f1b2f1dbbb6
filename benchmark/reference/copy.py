"""A copy's reference is its input: every element, bit for bit."""

from __future__ import annotations

import torch

from benchmark.reference import lower as low


def control(x):
    """The copy one precision below: through bf16 and back."""
    return low.bf16(x)


def bits_differ(out, x) -> int:
    """Elements of ``out`` whose bits differ from ``x``'s. A shape or dtype
    that differs, or an ``out`` that is ``x``'s own memory (no copy was
    made), counts every element."""
    if out.shape != x.shape or out.dtype != x.dtype:
        return x.numel()
    if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        return x.numel()
    return int((out.view(torch.int32) != x.view(torch.int32)).sum())
