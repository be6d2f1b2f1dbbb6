"""Shared harness for the port's flash-attention instruments.

The counterpart of the JAX package's ``scripts/_fa_common.py``: one Q/K/V
setup, seeded 13 as the reference's ``PRNGKey(13)``, so that every
instrument (``fa_experiment``, ``fa_variant_check``, ``blocktune``) times
the same tensors, and one ``measure()`` factory around the
fixed-overhead-cancelling chain timer. The drift-cancelled comparison
itself is ``timing.adjacent_ratio_stats``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.workloads.flashattn import LANES, reference_attention
from tpu_operator_torch.workloads.timing import chain_per_iter_seconds

SEQ, HEADS, HEAD_DIM = 8192, 8, LANES
SEED = 13


def setup(seq=SEQ, heads=HEADS, hd=HEAD_DIM, with_ref=True, device: Optional[str] = None):
    """``(q, k, v, ref)``: bf16 normal ``(heads, seq, hd)`` tensors from a
    generator seeded 13 on the device, and the causal f32 oracle (or None).
    On ``cuda`` unless ``device`` says otherwise; without a GPU the default
    raises."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (
        torch.randn((heads, seq, hd), generator=gen, device=dev, dtype=torch.bfloat16)
        for _ in range(3)
    )
    ref = reference_attention(q, k, v) if with_ref else None
    return q, k, v, ref


def make_measure(q, k, v, iters=32):
    """``measure(flash_fn) -> seconds`` per iteration of the serial chain
    ``x = flash_fn(x, k, v)`` starting from ``q``."""

    def force(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return float(x[0, 0, :8].float().sum())

    def measure(fn):
        return chain_per_iter_seconds(lambda x: fn(x, k, v), q, force, iters)

    return measure


def max_err(fn, q, k, v, ref) -> float:
    """Max-abs error of ``fn(q, k, v)`` against the f32 oracle ``ref``."""
    return float((fn(q, k, v).float() - ref).abs().max())


def ratio_summary(stats: dict) -> dict:
    """``adjacent_ratio_stats``'s result as JSON: per candidate the median
    ratio and its interquartile range."""
    return {name: {"median": med, "iqr": [lo, hi]} for name, (med, lo, hi, _) in stats.items()}
