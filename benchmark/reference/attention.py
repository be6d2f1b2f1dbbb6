"""Attention in f32: ``softmax(q k^T / sqrt(d)) v``, causal, in blocks of query rows."""

from __future__ import annotations

import math

import torch

from benchmark.reference import exact_matmuls, lower as low

ROWS = 1024  # query rows a block: 8 heads x 1024 x 8192 f32 scores is 256 MiB


def attention(q, k, v, causal: bool = True, lower: bool = False, rows: int = ROWS):
    """f32 attention over ``(heads, seq, head_dim)``; row ``i`` attends to
    keys ``0..i`` when ``causal``. ``lower`` is the control: q, k, v and the
    probabilities rounded through fp8 before each product."""
    exact_matmuls()
    heads, seq, head_dim = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    cast = low.fp8 if lower else (lambda t: t.float())
    qf, kf, vf = cast(q), cast(k), cast(v)
    out = torch.empty((heads, seq, head_dim), dtype=torch.float32, device=q.device)
    for r0 in range(0, seq, rows):
        r1 = min(seq, r0 + rows)
        keys = r1 if causal else seq
        s = torch.matmul(qf[:, r0:r1], kf[:, :keys].transpose(1, 2)) * scale
        if causal:
            qpos = torch.arange(r0, r1, device=q.device)[:, None]
            kpos = torch.arange(keys, device=q.device)[None, :]
            s.masked_fill_(kpos > qpos, float("-inf"))
        s -= s.amax(dim=-1, keepdim=True)
        p = torch.exp_(s)
        p /= p.sum(dim=-1, keepdim=True)
        if lower:
            p = low.fp8(p)
        out[:, r0:r1] = torch.matmul(p, vf[:, :keys])
        del s, p
    return out


def max_gap(out, ref) -> float:
    """The largest absolute difference between ``out`` and the f32 ``ref``."""
    return float((out.float() - ref).abs().max())
