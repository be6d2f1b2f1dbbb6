"""Ring-attention context-parallel probe: long-context readiness.

The counterpart of the JAX package's ``workloads/ringattn.py``. The
sequence is sharded over the ``sp`` ranks; each rank keeps its Q block and
rotates the K/V blocks around the ring with ``ppermute`` (``sp`` hops),
folding each visiting block into an online-softmax accumulator (running
max ``m`` and sum ``l`` in f32). After ``sp`` hops every rank has attended
over the whole sequence without holding all of K/V in one product.

Validation is exact, not statistical: each rank holds its output rows
against single-pass full attention of the same Q rows over the whole K/V
(``_full_attention``, f32), and the worst error over the ranks is the
probe's. A dropped or reordered K/V block gives O(1) errors.

The products take the bf16 inputs as f32 (bf16 products are exact in f32,
which is what the reference's ``preferred_element_type=f32`` computes),
with TF32 off on the card (``mesh.spawn_world``'s ranks). These are plain
``einsum``s, as in the reference: no kernel of this package replaces them.

Used by ``python -m tpu_operator_torch.validator --component ringattn``
and ``entry.dryrun_multichip``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from tpu_operator_torch import convert
from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.workloads.mesh import (
    Rank,
    all_reduce_scalar,
    ppermute,
    spawn_world,
    world_size,
)


@dataclass
class RingAttnResult:
    ok: bool
    n_devices: int
    seq_len: int
    heads: int
    head_dim: int
    max_abs_err: float
    elapsed_s: float
    achieved_tokens_per_s: float
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "n_devices": self.n_devices,
            "seq_len": self.seq_len,
            "heads": self.heads,
            "head_dim": self.head_dim,
            "max_abs_err": round(self.max_abs_err, 8),
            "elapsed_s": round(self.elapsed_s, 6),
            "achieved_tokens_per_s": round(self.achieved_tokens_per_s, 1),
            "error": self.error,
        }


def _ring_attention_block(q, k, v, world: Rank, scale: float):
    """The rank's ring attention: q/k/v are its ``[batch, seq_local, heads,
    head_dim]`` blocks. Rotates (k, v) ``world.size`` times; the online
    softmax folds in each visiting block."""
    n, r = world.size, world.rank
    b, t, h, d = q.shape
    qf = q.float()
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, t, h), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, t, h), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for _ in range(n):
        # scores over the visiting K block: [b, t, h, s]
        s = torch.einsum("bthd,bshd->bths", qf, kb.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bths,bshd->bthd", p, vb.float())
        m = m_new
        kb = ppermute(kb, (r + 1) % n, (r - 1) % n)
        vb = ppermute(vb, (r + 1) % n, (r - 1) % n)
    return (o / l[..., None]).to(q.dtype)


def _full_attention(q, k, v, scale: float):
    """Single-pass reference attention (f32 math)."""
    s = torch.einsum("bthd,bshd->bths", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bths,bshd->bthd", p, v.float())


def _check_seq(seq_len: int, n: int) -> None:
    if seq_len % n != 0:
        raise ValueError(f"seq_len {seq_len} not divisible by sp={n}")


def ringattn_inputs(batch: int, seq_len: int, heads: int, head_dim: int):
    """``(q, k, v)``, each ``[batch, seq_len, heads, head_dim]`` bf16 on the
    host, drawn from a generator seeded 7 (the reference's key; its values
    differ)."""
    gen = torch.Generator().manual_seed(7)
    shape = (batch, seq_len, heads, head_dim)
    return tuple(torch.randn(shape, generator=gen).to(torch.bfloat16) for _ in range(3))


def build_ringattn(
    world: Rank,
    batch: int = 1,
    seq_len: int = 2048,
    heads: int = 4,
    head_dim: int = 128,
    qkv: Optional[tuple] = None,
):
    """Returns (the rank's attention fn, its (q, k, v) blocks on its device,
    the whole (q, k, v)). ``qkv`` are the reference's global bf16 numpy
    arrays; by default ``ringattn_inputs`` draws them."""
    n = world.size
    _check_seq(seq_len, n)
    if qkv is None:
        full = ringattn_inputs(batch, seq_len, heads, head_dim)
    else:
        full = tuple(convert.to_torch(a) for a in qkv)
    step = full[0].shape[1] // n
    blocks = tuple(
        a[:, world.rank * step:(world.rank + 1) * step].to(world.device) for a in full
    )
    scale = 1.0 / full[0].shape[-1] ** 0.5

    def fn(qb, kb, vb):
        return _ring_attention_block(qb, kb, vb, world, scale)

    return fn, blocks, full


def rank_ringattn(
    world: Rank,
    batch: int = 1,
    seq_len: int = 2048,
    heads: int = 4,
    head_dim: int = 128,
    iters: int = 4,
    tol: float = 2e-2,
) -> RingAttnResult:
    """The rank's part of ``run_ringattn``; every rank returns the same
    result."""
    fn, (q, k, v), full = build_ringattn(world, batch, seq_len, heads, head_dim)
    out = fn(q, k, v)
    # this rank's rows of full attention over the whole K/V
    ref = _full_attention(
        q, full[1].to(world.device), full[2].to(world.device), 1.0 / head_dim**0.5
    )
    err = float((out.float() - ref).abs().max())
    max_err = all_reduce_scalar(err, dist.ReduceOp.MAX, world.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(q, k, v)
    world.sync()
    elapsed = all_reduce_scalar(time.perf_counter() - t0, dist.ReduceOp.MAX, world.device)
    tokens_per_s = batch * seq_len * iters / elapsed if elapsed > 0 else 0.0
    return RingAttnResult(
        ok=max_err <= tol,
        n_devices=world.size,
        seq_len=seq_len,
        heads=heads,
        head_dim=head_dim,
        max_abs_err=max_err,
        elapsed_s=elapsed,
        achieved_tokens_per_s=tokens_per_s,
        error="" if max_err <= tol else f"divergence {max_err:.4f} > tol {tol}",
    )


def run_ringattn(
    n_devices: Optional[int] = None,
    batch: int = 1,
    seq_len: int = 2048,
    heads: int = 4,
    head_dim: int = 128,
    iters: int = 4,
    tol: float = 2e-2,
    device: Optional[str] = None,
) -> RingAttnResult:
    """Run the context-parallel probe on ``n_devices`` ranks (every card by
    default) and check it against full attention. On ``cuda`` unless
    ``device`` says otherwise.

    ``tol`` bounds the max-abs divergence between the ring accumulator and
    single-pass attention; bf16 inputs with f32 accumulation keep genuine
    runs well inside 2e-2, while a dropped or reordered K/V block produces
    O(1) errors."""
    dev = resolve_device(device)
    try:
        n = world_size(n_devices, dev)
        _check_seq(seq_len, n)
        return spawn_world(
            rank_ringattn, n, dev, batch, seq_len, heads, head_dim, iters, tol
        )[0]
    except Exception as e:
        return RingAttnResult(
            ok=False,
            n_devices=0,
            seq_len=seq_len,
            heads=heads,
            head_dim=head_dim,
            max_abs_err=float("nan"),
            elapsed_s=0.0,
            achieved_tokens_per_s=0.0,
            error=str(e),
        )
