"""Pipeline-parallel (pp) probe: a GPipe micro-batch pipeline over ranks.

The counterpart of the JAX package's ``workloads/pipeline.py``. Each rank
holds one gelu MLP block (a "stage"); micro-batches enter at stage 0, and
every tick each stage runs its resident micro-batch and hands the
activation to its successor with ``ppermute`` (a chain ``i → i+1``, not a
ring: stage 0 receives zeros). After ``n_micro + n_stages - 1`` ticks
every micro-batch has passed every stage. The last stage keeps its outputs
only inside the schedule's diagonal window, and an ``all_reduce`` of its
outputs with zeros from every other stage gives every rank the result, as
the reference's stage-masked ``psum`` does.

Validation is exact: the pipelined output must match all stages applied in
order on one device (f32, 1e-4), with TF32 off on the card.

Used by ``python -m tpu_operator_torch.validator --component pipeline``
and ``entry.dryrun_multichip``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

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
class PipelineResult:
    ok: bool
    n_stages: int
    n_micro: int
    ticks: int
    max_abs_err: float
    elapsed_s: float
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "n_stages": self.n_stages,
            "n_micro": self.n_micro,
            "ticks": self.ticks,
            "max_abs_err": round(self.max_abs_err, 8),
            "elapsed_s": round(self.elapsed_s, 6),
            "error": self.error,
        }


def _stage_block(x, w):
    """One pipeline stage: gelu (tanh form, as ``jax.nn.gelu``) of an f32
    product."""
    return F.gelu(x @ w, approximate="tanh")


def pipeline_inputs(n_stages: int, n_micro: int, micro_batch: int, d_model: int):
    """``(x, w)`` as numpy f32: ``x`` ``[n_micro, micro_batch, d_model]``,
    ``w`` ``[n_stages, d_model, d_model]``, drawn from a generator seeded 3
    (the reference's key; its values differ)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((n_micro, micro_batch, d_model), generator=gen)
    # small weights keep activations O(1) through n stages
    w = torch.randn((n_stages, d_model, d_model), generator=gen) * (1.0 / d_model**0.5)
    return x.numpy(), w.numpy()


def build_pipeline(
    world: Rank,
    n_micro: int = 8,
    micro_batch: int = 4,
    d_model: int = 128,
    inputs: Optional[tuple] = None,
):
    """Returns (the rank's pipeline fn, (x, its stage's weights ``[1, d,
    d]``) on its device, the whole (x, w) on the host).

    ``inputs`` are the reference's global numpy ``(x, w)``; by default
    ``pipeline_inputs`` draws them. ``fn(x, ws)`` returns the ``[n_micro,
    micro_batch, d_model]`` outputs, the same on every rank."""
    n, r = world.size, world.rank
    if inputs is None:
        inputs = pipeline_inputs(n, n_micro, micro_batch, d_model)
    x, w = inputs
    mine = (
        convert.to_torch(x, world.device),
        convert.to_torch(convert.shard(w, 0, r, n), world.device),
    )
    ticks = x.shape[0] + n - 1
    send_to = r + 1 if r < n - 1 else None  # no wraparound: a chain
    recv_from = r - 1 if r > 0 else None

    def pipe(xs, ws):
        w_mine = ws[0]
        outs = torch.zeros_like(xs)
        recv = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
        for t in range(ticks):
            # stage 0 injects micro-batch t (clamped: bubble ticks are
            # masked out downstream by the write-index guard)
            inp = xs[min(t, xs.shape[0] - 1)] if r == 0 else recv
            act = _stage_block(inp, w_mine)
            # the micro-batch at this stage this tick; valid only in the
            # schedule's diagonal window
            mb_id = t - r
            if r == n - 1 and 0 <= mb_id < xs.shape[0]:
                outs[mb_id] = act
            recv = ppermute(act, send_to, recv_from)
        # only the last stage holds real outputs; every other contributes
        # zeros to the sum that replicates them
        dist.all_reduce(outs)
        return outs

    return pipe, mine, (convert.to_torch(x), convert.to_torch(w))


def rank_pipeline(
    world: Rank,
    n_micro: int = 8,
    micro_batch: int = 4,
    d_model: int = 128,
    tol: float = 1e-4,
) -> PipelineResult:
    """The rank's part of ``run_pipeline``; every rank returns the same
    result."""
    fn, (x, ws), (_, w) = build_pipeline(world, n_micro, micro_batch, d_model)
    dist.barrier()
    t0 = time.perf_counter()
    out = fn(x, ws)
    world.sync()
    elapsed = all_reduce_scalar(time.perf_counter() - t0, dist.ReduceOp.MAX, world.device)
    # sequential reference: all stages applied in order on one device
    ref = x
    for s in range(world.size):
        ref = _stage_block(ref, w[s].to(world.device))
    max_err = float((out - ref).abs().max())
    return PipelineResult(
        ok=max_err <= tol,
        n_stages=world.size,
        n_micro=n_micro,
        ticks=n_micro + world.size - 1,
        max_abs_err=max_err,
        elapsed_s=elapsed,
        error="" if max_err <= tol else f"divergence {max_err:.6f} > {tol}",
    )


def run_pipeline(
    n_devices: Optional[int] = None,
    n_micro: int = 8,
    micro_batch: int = 4,
    d_model: int = 128,
    tol: float = 1e-4,
    device: Optional[str] = None,
) -> PipelineResult:
    """Run the pipeline over ``n_devices`` stages (every card by default)
    and check it against the stages applied in order. On ``cuda`` unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    try:
        n = world_size(n_devices, dev)
        return spawn_world(rank_pipeline, n, dev, n_micro, micro_batch, d_model, tol)[0]
    except Exception as e:
        return PipelineResult(
            ok=False,
            n_stages=0,
            n_micro=n_micro,
            ticks=0,
            max_abs_err=float("nan"),
            elapsed_s=0.0,
            error=str(e),
        )
