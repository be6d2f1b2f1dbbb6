"""Expert-parallel (ep) probe: MoE token dispatch and combine through
``all_to_all``.

The counterpart of the JAX package's ``workloads/moe.py``. Each rank hosts
one expert; a top-1 router picks an expert per token; tokens are packed
into per-expert capacity slots (the inclusive ``cumsum`` of the one-hot
choice, minus one), exchanged with ``all_to_all_single``, run through the
resident expert MLP, exchanged back and unpacked. Tokens past an expert's
capacity are dropped and counted (an ``all_reduce``); the default capacity,
``tokens_per_device``, drops none for any routing.

Validation is exact: each rank holds its kept tokens against the dense
reference (every token through its argmax expert, f32, 1e-4), with TF32
off on the card; the worst error over the ranks is the probe's.

Used by ``python -m tpu_operator_torch.validator --component moe`` and
``entry.dryrun_multichip``.
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
    spawn_world,
    world_size,
)


@dataclass
class MoEResult:
    ok: bool
    n_experts: int
    tokens: int
    capacity: int
    dropped: int
    max_abs_err: float
    elapsed_s: float
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "n_experts": self.n_experts,
            "tokens": self.tokens,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "max_abs_err": round(self.max_abs_err, 8),
            "elapsed_s": round(self.elapsed_s, 6),
            "error": self.error,
        }


def _expert_mlp(x, w):
    """gelu (tanh form, as ``jax.nn.gelu``) of an f32 product."""
    return F.gelu(x @ w, approximate="tanh")


def moe_capacity(n: int, tokens_per_device: int, capacity_factor: Optional[float]) -> int:
    """Slots per (source, expert) pair: ``tokens_per_device`` by default,
    which never drops a token; a numeric factor exercises the overflow
    path."""
    if capacity_factor is None:
        capacity = tokens_per_device
    else:
        capacity = max(4, int(capacity_factor * tokens_per_device / n))
    return min(capacity, tokens_per_device)


def moe_inputs(n: int, tokens_per_device: int, d_model: int):
    """``(x, wg, we)`` as numpy f32: tokens ``[n * tokens_per_device,
    d_model]``, router ``[d_model, n]``, experts ``[n, d_model, d_model]``,
    drawn from a generator seeded 11 (the reference's key; its values
    differ)."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((n * tokens_per_device, d_model), generator=gen)
    wg = torch.randn((d_model, n), generator=gen)
    we = torch.randn((n, d_model, d_model), generator=gen) * (1.0 / d_model**0.5)
    return x.numpy(), wg.numpy(), we.numpy()


def build_moe(
    world: Rank,
    tokens_per_device: int = 64,
    d_model: int = 64,
    capacity_factor: Optional[float] = None,
    inputs: Optional[tuple] = None,
):
    """Returns (the rank's MoE fn, (its tokens, the router, its expert's
    weights ``[1, d, d]``) on its device, capacity, the whole (x, wg, we)
    on the host).

    ``inputs`` are the reference's global numpy ``(x, wg, we)``; by
    default ``moe_inputs`` draws them. ``fn`` returns (the rank's outputs,
    its keep mask, the dropped-token count over every rank)."""
    n, r = world.size, world.rank
    if inputs is None:
        inputs = moe_inputs(n, tokens_per_device, d_model)
    x, wg, we = inputs
    capacity = moe_capacity(n, x.shape[0] // n, capacity_factor)
    dev = world.device
    mine = (
        convert.to_torch(convert.shard(x, 0, r, n), dev),
        convert.to_torch(wg, dev),
        convert.to_torch(convert.shard(we, 0, r, n), dev),
    )

    def moe(xs, wgr, wes):
        d = xs.shape[1]
        choice = (xs @ wgr).argmax(dim=-1)  # [t] expert id per token
        onehot = F.one_hot(choice, n)  # [t, e]
        # slot = how many earlier tokens (inclusive) chose the same expert,
        # minus one; zero in the non-chosen columns so the row-sum is the
        # chosen expert's slot id
        slot = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=-1)
        keep = slot < capacity
        dropped = (~keep).sum()
        # dispatch tensor [e, capacity, d]: payloads packed into
        # (destination expert, slot); dropped tokens add zeros at (0, 0)
        e_idx = torch.where(keep, choice, 0)
        s_idx = torch.where(keep, slot, 0)
        payload = torch.where(keep[:, None], xs, 0.0)
        disp = torch.zeros((n, capacity, d), dtype=xs.dtype, device=xs.device)
        disp.index_put_((e_idx, s_idx), payload, accumulate=True)
        # after the exchange, rank e holds the slots every peer packed for
        # expert e: [n_sources, capacity, d]
        recv = torch.empty((n * capacity, d), dtype=xs.dtype, device=xs.device)
        dist.all_to_all_single(recv, disp.reshape(n * capacity, d))
        y = _expert_mlp(recv, wes[0])
        # return trip: each source gets its transformed slots back
        back = torch.empty_like(y)
        dist.all_to_all_single(back, y)
        out = back.reshape(n, capacity, d)[e_idx, s_idx]
        out = torch.where(keep[:, None], out, 0.0)  # dropped tokens: zeros
        dist.all_reduce(dropped)
        return out, keep, dropped

    full = (convert.to_torch(x), convert.to_torch(wg), convert.to_torch(we))
    return moe, mine, capacity, full


def rank_moe(
    world: Rank,
    tokens_per_device: int = 64,
    d_model: int = 64,
    capacity_factor: Optional[float] = None,
    tol: float = 1e-4,
) -> MoEResult:
    """The rank's part of ``run_moe``; every rank returns the same result."""
    fn, (x, wg, we_mine), capacity, (xs_all, _, we) = build_moe(
        world, tokens_per_device, d_model, capacity_factor
    )
    dist.barrier()
    t0 = time.perf_counter()
    out, keep, dropped = fn(x, wg, we_mine)
    world.sync()
    elapsed = all_reduce_scalar(time.perf_counter() - t0, dist.ReduceOp.MAX, world.device)
    dropped = int(dropped)
    # dense reference for this rank's tokens: each through its argmax
    # expert; dropped tokens (zeroed in the probe's output) are excluded so
    # the numerical check stays apart from the capacity check
    choice = (x @ wg).argmax(dim=-1)
    ref = torch.zeros_like(x)
    for e in range(world.size):
        sel = choice == e
        if bool(sel.any()):
            ref[sel] = _expert_mlp(x[sel], we[e].to(world.device))
    diff = (out - ref).abs()[keep]
    err = float(diff.max()) if diff.numel() else 0.0
    max_err = all_reduce_scalar(err, dist.ReduceOp.MAX, world.device)
    errors = []
    if dropped:
        errors.append(f"{dropped} tokens dropped (capacity too low)")
    if max_err > tol:
        errors.append(f"divergence {max_err:.6f} > {tol}")
    return MoEResult(
        ok=not errors,
        n_experts=world.size,
        tokens=xs_all.shape[0],
        capacity=capacity,
        dropped=dropped,
        max_abs_err=max_err,
        elapsed_s=elapsed,
        error="; ".join(errors),
    )


def run_moe(
    n_devices: Optional[int] = None,
    tokens_per_device: int = 64,
    d_model: int = 64,
    capacity_factor: Optional[float] = None,
    tol: float = 1e-4,
    device: Optional[str] = None,
) -> MoEResult:
    """Run the MoE layer over ``n_devices`` experts (every card by default)
    and check it against the dense reference. On ``cuda`` unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    try:
        n = world_size(n_devices, dev)
        return spawn_world(
            rank_moe, n, dev, tokens_per_device, d_model, capacity_factor, tol
        )[0]
    except Exception as e:
        return MoEResult(
            ok=False,
            n_experts=0,
            tokens=0,
            capacity=0,
            dropped=0,
            max_abs_err=float("nan"),
            elapsed_s=0.0,
            error=str(e),
        )
