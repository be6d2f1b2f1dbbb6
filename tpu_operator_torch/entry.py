"""Entry points of the port (the counterparts of ``__graft_entry__``).

``entry()`` — the flagship compute path: the validator's bf16 matmul chain
at size 1024, depth 2.

``dryrun_multichip(n)`` — the multi-device path: one world of ``n`` ranks
(``workloads/mesh.py``; NCCL, one card a rank, unless the caller asks for
the CPU) runs one burn-in train step on the dp × tp mesh (batch over dp,
column/row-parallel weights over tp), then the other parallelism axes on
the same ranks: sp — blockwise ring attention (K/V rotated by
``ppermute``); pp — the GPipe micro-batch pipeline (stage weights, chained
``ppermute``); ep — top-1 MoE with ``all_to_all`` dispatch and combine;
all at tiny shapes. Unlike the reference, which re-forces a CPU mesh when
it finds fewer chips than ``n``, it raises when there are fewer cards.
"""

from __future__ import annotations

import math
from typing import Optional

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.workloads.burnin import build_burnin
from tpu_operator_torch.workloads.matmul import make_matmul_step
from tpu_operator_torch.workloads.mesh import Rank, spawn_world
from tpu_operator_torch.workloads.moe import rank_moe
from tpu_operator_torch.workloads.pipeline import rank_pipeline
from tpu_operator_torch.workloads.ringattn import rank_ringattn


def entry(device: Optional[str] = None):
    """``(fn, (a, b))``: call ``fn(a, b)`` to run the chain. On ``cuda``
    unless ``device`` says otherwise."""
    return make_matmul_step(size=1024, depth=2, device=device)


def _dryrun_rank(world: Rank):
    """One rank of ``dryrun_multichip``: (dp, tp, loss, ringattn, pipeline,
    moe results)."""
    n = world.size
    mesh, train_step, params, (x, y) = build_burnin(
        world, batch=8 * max(1, n), d_model=64, d_hidden=128
    )
    params, loss = train_step(params, x, y)
    world.sync()
    ra = rank_ringattn(world, seq_len=32 * n, heads=2, head_dim=32, iters=1)
    pp = rank_pipeline(world, n_micro=4, micro_batch=2, d_model=32)
    ep = rank_moe(world, tokens_per_device=16, d_model=16)
    return mesh.dp, mesh.tp, float(loss), ra, pp, ep


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """Run the dp/tp/sp/pp/ep dryrun on ``n_devices`` ranks and print its
    summary; raises on the first probe that fails."""
    dev = resolve_device(device)
    dp, tp, loss, ra, pp, ep = spawn_world(_dryrun_rank, n_devices, dev)[0]
    if not math.isfinite(loss):
        raise RuntimeError(f"burn-in dp×tp dryrun gave loss {loss}")
    if not ra.ok:
        raise RuntimeError(f"ring-attention sp dryrun failed: {ra.error}")
    if not pp.ok:
        raise RuntimeError(f"pipeline pp dryrun failed: {pp.error}")
    if not ep.ok:
        raise RuntimeError(f"moe ep dryrun failed: {ep.error}")
    print(
        f"dryrun_multichip OK: mesh dp={dp} tp={tp} sp={ra.n_devices} "
        f"pp={pp.n_stages} ep={ep.n_experts} ({n_devices} devices), "
        f"loss={loss:.5f}, ringattn max_err={ra.max_abs_err:.2e}, "
        f"pipeline max_err={pp.max_abs_err:.2e}, moe max_err={ep.max_abs_err:.2e}"
    )
