"""Ring probe: per-link health and bandwidth through ``ppermute``.

The counterpart of the JAX package's ``workloads/ring.py``. A bf16 payload
is rotated around a 1-D ring of all ranks, each hop a ``ppermute`` to rank
``i + 1`` (``mesh.ppermute``, over NCCL between cards). After ``n`` hops
every rank's payload must be back bit for bit, and the hop time gives an
aggregate link-bandwidth estimate. A one-rank ring is vacuously healthy.

Used by ``python -m tpu_operator_torch.validator --component ici``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
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

PAYLOAD_COLS = 512


@dataclass
class RingResult:
    ok: bool
    n_devices: int
    hops: int
    payload_mb: float
    elapsed_s: float
    gbps_per_hop: float
    integrity: bool
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "n_devices": self.n_devices,
            "hops": self.hops,
            "payload_mb": self.payload_mb,
            "elapsed_s": round(self.elapsed_s, 6),
            "gbps_per_hop": round(self.gbps_per_hop, 3),
            "integrity": self.integrity,
            "error": self.error,
        }


def payload_rows(payload_mb: float) -> int:
    """Rows of a rank's ``(rows, PAYLOAD_COLS)`` bf16 payload."""
    return max(1, int(payload_mb * 2**20 / 2 / PAYLOAD_COLS))


def build_ring(world: Rank, payload_mb: float = 4.0, payload: Optional[np.ndarray] = None):
    """Returns (full-ring rotation fn, this rank's payload).

    By default each rank's ``payload_mb`` MB payload is filled with its own
    rank; ``payload``, the reference's global ``(n * rows, cols)`` bf16
    array, gives each rank its block of rows instead."""
    n, r = world.size, world.rank
    if payload is None:
        x = torch.full(
            (payload_rows(payload_mb), PAYLOAD_COLS), float(r),
            dtype=torch.bfloat16, device=world.device,
        )
    else:
        x = convert.to_torch(convert.shard(payload, 0, r, n), world.device)

    def rotate_full_ring(v):
        for _ in range(n):
            v = ppermute(v, (r + 1) % n, (r - 1) % n)
        return v

    return rotate_full_ring, x


def rank_ring_probe(world: Rank, payload_mb: float = 4.0, iters: int = 4) -> RingResult:
    """The rank's part of ``run_ring_probe``; every rank returns the same
    result."""
    rotate, x = build_ring(world, payload_mb)
    n = world.size
    if n < 2:
        # a 1-card "ring" is vacuously healthy
        return RingResult(True, n, 0, payload_mb, 0.0, 0.0, True)
    out = rotate(x)  # integrity round
    world.sync()
    same = float(torch.equal(out, x))
    integrity = all_reduce_scalar(same, dist.ReduceOp.MIN, world.device) == 1.0
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = rotate(out)
    world.sync()
    elapsed = all_reduce_scalar(time.perf_counter() - t0, dist.ReduceOp.MAX, world.device)
    # each link carries one shard per hop; the timed region runs n*iters
    # hops, so per-link bytes = shard_bytes * n * iters
    shard_bytes = x.numel() * x.element_size()
    per_link_bytes = shard_bytes * n * iters
    return RingResult(
        ok=integrity,
        n_devices=n,
        hops=n * iters,
        payload_mb=payload_mb,
        elapsed_s=elapsed,
        gbps_per_hop=(per_link_bytes / elapsed) * 8 / 1e9,
        integrity=integrity,
    )


def run_ring_probe(
    n_devices: Optional[int] = None,
    payload_mb: float = 4.0,
    iters: int = 4,
    device: Optional[str] = None,
) -> RingResult:
    """Rotate the payload around a ring of ``n_devices`` ranks (every card
    by default). On ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    try:
        n = world_size(n_devices, dev)
        return spawn_world(rank_ring_probe, n, dev, payload_mb, iters)[0]
    except Exception as e:
        return RingResult(False, 0, 0, payload_mb, 0.0, 0.0, False, error=str(e))
