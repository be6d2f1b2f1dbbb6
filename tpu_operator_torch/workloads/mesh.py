"""Worlds of processes: the port's counterpart of ``jax.sharding.Mesh``.

The JAX package drives a device mesh from one process (``shard_map`` and
``jit`` over ``Mesh``). The port runs one process per rank instead: a
workload is a *rank function* ``fn(rank, *args)`` that ``spawn_world``
runs in ``n`` processes joined by ``torch.distributed``:

* on ``cuda``, NCCL, one rank per card (rank ``r`` on ``cuda:r``); a world
  larger than the cards visible raises, it never falls back to the CPU;
* on ``cpu``, gloo, ``n`` processes.

Processes start with the ``spawn`` method (the parent may already hold a
CUDA context), so a rank function and its arguments must pickle: a
module-level function, numpy arrays and plain values. Ranks meet through a
``file://`` rendezvous in a fresh temporary directory, so worlds started
side by side never share a port. Every rank has ``INIT_TIMEOUT_S`` to join
and for each collective; the parent gives the whole world ``timeout_s`` and
kills what is left after it. A rank that raises, dies or sends no result
fails the world.

The collectives the reference names map as: ``ppermute`` → ``ppermute``
below (``batch_isend_irecv``), ``psum`` → ``all_reduce``, ``all_to_all`` →
``all_to_all_single``; the ``dp`` × ``tp`` layout of ``burnin`` is
``mesh_shape`` and ``dp_tp_groups``.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_operator_torch.device import resolve_device

# seconds a rank may wait at the rendezvous and in any one collective
INIT_TIMEOUT_S = 60
# seconds the parent gives a world, start-up included, by default
WORLD_TIMEOUT_S = 300
# seconds the parent waits, after a rank failed, for the others' errors
FAILURE_GRACE_S = 2.0


@dataclass(frozen=True)
class Rank:
    """What a rank function is given: its rank, the world's size and the
    device its tensors live on."""

    rank: int
    size: int
    device: torch.device

    def sync(self) -> None:
        """Wait for the device's queued work (host timers read after it)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def mesh_shape(n: int) -> Tuple[int, int]:
    """Factor n into (dp, tp), as square as possible with tp a power of
    two (the reference's ``burnin._mesh_shape``)."""
    tp = 1
    while tp * 2 <= n and n % (tp * 2) == 0 and tp * 2 <= int(n**0.5) + 1:
        tp *= 2
    return n // tp, tp


def world_size(n_devices: Optional[int], dev: torch.device) -> int:
    """``n_devices``, or by default every card on ``cuda`` and one rank on
    the CPU."""
    if n_devices is not None:
        return n_devices
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def check_world(n: int, dev: torch.device) -> None:
    """Raise unless a world of ``n`` ranks fits on ``dev``'s type."""
    if n < 1:
        raise ValueError(f"a world needs at least one rank, asked for {n}")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"need {n} devices, have {have} (platform=cuda)")


def spawn_world(
    fn: Callable, n: int, device=None, *args, timeout_s: float = WORLD_TIMEOUT_S
) -> List:
    """Run ``fn(Rank, *args)`` in ``n`` processes joined by
    ``torch.distributed`` and return their results, by rank.

    ``device`` is ``cuda`` (NCCL; the default, which raises without a GPU
    or with fewer cards than ``n``) or ``cpu`` (gloo). Raises
    ``RuntimeError`` with the failing rank's traceback when a rank raises,
    dies or has sent no result within ``timeout_s``."""
    dev = resolve_device(device)
    check_world(n, dev)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, failed = {}, []
    with tempfile.TemporaryDirectory(prefix="tpu-operator-world-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, rank, n, dev.type, init, results, args),
                daemon=True,
            )
            for rank in range(n)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) + len(failed) < n:
                now = time.monotonic()
                if failed:
                    # the first error may be a peer's lost connection:
                    # wait a little for the other ranks' errors too, so
                    # that the cause is in the message
                    if now >= grace:
                        break
                elif now >= deadline:
                    missing = sorted(set(range(n)) - set(got))
                    raise RuntimeError(
                        f"world of {n} on {dev.type}: ranks {missing} sent no "
                        f"result within {timeout_s} s"
                    )
                try:
                    rank, ok, out = results.get(timeout=0.1 if failed else 1.0)
                except queue.Empty:
                    dead = [
                        r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got
                    ]
                    if dead and not failed:
                        raise RuntimeError(
                            f"world of {n} on {dev.type}: rank {dead[0]} died "
                            f"(exit code {procs[dead[0]].exitcode}) with no result"
                        )
                    continue
                if ok:
                    got[rank] = out
                else:
                    if not failed:
                        grace = time.monotonic() + FAILURE_GRACE_S
                    failed.append((rank, out))
            if failed:
                raise RuntimeError("\n".join(
                    f"rank {rank} of {n} on {dev.type} failed:\n{tb}" for rank, tb in failed
                ))
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5)
            results.close()
    return [got[r] for r in range(n)]


def _rank_main(fn, rank, n, device_type, init, results, args) -> None:
    """One rank's process: join the world, run ``fn``, send back its result
    (or the traceback), leave the world."""
    joined = False
    try:
        dev = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            # the probes' f32 products are the reference's full-precision
            # dots (Precision.HIGHEST): TF32 would miss their 1e-4
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            # ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init,
            world_size=n,
            rank=rank,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
            device_id=dev if dev.type == "cuda" else None,
        )
        joined = True
        # every rank in: NCCL wants all ranks in a group's first call
        dist.barrier()
        out = fn(Rank(rank, n, dev), *args)
    except BaseException:
        # reported before leaving the group, so that the cause is sent
        # before the lost connection it gives the other ranks
        results.put((rank, False, traceback.format_exc()))
        raise
    else:
        results.put((rank, True, out))
    finally:
        if joined:
            dist.destroy_process_group()


def dp_tp_groups(world: Rank, dp: int, tp: int):
    """(this rank's ``dp`` group, its ``tp`` group) on the ``dp`` × ``tp``
    mesh that ``np.asarray(devices).reshape(dp, tp)`` lays out: rank ``r``
    at ``(r // tp, r % tp)``. Every rank creates every group, in the same
    order, as ``new_group`` requires."""
    mine_dp = mine_tp = None
    for t in range(tp):
        group = dist.new_group([d * tp + t for d in range(dp)])
        if world.rank % tp == t:
            mine_dp = group
    for d in range(dp):
        group = dist.new_group([d * tp + t for t in range(tp)])
        if world.rank // tp == d:
            mine_tp = group
    return mine_dp, mine_tp


def ppermute(x: torch.Tensor, send_to: Optional[int], recv_from: Optional[int]):
    """This rank's part of ``jax.lax.ppermute``: send ``x`` to rank
    ``send_to`` and return what rank ``recv_from`` sent, or zeros where no
    rank sends here (``recv_from`` None). A rank that is its own peer keeps
    ``x``: no send to itself is issued."""
    rank = dist.get_rank()
    if send_to == rank and recv_from == rank:
        return x
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), send_to))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def all_reduce_scalar(value: float, op=dist.ReduceOp.SUM, device=None) -> float:
    """``value`` reduced over the world with ``op``, in f64."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return float(t.item())
