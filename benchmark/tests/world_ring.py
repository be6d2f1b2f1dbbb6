"""A component for the tests of the harness's world, never a cell of
``BENCHMARK.json``: each call, on every rank, one ``all_reduce`` of a buffer
of ``mib`` MiB and one ring step (``mesh.ppermute``) of another, each held
exactly. ``test_harness_world.add_world`` copies it into a copy of the
benchmark as ``components/world_ring.py``.

Its widths may plant what the tests look for, each on one rank:
``fault`` (``{"rank", "call", "kind"}``: on that call, ``raise``, ``die``
or ``hang``), ``ballast`` (``{"rank", "mib"}``: memory held from
``prepare`` on), ``forbidden`` (``{"rank"}``: a stand-in module named
``jax`` loaded). ``last_rank_only`` is a number that the last rank alone
gives."""

import os
import sys
import time
import types

import torch
import torch.distributed as dist

from tpu_operator_torch.workloads import mesh

BUILDERS = []  # it calls no kernel builder of the program: ``held`` holds nothing
MIB_FLOATS = 2**20 // 4
_state = {"calls": 0, "ballast": None}


def _planted(run, w, key):
    found = w.get(key)
    return found if found and found["rank"] == run.rank.rank else None


def prepare(run, w) -> dict:
    ballast = _planted(run, w, "ballast")
    if ballast:
        _state["ballast"] = torch.ones(ballast["mib"] * MIB_FLOATS, device=run.device)
    if _planted(run, w, "forbidden"):
        sys.modules["jax"] = types.ModuleType("jax")
    return {}


def call(run, w) -> dict:
    _state["calls"] += 1
    fault = _planted(run, w, "fault")
    if fault and fault["call"] == _state["calls"]:
        if fault["kind"] == "raise":
            raise RuntimeError(f"planted fault on rank {run.rank.rank}, call {_state['calls']}")
        if fault["kind"] == "die":
            os._exit(3)
        time.sleep(3600)
    me, n = run.rank.rank, run.rank.size
    total = torch.full((w["mib"] * MIB_FLOATS,), float(me + 1), device=run.device)
    dist.all_reduce(total)
    mine = torch.full((w["mib"] * MIB_FLOATS,), float(me + 1), device=run.device)
    got = mesh.ppermute(mine, (me + 1) % n, (me - 1) % n)
    return {"total": total, "got": got, "want": float(n * (n + 1) // 2),
            "from": float((me - 1) % n + 1), "rank": me}


def numbers(payload, run, w) -> dict:
    return {"allreduce_gap": (payload["total"] - payload["want"]).abs().max().item(),
            "ring_gap": (payload["got"] - payload["from"]).abs().max().item(),
            "rank": float(payload["rank"])}


def compare(run, w, gen, control: bool = False) -> dict:
    me, n = run.rank.rank, run.rank.size
    x = torch.randint(-1000, 1000, (4096,), generator=gen, device=run.device).float()
    mine = x * (me + 1)  # every rank draws the same x from the seed
    dist.all_reduce(mine)
    out = {"seeded_gap": (mine - x * (n * (n + 1) // 2)).abs().max().item()}
    if me == n - 1:
        out["last_rank_only"] = w["last_rank_only"]
    return out


def held(run, w, builds, control: bool = False) -> dict:
    return {}
