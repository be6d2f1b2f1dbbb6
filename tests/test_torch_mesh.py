"""The port's process-group layer (``workloads/mesh.py``) on the CPU: the
dp × tp factoring against the reference's, the collectives' per-rank
semantics in one gloo world of four, and the world's failure paths (a rank
that raises, a world that sends nothing in time) ending in an error, not a
hang."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_operator_torch.workloads import mesh

N = 4
WORLD_TIMEOUT_S = 120


def _mesh_cases(world):
    """Every case of this module that needs a world, on one rank."""
    r, n = world.rank, world.size
    out = {}
    payload = torch.arange(6, dtype=torch.bfloat16) + 10 * r
    # a ring: each rank gets its predecessor's payload
    out["ring"] = mesh.ppermute(payload, (r + 1) % n, (r - 1) % n).float().tolist()
    # a chain (the pipeline's i -> i+1): rank 0 receives zeros
    nxt = r + 1 if r < n - 1 else None
    prev = r - 1 if r > 0 else None
    out["chain"] = mesh.ppermute(payload, nxt, prev).float().tolist()
    # a rank that is its own peer (a one-card ring) keeps its payload
    out["self"] = mesh.ppermute(payload, r, r).float().tolist()
    # a one-stage chain sends and receives nothing: zeros
    out["none"] = mesh.ppermute(payload, None, None).float().tolist()
    dp, tp = mesh.mesh_shape(n)
    dp_group, tp_group = mesh.dp_tp_groups(world, dp, tp)
    ranks = torch.tensor([float(r)])
    in_dp = ranks.clone()
    dist.all_reduce(in_dp, group=dp_group)
    in_tp = ranks.clone()
    dist.all_reduce(in_tp, group=tp_group)
    out["dp_sum"], out["tp_sum"] = float(in_dp), float(in_tp)
    out["max"] = mesh.all_reduce_scalar(float(r), dist.ReduceOp.MAX)
    return out


@pytest.fixture(scope="module")
def world_results():
    return mesh.spawn_world(_mesh_cases, N, "cpu", timeout_s=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_matches_reference(n):
    from tpu_operator.workloads.burnin import _mesh_shape

    assert mesh.mesh_shape(n) == _mesh_shape(n)


@pytest.mark.parametrize("rank", range(N))
def test_ppermute_ring_and_chain(world_results, rank):
    res = world_results[rank]
    base = np.arange(6, dtype=np.float32)
    assert res["ring"] == (base + 10 * ((rank - 1) % N)).tolist()
    want_chain = np.zeros(6) if rank == 0 else base + 10 * (rank - 1)
    assert res["chain"] == want_chain.tolist()
    assert res["self"] == (base + 10 * rank).tolist()
    assert res["none"] == [0.0] * 6


@pytest.mark.parametrize("rank", range(N))
def test_dp_tp_groups_follow_the_reshaped_mesh(world_results, rank):
    """Rank r at (r // tp, r % tp), as ``np.asarray(devices).reshape(dp,
    tp)`` lays the devices out: its dp group is its column, its tp group
    its row."""
    dp, tp = mesh.mesh_shape(N)
    grid = np.arange(N).reshape(dp, tp)
    res = world_results[rank]
    assert res["dp_sum"] == float(grid[:, rank % tp].sum())
    assert res["tp_sum"] == float(grid[rank // tp, :].sum())
    assert res["max"] == float(N - 1)


def _raise_on_rank_1(world):
    if world.rank == 1:
        raise ValueError("rank one gives up")
    # rank 0 waits in a collective rank 1 never joins
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def _sleep(world):
    time.sleep(60)


def test_a_rank_that_raises_fails_the_world_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one gives up") as err:
        mesh.spawn_world(_raise_on_rank_1, 2, "cpu", timeout_s=WORLD_TIMEOUT_S)
    assert "rank 1 of 2" in str(err.value)
    # the parent did not wait for rank 0's collective to time out
    assert time.monotonic() - t0 < mesh.INIT_TIMEOUT_S


def test_a_world_that_sends_nothing_times_out():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="sent no result within 3 s"):
        mesh.spawn_world(_sleep, 1, "cpu", timeout_s=3)
    assert time.monotonic() - t0 < 30


def test_world_size_defaults():
    assert mesh.world_size(None, torch.device("cpu")) == 1
    assert mesh.world_size(3, torch.device("cpu")) == 3
    with pytest.raises(ValueError):
        mesh.check_world(0, torch.device("cpu"))
