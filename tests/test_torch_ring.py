"""The port's ring probe against the JAX package's, on the CPU: the same
bf16 payload rotated around a ring of four (the JAX side on the 8-device
CPU mesh, the port in a gloo world of four) comes back bit for bit on both,
and the port's probe reports what the reference's does."""

import numpy as np
import pytest
import torch

from tpu_operator_torch import convert
from tpu_operator_torch.workloads import mesh, ring

N = 4
PAYLOAD_MB = 0.25
WORLD_TIMEOUT_S = 120


def _ring_cases(world, payload):
    """Every case of this module on one rank: one full rotation of the
    reference's payload, each hop's view of the rank-filled payload, and
    the probe."""
    rotate, x = ring.build_ring(world, payload=payload)
    out = {"rotated": convert.to_numpy(rotate(x)), "before": convert.to_numpy(x)}
    _, mine = ring.build_ring(world, PAYLOAD_MB)
    r, n = world.rank, world.size
    hop = mesh.ppermute(mine, (r + 1) % n, (r - 1) % n)
    out["one_hop_value"] = float(hop[0, 0])
    out["probe"] = ring.rank_ring_probe(world, PAYLOAD_MB, iters=2)
    return out


@pytest.fixture(scope="module")
def cases():
    import jax
    import jax.numpy as jnp

    from tpu_operator.workloads.ring import build_ring

    _, fn, x = build_ring(n_devices=N, payload_mb=PAYLOAD_MB)
    # a payload of random bits, not only each device's ordinal
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**16, size=x.shape, dtype=np.uint16)
    # keep NaN patterns out: jax may canonicalise them
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF
    payload = bits.view(jnp.bfloat16)
    sharding = x.sharding
    jax_out = np.asarray(fn(jax.device_put(jnp.asarray(payload), sharding)))
    port = mesh.spawn_world(_ring_cases, N, "cpu", payload, timeout_s=WORLD_TIMEOUT_S)
    return {"payload": payload, "jax_out": jax_out, "port": port}


@pytest.mark.parametrize("rank", range(N))
def test_full_ring_is_bit_exact_like_the_reference(cases, rank):
    rows = cases["payload"].shape[0] // N
    block = slice(rank * rows, (rank + 1) * rows)
    want = cases["jax_out"][block].view(np.uint16)
    got = cases["port"][rank]["rotated"]
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == cases["payload"][block].view(np.uint16).tobytes()
    assert cases["port"][rank]["before"].tobytes() == want.tobytes()


@pytest.mark.parametrize("rank", range(N))
def test_one_hop_moves_each_shard_to_the_next_rank(cases, rank):
    assert cases["port"][rank]["one_hop_value"] == float((rank - 1) % N)


def test_probe_matches_the_reference(cases):
    from tpu_operator.workloads.ring import run_ring_probe

    want = run_ring_probe(n_devices=N, payload_mb=PAYLOAD_MB, iters=2)
    got = cases["port"][0]["probe"]
    assert want.ok and got.ok, got.error
    assert got.integrity and got.gbps_per_hop > 0
    for key in ("n_devices", "hops", "payload_mb", "integrity"):
        assert getattr(got, key) == getattr(want, key), key
    # every rank reports the world's result
    assert all(c["probe"] == got for c in cases["port"])


def test_payload_shape_matches_the_reference():
    import jax

    from tpu_operator.workloads.ring import build_ring

    _, _, x = build_ring(n_devices=N, payload_mb=PAYLOAD_MB)
    assert x.shape == (N * ring.payload_rows(PAYLOAD_MB), ring.PAYLOAD_COLS)
    assert jax.numpy.dtype(x.dtype) == jax.numpy.bfloat16


def test_result_to_dict_keys_match():
    from tpu_operator.workloads.ring import RingResult

    args = (True, 4, 16, 4.0, 0.5, 10.0, True)
    assert ring.RingResult(*args).to_dict() == RingResult(*args).to_dict()


def test_probe_reports_too_many_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    res = ring.run_ring_probe(n_devices=2)
    assert not res.ok and "need 2 devices, have 1" in res.error
