"""The port's ring attention against the JAX package's, on the CPU: the
same bf16 q, k, v (the JAX side's, carried across by ``convert``) through
ring attention over four ranks (the JAX side on the 8-device CPU mesh, the
port in a gloo world of four) agree within 2e-2 with the JAX sharded output
and with single-pass full attention, the reference's tolerance."""

import numpy as np
import pytest

from tpu_operator_torch import convert
from tpu_operator_torch.workloads import mesh, ringattn

N = 4
SEQ, HEADS, HEAD_DIM = 256, 2, 32
TOL = 2e-2
WORLD_TIMEOUT_S = 120


def _ringattn_cases(world, qkv):
    """Every case of this module on one rank: its output block on the
    reference's inputs, and the probe on the port's own."""
    fn, (q, k, v), _ = ringattn.build_ringattn(
        world, seq_len=SEQ, heads=HEADS, head_dim=HEAD_DIM, qkv=qkv
    )
    return {
        "out": convert.to_numpy(fn(q, k, v).float()),
        "probe": ringattn.rank_ringattn(world, seq_len=SEQ, heads=HEADS, head_dim=HEAD_DIM,
                                        iters=1),
    }


@pytest.fixture(scope="module")
def cases():
    import jax

    from tpu_operator.workloads.ringattn import _full_attention, build_ringattn

    _, fn, (q, k, v) = build_ringattn(n_devices=N, seq_len=SEQ, heads=HEADS, head_dim=HEAD_DIM)
    qkv = tuple(np.asarray(a) for a in (q, k, v))
    jax_out = np.asarray(jax.block_until_ready(fn(q, k, v)), np.float32)
    f32 = [a.astype(np.float32) for a in qkv]
    full = np.asarray(_full_attention(*f32, scale=1.0 / HEAD_DIM**0.5))
    k_rolled = np.roll(f32[1], SEQ // N, axis=1)
    full_bad = np.asarray(_full_attention(f32[0], k_rolled, f32[2], scale=1.0 / HEAD_DIM**0.5))
    port = mesh.spawn_world(_ringattn_cases, N, "cpu", qkv, timeout_s=WORLD_TIMEOUT_S)
    return {
        "jax_out": jax_out,
        "full": full,
        "full_bad": full_bad,
        "out": np.concatenate([c["out"] for c in port], axis=1),
        "port": port,
    }


def test_output_keeps_the_sequence_sharded(cases):
    assert all(c["out"].shape == (1, SEQ // N, HEADS, HEAD_DIM) for c in cases["port"])
    assert cases["out"].shape == cases["jax_out"].shape


@pytest.mark.parametrize("against", ["jax_out", "full"])
def test_matches_the_reference(cases, against):
    assert np.isfinite(cases["out"]).all()
    assert float(np.abs(cases["out"] - cases[against]).max()) <= TOL


def test_a_misordered_ring_would_fail(cases):
    """The check has teeth: one K block out of place gives O(1) errors."""
    assert float(np.abs(cases["out"] - cases["full_bad"]).max()) > 0.1


def test_probe_on_its_own_inputs(cases):
    from tpu_operator.workloads.ringattn import run_ringattn

    res = cases["port"][0]["probe"]
    assert res.ok, res.error
    assert res.max_abs_err <= TOL and res.achieved_tokens_per_s > 0
    want = run_ringattn(n_devices=N, seq_len=SEQ, heads=HEADS, head_dim=HEAD_DIM, iters=1)
    for key in ("n_devices", "seq_len", "heads", "head_dim"):
        assert getattr(res, key) == getattr(want, key), key
    assert all(c["probe"] == res for c in cases["port"])


def test_seq_not_divisible_is_reported_like_the_reference():
    from tpu_operator.workloads.ringattn import run_ringattn

    want = run_ringattn(n_devices=8, seq_len=500)
    got = ringattn.run_ringattn(n_devices=8, seq_len=500, device="cpu")
    assert not got.ok and got.error == want.error


def test_result_to_dict_keys_match():
    from tpu_operator.workloads.ringattn import RingAttnResult

    args = (True, 4, 2048, 4, 128, 1e-3, 0.5, 1e5)
    assert ringattn.RingAttnResult(*args).to_dict() == RingAttnResult(*args).to_dict()
