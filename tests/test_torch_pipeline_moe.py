"""The port's pipeline and MoE probes against the JAX package's, on the
CPU: the same inputs (the JAX side's, carried across by ``convert``)
through the GPipe pipeline over four stages and the top-1 MoE layer over
four experts (the JAX side on the 8-device CPU mesh, the port in a gloo
world of four) agree within 1e-4, the reference's tolerance; MoE drops no
token at its default capacity and drops what the reference drops at
``capacity_factor=0.5``."""

import numpy as np
import pytest

from tpu_operator_torch import convert
from tpu_operator_torch.workloads import mesh, moe, pipeline

N = 4
PIPE = {"n_micro": 6, "micro_batch": 2, "d_model": 32}
MOE = {"tokens_per_device": 16, "d_model": 16}
TOL = 1e-4
WORLD_TIMEOUT_S = 120


def _cases(world, pipe_inputs, moe_inputs):
    """Every case of this module on one rank: the pipeline and the MoE
    layer (default capacity and factor 0.5) on the reference's inputs, and
    the probes on the port's own."""
    fn, (x, ws), _ = pipeline.build_pipeline(world, inputs=pipe_inputs, **PIPE)
    out = {"pipe": convert.to_numpy(fn(x, ws))}
    for factor in (None, 0.5):
        fn, args, capacity, _ = moe.build_moe(
            world, capacity_factor=factor, inputs=moe_inputs, **MOE
        )
        y, keep, dropped = fn(*args)
        out[("moe", factor)] = (convert.to_numpy(y), convert.to_numpy(keep), int(dropped),
                                capacity)
    out["pipe_probe"] = pipeline.rank_pipeline(world, **PIPE)
    out["moe_probe"] = moe.rank_moe(world, **MOE)
    out["moe_probe_half"] = moe.rank_moe(world, capacity_factor=0.5, **MOE)
    return out


@pytest.fixture(scope="module")
def cases():
    from tpu_operator.workloads.moe import build_moe
    from tpu_operator.workloads.pipeline import build_pipeline

    _, pfn, (x, w) = build_pipeline(n_devices=N, **PIPE)
    pipe_inputs = (np.asarray(x), np.asarray(w))
    want = {"pipe": np.asarray(pfn(x, w))}
    for factor in (None, 0.5):
        _, mfn, (mx, wg, we), capacity = build_moe(n_devices=N, capacity_factor=factor, **MOE)
        y, keep, dropped = mfn(mx, wg, we)
        want[("moe", factor)] = (np.asarray(y), np.asarray(keep), int(dropped), capacity)
    moe_inputs = (np.asarray(mx), np.asarray(wg), np.asarray(we))
    port = mesh.spawn_world(
        _cases, N, "cpu", pipe_inputs, moe_inputs, timeout_s=WORLD_TIMEOUT_S
    )
    return {"want": want, "port": port}


@pytest.mark.parametrize("rank", range(N))
def test_pipeline_matches_the_reference(cases, rank):
    """Every rank holds the replicated outputs, as the reference's psum
    gives every device."""
    got = cases["port"][rank]["pipe"]
    want = cases["want"]["pipe"]
    assert got.shape == want.shape == (PIPE["n_micro"], PIPE["micro_batch"], PIPE["d_model"])
    assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("factor", [None, 0.5])
def test_moe_matches_the_reference(cases, factor):
    y_want, keep_want, dropped_want, cap_want = cases["want"][("moe", factor)]
    port = [c[("moe", factor)] for c in cases["port"]]
    y = np.concatenate([p[0] for p in port])
    keep = np.concatenate([p[1] for p in port])
    assert [p[3] for p in port] == [cap_want] * N
    assert all(p[2] == dropped_want for p in port)
    assert keep.tolist() == keep_want.tolist()
    assert float(np.abs(y - y_want).max()) <= TOL
    if factor is None:
        assert dropped_want == 0
    else:
        assert dropped_want > 0


def test_pipeline_probe(cases):
    from tpu_operator.workloads.pipeline import run_pipeline

    res = cases["port"][0]["pipe_probe"]
    assert res.ok, res.error
    assert res.n_stages == N and res.ticks == PIPE["n_micro"] + N - 1
    assert res.max_abs_err <= TOL
    want = run_pipeline(n_devices=N, **PIPE)
    assert (res.n_stages, res.n_micro, res.ticks) == (want.n_stages, want.n_micro, want.ticks)


def test_moe_probe(cases):
    res = cases["port"][0]["moe_probe"]
    assert res.ok, res.error
    assert (res.n_experts, res.tokens, res.capacity, res.dropped) == (
        N, N * MOE["tokens_per_device"], MOE["tokens_per_device"], 0)
    assert res.max_abs_err <= TOL


def test_moe_probe_fails_loudly_on_overflow(cases):
    res = cases["port"][0]["moe_probe_half"]
    assert not res.ok and res.dropped > 0 and "dropped" in res.error
    assert res.max_abs_err <= TOL
    assert all(c["moe_probe_half"] == res for c in cases["port"])


@pytest.mark.parametrize("n,tokens,factor", [(1, 64, None), (8, 64, None), (2, 64, 0.2),
                                             (4, 16, 0.5), (8, 8, 0.5)])
def test_moe_capacity_matches_the_reference(n, tokens, factor):
    from tpu_operator.workloads.moe import build_moe

    want = build_moe(n_devices=n, tokens_per_device=tokens, d_model=8, capacity_factor=factor)[3]
    assert moe.moe_capacity(n, tokens, factor) == want


@pytest.mark.parametrize("which", ["pipeline", "moe"])
def test_result_to_dict_keys_match(which):
    if which == "pipeline":
        from tpu_operator.workloads.pipeline import PipelineResult

        args = (True, 4, 8, 11, 1e-6, 0.5)
        assert pipeline.PipelineResult(*args).to_dict() == PipelineResult(*args).to_dict()
    else:
        from tpu_operator.workloads.moe import MoEResult

        args = (True, 4, 256, 64, 0, 1e-6, 0.5)
        assert moe.MoEResult(*args).to_dict() == MoEResult(*args).to_dict()
