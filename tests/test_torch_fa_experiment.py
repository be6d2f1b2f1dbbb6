"""The port's structural-variant instrument (K7) against the JAX package's,
on the CPU: the plain versions of ``paired``, ``bf16s`` and ``paired16``
against the Pallas kernels of ``scripts/fa_experiment.py::build`` run in
interpret mode on the same numpy inputs, and ``run_experiment`` against
the reference's candidates as a whole.

The script's module body runs the 8192 setup and the timing, so it is
never imported: ``build`` is taken from its source with ``ast`` and run
with small globals, ``pl.pallas_call`` wrapped to ``interpret=True``."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_flashattn import bf16_qkv
from tpu_operator.workloads import flashattn as ref
from tpu_operator_torch import _build, convert
from tpu_operator_torch.workloads import fa_common, fa_variant_check
from tpu_operator_torch.workloads import fa_experiment as port

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "fa_experiment.py"
HEAD_DIM = 128
ORACLE_TOL = 2e-2  # the reference's tolerance against the f32 oracle
# port-plain against interpreted Pallas: K3's tolerance for ``paired``;
# one bf16 ulp of outputs in [2, 4) (1.56e-2) for the half-width softmax
PLAIN_TOL = {"paired": 1e-2, "bf16s": 2e-2, "paired16": 2e-2}


class _InterpretPallas:
    """``pl`` with ``pallas_call`` run in interpret mode on the CPU."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@functools.lru_cache(maxsize=None)
def reference_build(seq, heads, bq, bk):
    """The reference's ``build(mode)`` with these globals."""
    tree = ast.parse(SCRIPT.read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "build"]
    namespace = {
        "jax": jax, "jnp": jnp, "lax": lax, "pl": _InterpretPallas(), "pltpu": pltpu,
        "diag_stop": ref.diag_stop, "seq": seq, "heads": heads, "hd": HEAD_DIM,
        "bq": bq, "bk": bk, "scale": 1.0 / HEAD_DIM**0.5,
    }
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT), "exec"), namespace)
    return namespace["build"]


def jax_candidate(name, seq, heads, bq, bk):
    if name == "shipped":
        return ref.make_flash_fn(seq, heads, HEAD_DIM, bq, bk, causal=True, interpret=True)
    return reference_build(seq, heads, bq, bk)(name)


@functools.lru_cache(maxsize=None)
def jax_output(name, seq, heads, bq, bk):
    q, k, v = (jnp.asarray(a) for a in bf16_qkv(heads, seq, seed=seq + heads + bk))
    if name == "full":
        fn = ref.make_flash_fn(seq, heads, HEAD_DIM, bq, bk, causal=True, interpret=True)
    else:
        fn = jax_candidate(name, seq, heads, bq, bk)
    return np.asarray(fn(q, k, v)).astype(np.float32)


def port_output(mode, seq, heads, bq, bk):
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(heads, seq, seed=seq + heads + bk))
    out = port.build(mode, seq, heads, HEAD_DIM, bq, bk)(q, k, v)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (heads, seq, HEAD_DIM)
    return convert.to_numpy(out, jnp.bfloat16).astype(np.float32)


def oracle(seq, heads, bk):
    q, k, v = (jnp.asarray(a) for a in bf16_qkv(heads, seq, seed=seq + heads + bk))
    return np.asarray(ref.reference_attention(q, k, v, True))


# (seq, heads, block_q, block_k)
SHAPES = [(512, 2, 128, 128), (512, 1, 128, 256), (1024, 2, 128, 256)]


@pytest.mark.parametrize("seq,heads,bq,bk", SHAPES)
@pytest.mark.parametrize("mode", port.MODES)
def test_mode_matches_jax(mode, seq, heads, bq, bk):
    """Port-plain against interpreted Pallas within ``PLAIN_TOL``; each
    side against the f32 oracle under 2e-2."""
    assert_mode_matches_jax(mode, seq, heads, bq, bk)


# K7c's Hopper kernel at its edges: an odd unmasked sub-tile left after the
# pairs (64/64), and eight sub-tiles per k-block, so the ring wraps inside
# one (128/512)
PAIRED16_EDGE_SHAPES = [(512, 1, 64, 64), (1024, 2, 128, 512)]


@pytest.mark.parametrize("seq,heads,bq,bk", PAIRED16_EDGE_SHAPES)
def test_paired16_matches_jax_at_the_hopper_edges(seq, heads, bq, bk):
    """As test_mode_matches_jax, at the tilings the card's K7c runs at its
    edges."""
    assert_mode_matches_jax("paired16", seq, heads, bq, bk)


def assert_mode_matches_jax(mode, seq, heads, bq, bk):
    got = port_output(mode, seq, heads, bq, bk)
    want = jax_output(mode, seq, heads, bq, bk)
    truth = oracle(seq, heads, bk)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= PLAIN_TOL[mode]
    assert float(np.abs(got - truth).max()) < ORACLE_TOL
    assert float(np.abs(want - truth).max()) < ORACLE_TOL


@pytest.mark.parametrize("paired,single", [("paired", "full"), ("paired16", "bf16s")])
def test_interpreted_pairs_equal_their_single_block_mode(paired, single):
    """Pairing changes the order of issue, not the arithmetic: the
    reference's paired modes equal their single-block modes bit for bit,
    as the port's K7a equals K3 and K7c equals K7b."""
    for shape in SHAPES:
        np.testing.assert_array_equal(jax_output(paired, *shape), jax_output(single, *shape))


@pytest.mark.parametrize("paired,single", [("paired", "full"), ("paired16", "bf16s")])
def test_plain_pairs_are_their_single_block_mode(paired, single):
    """The port has one plain version for each pair of modes."""
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(2, 512, seed=3))
    want = (port.fa.flash_attention(q, k, v, 128, 256, True) if single == "full"
            else port.experiment_flash(q, k, v, 128, 256, single))
    assert torch.equal(port.experiment_flash(q, k, v, 128, 256, paired), want)


def test_plain_flash_takes_one_softmax():
    """The half-width softmax is a mode of the one plain recurrence, and
    it cannot be combined with K5's."""
    q = torch.zeros((1, 256, HEAD_DIM), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pick one"):
        port.fa.plain_flash(q, q, q, 128, 128, bf16exp=True, bf16s=True)


@pytest.mark.parametrize("mode", port.MODES)
def test_plain_modes_launch_nothing(mode):
    _build.reset_launches()
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(1, 256, seed=4))
    port.experiment_flash(q, k, v, 128, 128, mode)
    assert _build.launches == {name: 0 for name in _build.KERNELS}


def test_every_mode_has_its_own_counter():
    names = list(port.MODE_KERNELS.values())
    assert len(set(names)) == len(names) and set(names) <= set(_build.KERNELS)
    flash_names = {name for name, _ in port.fa.VARIANT_KERNELS.values()}
    assert not set(names) & flash_names


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown"):
        port.build("nope", 512, 2)
    q = torch.zeros((1, 256, HEAD_DIM), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown"):
        port.experiment_flash(q, q, q, 128, 128, "nope")
    with pytest.raises(ValueError, match="unknown"):
        port.run_experiment(["paired", "nope"], seq=256, heads=1, device="cpu")


def test_non_tiling_shapes_raise():
    with pytest.raises(ValueError):
        port.build("bf16s", 300, 2)
    q = torch.zeros((2, 300, HEAD_DIM), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        port.experiment_flash(q, q, q, 128, 128, "paired")
    q = torch.zeros((2, 256, HEAD_DIM), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="built for"):
        port.build("paired16", 512, 2)(q, q, q)


def test_modes_take_a_partial_last_block_as_flashattn_does():
    """``experiment_flash`` takes the tilings ``flashattn`` takes: at seq
    520 (128/128, a partial last block) ``paired`` is K3's function and
    ``paired16`` K7b's, under the oracle's tolerance; ``build``, the
    reference instrument's own, still takes only tilings that divide."""
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(2, 520, seed=8))
    assert torch.equal(port.experiment_flash(q, k, v, 128, 128, "paired"),
                       port.fa.flash_attention(q, k, v, 128, 128, True))
    assert torch.equal(port.experiment_flash(q, k, v, 128, 128, "paired16"),
                       port.experiment_flash(q, k, v, 128, 128, "bf16s"))
    truth = port.fa.reference_attention(q, k, v)
    for mode in port.MODES:
        out = port.experiment_flash(q, k, v, 128, 128, mode)
        assert float((out.float() - truth).abs().max()) < ORACLE_TOL, mode
    with pytest.raises(ValueError, match="must tile"):
        port.build("paired", 520, 2)


def test_run_experiment_cpu_matches_the_reference_candidates():
    """The slice as a whole: each candidate's ``max_err`` against the
    oracle on the port's inputs within 1e-2 of the JAX candidate's on the
    same values; numerics only off the card."""
    seq, heads, bq, bk = 512, 2, 128, 128
    got = port.run_experiment(port.MODES, seq=seq, heads=heads, block_q=bq, block_k=bk,
                              device="cpu")
    assert "wall_speedup" not in got and got["device"] == "cpu"
    assert set(got["max_err"]) == {"shipped", *port.MODES}
    q, k, v, _ = fa_common.setup(seq, heads, HEAD_DIM, with_ref=False, device="cpu")
    jq, jk, jv = (jnp.asarray(convert.to_numpy(t, jnp.bfloat16)) for t in (q, k, v))
    truth = np.asarray(ref.reference_attention(jq, jk, jv, True))
    for name, err in got["max_err"].items():
        want = np.asarray(jax_candidate(name, seq, heads, bq, bk)(jq, jk, jv))
        jax_err = float(np.abs(want.astype(np.float32) - truth).max())
        assert err < ORACLE_TOL and jax_err < ORACLE_TOL
        assert abs(err - jax_err) <= 1e-2, name


def test_run_experiment_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run_experiment(["paired"], seq=256, heads=1)


def test_setup_is_seeded_and_deterministic():
    a = fa_common.setup(256, 2, HEAD_DIM, device="cpu")
    b = fa_common.setup(256, 2, HEAD_DIM, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    q, k, v, truth = a
    assert q.dtype == torch.bfloat16 and tuple(q.shape) == (2, 256, HEAD_DIM)
    assert not torch.equal(q, k) and not torch.equal(k, v)
    gen = torch.Generator().manual_seed(13)
    assert torch.equal(q, torch.randn((2, 256, HEAD_DIM), generator=gen, dtype=torch.bfloat16))
    assert torch.equal(truth, port.fa.reference_attention(q, k, v))
    assert fa_common.setup(256, 2, HEAD_DIM, with_ref=False, device="cpu")[3] is None


def test_make_measure_chains_through_q():
    q, k, v, _ = fa_common.setup(128, 1, HEAD_DIM, with_ref=False, device="cpu")
    seen = []

    def fn(x, k_, v_):
        assert k_ is k and v_ is v
        seen.append(x)
        return x

    assert fa_common.make_measure(q, k, v, iters=4)(fn) > 0
    assert seen and seen[0] is q


def test_variant_check_cpu():
    """Numerics only off the card: K3's and K4's plain versions are one
    function, so their errors are equal and under the oracle's tolerance."""
    got = fa_variant_check.run_variant_check(seq=256, heads=2, device="cpu")
    assert "wall_speedup" not in got
    assert got["max_err"]["shipped"] == got["max_err"]["pipelined"] < ORACLE_TOL
