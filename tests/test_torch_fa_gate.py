"""The port's flash gate (``workloads/fa_gate.py``) and its self-test
(``workloads/fa_gate_selftest.py``) against the JAX package's
``bench.flashattn_gate_ok`` and ``scripts/fa_gate_selftest.py``.

The two gate cases of ``tests/test_bench_gate.py`` run on each package
under their own names (``two_sided.hold``), with the reference's
assertions made in each side's terms (its floor and its populations);
the outcomes must be equal. The gate is then held equal to the
reference's on ratios from a numpy seed and the edge values (``None``,
the floor, the floor less 1e-6) with the same explicit floor, on the card
and off it, and under the floor's env override. The self-tests run with
their probes and matmuls replaced by the same fake results (no card is
needed) and must exit alike. ``bench.py`` and the reference's script are
loaded by path here only; the port never imports them.
"""

import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.two_sided import BY_SIDE, hold
from tpu_operator_torch.workloads import fa_gate, fa_gate_selftest
from tpu_operator_torch.workloads import flashattn as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 27


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_bench():
    return _load("bench", "bench.py")


@pytest.fixture
def clean_env(monkeypatch):
    """No floor override, and ``bench`` imported afresh by whoever needs
    it (the reference's self-test imports it by name); ``sys.path`` and
    ``sys.modules['bench']`` restored afterwards."""
    monkeypatch.delenv(fa_gate.FLOOR_ENV, raising=False)
    saved_path, saved_bench = list(sys.path), sys.modules.pop("bench", None)
    yield monkeypatch
    sys.path[:] = saved_path
    sys.modules.pop("bench", None)
    if saved_bench is not None:
        sys.modules["bench"] = saved_bench


def _sides():
    bench = _load_bench()
    return {
        # the reference's test: 0.70 from its healthy band, 0.47 from its degraded class
        "reference": SimpleNamespace(name="reference", gate=bench.flashattn_gate_ok,
                                     floor=bench.FLASHATTN_VS_MATMUL_FLOOR, healthy=0.70, degraded=0.47),
        "port": SimpleNamespace(name="port", gate=fa_gate.flashattn_gate_ok,
                                floor=fa_gate.gate_floor(), healthy=fa_gate.HEALTHY_LOWEST,
                                degraded=fa_gate.DEGRADED_HIGHEST),
    }


def trips_script(s):
    if s.name == "reference":
        assert s.floor == 0.57  # round-5 separator midpoint
    else:
        assert s.floor == (fa_gate.HEALTHY_LOWEST + fa_gate.DEGRADED_HIGHEST) / 2
    out = [s.gate(s.healthy, True), s.gate(s.floor, True), s.gate(s.degraded, True),
           s.gate(s.floor - 1e-6, True), s.gate(None, True), s.gate(None, False), s.gate(0.1, False)]
    # the healthy band and the boundary pass; a regression, a hair under the
    # floor and a failed measurement trip; off the card nothing is gated
    assert out == [True, True, False, False, False, True, True]
    return out


@BY_SIDE
def test_gate_trips_below_floor_and_on_missing_ratio(clean_env, side):
    hold(_sides(), side, trips_script)


def override_script(s):
    out = [s.gate(0.8, True), s.gate(0.95, True)]
    assert out == [False, True]
    return out


@BY_SIDE
def test_gate_floor_env_override(clean_env, side):
    clean_env.setenv(fa_gate.FLOOR_ENV, "0.9")
    hold(_sides(), side, override_script)


def seeded_ratios(floor):
    rng = np.random.default_rng(SEED)
    return [float(r) for r in rng.uniform(0.0, 1.2, 64)] + [None, floor, floor - 1e-6, floor + 1e-6, 0.0]


FLOORS = [0.57, fa_gate.FLASHATTN_VS_MATMUL_FLOOR, 0.9]


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("floor", FLOORS)
def test_gate_agrees_with_the_reference_at_an_explicit_floor(clean_env, floor, on_card):
    bench = _load_bench()
    for ratio in seeded_ratios(floor):
        assert fa_gate.flashattn_gate_ok(ratio, on_card, floor) == bench.flashattn_gate_ok(ratio, on_card, floor), \
            (ratio, on_card, floor)


@pytest.mark.parametrize("override", ["0.3", "0.57", "0.75"])
def test_gate_agrees_with_the_reference_under_the_override(clean_env, override):
    """The env override, set before the reference's bench is loaded (it
    reads it at import) and after the port's module was (it reads it at
    use), gives both the same floor and the same verdicts."""
    clean_env.setenv(fa_gate.FLOOR_ENV, override)
    bench = _load_bench()
    assert fa_gate.gate_floor() == bench.FLASHATTN_VS_MATMUL_FLOOR == float(override)
    for ratio in seeded_ratios(float(override)):
        for on_card in (True, False):
            assert fa_gate.flashattn_gate_ok(ratio, on_card) == bench.flashattn_gate_ok(ratio, on_card)


def test_floor_is_the_midpoint_of_its_populations(clean_env):
    lo, hi = fa_gate.DEGRADED_HIGHEST, fa_gate.HEALTHY_LOWEST
    assert fa_gate.FLASHATTN_VS_MATMUL_FLOOR == (lo + hi) / 2
    assert lo < fa_gate.FLASHATTN_VS_MATMUL_FLOOR < hi
    assert fa_gate.gate_floor() == fa_gate.FLASHATTN_VS_MATMUL_FLOOR
    # the populations' points: the shipped blocks and a pair K3 takes on the card
    assert fa_gate.SHIPPED_BLOCKS == fa.card_blocks(fa_gate.SEQ) == (128, 128)
    bq, bk = fa_gate.DEGRADED_BLOCKS
    assert bq == 64 and bk % fa.KERNEL_KEY_TILE == 0
    fa.check_kernel_tiling("flash_fwd", bq, bk)
    fa.check_tiling(fa_gate.SEQ, bq, bk)
    assert fa_gate.POPULATION_CARD.startswith("NVIDIA H100")
    assert fa_gate.POPULATION_POWER_LIMIT.endswith(" W")


def probe_result(tflops, ok=True, block_q=64, block_k=64):
    return SimpleNamespace(ok=ok, tflops=tflops if ok else 0.0, tflops_effective=tflops if ok else 0.0,
                           error="" if ok else "probe failed", block_q=block_q, block_k=block_k)


def matmul_result(tflops, ok=True):
    return SimpleNamespace(ok=ok, tflops=tflops if ok else 0.0, error="" if ok else "matmul failed")


def _seeded_case():
    rng = np.random.default_rng(SEED)
    return [float(t) for t in rng.uniform(100.0, 400.0, 3)], float(rng.uniform(500.0, 900.0))


# (probe rates, None for a failed probe; matmul rate, None for a failed matmul)
SELFTEST_CASES = {
    "tripped": ([100.0, 120.0, 110.0], 800.0),
    "not_tripped": ([300.0, 350.0, 340.0], 700.0),
    "at_floor": ([210.0, 200.0, 150.0], 700.0),
    "one_probe_failed": ([None, 90.0, 80.0], 700.0),
    "probes_failed": ([None, None, None], 700.0),
    "matmul_failed": ([300.0, 320.0, 310.0], None),
    "matmul_zero": ([300.0, 320.0, 310.0], 0.0),
    "seeded": _seeded_case(),
}
FLOOR_FOR_SELFTEST = "0.3"  # so that "at_floor" sits exactly on it


def fakes(probes, mm):
    it = iter(probes * 2)

    def probe(*args, **kw):
        t = next(it)
        return probe_result(t if t is not None else 0.0, ok=t is not None)

    def matmul(*args, **kw):
        return matmul_result(mm if mm is not None else 0.0, ok=mm is not None)

    return probe, matmul


@pytest.mark.parametrize("case", sorted(SELFTEST_CASES))
def test_selftest_exits_as_the_reference_does(clean_env, capsys, case):
    probes, mm = SELFTEST_CASES[case]
    clean_env.setenv(fa_gate.FLOOR_ENV, FLOOR_FOR_SELFTEST)
    # the reference's script imports bench by name from its working directory
    clean_env.chdir(REPO)
    ref = _load("ref_fa_gate_selftest", "scripts/fa_gate_selftest.py")
    probe, matmul = fakes(probes, mm)
    clean_env.setattr(ref, "run_flashattn_probe", probe)
    clean_env.setattr(ref, "run_matmul_validation", matmul)
    want = ref.main()
    ref_out = capsys.readouterr().out

    probe, matmul = fakes(probes, mm)
    clean_env.setattr(fa_gate, "run_flashattn_probe", probe)
    clean_env.setattr(fa_gate, "run_matmul_validation", matmul)
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    got = fa_gate_selftest.main()
    out = capsys.readouterr().out
    assert got == want, (case, ref_out, out)
    assert ("gate_tripped=True" in out) == (want == 0) == ("gate_tripped=True" in ref_out)
    assert ("measurement failed" in out) == ("measurement failed" in ref_out)


def test_selftest_without_a_gpu_exits_2_and_measures_nothing(monkeypatch, capsys):
    def measure(*args, **kw):
        raise AssertionError("measured without a GPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fa_gate, "measure_vs_matmul", measure)
    monkeypatch.setattr(fa_gate, "run_flashattn_probe", measure)
    assert fa_gate_selftest.main() == 2
    assert fa_gate.main(["128/128"]) == 2
    assert capsys.readouterr().out == ""


def test_measure_vs_matmul_takes_the_best_probe_and_none_on_failure(monkeypatch):
    calls = []
    probe, matmul = fakes([300.0, 360.0, 330.0], 720.0)

    def counted(*args, **kw):
        calls.append(kw)
        return probe(*args, **kw)

    monkeypatch.setattr(fa_gate, "run_flashattn_probe", counted)
    monkeypatch.setattr(fa_gate, "run_matmul_validation", matmul)
    r = fa_gate.measure_vs_matmul(64, 64)
    assert len(calls) == fa_gate.PROBE_RUNS
    assert all((c["seq"], c["heads"], c["block_q"], c["block_k"]) == (8192, 8, 64, 64) for c in calls)
    assert r["fa_tflops"] == 360.0 and r["mm_tflops"] == 720.0 and r["vs_matmul"] == 0.5
    for probes, mm in (([None, None, None], 720.0), ([300.0, 360.0, 330.0], None),
                       ([300.0, 360.0, 330.0], 0.0)):
        probe, matmul = fakes(probes, mm)
        monkeypatch.setattr(fa_gate, "run_flashattn_probe", probe)
        monkeypatch.setattr(fa_gate, "run_matmul_validation", matmul)
        r = fa_gate.measure_vs_matmul(64, 64)
        assert r["vs_matmul"] is None and r["vs_matmul_performed"] is None, (probes, mm)
        assert not fa_gate.flashattn_gate_ok(r["vs_matmul"], True)


def test_measure_vs_matmul_on_the_cpu_at_a_small_size(monkeypatch):
    """The real probe and matmul on the CPU (the plain versions: numerics
    only, so the probe reports no rate): the reading holds the blocks it
    ran and a ratio of 0.0, not ``None``."""
    monkeypatch.setattr(fa_gate, "SEQ", 256)
    monkeypatch.setattr(fa_gate, "HEADS", 2)
    monkeypatch.setattr(fa_gate, "MATMUL_SIZE", 128)
    r = fa_gate.measure_vs_matmul(64, 256, device="cpu")
    assert (r["block_q"], r["block_k"]) == (64, 256)
    assert r["fa_error"] == "" and r["mm_error"] == ""
    assert r["mm_tflops"] > 0 and r["vs_matmul"] == 0.0


def effective_fakes(rates, mm):
    """Probes whose performed and effective rates differ, as a tiling
    with masked work gives: ``rates`` holds ``(tflops, tflops_effective)``
    a probe; one matmul at ``mm``."""
    it = iter(rates * 2)

    def probe(*args, **kw):
        performed, effective = next(it)
        return SimpleNamespace(ok=True, tflops=performed, tflops_effective=effective, error="",
                               block_q=64, block_k=8192)

    return probe, lambda *a, **kw: matmul_result(mm)


# the best by performed rate (400) is not the best by effective rate (250)
MASKED_WORK = [(400.0, 200.0), (300.0, 250.0), (350.0, 225.0)]


def test_measure_vs_matmul_divides_the_effective_rate(monkeypatch):
    """The gate's numerator is the probe's effective rate, and the best
    probe is the best by it; ``vs_matmul_performed`` divides the same
    probe's performed rate."""
    probe, matmul = effective_fakes(MASKED_WORK, 500.0)
    monkeypatch.setattr(fa_gate, "run_flashattn_probe", probe)
    monkeypatch.setattr(fa_gate, "run_matmul_validation", matmul)
    r = fa_gate.measure_vs_matmul(64, 8192)
    assert (r["fa_tflops"], r["fa_tflops_performed"], r["mm_tflops"]) == (250.0, 300.0, 500.0)
    assert r["vs_matmul"] == 0.5 and r["vs_matmul_performed"] == 0.6


def test_selftest_numerator_is_the_effective_rate_where_the_reference_takes_tflops(clean_env, capsys):
    """On probes whose two rates differ the self-tests part, by design:
    the reference takes the best ``tflops`` (400 / 500 = 0.8, over a 0.7
    floor: not tripped), the port the best ``tflops_effective`` (250 / 500
    = 0.5: tripped)."""
    clean_env.setenv(fa_gate.FLOOR_ENV, "0.7")
    clean_env.chdir(REPO)
    ref = _load("ref_fa_gate_selftest", "scripts/fa_gate_selftest.py")
    probe, matmul = effective_fakes(MASKED_WORK, 500.0)
    clean_env.setattr(ref, "run_flashattn_probe", probe)
    clean_env.setattr(ref, "run_matmul_validation", matmul)
    assert ref.main() == 1
    ref_out = capsys.readouterr().out
    assert "fa=400.0 TFLOPS" in ref_out and "vs_matmul=0.8000" in ref_out and "gate_tripped=False" in ref_out

    probe, matmul = effective_fakes(MASKED_WORK, 500.0)
    clean_env.setattr(fa_gate, "run_flashattn_probe", probe)
    clean_env.setattr(fa_gate, "run_matmul_validation", matmul)
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    assert fa_gate_selftest.main() == 0
    out = capsys.readouterr().out
    assert "fa=250.0 TFLOPS" in out and "vs_matmul=0.5000" in out and "gate_tripped=True" in out
