"""The port's timing helpers give the JAX package's answers on a scripted
clock and scripted steps (exact equality: same arithmetic, same order).

The three ``adjacent_ratio_stats`` cases of ``tests/test_bench_gate.py``
(drift cancelled, exact ratios under slow drift, the transform hook) run
on each package under their own names (``two_sided.hold``), on scripted
measurements, with the reference's assertions made on each side; the
statistics must be equal.
"""

import time
from types import SimpleNamespace

import pytest

from tests.two_sided import BY_SIDE, hold
from tpu_operator.workloads import timing as ref_timing
from tpu_operator_torch.workloads import timing as port_timing

SIDES = {"reference": SimpleNamespace(name="reference", timing=ref_timing),
         "port": SimpleNamespace(name="port", timing=port_timing)}


def scripted_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


# (iters, clock readings in call order: t(0) pair, t(iters) pair, t(lo) pair)
CLOCKS = [
    (8, [0.0, 0.01, 1.0, 1.81, 2.0, 2.21]),
    (16, [0.0, 0.002, 5.0, 5.5, 9.0, 9.13]),
    # the zero-length run is slower than the full one: sub0 is dropped
    (4, [0.0, 0.9, 1.0, 1.4, 2.0, 2.1]),
    # a single iteration: no two-length delta
    (1, [0.0, 0.1, 1.0, 1.3]),
]


@pytest.mark.parametrize("iters,ticks", CLOCKS)
def test_chain_per_iter_seconds_matches_reference(monkeypatch, iters, ticks):
    steps = []

    def step(v):
        steps.append(v)
        return v + 1

    scripted_clock(monkeypatch, ticks)
    want = ref_timing.chain_per_iter_seconds(step, 0, lambda v: v, iters)
    ref_steps = list(steps)
    steps.clear()
    scripted_clock(monkeypatch, ticks)
    got = port_timing.chain_per_iter_seconds(step, 0, lambda v: v, iters)
    assert got == want
    assert steps == ref_steps


@pytest.mark.parametrize("with_transform", [False, True])
def test_adjacent_ratio_stats_matches_reference(with_transform):
    def scripted(values):
        it = iter(values)
        return lambda fn: fn * next(it)

    values = [1.0, 1.1, 0.9, 1.05, 0.95, 1.2, 1.0, 0.8, 1.3, 1.01] * 4
    cands = {"a": 2.0, "b": 0.5}
    transform = (lambda key, b, c: (b / c) ** 2) if with_transform else None
    want = ref_timing.adjacent_ratio_stats(
        scripted(values), 1.0, cands, reps=5, transform=transform
    )
    got = port_timing.adjacent_ratio_stats(
        scripted(values), 1.0, cands, reps=5, transform=transform
    )
    assert got == want


@BY_SIDE
def test_adjacent_ratio_stats_cancels_drift(side):
    """A candidate a constant 2x faster reads a median above 1, bracketed
    by its quartiles, while the measurement drifts across reps."""

    def script(side):
        drift = {"t": 0}

        def measure(fn):
            drift["t"] += 1
            return fn() * (1.0 + (drift["t"] % 7))  # a wandering card

        stats = side.timing.adjacent_ratio_stats(measure, lambda: 1.0, {"fast": lambda: 0.5}, reps=5)
        med, lo, hi, ratios = stats["fast"]
        assert len(ratios) == 5
        assert lo <= med <= hi
        assert 1.0 < med
        return stats

    hold(SIDES, side, script)


@BY_SIDE
def test_adjacent_ratio_stats_exact_when_drift_is_slow(side):
    def script(side):
        rep_scale = iter([1.0, 1.0, 3.0, 3.0, 10.0, 10.0])
        stats = side.timing.adjacent_ratio_stats(lambda fn: fn() * next(rep_scale), lambda: 1.0,
                                                 {"fast": lambda: 0.25}, reps=3)
        med, lo, hi, ratios = stats["fast"]
        assert ratios == [4.0, 4.0, 4.0]
        assert (med, lo, hi) == (4.0, 4.0, 4.0)
        return stats

    hold(SIDES, side, script)


@BY_SIDE
def test_adjacent_ratio_stats_transform_hook(side):
    def script(side):
        def transform(key, b, c):
            assert key == "k"
            return (b / c) * 0.5  # a per-FLOP normalisation

        stats = side.timing.adjacent_ratio_stats(lambda fn: fn(), lambda: 2.0, {"k": lambda: 1.0}, reps=2,
                                                 transform=transform)
        assert stats["k"][3] == [1.0, 1.0]
        return stats

    hold(SIDES, side, script)
