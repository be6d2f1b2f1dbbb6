"""The port's timing helpers give the JAX package's answers on a scripted
clock and scripted steps (exact equality: same arithmetic, same order)."""

import time

import pytest

from tpu_operator.workloads import timing as ref_timing
from tpu_operator_torch.workloads import timing as port_timing


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
