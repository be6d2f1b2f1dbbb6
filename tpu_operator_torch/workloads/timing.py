"""Fixed-overhead-cancelling throughput timing, shared by the validation
workloads (``matmul.py``, ``membw.py``, ``flashattn.py``).

The same estimators as the JAX package's ``workloads/timing.py``. A CUDA
launch returns before the card finishes, so the caller's ``force`` must
wait for the device (``torch.cuda.synchronize()``) before its scalar fetch.
Three per-iteration estimators are combined:

* the plain mean ``t(iters)/iters`` — includes the overhead, biased high;
* the zero-length-subtracted mean ``(t(iters) - t(0))/iters`` — the
  overhead measured directly;
* the two-length delta ``(t(iters) - t(lo))/(iters - lo)`` — every cost
  that does not scale with iterations cancelled algebraically.

The median of the three is robust to any single measurement being polluted
by host jitter, and cannot exceed the plain mean by more than the honest
overhead correction.

``span`` opens the probe layer's spans (``obs/trace.py``): the validator's
components, the probes' phases and each timed round here. They record
while the tracer is enabled or a torch profiler is recording; with both
off a span is one attribute load, one module-attribute read and a branch.
They are never profiler annotations, which the profiler would put on the
card's timeline beside the kernels.
"""

from __future__ import annotations

import time
from typing import Callable

from torch.autograd import profiler as _autograd_profiler

from tpu_operator_torch.obs import trace

TRACER = trace.TRACER


def span(_span_name: str, **attrs):
    """A span of the validator's card path (a context manager): recorded
    while the tracer is enabled or a torch profiler is recording, else the
    tracer's shared no-op handle."""
    if TRACER.enabled or _autograd_profiler._is_profiler_enabled:
        return TRACER.span(_span_name, **attrs)
    return trace.NOOP


def chain_per_iter_seconds(step: Callable, x, force: Callable, iters: int) -> float:
    """Seconds per iteration of the serial chain ``v = step(v)``, fixed
    overhead (launch + completion fetch) cancelled.

    ``step`` must make each launch depend on the previous one (so device
    work can't overlap across iterations) and ``force`` must block until
    ``v`` is fully materialized (synchronize, then a scalar fetch).
    """

    def timed(n: int) -> float:
        with span("timing.round", n=n):
            t0 = time.perf_counter()
            v = x
            for _ in range(n):
                v = step(v)
            force(v)
            return time.perf_counter() - t0

    with span("timing.round", n=1, warm=True):
        force(step(x))  # warmup (kernel build/autotune + first execution)
    t_zero = timed(0)  # pure sync/fetch round-trip
    t_full = timed(iters)
    candidates = [t_full / iters]
    sub0 = (t_full - t_zero) / iters
    if sub0 > 0:
        candidates.append(sub0)
    lo = max(1, iters // 4)
    if iters > lo:
        t_lo = timed(lo)
        delta = (t_full - t_lo) / (iters - lo)
        if delta > 0:
            candidates.append(delta)
    candidates.sort()
    # lower-middle on even counts: with [plain, sub0] the overhead-corrected
    # estimate must win, not the overhead-inclusive plain mean
    return candidates[(len(candidates) - 1) // 2]


def adjacent_ratio_stats(
    measure: Callable,
    base,
    cands: dict,
    reps: int = 9,
    transform: Callable = None,
):
    """Drift-cancelled A/B comparison on a card whose clocks and neighbours
    wander: each rep times every candidate ADJACENT to a fresh base
    measurement and records ``base/candidate`` (>1 means the candidate
    is faster) — slow drift multiplies both sides of a rep equally, so
    the ratio isolates the kernel difference the raw numbers bury.
    Returns ``{key: (median, iqr_lo, iqr_hi, ratios)}``.

    ``measure(fn) -> seconds`` is supplied by the caller (typically a
    ``chain_per_iter_seconds`` closure). ``transform(key, base_s,
    cand_s) -> ratio`` overrides the plain wall ratio.
    """
    import statistics

    ratios = {k: [] for k in cands}
    for _ in range(reps):
        for k_, fn in cands.items():
            b = measure(base)
            c = measure(fn)
            ratios[k_].append(
                transform(k_, b, c) if transform is not None else b / c
            )
    out = {}
    for k_, rs in ratios.items():
        rs = sorted(rs)
        out[k_] = (
            statistics.median(rs),
            rs[len(rs) // 4],
            rs[-1 - len(rs) // 4],
            rs,
        )
    return out


def event_ms(fn: Callable, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls on the current CUDA device, from CUDA events, after ``warmup``
    calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
