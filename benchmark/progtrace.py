"""The program's own spans in the traced window, on the device trace's clock.

The port's validator path records its spans through its tracer
(``tpu_operator_torch.obs.trace``) while a torch profiler records, so a
``--trace 1`` run has them with no annotation on the card's timeline. Their
clock is ``time.monotonic_ns``, the clock of ``time.perf_counter`` and so of
the benchmark's host spans (``run.spans``); the profiler keeps its own. The
benchmark's ``pass`` spans are on both, so the median of their start
offsets maps one clock onto the other.

Every function returns ``None`` where it cannot answer: the program has no
public read of its tracer (a program without these spans), no record
starts inside the window, the ring dropped records that may lie in it, or,
for the clock, the ``pass`` spans do not match one to one or their offsets
stray more than ``RESIDUAL_NS`` from the median. The residual leaves out
the first pass and takes the ``RESIDUAL_QUANTILE`` of the rest: on the H100
nine passes in ten start within 8 us of the median, and about one in 500
reads 100-150 us late on the host, a delay between the annotation's start
and the host clock's read, not a clock that drifts; the median is not moved
by it, so one such pass does not unmatch the window.
"""

from __future__ import annotations

import statistics
import threading
from collections import defaultdict

RESIDUAL_NS = 200_000
RESIDUAL_QUANTILE = 0.99
PASS_SPAN = "pass"
NO_SPAN = None  # the key of idle time under no program span


def snapshot():
    """The program tracer's ``Snapshot`` (``base_ns``, ``records``,
    ``dropped``), or ``None`` where the program has no such read."""
    from tpu_operator_torch.obs import trace

    read = getattr(trace.TRACER, "snapshot", None)
    return read() if read is not None else None


def host_passes(run) -> list:
    """The window's ``pass`` spans on the host clock, as ``(start_ns, end_ns)``."""
    return [(round(s * 1e9), round(e * 1e9)) for name, s, e in run.spans if name == PASS_SPAN]


def records(run):
    """The program's spans that start inside the window, on the host's
    monotonic clock, as ``(name, start_ns, end_ns)`` in start order; only
    those of this thread, the one that ran the window."""
    passes = host_passes(run)
    snap = snapshot()
    if not passes or snap is None:
        return None
    lo, hi = min(s for s, _ in passes), max(e for _, e in passes)
    # the ring lets go of the oldest finished first: where it dropped any,
    # they may lie in the window unless its oldest kept record ended first
    if snap.dropped:
        oldest = snap.records[0] if snap.records else None
        if oldest is None or snap.base_ns + 1000 * (oldest["ts"] + oldest.get("dur", 0)) > lo:
            return None
    tid = threading.get_ident() & 0xFFFF
    out = []
    for r in snap.records:
        start = snap.base_ns + 1000 * r["ts"]
        if r["ph"] == "X" and r["tid"] == tid and lo <= start < hi:
            out.append((r["name"], start, start + 1000 * r["dur"]))
    out.sort(key=lambda x: (x[1], -x[2]))
    return out or None


def clock_offset(run):
    """``(offset_ns, residual_ns)``: what to add to a host time to put it on
    the profiler's clock, the median over the matched ``pass`` spans, and the
    ``RESIDUAL_QUANTILE`` of the passes' distances from it, the first pass
    left out (with two or three passes, the largest)."""
    if run.trace is None:
        return None
    host = host_passes(run)
    traced = sorted((s, e) for name, s, e in run.trace.spans if name == PASS_SPAN)
    if not host or len(host) != len(traced):
        return None
    offsets = [t[0] - h[0] for h, t in zip(host, traced)]
    offset = statistics.median_low(offsets)
    far = sorted(abs(o - offset) for o in offsets[1:])
    residual = far[min(len(far) - 1, int(RESIDUAL_QUANTILE * len(far)))] if far else 0
    return (offset, residual) if residual <= RESIDUAL_NS else None


def innermost(spans) -> list:
    """Non-overlapping ``(start, end, name)`` pieces of nested ``spans``
    (``(name, start, end)`` in start order), each named by the innermost
    span that covers it; a child is cut to its parent's end."""
    pieces, stack, t = [], [], 0

    def close_to(limit):
        nonlocal t
        while stack and stack[-1][1] <= limit:
            name, end = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for name, s, e in spans:
        close_to(s)
        if stack:
            if s > t:
                pieces.append((t, s, stack[-1][0]))
            e = min(e, stack[-1][1])
        stack.append((name, e))
        t = s
    close_to(float("inf"))
    return pieces


def idle_by_span(run):
    """The window's idle nanoseconds on the card by the innermost program
    span open at the time (``NO_SPAN`` where none was), the time of a gap
    split where the spans split it; ``None`` where the clocks cannot be
    matched or nothing ran on the card."""
    if run.trace is None or not run.trace.device_ops:
        return None
    spans, clock = records(run), clock_offset(run)
    if spans is None or clock is None:
        return None
    offset = clock[0]
    pieces = innermost([(name, s + offset, e + offset) for name, s, e in spans])
    idle = defaultdict(int)
    i = 0
    for gs, ge in run.trace.gaps():
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        covered, j = 0, i
        while j < len(pieces) and pieces[j][0] < ge:
            cut = min(ge, pieces[j][1]) - max(gs, pieces[j][0])
            if cut > 0:
                idle[pieces[j][2]] += cut
                covered += cut
            j += 1
        idle[NO_SPAN] += ge - gs - covered
    return dict(idle)


def idle_by_layer(run):
    """``idle_by_span`` summed by the spans' layers (the name before its
    first ``.``); ``NO_SPAN`` as there."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    out = defaultdict(int)
    for name, ns in idle.items():
        out[name if name is NO_SPAN else name.split(".", 1)[0]] += ns
    return dict(out)


def idle_ms_a_pass(run, layer: str):
    """Idle milliseconds a pass on the card whose innermost program span is
    of ``layer``."""
    idle = idle_by_layer(run)
    if idle is None:
        return None
    return idle.get(layer, 0) / 1e6 / run.counters["passes"]


def span_ms_a_pass(run, name: str):
    """Summed milliseconds of the program's ``name`` spans a pass."""
    spans = records(run)
    times = [e - s for n, s, e in spans or () if n == name]
    return sum(times) / 1e6 / run.counters["passes"] if times else None
