"""The window's device trace: ``torch.profiler`` over the card, reduced to
intervals.

The profiler records the card's kernels, copies and fills (CUPTI), the
host's operators and runtime calls, and the benchmark's own spans as
annotations, all on one clock. ``Trace`` keeps them as
``(name, start_ns, end_ns)`` and works out the traced window (the first
pass's start to the last pass's end), the seconds in which some operation
ran on the card, the idle gaps, and the breakdown of the result line.
``Reduced`` is what a helper rank of a world (``world.py``) sends back of
its own trace: those sums, without the events.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from functools import cached_property

import torch

BREAKDOWN_ROWS = 10
NAME_CHARS = 120


class DeviceTrace:
    """Starts and stops the profiler around the window."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=activities)

    def start(self) -> None:
        self.prof.start()

    def stop(self, window_span: str, span_names) -> "Trace":
        """The trace of the window; ``span_names`` are the benchmark's spans."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        trace = Trace.from_kineto(self.prof.profiler.kineto_results.events(), window_span,
                                  set(span_names))
        self.prof = None
        return trace


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:NAME_CHARS]


def union(intervals) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def outermost(intervals) -> list:
    """The intervals not nested in an earlier one, sorted by start."""
    top = []
    for item in sorted(intervals, key=lambda x: (x[1], -x[2])):
        if not top or item[1] >= top[-1][2]:
            top.append(item)
    return top


def covering(items, starts, t):
    """The item of sorted, non-overlapping ``items`` (``(name, s, e)``) that
    holds time ``t``, or ``None``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and items[i][1] <= t < items[i][2]:
        return items[i]
    return None


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)  # (name, start_ns, end_ns)
    host_ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)  # the benchmark's annotations
    window_span: str = "pass"

    @classmethod
    def from_kineto(cls, events, window_span: str, span_names) -> "Trace":
        """Sorts the profiler's events: the benchmark's spans (by name, on the
        host; their copies on the card's timeline are left out), the card's
        operations (kernels, copies, fills) and the host's operations."""
        trace = cls(window_span=window_span)
        for e in events:
            name = e.name()
            item = (name, e.start_ns(), e.start_ns() + e.duration_ns())
            on_card = e.device_type() == torch.autograd.DeviceType.CUDA
            if name in span_names:
                if not on_card:
                    trace.spans.append(item)
            elif on_card:
                trace.device_ops.append(item)
            else:
                trace.host_ops.append(item)
        return trace

    @cached_property
    def window(self):
        passes = [(s, e) for name, s, e in self.spans if name == self.window_span]
        if not passes:
            return None
        return min(s for s, _ in passes), max(e for _, e in passes)

    @property
    def window_s(self) -> float:
        w = self.window
        return (w[1] - w[0]) / 1e9 if w else 0.0

    @cached_property
    def busy(self) -> list:
        """The merged intervals in which some operation ran on the card,
        cut to the window."""
        w = self.window
        if not w:
            return []
        cut = [(max(s, w[0]), min(e, w[1])) for _, s, e in self.device_ops
               if e > w[0] and s < w[1]]
        return union(cut)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def gaps(self) -> list:
        """The window's idle ``(start_ns, end_ns)`` stretches."""
        w = self.window
        if not w:
            return []
        out, t = [], w[0]
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if w[1] > t:
            out.append((t, w[1]))
        return out

    def mean_seconds(self, pattern) -> "float | None":
        """Mean seconds of the card's operations whose name ``pattern`` finds."""
        times = [e - s for name, s, e in self.device_ops if pattern.search(name)]
        return sum(times) / len(times) / 1e9 if times else None

    def idle_by_host(self) -> dict:
        """The window's idle nanoseconds by what the host was doing: the
        benchmark span open (a component) and the outermost host operation,
        or ``python`` between operations."""
        spans = outermost([x for x in self.spans if x[0] != self.window_span])
        span_starts = [s for _, s, _ in spans]
        ops = outermost(self.host_ops)
        op_starts = [s for _, s, _ in ops]
        idle = defaultdict(int)
        for s, e in self.gaps():
            t = (s + e) // 2
            span = covering(spans, span_starts, t)
            op = covering(ops, op_starts, t)
            label = f"{span[0] if span else 'between components'}: {op[0] if op else 'python'}"
            idle[label] += e - s
        return idle

    def breakdown(self) -> dict:
        """The card's operations that took the most time, and the window's idle
        time by what the host was doing (``idle_by_host``)."""
        by_op = defaultdict(int)
        for name, s, e in self.device_ops:
            by_op[short_name(name)] += e - s
        return {"device_ops": _top(by_op, 1e9), "idle_gaps": _top(self.idle_by_host(), 1e9)}

    def reduce(self) -> "Reduced":
        """This trace's sums, without its events."""
        ops = defaultdict(lambda: [0, 0])
        for name, s, e in self.device_ops:
            ops[name][0] += 1
            ops[name][1] += e - s
        return Reduced(window_s=self.window_s, busy_s=self.busy_s,
                       ops={name: (n, ns / 1e9) for name, (n, ns) in ops.items()},
                       idle={label: ns / 1e9 for label, ns in self.idle_by_host().items()})


def _top(totals: dict, per_second: float) -> list:
    """The ``BREAKDOWN_ROWS`` largest of ``totals``, as ``[name, seconds]``."""
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
    return [[k, v / per_second] for k, v in ranked]


@dataclass
class Reduced:
    """One card's trace reduced to its sums: the traced window and the
    seconds busy in it (as ``Trace`` has them), each device operation's
    launches and seconds by its full name, and the idle seconds by what the
    host was doing. A helper rank sends this over its pipe."""

    window_s: float
    busy_s: float
    ops: dict  # full name -> (launches, seconds)
    idle: dict  # what the host was doing -> idle seconds

    def mean_seconds(self, pattern) -> "float | None":
        """Mean seconds of the operations whose name ``pattern`` finds."""
        hits = [v for name, v in self.ops.items() if pattern.search(name)]
        launches = sum(n for n, _ in hits)
        return sum(s for _, s in hits) / launches if launches else None

    def breakdown(self) -> dict:
        """As ``Trace.breakdown``."""
        by_op = defaultdict(float)
        for name, (_, seconds) in self.ops.items():
            by_op[short_name(name)] += seconds
        return {"device_ops": _top(by_op, 1), "idle_gaps": _top(self.idle, 1)}
