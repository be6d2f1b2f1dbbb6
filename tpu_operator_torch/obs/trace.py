"""Low-overhead reconcile tracing.

The port's copy of ``tpu_operator/obs/trace.py``, whole: ``kube/rest.py``
opens a ``rest.request`` span a call and ``kube/retry.py`` records breaker
trips in the flight recorder (``obs/flight.py``).

A span is ``(name, attrs, start/end monotonic ns, span id, parent id,
thread)``. Context propagation is a thread-local stack: a span opened
while another is live on the same thread becomes its child, and the
parent accumulates the child's wall time so the exporter can report
SELF time per layer (the layer is the span name's prefix before the
first ``.`` — ``pass.reconcile`` → layer ``pass``).

Cost model (the 50 ms steady-pass bench gate rides on this):

* **disabled** (the default): ``span()`` is one attribute load, one
  branch and the return of a shared no-op handle — no allocation, no
  lock, no clock read;
* **enabled**: two ``monotonic_ns`` reads, one small dict, one
  lock-guarded ring append per span. Spans are placed at pass/state/
  request granularity, never per node, so a steady 1000-node pass
  carries ~30 spans (~60 µs).

Export is Chrome trace-event JSON (``{"traceEvents": [...]}``), loadable
in Perfetto / ``chrome://tracing``. Completed spans also feed the flight
recorder's span ring (``obs/flight.py``) so a post-mortem dump carries
the recent causal timeline.

The validator's card probes open their spans through
``workloads/timing.py::span``, which also records while a torch profiler
runs (``Tracer.span``); a reader takes the buffered records with their
time base from ``Tracer.snapshot``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

_TL = threading.local()

# installed by obs/flight.py at import: every finished span record is
# offered to the flight recorder's bounded span ring
span_sink: Optional[Callable[[Dict[str, Any]], None]] = None


def _stack() -> List["_SpanHandle"]:
    st = getattr(_TL, "stack", None)
    if st is None:
        st = _TL.stack = []
    return st


class _NoopSpan:
    """Shared disabled-mode handle: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value: Any) -> None:
        pass


_NOOP = _NoopSpan()
NOOP = _NOOP  # public alias for callers threading a handle through


class _SpanHandle:
    __slots__ = (
        "tracer",
        "name",
        "attrs",
        "t0_ns",
        "span_id",
        "parent_id",
        "child_ns",
    )

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.child_ns = 0

    def set(self, key: str, value: Any) -> None:
        """Attach an attribute discovered mid-span (e.g. retry count)."""
        self.attrs[key] = value

    def __enter__(self):
        stack = _stack()
        self.parent_id = stack[-1].span_id if stack else 0
        self.span_id = self.tracer._next_id()
        stack.append(self)
        self.t0_ns = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.monotonic_ns()
        stack = _stack()
        # tolerate a foreign pop (a handle leaked across threads/generators)
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        dur = t1 - self.t0_ns
        if stack:
            stack[-1].child_ns += dur
        self.tracer._finish(self, t1, dur)
        return False


class Snapshot(NamedTuple):
    """The tracer's buffered records, oldest finished first. A record's
    start is ``base_ns + ts * 1000`` on ``time.monotonic_ns``'s clock
    (``ts`` and ``dur`` are whole microseconds); ``dropped`` counts the
    records the full ring let go since the last reset, the oldest finished
    first."""

    base_ns: int
    records: List[Dict[str, Any]]
    dropped: int


class Tracer:
    """Process-global span collector. ``enabled`` is the ONE branch the
    disabled fast path pays."""

    def __init__(self, capacity: Optional[int] = None):
        self.enabled = False
        if capacity is None:
            try:
                capacity = int(os.environ.get("TRACE_BUFFER_SPANS", "20000"))
            except ValueError:
                capacity = 20000
        self.capacity = max(64, capacity)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._id = 0
        # monotonic base for trace-file timestamps (set on enable so a
        # long-lived process's export starts near zero)
        self._base_ns = time.monotonic_ns()
        self.spans_total = 0
        # cumulative per-layer accumulators: layer -> [count, total_ns,
        # self_ns]; mark_pass() diffs these into the last-pass summary
        self._layers: Dict[str, List[int]] = {}
        self._pass_mark: Dict[str, List[int]] = {}
        self.last_pass: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------
    def enable(self) -> None:
        with self._lock:
            # re-base only while the buffer is empty: spans surviving a
            # disable/enable cycle (fleet_converge's overhead rounds)
            # must keep one common timebase or the export time-warps
            if not self._spans:
                self._base_ns = time.monotonic_ns()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._base_ns = time.monotonic_ns()
            self._spans.clear()
            self._layers = {}
            self._pass_mark = {}
            self.last_pass = {}
            self.spans_total = 0

    def span(self, _span_name: str, **attrs: Any) -> _SpanHandle:
        """Open a span on this tracer whether or not it is enabled, for a
        caller with a reason of its own to record."""
        return _SpanHandle(self, _span_name, attrs)

    def snapshot(self) -> Snapshot:
        """The buffered records with their time base (``Snapshot``)."""
        with self._lock:
            records = list(self._spans)
            return Snapshot(self._base_ns, records, self.spans_total - len(records))

    def _next_id(self) -> int:
        # races only produce duplicate display ids, never corruption; a
        # lock here would put contention on every span open
        self._id += 1
        return self._id

    def _finish(self, handle: _SpanHandle, t1_ns: int, dur_ns: int) -> None:
        layer = handle.name.split(".", 1)[0]
        rec = {
            "name": handle.name,
            "cat": layer,
            "ph": "X",
            "ts": (handle.t0_ns - self._base_ns) // 1000,
            "dur": max(0, dur_ns // 1000),
            "pid": 1,
            "tid": threading.get_ident() & 0xFFFF,
            "id": handle.span_id,
            "args": handle.attrs,
        }
        if handle.parent_id:
            rec["args"]["parent"] = handle.parent_id
        self_ns = max(0, dur_ns - handle.child_ns)
        with self._lock:
            self._spans.append(rec)
            self.spans_total += 1
            acc = self._layers.get(layer)
            if acc is None:
                acc = self._layers[layer] = [0, 0, 0]
            acc[0] += 1
            acc[1] += dur_ns
            acc[2] += self_ns
        sink = span_sink
        if sink is not None:
            try:
                sink(rec)
            except Exception:
                pass

    def _instant(self, name: str, attrs: Dict[str, Any]) -> None:
        rec = {
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "i",
            "s": "t",
            "ts": (time.monotonic_ns() - self._base_ns) // 1000,
            "pid": 1,
            "tid": threading.get_ident() & 0xFFFF,
            "args": attrs,
        }
        with self._lock:
            self._spans.append(rec)
            self.spans_total += 1

    # ------------------------------------------------------------------
    def mark_pass(self) -> Dict[str, Dict[str, float]]:
        """Seal a reconcile pass: the per-layer (count, total, self-time)
        delta since the previous mark becomes ``last_pass`` — the
        summary /debug/vars "trace" and ``fleet_converge`` report."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for layer, acc in self._layers.items():
                prev = self._pass_mark.get(layer, (0, 0, 0))
                count = acc[0] - prev[0]
                if count <= 0:
                    continue
                out[layer] = {
                    "spans": count,
                    "total_ms": round((acc[1] - prev[1]) / 1e6, 3),
                    "self_ms": round((acc[2] - prev[2]) / 1e6, 3),
                }
            self._pass_mark = {k: list(v) for k, v in self._layers.items()}
            self.last_pass = out
            return out

    def stats(self) -> Dict[str, Any]:
        """/debug/vars "trace" payload."""
        with self._lock:
            layers = {
                layer: {
                    "spans": acc[0],
                    "total_ms": round(acc[1] / 1e6, 3),
                    "self_ms": round(acc[2] / 1e6, 3),
                }
                for layer, acc in sorted(self._layers.items())
            }
            return {
                "enabled": self.enabled,
                "spans_total": self.spans_total,
                "buffered": len(self._spans),
                "capacity": self.capacity,
                "last_pass": dict(self.last_pass),
                "layers": layers,
            }

    # ------------------------------------------------------------------
    def export_chrome(self, path: str) -> int:
        """Write the buffered spans as Chrome trace-event JSON (one
        object with a ``traceEvents`` array — the format Perfetto and
        chrome://tracing load directly). Returns the span count."""
        with self._lock:
            events = list(self._spans)
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "gpu-operator obs/trace.py"},
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return len(events)


TRACER = Tracer()


def span(_span_name: str, **attrs: Any):
    """Open a span (context manager). Disabled tracing returns the
    shared no-op handle: one branch, zero allocation beyond the
    caller's kwargs. The positional parameter is underscored so
    ``name=``/``kind=`` stay usable as attribute keys."""
    t = TRACER
    if not t.enabled:
        return _NOOP
    return _SpanHandle(t, _span_name, attrs)


def instant(_span_name: str, **attrs: Any) -> None:
    """Record a zero-duration marker (Chrome instant event)."""
    t = TRACER
    if not t.enabled:
        return
    t._instant(_span_name, attrs)


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()
