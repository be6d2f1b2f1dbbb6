"""Flight recorder: bounded rings of recent structured events + spans,
dumped on failure triggers for post-mortem causal timelines.

The port's copy of ``tpu_operator/obs/flight.py``, whole; the dump
directory is ``GPU_OPERATOR_FLIGHT_DIR`` and the rate limit
``GPU_OPERATOR_FLIGHT_MIN_INTERVAL_S``.

The event ring is ALWAYS on (an append to a bounded deque — there is
nothing to enable), fed by the low-rate diagnostic writes the system
already makes: per-pass label fan-outs, disruption-budget admissions
and releases, circuit-breaker trips, watch re-lists, remediation /
repartition FSM transitions, chaos injections, invariant violations.
The span ring fills only while tracing (``obs/trace.py``) is enabled.

``dump(reason)`` freezes both rings into a timestamped JSON file under
``GPU_OPERATOR_FLIGHT_DIR`` (default: ``<tmp>/gpu-operator-flight``)
and notifies the optional ``event_sink`` (the reconciler wires a
warning Event through it). Dumps are rate-limited per reason
(``GPU_OPERATOR_FLIGHT_MIN_INTERVAL_S``, default 30 s) so a flapping
trigger cannot turn the recorder into a disk-filling loop.

In the reference, the stall watchdog, a state going Degraded and the
chaos soak's invariant checker trigger dumps; in the port those callers
are control-plane steps still to come, and the breaker trip and the watch
re-list record events.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("gpu-operator.flight")

DEFAULT_EVENT_CAPACITY = 4096
DEFAULT_SPAN_CAPACITY = 2048


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    def __init__(
        self,
        event_capacity: int = DEFAULT_EVENT_CAPACITY,
        span_capacity: int = DEFAULT_SPAN_CAPACITY,
    ):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(16, event_capacity))
        self._spans: deque = deque(maxlen=max(16, span_capacity))
        self.events_total = 0
        self.dumps_total = 0
        self.dump_errors = 0
        self.last_dump_path: Optional[str] = None
        # recent dump paths (bounded): the soak report lists them
        self.dump_paths: deque = deque(maxlen=32)
        self._last_dump_by_reason: Dict[str, float] = {}
        self.min_interval_s = _env_float(
            "GPU_OPERATOR_FLIGHT_MIN_INTERVAL_S", 30.0
        )
        self.dir = os.environ.get("GPU_OPERATOR_FLIGHT_DIR") or os.path.join(
            tempfile.gettempdir(), "gpu-operator-flight"
        )
        # optional notifier called as (reason, detail, path) after a
        # dump lands — the reconciler posts a warning Event through it;
        # a broken sink must never break the dump itself
        self.event_sink: Optional[Callable[[str, str, str], None]] = None

    # ------------------------------------------------------------------
    def record(self, kind: str, /, **fields: Any) -> None:
        """Append one structured event. Cheap enough for every budget
        admission / FSM transition / breaker trip; NOT meant for
        per-request traffic (that is the span ring's job). The event
        kind is positional-only and always wins over a same-named
        field — a caller cannot corrupt the taxonomy."""
        rec = dict(fields)
        rec["t"] = round(time.time(), 3)
        rec["kind"] = kind
        with self._lock:
            self._events.append(rec)
            self.events_total += 1

    def add_span(self, span_rec: Dict[str, Any]) -> None:
        """Sink for the tracer's completed spans (obs/trace.py)."""
        with self._lock:
            self._spans.append(span_rec)

    def snapshot(self) -> Dict[str, List[Dict[str, Any]]]:
        with self._lock:
            return {
                "events": list(self._events),
                "spans": list(self._spans),
            }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._spans.clear()
            self._last_dump_by_reason.clear()

    # ------------------------------------------------------------------
    def dump(
        self,
        reason: str,
        detail: str = "",
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Freeze the rings to a timestamped JSON file. Returns the
        path, or None when rate-limited / failed. Never raises: the
        recorder fires from failure paths that must stay on their feet."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_by_reason.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_dump_by_reason[reason] = now
        try:
            os.makedirs(self.dir, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            safe = "".join(
                ch if ch.isalnum() or ch in "-_." else "-" for ch in reason
            )[:80]
            path = os.path.join(
                self.dir, f"flight-{stamp}-{safe}-{os.getpid()}.json"
            )
            payload = {
                "reason": reason,
                "detail": detail,
                "ts": time.time(),
                "pid": os.getpid(),
            }
            if extra:
                payload["extra"] = extra
            payload.update(self.snapshot())
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except Exception:
            with self._lock:
                self.dump_errors += 1
            log.exception("flight-recorder dump failed (%s)", reason)
            return None
        with self._lock:
            self.dumps_total += 1
            self.last_dump_path = path
            self.dump_paths.append(path)
        log.warning(
            "flight recorder dumped (%s%s): %s",
            reason,
            f" — {detail}" if detail else "",
            path,
        )
        sink = self.event_sink
        if sink is not None:
            try:
                sink(reason, detail, path)
            except Exception:
                log.debug("flight dump event sink failed", exc_info=True)
        return path

    # ------------------------------------------------------------------
    def dump_paths_snapshot(self) -> List[str]:
        """Locked copy of the recent dump paths — callers must never
        iterate the live ring while dump() may append from another
        thread (deque iteration raises on concurrent mutation)."""
        with self._lock:
            return list(self.dump_paths)

    def stats(self) -> Dict[str, Any]:
        """/debug/vars "flight" payload."""
        with self._lock:
            return {
                "events_buffered": len(self._events),
                "spans_buffered": len(self._spans),
                "events_total": self.events_total,
                "dumps_total": self.dumps_total,
                "dump_errors": self.dump_errors,
                "last_dump_path": self.last_dump_path,
                "dir": self.dir,
                "min_interval_s": self.min_interval_s,
            }


RECORDER = FlightRecorder()


def record(kind: str, /, **fields: Any) -> None:
    RECORDER.record(kind, **fields)


def dump(reason: str, detail: str = "", extra=None) -> Optional[str]:
    return RECORDER.dump(reason, detail, extra)


# completed spans flow into the post-mortem ring
from tpu_operator_torch.obs import trace as _trace  # noqa: E402

_trace.span_sink = RECORDER.add_span
