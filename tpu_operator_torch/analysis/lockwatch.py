"""Runtime lock-order watchdog — the dynamic half of the analyzer.

The static ``lock-order`` rule only sees acquisitions that nest
TEXTUALLY; the real system nests across call boundaries (a controller
method holding its own lock calls into the write pipeline, which takes
its lock, which calls a batch lane's flush...). This module watches the
real thing: while enabled, ``threading.Lock``/``RLock`` construction is
wrapped so every acquisition records into a per-thread held set, every
"acquire B while holding A" adds an ``A → B`` edge to a process-wide
acquisition-order graph keyed by lock CREATION SITE, and a cycle in
that graph — two threads that ever acquired the same pair of lock
sites in opposite orders — is a potential deadlock even if this run
never interleaved into one.

Also recorded: **held-across-blocking** events — ``time.sleep``,
``WriteFuture.result()`` and ``WritePipeline.drain()`` entered while
any watched lock is held (the runtime twin of the static
``lock-blocking`` rule).

Violations flight-record through ``obs/flight.py`` (``lockwatch.cycle``
/ ``lockwatch.blocking`` events; a cycle also triggers a post-mortem
dump), so a chaos soak that trips the watchdog leaves a causal
timeline next to the invariant dumps.

Usage (the port's chaos suites run under it with ``GPU_LOCKWATCH=1``,
the bad-version soak always; ``watching()`` reads the variables)::

    from tpu_operator_torch.analysis import lockwatch
    lockwatch.enable()
    ...  # run the system under load
    assert lockwatch.cycles() == []
    lockwatch.disable()

Only locks CREATED while enabled are watched — enable before building
the controllers under test. Edges between two instances of the same
creation site are ignored (a site cannot order against itself without
instance identity, and Python would already deadlock on a true
re-acquire). Overhead is one dict touch per acquire; fine for tests,
not meant for production.

The port's copy of ``tpu_operator/analysis/lockwatch.py``. Its names are
the reference's (``enable``, ``disable``, ``enabled``, ``cycles``,
``violations``, ``stats``, the ``lockwatch.*`` flight events); the
variables are the card's, ``GPU_LOCKWATCH`` and ``GPU_LOCKWATCH_STRICT``
(``watching``, the reference's session fixture as a context manager,
since the port's tests cannot add one to ``tests/conftest.py``). No
fallback hides a failure: the port's write pipeline is always there, so
it is imported plainly and a failed patch fails ``enable()``. ``disable()``
puts back exactly what ``enable()`` found — ``threading.Lock``,
``threading.RLock``, ``time.sleep``, ``WriteFuture.result`` and
``WritePipeline.drain`` — so the reference's watchdog and this one,
which patch the same process-wide globals, can be enabled in turn (or
nested) in one process. The bookkeeping lock comes from ``_thread``,
never from a factory another watchdog may have patched.
"""

from __future__ import annotations

import _thread
import os
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from tpu_operator_torch.kube import write_pipeline as wp
from tpu_operator_torch.obs import flight

# the real factories, whoever patched ``threading`` before this import:
# the watch's own bookkeeping lock must never be a watched lock
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock

ENV = "GPU_LOCKWATCH"
STRICT_ENV = "GPU_LOCKWATCH_STRICT"

_MAX_VIOLATIONS = 256


_SKIP_BASENAMES = ("lockwatch.py", "threading.py")


def _caller_site() -> str:
    """file:line of the nearest frame outside this module and
    threading.py, shortened to the last two path components. Exact
    basename matching: a file merely NAMED like us (test_lockwatch.py)
    must still resolve to its own sites."""
    import sys

    frame = sys._getframe(1)
    while frame is not None:
        fname = frame.f_code.co_filename
        if os.path.basename(fname) not in _SKIP_BASENAMES:
            parts = fname.replace(os.sep, "/").split("/")
            return f"{'/'.join(parts[-2:])}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


class _WatchedLock:
    """Delegating wrapper around a real lock. Supports ``with``,
    explicit acquire/release, ``threading.Condition`` construction, and
    anything else via ``__getattr__`` delegation."""

    __slots__ = ("_real", "site", "_watch")

    def __init__(self, real: Any, site: str, watch: "LockWatch"):
        self._real = real
        self.site = site
        self._watch = watch

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._watch._on_acquire(self)
        return ok

    def release(self) -> None:
        self._watch._on_release(self)
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _at_fork_reinit(self):  # threading internals call this on fork
        return self._real._at_fork_reinit()

    def __getattr__(self, name: str):
        return getattr(self._real, name)

    def __repr__(self):
        return f"<watched {self._real!r} from {self.site}>"


class _WatchedRLock(_WatchedLock):
    """RLock wrapper. ``threading.Condition`` probes ``_release_save``/
    ``_acquire_restore``/``_is_owned`` — defining them here (with
    bookkeeping) keeps the held-set consistent across ``cond.wait()``
    on an RLock-backed condition; the plain-Lock wrapper deliberately
    does NOT define them so Condition falls back to acquire/release,
    which are instrumented anyway."""

    __slots__ = ()

    def _release_save(self):
        self._watch._on_release_all(self)
        return self._real._release_save()

    def _acquire_restore(self, state):
        self._real._acquire_restore(state)
        # state is (count, owner); restore the recursion count
        count = state[0] if isinstance(state, tuple) else 1
        self._watch._on_acquire(self, count=count)

    def _is_owned(self):
        return self._real._is_owned()


class LockWatch:
    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        self._enabled = False
        # (site_a, site_b) -> witness dict (first observation wins)
        self._edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._violations: List[Dict[str, Any]] = []
        self._cycles_seen: set = set()
        self.locks_created = 0
        self.acquires = 0
        self.blocking_events = 0
        self._saved: Dict[str, Any] = {}

    # -- held-set bookkeeping (per thread) ------------------------------
    def _held(self) -> List[List[Any]]:
        """This thread's held list: [[lock, count], ...] in acquisition
        order."""
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _on_acquire(self, lock: _WatchedLock, count: int = 1) -> None:
        if not self._enabled:
            return
        self.acquires += 1
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[1] += count  # reentrant (RLock)
                return
        new_edges = []
        for entry in held:
            a = entry[0].site
            if a != lock.site and (a, lock.site) not in self._edges:
                new_edges.append((a, lock.site))
        held.append([lock, count])
        if new_edges:
            self._add_edges(new_edges)

    def _on_release(self, lock: _WatchedLock) -> None:
        held = getattr(self._tls, "held", None)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][1] -= 1
                if held[i][1] <= 0:
                    del held[i]
                return
        # released by a thread that never acquired it (legal for plain
        # locks used as signals); nothing to unwind

    def _on_release_all(self, lock: _WatchedLock) -> None:
        """Full release regardless of recursion count (Condition.wait
        on an RLock)."""
        held = getattr(self._tls, "held", None)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    # -- graph ----------------------------------------------------------
    def _add_edges(self, new_edges: List[Tuple[str, str]]) -> None:
        caller = _caller_site()
        thread = threading.current_thread().name
        found_cycles = []
        with self._mu:
            for a, b in new_edges:
                if (a, b) in self._edges:
                    continue
                self._edges[(a, b)] = {"thread": thread, "at": caller}
                cycle = self._path_locked(b, a)
                if cycle is not None:
                    found_cycles.append([a] + cycle)
        for cyc in found_cycles:
            self._record_cycle(cyc)

    def _path_locked(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src → dst over current edges (caller holds _mu)."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self._edges:
            adj.setdefault(a, []).append(b)
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in sorted(adj.get(node, ())):
                stack.append((nxt, path + [nxt]))
        return None

    def _record_cycle(self, cycle: List[str]) -> None:
        key = tuple(sorted(set(cycle)))
        with self._mu:
            if key in self._cycles_seen:
                return
            self._cycles_seen.add(key)
            edges = {
                f"{a}->{b}": w
                for (a, b), w in self._edges.items()
                if a in key and b in key
            }
            violation = {
                "type": "lock-order-cycle",
                "cycle": cycle,
                "edges": edges,
                "thread": threading.current_thread().name,
            }
            if len(self._violations) < _MAX_VIOLATIONS:
                self._violations.append(violation)
        flight.record(
            "lockwatch.cycle",
            cycle=" -> ".join(cycle),
            thread=violation["thread"],
        )
        flight.dump(
            "lockwatch-cycle",
            detail=" -> ".join(cycle),
            extra={"edges": edges},
        )

    # -- blocking -------------------------------------------------------
    def _note_blocking(self, what: str) -> None:
        held = getattr(self._tls, "held", None)
        if not held:
            return
        self.blocking_events += 1
        sites = [entry[0].site for entry in held]
        caller = _caller_site()
        violation = {
            "type": "held-across-blocking",
            "call": what,
            "locks": sites,
            "at": caller,
            "thread": threading.current_thread().name,
        }
        with self._mu:
            if len(self._violations) < _MAX_VIOLATIONS:
                self._violations.append(violation)
        flight.record(
            "lockwatch.blocking", call=what, locks=sites, at=caller
        )

    # -- enable/disable -------------------------------------------------
    def enable(self) -> None:
        with self._mu:
            if self._enabled:
                return
            self._enabled = True

        watch = self

        def make_lock():
            watch.locks_created += 1
            return _WatchedLock(_REAL_LOCK(), _caller_site(), watch)

        def make_rlock():
            watch.locks_created += 1
            return _WatchedRLock(_REAL_RLOCK(), _caller_site(), watch)

        self._saved = {"Lock": threading.Lock, "RLock": threading.RLock}
        threading.Lock = make_lock
        threading.RLock = make_rlock

        real_sleep = time.sleep
        self._saved["sleep"] = real_sleep

        def watched_sleep(seconds):
            watch._note_blocking(f"time.sleep({seconds})")
            return real_sleep(seconds)

        time.sleep = watched_sleep

        # the write pipeline's two blocking surfaces; the class
        # attributes are saved as they are found (a function, or another
        # watchdog's wrapper), so disable() puts back exactly that
        real_result = wp.WriteFuture.__dict__["result"]
        real_drain = wp.WritePipeline.__dict__["drain"]
        self._saved["result"] = real_result
        self._saved["drain"] = real_drain

        def watched_result(fut, timeout=None):
            watch._note_blocking("WriteFuture.result()")
            return real_result(fut, timeout)

        def watched_drain(pipe, timeout=None, raise_errors=False):
            watch._note_blocking("WritePipeline.drain()")
            return real_drain(pipe, timeout, raise_errors)

        wp.WriteFuture.result = watched_result
        wp.WritePipeline.drain = watched_drain

    def disable(self) -> None:
        with self._mu:
            if not self._enabled:
                return
            self._enabled = False
        threading.Lock = self._saved.pop("Lock")
        threading.RLock = self._saved.pop("RLock")
        time.sleep = self._saved.pop("sleep")
        wp.WriteFuture.result = self._saved.pop("result")
        wp.WritePipeline.drain = self._saved.pop("drain")

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- reporting ------------------------------------------------------
    def cycles(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [
                v for v in self._violations if v["type"] == "lock-order-cycle"
            ]

    def violations(self) -> List[Dict[str, Any]]:
        with self._mu:
            return list(self._violations)

    def edges(self) -> Dict[str, Dict[str, Any]]:
        with self._mu:
            return {f"{a}->{b}": dict(w) for (a, b), w in self._edges.items()}

    def reset(self) -> None:
        """Clear the graph + violations (keep patching state)."""
        with self._mu:
            self._edges.clear()
            self._violations.clear()
            self._cycles_seen.clear()
            self.acquires = 0
            self.blocking_events = 0

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "enabled": self._enabled,
                "locks_created": self.locks_created,
                "acquires": self.acquires,
                "edges": len(self._edges),
                "cycles": sum(
                    1
                    for v in self._violations
                    if v["type"] == "lock-order-cycle"
                ),
                "blocking_events": self.blocking_events,
            }


WATCH = LockWatch()


def enable() -> None:
    WATCH.enable()


def disable() -> None:
    WATCH.disable()


def enabled() -> bool:
    return WATCH.enabled


def cycles() -> List[Dict[str, Any]]:
    return WATCH.cycles()


def violations() -> List[Dict[str, Any]]:
    return WATCH.violations()


def reset() -> None:
    WATCH.reset()


def stats() -> Dict[str, Any]:
    return WATCH.stats()


class LockOrderError(AssertionError):
    """A lock-order cycle was observed (or, strict, a lock was held across
    a blocking call)."""


@contextmanager
def watching(strict: Optional[bool] = None) -> Iterator[LockWatch]:
    """Run the body under the watchdog (enabled here unless it already
    was, and then left enabled) and fail on what it saw: any lock-order
    cycle raises :class:`LockOrderError`; held-across-blocking events
    raise too when ``strict`` (default: ``GPU_LOCKWATCH_STRICT=1``), else
    they warn. The reference's ``TPU_LOCKWATCH`` session fixture, as a
    context manager."""
    if strict is None:
        strict = os.environ.get(STRICT_ENV) == "1"
    was_enabled = enabled()
    enable()
    try:
        yield WATCH
    finally:
        found = cycles()
        blocking = [
            v for v in violations() if v["type"] == "held-across-blocking"
        ]
        summary = stats()
        if not was_enabled:
            disable()
    if found:
        raise LockOrderError(
            f"lockwatch: lock-order cycle(s) observed ({summary}): "
            + "; ".join(" -> ".join(c["cycle"]) for c in found)
        )
    if blocking:
        detail = "; ".join(
            f"{v['call']} at {v['at']} holding {v['locks']}"
            for v in blocking[:5]
        )
        message = (
            f"lockwatch: {len(blocking)} held-across-blocking event(s): {detail}"
        )
        if strict:
            raise LockOrderError(message)
        warnings.warn(message)


def requested() -> bool:
    """Whether ``GPU_LOCKWATCH=1`` asks for the watchdog."""
    return os.environ.get(ENV) == "1"
