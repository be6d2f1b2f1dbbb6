"""One pruned-on-liveness log-once registry.

The port's copy of ``tpu_operator/obs/logonce.py``. It serves the
state machine's no-GPU DaemonSet skip set, remediation's (node, reason)
pairs and repartition's slice log-once, each of which needs the same
pruning (no unbounded growth under unique-name churn, no rejoin
inheriting the old suppression):

* ``log(logger, key, msg, *args)`` — emit at INFO the first time ``key``
  is seen, DEBUG thereafter (the condition is still visible at debug
  level without logspamming steady state);
* ``clear(key)`` / ``discard(key)`` — the condition cleared: the next
  occurrence logs again (once per stretch, not once per process);
* ``prune(live)`` — retire keys whose subject left the world; a tuple
  key's subject is its first element, a plain key is its own subject.
  This is the liveness bound: lifecycle churn (preemption waves,
  unique join names) can never grow the registry past the live fleet;
* set-compatible surface (``in``, ``add``, ``clear()``, ``len``) so the
  registries it replaced keep their call sites and tests.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Hashable, Iterable, Optional, Set


class LogOnce:
    def __init__(self) -> None:
        self._seen: Set[Hashable] = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def log(
        self,
        logger: logging.Logger,
        key: Hashable,
        msg: str,
        *args: Any,
        level: int = logging.INFO,
    ) -> bool:
        """Log ``msg % args`` at ``level`` the first time ``key`` is
        seen (DEBUG on repeats). Returns True when the first-time line
        was emitted."""
        with self._lock:
            first = key not in self._seen
            if first:
                self._seen.add(key)
        logger.log(level if first else logging.DEBUG, msg, *args)
        return first

    # ------------------------------------------------------------------
    # set-compatible surface
    # ------------------------------------------------------------------
    def add(self, key: Hashable) -> None:
        with self._lock:
            self._seen.add(key)

    def discard(self, key: Hashable) -> None:
        with self._lock:
            self._seen.discard(key)

    def clear(self, key: Optional[Hashable] = None) -> None:
        """``clear()`` forgets everything (a transition boundary, e.g.
        GPU nodes appearing); ``clear(key)`` forgets one key."""
        with self._lock:
            if key is None:
                self._seen.clear()
            else:
                self._seen.discard(key)

    def discard_subject(self, subject: Hashable) -> int:
        """Retire every key whose subject IS ``subject`` (the inverse of
        ``prune``'s liveness sweep — event-speed cleanup when one
        subject leaves the world, e.g. a deleted node's remediation
        entries). Returns how many were dropped."""
        with self._lock:
            before = len(self._seen)
            self._seen = {
                k
                for k in self._seen
                if (k[0] if isinstance(k, tuple) and k else k) != subject
            }
            return before - len(self._seen)

    def prune(self, live: Iterable[Hashable]) -> int:
        """Retire keys whose subject is not in ``live``; returns how
        many were dropped. A tuple key's subject is ``key[0]`` (the
        (name, reason) convention); any other key is its own subject."""
        live_set = set(live)
        with self._lock:
            before = len(self._seen)
            self._seen = {
                k
                for k in self._seen
                if (k[0] if isinstance(k, tuple) and k else k) in live_set
            }
            return before - len(self._seen)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._seen

    def __len__(self) -> int:
        with self._lock:
            return len(self._seen)
