"""Apiserver fault-tolerance policy: per-verb retries + circuit breaker.

The port's copy of ``tpu_operator/kube/retry.py``: the same jitter and
budget arithmetic, so one seeded ``random.Random`` gives both packages
the same schedule.

The reference operator leans on controller-runtime's client, whose
transport retries transient failures and whose workqueue backs off per
item; our stdlib-only ``RestClient`` historically retried only idempotent
GETs, so every write raced the apiserver's bad seconds. This module is
the single definition of the retry/backoff/breaker behavior every client
implementation exposes (``RestClient`` consults it on the wire;
``FakeClient``/``CachedClient`` carry the same surface so callers and
tests can tune one object regardless of backend):

* ``RetryPolicy`` — per-verb attempt counts, equal-jittered exponential
  backoff with a cap, a per-call wall-clock budget, and ``Retry-After``
  honoring for 429 load shedding. Jitter matters at fleet scale: a
  hundred operators retrying in lockstep after an apiserver blip is a
  second blip.
* ``CircuitBreaker`` — a GLOBAL consecutive-failure trip so a dead
  apiserver is probed politely instead of hammered per call site. While
  open, requests fail fast (the caller's level-triggered requeue retries
  later); the cooldown doubles per consecutive trip and resets on the
  first success. 4xx answers (including 409/429) count as *successes*
  here: the server answered, it is not down.

Both objects are cheap on the fault-free path — one attribute compare
for ``allow()``, one ``if`` for ``record_success`` — so the steady-state
hot loop pays nothing for the protection.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional


def _monotonic() -> float:
    return time.monotonic()


class RetryPolicy:
    """Per-verb retry/backoff policy (shared surface across clients).

    ``backoff(attempt)`` returns an equal-jittered exponential delay
    (``uniform(d/2, d)`` where ``d = min(cap, base * 2**(attempt-1))``);
    with ``retry_after`` given (a 429's header) the server's number wins,
    capped so a hostile/buggy header cannot park the worker."""

    def __init__(
        self,
        read_attempts: int = 3,
        write_attempts: int = 4,
        backoff_s: float = 0.5,
        cap_s: float = 8.0,
        budget_s: float = 20.0,
        rng: Optional[random.Random] = None,
    ):
        self.read_attempts = read_attempts
        self.write_attempts = write_attempts
        self.backoff_s = backoff_s
        self.cap_s = cap_s
        # per-CALL wall-clock budget: a single reconcile step must not
        # absorb minutes of retry sleep (the stall watchdog would trip);
        # exhausting the budget surfaces the last error to the caller's
        # rate-limited requeue instead
        self.budget_s = budget_s
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.retries_total = 0
        self.retries_by_verb: Dict[str, int] = {}
        self.giveups_total = 0
        self.retry_after_honored = 0

    def attempts_for(self, method: str) -> int:
        return self.read_attempts if method == "GET" else self.write_attempts

    def backoff(self, attempt: int, retry_after: Optional[float] = None) -> float:
        """Delay before retry number ``attempt`` (1-based). Pure
        computation — counters move in ``count_retry`` once the caller
        commits to the retry (a budget give-up must not read as an
        honored Retry-After)."""
        if retry_after is not None:
            return min(max(0.0, float(retry_after)), self.cap_s)
        d = min(self.cap_s, self.backoff_s * (2 ** (attempt - 1)))
        return self._rng.uniform(d / 2, d)

    def count_retry(self, method: str, honored_retry_after: bool = False) -> None:
        with self._lock:
            self.retries_total += 1
            self.retries_by_verb[method] = (
                self.retries_by_verb.get(method, 0) + 1
            )
            if honored_retry_after:
                self.retry_after_honored += 1

    def count_giveup(self) -> None:
        with self._lock:
            self.giveups_total += 1

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "retries_total": self.retries_total,
                "retries_by_verb": dict(self.retries_by_verb),
                "giveups_total": self.giveups_total,
                "retry_after_honored": self.retry_after_honored,
            }


class CircuitBreaker:
    """Global consecutive-failure breaker with doubling cooldown.

    ``allow()`` is the fast path: closed state is a single float compare
    (no lock). After ``threshold`` consecutive transport/5xx failures the
    breaker opens for ``cooldown_base_s`` (doubling per consecutive trip
    up to ``cooldown_cap_s``); while open every caller fails fast instead
    of stacking timeouts against a dead apiserver. When the cooldown
    lapses, requests flow again (half-open): the first success resets
    everything, the next failure re-trips with a doubled window."""

    def __init__(
        self,
        threshold: int = 5,
        cooldown_base_s: float = 1.0,
        cooldown_cap_s: float = 30.0,
    ):
        self.threshold = threshold
        self.cooldown_base_s = cooldown_base_s
        self.cooldown_cap_s = cooldown_cap_s
        self._lock = threading.Lock()
        self._open_until = 0.0
        self._consecutive = 0
        self._trip_streak = 0
        self.trips_total = 0
        self.fast_fails_total = 0

    def allow(self) -> bool:
        until = self._open_until
        if until and _monotonic() < until:
            with self._lock:
                self.fast_fails_total += 1
            return False
        return True

    def record_success(self) -> None:
        # fast path: nothing to reset in the healthy steady state
        if (
            not self._consecutive
            and not self._open_until
            and not self._trip_streak
        ):
            return
        with self._lock:
            self._consecutive = 0
            self._trip_streak = 0
            self._open_until = 0.0

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            now = _monotonic()
            if now < self._open_until:
                return  # already open: a straggler in-flight failure
            # half-open (a prior trip with no success since): ONE probe
            # failure re-trips immediately with a doubled window — a dead
            # server must not earn a fresh full threshold of stacked
            # timeouts per cooldown. From closed, a full threshold of
            # consecutive failures is required.
            if self._trip_streak == 0 and self._consecutive < self.threshold:
                return
            self.trips_total += 1
            self._trip_streak += 1
            cooldown = min(
                self.cooldown_cap_s,
                self.cooldown_base_s * (2 ** min(self._trip_streak - 1, 16)),
            )
            self._open_until = now + cooldown
            self._consecutive = 0
        # flight-recorder timeline: a trip is exactly the kind of rare
        # causal event a post-mortem needs (outside the lock; the
        # recorder takes its own)
        try:
            from tpu_operator_torch.obs import flight

            flight.record(
                "breaker.trip",
                trips_total=self.trips_total,
                cooldown_s=round(cooldown, 3),
            )
        except Exception:  # pragma: no cover - recorder must never hurt
            pass

    def stats(self) -> Dict[str, object]:
        with self._lock:
            now = _monotonic()
            return {
                "state": (
                    "open"
                    if self._open_until and now < self._open_until
                    else ("half-open" if self._open_until or self._consecutive else "closed")
                ),
                "consecutive_failures": self._consecutive,
                "trips_total": self.trips_total,
                "fast_fails_total": self.fast_fails_total,
                "open_for_s": (
                    round(self._open_until - now, 3)
                    if self._open_until and now < self._open_until
                    else 0.0
                ),
            }


class WatchBackoff:
    """Reconnect backoff for watch loops: jittered exponential growth
    with a cap, reset on a successful (re)connect. A fixed reconnect
    delay makes a fleet of informers a thundering herd against a
    recovering apiserver — every stream re-LISTs in the same second."""

    def __init__(
        self,
        base_s: float = 1.0,
        cap_s: float = 30.0,
        rng: Optional[random.Random] = None,
    ):
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = rng or random.Random()
        self._failures = 0

    def next_delay(self) -> float:
        d = min(self.cap_s, self.base_s * (2 ** self._failures))
        self._failures = min(self._failures + 1, 16)
        return self._rng.uniform(d / 2, d)

    def reset(self) -> None:
        self._failures = 0
