"""Gang admission — bounded hold-and-release over member hosts.

A multi-host slice job is admitted all-or-nothing: every member host
must take the job's chips, or none may keep them. The coordinator
provides the mutual-exclusion half of that contract — per-host admission
*holds* — with a protocol that cannot deadlock:

* **canonical order**: a gang acquires its member hosts' holds one at a
  time in one global order (sorted host name). Two gangs contending for
  overlapping hosts therefore collide at the FIRST shared host in that
  order, never in opposite orders — the circular wait a deadlock needs
  cannot form.
* **release-on-conflict**: a gang that finds its next host held releases
  everything it already holds and retries after a jittered backoff, so a
  half-admitted gang never pins hosts while waiting on another gang.
* **bounded holds**: every hold carries a TTL. A wedged admitter (or a
  crashed worker) cannot fence a host forever — the next acquirer
  reclaims the expired hold and counts the reclaim.
* **bounded admission**: ``acquire`` gives up after ``admit_timeout_s``
  and reports failure; the caller rolls the job back. Admission may
  fail; it may never hang.

Single-chip jobs ride the same gate as gangs of one — holds only protect
anything if *every* admission path honors them.

The port's copy of ``tpu_operator/schedsim/gang.py``, unchanged: a hold is
on a host, and nothing here names an accelerator. The per-gang jitter is
seeded by the gang id's crc32 on both sides, so one replay backs off alike.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional, Tuple


class GangCoordinator:
    """Per-host admission holds with TTL + deadlock-free multi-host
    acquisition."""

    def __init__(
        self,
        hold_ttl_s: float = 5.0,
        admit_timeout_s: float = 10.0,
        backoff_s: float = 0.002,
    ):
        self.hold_ttl_s = hold_ttl_s
        self.admit_timeout_s = admit_timeout_s
        self.backoff_s = backoff_s
        self._lock = threading.Lock()
        # node -> (gang_id, expires_at)
        self._holds: Dict[str, Tuple[str, float]] = {}
        self.acquires_total = 0
        self.conflicts_total = 0
        self.timeouts_total = 0
        self.expired_reclaims_total = 0

    # -- single-host primitives ------------------------------------------
    def try_hold(self, node: str, gang_id: str) -> bool:
        """One atomic try-acquire of one host's hold (reclaims expired
        holds). This is the only primitive that takes a hold — acquire()
        builds the multi-host protocol out of it, one host per lock
        acquisition, so contending gangs genuinely interleave."""
        now = time.monotonic()
        with self._lock:
            cur = self._holds.get(node)
            if cur is not None:
                holder, expires = cur
                if holder == gang_id:
                    # re-entrant refresh (same gang re-walks its order)
                    self._holds[node] = (gang_id, now + self.hold_ttl_s)
                    return True
                if expires > now:
                    return False
                self.expired_reclaims_total += 1
            self._holds[node] = (gang_id, now + self.hold_ttl_s)
            return True

    def release(self, gang_id: str, nodes: Iterable[str]) -> None:
        with self._lock:
            for node in nodes:
                if self._holds.get(node, (None, 0.0))[0] == gang_id:
                    del self._holds[node]

    def holder(self, node: str) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            cur = self._holds.get(node)
            if cur is None or cur[1] <= now:
                return None
            return cur[0]

    # -- the protocol -----------------------------------------------------
    def acquire(
        self,
        gang_id: str,
        nodes: Iterable[str],
        timeout_s: Optional[float] = None,
    ) -> bool:
        """All-or-nothing holds on every member host; True when the gang
        holds them all, False on admission timeout (nothing held)."""
        order: List[str] = sorted(set(nodes))
        deadline = time.monotonic() + (
            self.admit_timeout_s if timeout_s is None else timeout_s
        )
        # deterministic per-gang jitter: no shared RNG contention, and a
        # replay with the same gang ids backs off identically (crc32,
        # not hash() — builtin str hashing is randomized per process)
        rng = random.Random(zlib.crc32(gang_id.encode()))
        while True:
            got: List[str] = []
            blocked = False
            for node in order:
                if self.try_hold(node, gang_id):
                    got.append(node)
                else:
                    blocked = True
                    break
            if not blocked:
                with self._lock:
                    self.acquires_total += 1
                return True
            self.release(gang_id, got)
            with self._lock:
                self.conflicts_total += 1
            if time.monotonic() >= deadline:
                with self._lock:
                    self.timeouts_total += 1
                return False
            time.sleep(self.backoff_s * (0.5 + rng.random()))

    # -- observability ----------------------------------------------------
    def active_holds(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for _, exp in self._holds.values() if exp > now)

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "active_holds": sum(
                    1 for _, exp in self._holds.values() if exp > now
                ),
                "acquires_total": self.acquires_total,
                "conflicts_total": self.conflicts_total,
                "timeouts_total": self.timeouts_total,
                "expired_reclaims_total": self.expired_reclaims_total,
                "hold_ttl_s": self.hold_ttl_s,
            }
