"""Controller manager runtime.

The port's copy of ``tpu_operator/manager.py``, whole: the Python analogue
of controller-runtime's Manager (``main.go:88-159``): a rate-limited
workqueue fed by watch events, health probes on :8081, Prometheus metrics
on :8080, Lease-based leader election, and signal handling.

What the port decides here (the operator process's decisions, also in
``shard.py``, ``main.py``, ``operands/maintenance.py`` and ROADMAP):

* Internal names stay the reference's: ``RateLimiter``, ``WorkQueue``,
  ``LeaderElector``, ``Manager``, ``default_leader_identity``,
  ``default_workers`` and the ``/debug/vars`` key set.
* The leader Lease is ``gpu-operator-leader`` (the reference's
  ``tpu-operator-leader``) and the logger ``gpu-operator.manager``. Both
  operators run in the namespace ``tpu-operator``
  (``consts.DEFAULT_NAMESPACE``), so a port replica and a reference replica
  must not contend for one Lease.
* Variables that name no accelerator stay: ``RECONCILE_WORKERS``,
  ``RECONCILE_STALL_DEADLINE_S``, ``POD_NAME`` and ``POD_UID``.
* ``Manager.lease_seconds`` (30, the reference's fixed duration) is the
  leader Lease's duration, so a harness can time a failover in seconds.
* ``prometheus_client`` is imported inside ``start`` alone: the operator
  converges without it.
* The scrape shows the port's metric families under ``gpu_operator_``
  (``controllers/operator_metrics.py``).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import threading
import time
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from tpu_operator_torch.kube.client import Client
from tpu_operator_torch.kube.frozen import thaw
from tpu_operator_torch.obs import flight

log = logging.getLogger("gpu-operator.manager")

# the global leader Lease (the reference's ``tpu-operator-leader``)
LEADER_LEASE_NAME = "gpu-operator-leader"


class RateLimiter:
    """Per-item exponential backoff, 100ms base to 3s cap (reference
    ``controllers/clusterpolicy_controller.go:45-48``)."""

    def __init__(self, base: float = 0.1, cap: float = 3.0):
        self.base = base
        self.cap = cap
        self._failures = {}
        self._lock = threading.Lock()

    # failure counts cap here: past this the delay is pinned at ``cap``
    # anyway, and an unbounded count would overflow ``2**n`` float
    # conversion past ~1024 failures (~51 min of persistent failure at the
    # 3 s cap), raising OverflowError inside the worker's failure path and
    # killing the only worker thread
    MAX_EXPONENT = 16

    def when(self, item) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = min(n + 1, self.MAX_EXPONENT)
            return min(self.base * (2**n), self.cap)

    def forget(self, item) -> None:
        with self._lock:
            self._failures.pop(item, None)


class WorkQueue:
    """Deduplicating delayed workqueue (client-go semantics: an item queued
    while pending coalesces into one execution).

    Multi-worker extensions:

    * **processing set** — an item handed to a worker stays tracked until
      ``task_done``; ``add`` on an in-flight item parks the re-add in a
      dirty slot instead of queueing, so the SAME key is never dispatched
      to two workers (per-key serialization at any worker count) and a
      burst of same-key events landing mid-execution coalesces into
      exactly ONE re-run after the current one completes;
    * **barrier keys** (``mark_barrier``) — keys requiring EXCLUSIVE
      queue occupancy (the fleet-wide full passes): a due barrier item
      dispatches only once every in-flight item finished, and while one
      is due or running nothing else dispatches. Keyed delta items
      (node/slice sub-reconciles) overlap freely with each other.

    Callers that never invoke ``task_done`` (direct test drivers) keep
    the historical single-consumer behavior for distinct items; only
    re-adds of an in-flight item need the completion signal.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._ready = []  # (due_time, item)
        self._pending = set()
        # items currently executing on a worker (client-go "processing")
        self._processing = set()
        # item -> due time for the post-completion re-add (client-go
        # "dirty"): a re-add while processing coalesces here
        self._dirty = {}
        # keys with exclusive-occupancy semantics (full fleet passes)
        self._barriers = set()

    def mark_barrier(self, item) -> None:
        """Give ``item`` full-pass barrier semantics: it runs alone."""
        with self._cond:
            self._barriers.add(item)

    def add(self, item, delay: float = 0.0) -> None:
        due = time.monotonic() + delay
        with self._cond:
            if item in self._processing:
                # re-add while a worker runs this key: coalesce into one
                # re-execution after completion — never a concurrent one
                prev = self._dirty.get(item)
                if prev is None or due < prev:
                    self._dirty[item] = due
                return
            if item in self._pending:
                # an Add supersedes a pending AddAfter with a later due time
                # (client-go semantics): a watch event must not wait out a
                # long requeue timer
                for i, (t, existing) in enumerate(self._ready):
                    if existing == item and due < t:
                        self._ready[i] = (due, item)
                        self._cond.notify_all()
                return
            self._pending.add(item)
            self._ready.append((due, item))
            self._cond.notify_all()

    def task_done(self, item) -> None:
        """Worker completion signal: releases the key for re-dispatch,
        activating any re-add that coalesced while it ran."""
        with self._cond:
            self._processing.discard(item)
            due = self._dirty.pop(item, None)
            if due is not None and item not in self._pending:
                self._pending.add(item)
                self._ready.append((due, item))
            self._cond.notify_all()

    def _pick_locked(self, now: float):
        """The dispatch decision under ``_cond``: returns a due entry
        honoring barrier discipline, or None. A due barrier item blocks
        newer non-barrier dispatches (no starvation) and waits for the
        in-flight set to drain before running alone."""
        if self._barriers and not self._barriers.isdisjoint(self._processing):
            return None  # a full pass holds exclusive occupancy
        due = [e for e in self._ready if e[0] <= now]
        if not due:
            return None
        # key on the due time ONLY: entries tie on coarse clocks, and a
        # bare tuple min would then compare the items — a str full-pass
        # key against a tuple delta key raises TypeError, wedging every
        # worker's get() forever while healthz stays green
        due_barriers = [e for e in due if e[1] in self._barriers]
        if due_barriers:
            # drain-then-run: nothing new dispatches past a due barrier
            return (
                min(due_barriers, key=lambda e: e[0])
                if not self._processing
                else None
            )
        return min(due, key=lambda e: e[0])

    def get(self, timeout: Optional[float] = None):
        # `is not None`, NOT truthiness: get(timeout=0) is a non-blocking
        # poll ("return a due item or None now") — treating the falsy 0.0
        # as "no deadline" turned it into a block-forever
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            while True:
                now = time.monotonic()
                entry = self._pick_locked(now)
                if entry is not None:
                    self._ready.remove(entry)
                    self._pending.discard(entry[1])
                    self._processing.add(entry[1])
                    return entry[1]
                # blocked on barrier discipline (due work exists but may
                # not dispatch): only task_done/add can change the
                # picture, so wait for the notify, not a timer
                blocked = any(e[0] <= now for e in self._ready)
                wait = None
                if not blocked and self._ready:
                    wait = max(0.0, min(e[0] for e in self._ready) - now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining) if wait is not None else remaining
                self._cond.wait(wait)

    def remove_if(self, pred) -> List:
        """Drop every PENDING item matching ``pred`` (shard handoff:
        the lost shard's queued keys must not run here anymore — the
        new owner's resync re-derives them). In-flight items are not
        touched; ``wait_idle`` covers those. Returns the removed items."""
        with self._cond:
            removed = [e for e in self._ready if pred(e[1])]
            for e in removed:
                self._ready.remove(e)
                self._pending.discard(e[1])
            dirty = [i for i in self._dirty if pred(i)]
            for item in dirty:
                self._dirty.pop(item, None)
            if removed or dirty:
                self._cond.notify_all()
            return [e[1] for e in removed] + dirty

    def wait_idle(self, pred, timeout: float = 5.0) -> bool:
        """Block until no IN-FLIGHT item matches ``pred`` (or timeout).
        With ``remove_if`` this is the handoff drain barrier: once both
        return, none of the shard's keys is pending or running on this
        replica, so the new owner's executions cannot overlap ours."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while any(pred(i) for i in self._processing):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def due_len(self) -> int:
        """Items dispatchable right now (future-dated resync/requeue
        timers excluded) — the quiescence signal harnesses poll."""
        with self._cond:
            now = time.monotonic()
            return sum(1 for e in self._ready if e[0] <= now)

    def busy_len(self) -> int:
        """Items handed to workers and not yet task_done — the
        authoritative in-flight count (the manager's watchdog bracket
        lags it by a few instructions)."""
        with self._cond:
            return len(self._processing)

    def __len__(self):
        with self._cond:
            return len(self._ready)


def default_leader_identity() -> str:
    """Pod name + pod UID (downward API) like controller-runtime; the UID
    makes the identity unique across process restarts on the same host
    within one lease window. Falls back to hostname + a per-process
    random token off-cluster."""
    import os
    import uuid

    pod = os.environ.get("POD_NAME") or socket.gethostname()
    uid = os.environ.get("POD_UID") or uuid.uuid4().hex[:12]
    return f"{pod}_{uid}"


def _parse_rfc3339(ts: str):
    """Lease ``renewTime`` parser accepting RFC3339 with and without
    fractional seconds, and numeric offsets as well as ``Z``.
    controller-runtime and kubectl write ``...:05.999999Z`` (MicroTime)
    but other clients legally write ``...:05Z`` or ``...:05+00:00`` — a
    single-format strptime treated those leases as unparseable, hence
    perpetually expired, and STOLE a live peer's lease (fail-open).
    Returns an aware UTC datetime, or None when the timestamp is
    genuinely unparseable."""
    try:
        then = datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except (TypeError, ValueError):
        return None
    if then.tzinfo is None:
        then = then.replace(tzinfo=timezone.utc)
    return then.astimezone(timezone.utc)


class LeaderElector:
    """Lease-based leader election (reference ``main.go:97-107``)."""

    def __init__(
        self,
        client: Client,
        namespace: str,
        name: str = LEADER_LEASE_NAME,
        identity: Optional[str] = None,
        lease_seconds: int = 30,
    ):
        self.client = client
        self.namespace = namespace
        self.name = name
        self.identity = identity or default_leader_identity()
        self.lease_seconds = lease_seconds

    def try_acquire(self) -> bool:
        now = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")
        lease = self.client.get_or_none(
            "coordination.k8s.io/v1", "Lease", self.name, self.namespace
        )
        if lease is None:
            try:
                self.client.create(
                    {
                        "apiVersion": "coordination.k8s.io/v1",
                        "kind": "Lease",
                        "metadata": {"name": self.name, "namespace": self.namespace},
                        "spec": {
                            "holderIdentity": self.identity,
                            "leaseDurationSeconds": self.lease_seconds,
                            "renewTime": now,
                        },
                    }
                )
                return True
            except Exception:
                return False
        # ONE expiry-semantics implementation for acquisition and the
        # fencing read: a drift between the two re-opens the
        # split-brain window the fencing read exists to close
        holder = self._live_holder(lease)
        if holder is None or holder == self.identity:
            # the CAS below carries the read revision: when two
            # candidates race an expired lease, the apiserver 409s the
            # loser's update and exactly one acquisition wins
            # the lease may be a zero-copy informer view (frozen);
            # thaw before the read-modify-write or update() dies with
            # FrozenObjectError the first time the Lease kind is served
            # from the cache
            lease = thaw(lease)
            spec = lease.get("spec", {})
            spec.update({"holderIdentity": self.identity, "renewTime": now})
            lease["spec"] = spec
            try:
                self.client.update(lease)
                return True
            except Exception:
                return False
        return False

    def _read_lease_live(self):
        """The lease object from a LIVE read — leader decisions must
        never come from a cache (two replicas both serving a stale
        lease view could both believe they hold it)."""
        getter = getattr(self.client, "get_live", None)
        if callable(getter):
            from tpu_operator_torch.kube.client import NotFoundError

            try:
                return getter(
                    "coordination.k8s.io/v1",
                    "Lease",
                    self.name,
                    self.namespace,
                )
            except NotFoundError:
                return None
        return self.client.get_or_none(
            "coordination.k8s.io/v1", "Lease", self.name, self.namespace
        )

    @staticmethod
    def _live_holder(lease) -> Optional[str]:
        """The identity holding an UNEXPIRED lease, or None when the
        lease is absent/unheld/expired/unparseable (acquirable). The
        single expiry-semantics implementation — ``try_acquire`` and
        the ``holds()`` fencing read must never drift apart."""
        if lease is None:
            return None
        spec = lease.get("spec", {}) or {}
        holder = spec.get("holderIdentity")
        if not holder:
            return None
        then = _parse_rfc3339(spec.get("renewTime", "") or "")
        if then is None:
            return None
        age = (datetime.now(timezone.utc) - then).total_seconds()
        if age > spec.get("leaseDurationSeconds", 30):
            return None
        return holder

    def current_holder(self) -> Optional[str]:
        """The identity currently holding an UNEXPIRED lease from a
        LIVE read, or None when acquirable."""
        return self._live_holder(self._read_lease_live())

    def holds(self) -> bool:
        """LIVE check that THIS identity still holds the lease — the
        fencing read sharded replicas make before budgeted work (a
        renewal-loop miss can lag a takeover by most of a renew
        interval; this closes that window at the decision point)."""
        return self.current_holder() == self.identity


class _HealthHandler(BaseHTTPRequestHandler):
    """Probe endpoints plus a minimal debug surface (the reference has no
    pprof; SURVEY.md §5 suggests an optional one — /debug/stacks is the
    Python equivalent of pprof's goroutine dump, /debug/vars mirrors
    expvar)."""

    manager: "Manager" = None

    def do_GET(self):  # noqa: N802
        if self.path.startswith("/debug/"):
            # opt-in only: stack traces/internals on a pod-network-reachable
            # port are an information-disclosure surface
            if self.manager is None or not self.manager.debug_endpoints:
                self._respond(404, "debug endpoints disabled\n")
                return
            if self.path.startswith("/debug/stacks"):
                self._respond(200, _dump_stacks(), "text/plain")
                return
            if not self.path.startswith("/debug/vars"):
                self._respond(404, "no such debug endpoint\n")
                return
        if self.path.startswith("/debug/vars"):
            import json

            m = self.manager
            payload = (
                m.debug_vars_payload()
                if m
                else {"queue_len": 0, "threads": threading.active_count()}
            )
            body = json.dumps(payload)
            self._respond(200, body, "application/json")
            return
        healthy = self.manager is None or self.manager.healthy()
        self._respond(
            200 if healthy else 500, "ok" if healthy else "unhealthy"
        )

    def _respond(self, code, body, ctype="text/plain"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):  # silence
        pass


def _dump_stacks() -> str:
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def default_workers() -> int:
    """Reconcile worker count (``RECONCILE_WORKERS``, default 4): M
    workers consume the keyed workqueue so independent node/slice delta
    sub-reconciles overlap, while per-key serialization and the
    full-pass barrier keys keep every historical ordering guarantee.
    1 restores the strict MaxConcurrentReconciles=1 behavior."""
    try:
        return max(1, int(os.environ.get("RECONCILE_WORKERS", "4")))
    except ValueError:
        return 4


class Manager:
    """Runs reconcilers off a shared watch-fed workqueue."""

    def __init__(
        self,
        client: Client,
        namespace: str,
        metrics_port: int = 8080,
        probe_port: int = 8081,
        leader_election: bool = False,
        debug_endpoints: bool = False,
        pass_deadline_s: Optional[float] = None,
        workers: Optional[int] = None,
    ):
        self.client = client
        self.namespace = namespace
        self.metrics_port = metrics_port
        self.probe_port = probe_port
        self.leader_election = leader_election
        self.debug_endpoints = debug_endpoints
        self.queue = WorkQueue()
        self.rate_limiter = RateLimiter()
        self._reconcilers = {}
        # tuple-key families: ("node", name) dispatches the registered
        # "node" handler with the name — the delta sub-reconcile path
        self._keyed_reconcilers = {}
        # plain key -> low-frequency resync interval: the safety-net
        # re-add applied after a completed pass that asked for no
        # requeue, so the full pass still converges anything the delta
        # router dropped
        self._resync_s = {}
        self._stop = threading.Event()
        self._last_reconcile_ok = True
        self._threads = []
        self.workers = workers if workers is not None else default_workers()
        # stall watchdog: a single hung state check used to wedge ALL
        # reconciling while probes stayed green forever; healthy() now
        # flips once any in-flight pass outlives this deadline, so the
        # kubelet restarts the pod
        self.pass_deadline_s = (
            pass_deadline_s
            if pass_deadline_s is not None
            else float(os.environ.get("RECONCILE_STALL_DEADLINE_S", "300"))
        )
        # legacy single-slot in-flight bracket (tests wedge the watchdog
        # by poking these directly); the worker pool tracks its own
        # per-worker brackets in _inflight below
        self._inflight_item: Optional[str] = None
        self._inflight_since: Optional[float] = None
        # worker index -> (item, since_monotonic) under _inflight_lock
        self._inflight = {}
        self._inflight_lock = threading.Lock()
        self._last_progress = time.monotonic()
        # extra /debug/vars payload fragments: name -> zero-arg callable
        # returning a JSON-serializable value (e.g. the reconciler's
        # per-pass snapshot hit rates)
        self._debug_vars = {}
        # shutdown callbacks (run once, before the cache stops): the
        # warm-restart journal's final save rides this so a clean stop
        # persists the freshest world-state
        self._stop_hooks = []
        self._stop_hooks_ran = False
        # stall-watchdog flight dumps fired (the monitor thread dumps
        # the recorder once per stall EPISODE, not per poll)
        self._stall_dumps = 0
        self._metrics_httpd = None
        # sharded scale-out (shard.py): build_manager sets
        # these when GPU_SHARDS > 1 — the per-shard lease loop starts
        # with the manager and stops with it; shard_state is the
        # ownership view the router/reconcilers consult. None = the
        # default single-process operator.
        self.shard_lease_manager = None
        self.shard_state = None
        # the leader Lease's duration (the reference's fixed 30 s); a
        # harness that times a failover shortens it before start()
        self.lease_seconds = 30

    def add_reconciler(
        self,
        key: str,
        fn: Callable[[str], object],
        resync_s: Optional[float] = None,
    ) -> None:
        """``fn(name) -> Result`` (with optional ``requeue_after``).

        Plain-key reconcilers are the fleet-wide full passes: they get
        BARRIER semantics on the queue (exclusive occupancy — no delta
        sub-reconcile overlaps a full pass, and the two full passes
        never overlap each other, preserving the historical
        MaxConcurrentReconciles=1 ordering between them). ``resync_s``
        installs the low-frequency safety-net re-add applied whenever a
        completed pass requested no requeue."""
        self._reconcilers[key] = fn
        self.queue.mark_barrier(key)
        if resync_s:
            self._resync_s[key] = float(resync_s)

    def add_keyed_reconciler(
        self, kind: str, fn: Callable[[str], object]
    ) -> None:
        """Register the handler for ``(kind, name)`` queue keys — the
        event-scoped delta sub-reconciles (``("node", name)``,
        ``("slice", sid)``). Keyed items are NOT barriers: different
        keys overlap across workers; the queue's processing set keeps
        the same key strictly serial."""
        self._keyed_reconcilers[kind] = fn

    def _resolve(self, item):
        """Dispatch: ``(fn, arg)`` for a queue item, or ``(None, None)``."""
        if isinstance(item, tuple) and len(item) == 2:
            fn = self._keyed_reconcilers.get(item[0])
            return fn, item[1]
        return self._reconcilers.get(item), item

    @staticmethod
    def format_key(item) -> str:
        """Display form of a queue key (tuple keys as ``kind/name``)."""
        if isinstance(item, tuple):
            return "/".join(str(p) for p in item)
        return str(item)

    def register_debug_vars(self, name: str, fn: Callable[[], object]) -> None:
        """Attach a provider to the /debug/vars payload."""
        self._debug_vars[name] = fn

    def add_stop_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` once when the manager stops, before the informer
        cache shuts down (so hooks can still read it)."""
        self._stop_hooks.append(fn)

    def enqueue(self, key, delay: float = 0.0) -> None:
        """Queue a reconcile key: a plain full-pass key or a typed
        ``(kind, name)`` delta key."""
        self.queue.add(key, delay)

    def healthy(self) -> bool:
        return not self._stop.is_set() and not self.stalled()

    def _oldest_inflight(self):
        """``(item, since)`` of the longest-running in-flight reconcile
        across the worker pool (plus the legacy single-slot bracket), or
        ``None`` when every worker is idle."""
        with self._inflight_lock:
            entries = list(self._inflight.values())
        since = self._inflight_since
        if since is not None:
            entries.append((self._inflight_item, since))
        if not entries:
            return None
        return min(entries, key=lambda e: e[1])

    def stalled(self) -> bool:
        """True when any worker's in-flight reconcile has outlived the
        pass deadline — a wedged pass (hung socket, deadlock in a state
        check) that would otherwise keep probes green while that worker
        reconciles nothing."""
        oldest = self._oldest_inflight()
        return (
            oldest is not None
            and time.monotonic() - oldest[1] > self.pass_deadline_s
        )

    def watchdog_stats(self) -> dict:
        """Stall-watchdog disposition for /debug/vars."""
        now = time.monotonic()
        oldest = self._oldest_inflight()
        with self._inflight_lock:
            inflight_count = len(self._inflight)
        if self._inflight_since is not None:
            inflight_count += 1
        return {
            "pass_deadline_s": self.pass_deadline_s,
            "inflight": (
                self.format_key(oldest[0]) if oldest is not None else None
            ),
            "inflight_for_s": (
                round(now - oldest[1], 3) if oldest is not None else None
            ),
            "inflight_count": inflight_count,
            "workers": self.workers,
            "stalled": bool(
                oldest is not None
                and now - oldest[1] > self.pass_deadline_s
            ),
            "last_progress_age_s": round(now - self._last_progress, 3),
            "stall_dumps": self._stall_dumps,
        }

    def debug_vars_payload(self) -> dict:
        """The full /debug/vars payload (factored out of the HTTP
        handler so tests can pin the key-set schema — a refactor
        silently dropping a diagnostic surface fails tier-1)."""
        import json

        payload = {
            "queue_len": len(self.queue),
            "threads": threading.active_count(),
            "reconcilers": sorted(self._reconcilers),
            "last_reconcile_ok": self._last_reconcile_ok,
            # stall-watchdog disposition: what is in flight, for how
            # long, and whether it breached the pass deadline
            "watchdog": self.watchdog_stats(),
        }
        fault = getattr(self.client, "fault_stats", None)
        if callable(fault):
            # retry/breaker counters (kube/retry.py): the apiserver
            # fault-tolerance layer's disposition
            try:
                payload["fault_tolerance"] = fault()
            except Exception as e:  # noqa: BLE001
                payload["fault_tolerance"] = {"error": str(e)}
        if hasattr(self.client, "cache_info"):
            # per-kind informer store sizes; null = informer never
            # synced (reads fall through live) — the staleness tell
            payload["informer_cache"] = self.client.cache_info()
        if hasattr(self.client, "drift_repairs_total"):
            # watch events the resync pass had to repair — nonzero
            # means a stream silently swallowed an event
            payload["informer_drift_repairs"] = (
                self.client.drift_repairs_total()
            )
        if hasattr(self.client, "read_stats"):
            # zero-copy read path counters: cache gets/lists served,
            # cumulative list latency, indexed-list share, and how
            # many reads paid an explicit copy
            payload["informer_reads"] = self.client.read_stats()
        for var_name, fn in self._debug_vars.items():
            # registered providers (e.g. the reconciler's per-pass
            # snapshot hit rates); a broken provider must not take
            # down the whole debug surface
            try:
                value = fn()
                json.dumps(value)  # unserializable == broken provider
                payload[var_name] = value
            except Exception as e:  # noqa: BLE001
                payload[var_name] = {"error": str(e)}
        return payload

    def drain_shard_keys(self, pred, timeout: float = 5.0) -> int:
        """Shard-handoff drain: drop pending keys matching ``pred`` and
        wait for matching in-flight keys to finish. Called from the
        shard lease manager's loss callback AFTER ownership flipped (the
        router is already dropping the shard's events), so when this
        returns the lost shard has no work pending, queued or running on
        this replica."""
        removed = self.queue.remove_if(pred)
        if not self.queue.wait_idle(pred, timeout):
            log.warning(
                "shard drain timed out with matching key(s) still in "
                "flight; the ownership re-check at dispatch skips them"
            )
        return len(removed)

    # ------------------------------------------------------------------
    def start(self) -> None:
        # per-shard leases first: a sharded replica must know which
        # shards it owns BEFORE its informers list (the Node/Pod scope
        # predicates read ownership) and before the first reconcile
        if self.shard_lease_manager is not None:
            self.shard_lease_manager.start()
        if self.metrics_port:
            try:
                from prometheus_client import start_http_server

                # newer prometheus_client returns (httpd, thread); keep
                # the handle so stop() can release the port
                started = start_http_server(self.metrics_port)
                if isinstance(started, tuple) and started:
                    self._metrics_httpd = started[0]
            except Exception:
                log.exception("metrics server failed to start")
        # stall-watchdog monitor: /healthz flipping is passive (it needs
        # a probe to ask) — this thread actively notices the flip and
        # dumps the flight recorder ONCE per stall episode, so the
        # post-mortem timeline exists even when the kubelet restart
        # destroys the process moments later
        def _watchdog_monitor():
            tripped = False
            interval = min(5.0, max(0.2, self.pass_deadline_s / 10.0))
            while not self._stop.is_set():
                stalled = self.stalled()
                if stalled and not tripped:
                    tripped = True
                    self._stall_dumps += 1
                    oldest = self._oldest_inflight()
                    wedged = (
                        self.format_key(oldest[0])
                        if oldest is not None
                        else None
                    )
                    flight.record(
                        "watchdog.stall",
                        inflight=wedged,
                        deadline_s=self.pass_deadline_s,
                    )
                    flight.RECORDER.dump(
                        "watchdog-stall",
                        detail=(
                            f"reconcile {wedged!r} in flight "
                            f"> {self.pass_deadline_s}s"
                        ),
                        extra=self.watchdog_stats(),
                    )
                elif not stalled:
                    tripped = False
                self._stop.wait(interval)

        t = threading.Thread(
            target=_watchdog_monitor, name="watchdog", daemon=True
        )
        t.start()
        self._threads.append(t)
        if self.probe_port:
            handler = type("H", (_HealthHandler,), {"manager": self})
            server = ThreadingHTTPServer(("0.0.0.0", self.probe_port), handler)
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            self._threads.append(t)
        if self.leader_election:
            elector = LeaderElector(
                self.client, self.namespace, lease_seconds=self.lease_seconds
            )
            log.info("waiting for leader lease as %s", elector.identity)
            while not self._stop.is_set() and not elector.try_acquire():
                time.sleep(2)
            # keep renewing in the background; losing the lease means
            # another replica took over — stop reconciling and let the pod
            # restart into candidate state (controller-runtime exits on lost
            # leadership for the same reason: two actors reconciling the
            # same CR race each other)
            def renew():
                misses = 0
                while not self._stop.is_set():
                    try:
                        acquired = elector.try_acquire()
                    except Exception:
                        # transient apiserver failure: count it like a lost
                        # renew — persisting past the lease duration must
                        # stop this replica, never kill the renew thread
                        log.exception("lease renewal attempt failed")
                        acquired = False
                    if acquired:
                        misses = 0
                    else:
                        misses += 1
                        if misses >= 2:
                            log.error(
                                "leader lease lost (holder changed or "
                                "apiserver unreachable); stopping manager"
                            )
                            self.stop()
                            return
                    time.sleep(max(1, elector.lease_seconds // 3))

            t = threading.Thread(target=renew, daemon=True)
            t.start()
            self._threads.append(t)
        if hasattr(self.client, "start_informers"):
            # warm the informer cache before the first reconcile so the
            # hot loop reads O(1) from the start (controller-runtime's
            # WaitForCacheSync before workers, main.go:155); on timeout
            # the cache degrades to live passthrough, never to staleness
            synced = self.client.start_informers(self._stop)
            if not synced:
                log.warning("informer cache did not fully sync; reads degrade to live")
        for i in range(self.workers):
            worker = threading.Thread(
                target=self._run_worker,
                args=(i,),
                name=f"reconcile-worker-{i}",
                daemon=True,
            )
            worker.start()
            self._threads.append(worker)

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self.stop())

    def stop(self) -> None:
        self._stop.set()
        if not self._stop_hooks_ran:
            self._stop_hooks_ran = True
            for fn in self._stop_hooks:
                try:
                    fn()
                except Exception:
                    log.exception("stop hook failed")
        # shard leases released AFTER the stop hooks: the warm
        # journal's final save is ownership-gated (only the shard-0
        # holder may write the shared journal), so releasing first
        # would silently skip it. release=True clears the holder
        # server-side — a planned restart hands shards to peers on
        # their next tick instead of costing a full lease window.
        if self.shard_lease_manager is not None:
            try:
                self.shard_lease_manager.stop(release=True)
            except Exception:
                log.exception("shard lease manager stop failed")
        # graceful cache shutdown: join informer + resync threads so no
        # loop LISTs a dead apiserver after the manager stops (the
        # reference's manager stops its cache before Start returns,
        # main.go:88-108)
        if hasattr(self.client, "stop"):
            try:
                self.client.stop()
            except Exception:
                log.exception("cache stop failed")
        if self._metrics_httpd is not None:
            try:
                self._metrics_httpd.shutdown()
                # shutdown() only ends serve_forever; the listening
                # socket stays bound until server_close()
                self._metrics_httpd.server_close()
            except Exception:
                log.debug("metrics server shutdown failed", exc_info=True)
            self._metrics_httpd = None

    def run_forever(self) -> None:
        self.start()
        while not self._stop.is_set():
            time.sleep(0.5)

    # ------------------------------------------------------------------
    def _run_worker(self, widx: int = 0) -> None:
        """One of M queue consumers (reference: MaxConcurrentReconciles,
        ``controllers/clusterpolicy_controller.go:319`` runs 1; the keyed
        delta queue runs ``self.workers``). Ordering safety lives in the
        QUEUE, not here: the processing set keeps one key on one worker,
        and full-pass barrier keys drain the pool before running alone —
        so N workers only ever overlap INDEPENDENT node/slice deltas."""
        while not self._stop.is_set():
            item = None
            got = False
            try:
                item = self.queue.get(timeout=0.5)
                if item is None:
                    continue
                got = True
                fn, arg = self._resolve(item)
                if fn is None:
                    continue
                # watchdog bracket: the probe thread reads these to tell
                # a wedged pass from a busy one
                with self._inflight_lock:
                    self._inflight[widx] = (item, time.monotonic())
                try:
                    result = fn(arg)
                    self.rate_limiter.forget(item)
                    requeue = getattr(result, "requeue_after", None)
                    if requeue:
                        self.queue.add(item, requeue)
                    else:
                        resync = self._resync_s.get(item)
                        if resync:
                            # converged full pass: park the safety-net
                            # re-add — the low-frequency resync must
                            # still converge anything the delta router
                            # dropped (an event supersedes the timer)
                            self.queue.add(item, resync)
                    self._last_reconcile_ok = True
                except Exception:
                    log.exception(
                        "reconcile %s failed", self.format_key(item)
                    )
                    self._last_reconcile_ok = False
                    self.queue.add(item, self.rate_limiter.when(item))
                finally:
                    with self._inflight_lock:
                        self._inflight.pop(widx, None)
                    self._last_progress = time.monotonic()
            except Exception:
                # a bug in the queue/limiter machinery must never silently
                # kill a worker while probes keep reporting healthy
                # (controller-runtime's panic would crash the whole process
                # and restart the pod; a dead daemon thread here would just
                # shrink the pool forever)
                log.exception("worker loop error; continuing")
                self._last_reconcile_ok = False
                if item is not None:
                    # keep level-triggered retry semantics: without this,
                    # the in-flight key is lost until an external event
                    # re-enqueues it
                    try:
                        self.queue.add(item, 1.0)
                    except Exception:
                        log.exception(
                            "failed to requeue %s", self.format_key(item)
                        )
                self._stop.wait(1)
            finally:
                if got:
                    try:
                        self.queue.task_done(item)
                    except Exception:
                        log.exception("task_done bookkeeping failed")
