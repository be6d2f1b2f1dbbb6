"""Sharded horizontal scale-out.

The port's copy of ``tpu_operator/shard.py``, whole. The reference
operator is single-replica by design: one leader-elected manager
reconciling one cluster-scoped CR. After the delta-reconcile work the
event path is O(events) — but every event, every informer
store and the one write pipeline still live in ONE process. This module
converts that into N cooperating operator replicas:

* **shard space** — a fixed ring of ``GPU_SHARDS`` shards. A node's
  shard is the stable hash of its *slice identity*
  (``slice_id_for_node``), so a multi-host slice and every member host
  always land on ONE shard — the per-slice readiness aggregate never
  needs cross-shard reads. Ownership moves between replicas by lease,
  never by resizing the ring, so assignment is consistent across
  replicas by construction (every replica computes the same hash).
* **per-shard Leases** — :class:`ShardLeaseManager` extends the
  manager's ``LeaderElector`` from one global lease to one lease per
  shard (``gpu-operator-shard-<i>``): each replica greedily acquires
  free/expired shard leases up to ``GPU_SHARD_MAX`` and renews what it
  holds. Losing a renewal (another holder, apiserver partition) drops
  the shard *immediately* — the queue is drained of that shard's keys
  and the in-flight set settles before the loss callback returns, so a
  drained key never runs concurrently with the new owner's.
* **shard-0 pinning** — full-pass work (CR render, rollout
  orchestration, disruption-budget arithmetic, CR status) runs ONLY on
  the replica holding shard 0, keeping the three-consumer
  ``maxUnavailable`` pool a single global arbiter. Every budgeted pass
  re-confirms the shard-0 lease with a LIVE read first
  (:meth:`ShardLeaseManager.confirm_full_pass_owner`) — a stale holder
  whose lease was taken over degrades to a scoped worker instead of
  double-draining (the split-brain guard).
* **event routing** — the delta ``EventRouter`` drops events for keys
  outside the replica's owned shards before they enqueue
  (``shard_events_dropped_total``); per-shard routed counts feed the
  balance check the bench gate rides.

Leases are deliberately NOT served from the informer cache (see
``kube/cache.default_cache_specs``) — every acquire/renew/confirm is a
live read, the same reason the global leader election reads live.

Disabled entirely unless ``GPU_SHARDS`` > 1; the default single-process
operator never constructs any of this.

What the port decides here (with ``manager.py``'s decisions):

* Internal names stay the reference's: ``HashRing``,
  ``ShardLeaseManager``, ``node_slice_identity``, ``FULL_PASS_SHARD`` and
  ``DEFAULT_LEASE_S``.
* The variables are ``GPU_SHARDS``, ``GPU_SHARD_MAX`` and
  ``GPU_SHARD_LEASE_S`` (the reference's ``TPU_*``), and the Leases
  ``gpu-operator-shard-<i>`` (``SHARD_LEASE_PREFIX``; the reference's
  ``tpu-operator-shard-``), so a port replica never takes a reference
  replica's shard in the shared namespace.
* The ring is the reference's sha1 ring. Slice ids and node names cross
  ``convert`` unchanged, so both packages put every key on one shard.
* ``node_slice_identity`` reads the port's ``slice_id_for_node``: a GPU
  node's host count comes from the slice-hosts label alone, and the
  members of a multi-host slice land on their slice's shard.
* The import of ``manager.LeaderElector`` stays lazy, as the reference's.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Set

# per-shard journal slicing lives beside the journal itself (kube/warm:
# kube may not import upward); re-exported here as the sharding API
from tpu_operator_torch.kube.warm import journal_shard_slice  # noqa: F401
from tpu_operator_torch.obs import flight

log = logging.getLogger("gpu-operator.shard")

SHARD_LEASE_PREFIX = "gpu-operator-shard-"
# the shard whose holder runs the fleet-global full pass (render,
# rollout, budget arithmetic, CR status) — ONE global arbiter
FULL_PASS_SHARD = 0

DEFAULT_LEASE_S = 15


def shards_enabled() -> int:
    """Shard count from ``GPU_SHARDS``; 0/1/unset = sharding disabled."""
    try:
        n = int(os.environ.get("GPU_SHARDS", "0"))
    except ValueError:
        return 0
    return n if n > 1 else 0


def default_max_shards(shards: int) -> int:
    """Per-replica ownership cap from ``GPU_SHARD_MAX`` (default: all —
    a lone replica owns the whole ring and behaves like the
    single-process operator)."""
    try:
        n = int(os.environ.get("GPU_SHARD_MAX", "0"))
    except ValueError:
        n = 0
    return n if n > 0 else shards


def default_lease_seconds() -> int:
    try:
        return max(2, int(os.environ.get("GPU_SHARD_LEASE_S", str(DEFAULT_LEASE_S))))
    except ValueError:
        return DEFAULT_LEASE_S


class HashRing:
    """Stable hash over a fixed shard space.

    sha1 (not Python ``hash``: that is salted per process, and two
    replicas MUST compute identical assignments) of the key's bytes onto
    ``shards`` buckets. The ring never resizes at runtime — ownership
    rebalancing happens by moving *leases* between replicas, which is
    what makes assignment consistent: a key's shard never changes, only
    the shard's owner does."""

    def __init__(self, shards: int):
        self.shards = max(1, int(shards))

    def shard_of(self, key: str) -> int:
        digest = hashlib.sha1(str(key).encode()).digest()
        return int.from_bytes(digest[:8], "big") % self.shards


def node_slice_identity(node: dict) -> str:
    """The shard key for a node: its slice identity, so every member
    host of a multi-host slice shares one shard with the slice itself."""
    from tpu_operator_torch.controllers.slice_status import slice_id_for_node

    try:
        return slice_id_for_node(node) or node["metadata"]["name"]
    except Exception:
        return node.get("metadata", {}).get("name", "")


class ShardLeaseManager:
    """Per-shard Lease ownership for one operator replica.

    The cross-process half of the scale-out: extends
    ``manager.LeaderElector`` from one global lease to one lease per
    shard. ``start()`` runs one synchronous acquisition round (so a
    fresh replica knows its shards before its informers list) and then a
    background renew/acquire loop at ``lease_seconds / 3``.

    Thread-safety: ``_owned`` and the node→shard map are read from the
    reconcile workers and the event-router hook threads; the tick runs
    on its own thread. All shared state sits under ``_lock``; the
    gain/lose callbacks run OUTSIDE it (they drain queues and touch the
    client)."""

    def __init__(
        self,
        client,
        namespace: str,
        shards: int,
        identity: Optional[str] = None,
        lease_seconds: Optional[int] = None,
        max_shards: Optional[int] = None,
        takeover_full: bool = True,
    ):
        from tpu_operator_torch.manager import LeaderElector, default_leader_identity

        self.client = client
        self.namespace = namespace
        self.shards = int(shards)
        self.ring = HashRing(shards)
        self.identity = identity or default_leader_identity()
        self.lease_seconds = lease_seconds or default_lease_seconds()
        self.max_shards = (
            max_shards if max_shards is not None else default_max_shards(shards)
        )
        # shard 0 orphaned (its holder died) may always be taken over,
        # even past max_shards: the fleet must never sit without its one
        # global arbiter because every replica is "full"
        self.takeover_full = takeover_full
        self._electors = {
            i: LeaderElector(
                client,
                namespace,
                name=f"{SHARD_LEASE_PREFIX}{i}",
                identity=self.identity,
                lease_seconds=self.lease_seconds,
            )
            for i in range(self.shards)
        }
        self._lock = threading.Lock()
        self._owned: Set[int] = set()
        # consecutive unproven renewals per shard (see tick): a renewal
        # that failed WITHOUT evidence of a takeover is an apiserver
        # transient until the lease could actually have expired
        self._renew_misses: Dict[int, int] = {}
        # shard -> True while some OTHER live (unexpired) holder has it;
        # refreshed each tick — the full-pass owner's write-coverage
        # fallback (an orphaned shard's labels are its to converge)
        self._held_by_other: Dict[int, bool] = {}
        # node name -> shard, maintained from node OBJECTS (the slice
        # identity needs labels); name-only lookups fall back to
        # hashing the name, which is exact for single-host slices
        self._node_shard: Dict[str, int] = {}
        self.on_gain: List[Callable[[int], None]] = []
        self.on_lose: List[Callable[[int], None]] = []
        self.handoffs_total = 0
        self.events_dropped_total = 0
        self.events_routed: Dict[int, int] = {}
        self.fenced_passes = 0
        self.failover: Dict[str, object] = {}
        # wired by build_manager: the OperatorMetrics instance the tick
        # publishes shard_ownership / handoff / dropped gauges into
        self.metrics = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ring helpers ----------------------------------------------------
    def shard_of_slice(self, sid: str) -> int:
        return self.ring.shard_of(sid)

    def shard_of_node_obj(self, node: dict) -> int:
        name = node.get("metadata", {}).get("name", "")
        shard = self.ring.shard_of(node_slice_identity(node))
        if name:
            with self._lock:
                self._node_shard[name] = shard
        return shard

    def note_node(self, name: str, shard: int) -> None:
        with self._lock:
            self._node_shard[name] = shard

    def forget_node(self, name: str) -> None:
        with self._lock:
            self._node_shard.pop(name, None)

    def shard_of_node_name(self, name: str) -> int:
        with self._lock:
            shard = self._node_shard.get(name)
        # unmapped name: hash the name itself — exact for single-host
        # slices (sid == node name), a safe routing default otherwise
        return shard if shard is not None else self.ring.shard_of(name)

    # -- ownership -------------------------------------------------------
    def owned(self) -> Set[int]:
        with self._lock:
            return set(self._owned)

    def owns(self, shard: int) -> bool:
        with self._lock:
            return shard in self._owned

    def owns_full_pass(self) -> bool:
        return self.owns(FULL_PASS_SHARD)

    def owns_slice(self, sid: str) -> bool:
        return self.owns(self.shard_of_slice(sid))

    def owns_node_name(self, name: str) -> bool:
        return self.owns(self.shard_of_node_name(name))

    def owns_node_obj(self, node: dict) -> bool:
        return self.owns(self.shard_of_node_obj(node))

    def keep_node(self, node: dict) -> bool:
        """Informer scope predicate for the Node store: the full-pass
        owner mirrors the whole fleet (global budget/status need it);
        scoped workers mirror only their shards."""
        if self.owns_full_pass():
            return True
        return self.owns_node_obj(node)

    def keep_pod(self, pod: dict) -> bool:
        """Informer scope predicate for the Pod store (composed on top
        of the namespace/card scope filter). Unmapped node names are
        KEPT — dropping a pod we cannot attribute would be wrong, and
        the map converges as node events flow."""
        if self.owns_full_pass():
            return True
        name = pod.get("spec", {}).get("nodeName") or ""
        if not name:
            return True
        with self._lock:
            shard = self._node_shard.get(name)
        if shard is None:
            return True
        return self.owns(shard)

    # -- write coverage (label/verdict gating) ---------------------------
    def covers_node_obj(self, node: dict) -> bool:
        """Should THIS replica write this node's operator labels?
        Owned → yes. Not owned but the shard's lease is vacant/expired →
        yes IF we hold the full pass (shard 0 is the safety net for
        orphaned shards, so a dead replica's nodes still converge)."""
        shard = self.shard_of_node_obj(node)
        if self.owns(shard):
            return True
        if not self.owns_full_pass():
            return False
        with self._lock:
            return not self._held_by_other.get(shard, False)

    def covers_slice(self, sid: str) -> bool:
        shard = self.shard_of_slice(sid)
        if self.owns(shard):
            return True
        if not self.owns_full_pass():
            return False
        with self._lock:
            return not self._held_by_other.get(shard, False)

    # -- router accounting -----------------------------------------------
    def note_event_dropped(self) -> None:
        with self._lock:
            self.events_dropped_total += 1

    def note_event_routed(self, shard: int) -> None:
        with self._lock:
            self.events_routed[shard] = self.events_routed.get(shard, 0) + 1

    # -- the split-brain guard -------------------------------------------
    def confirm_full_pass_owner(self) -> bool:
        """LIVE re-check of the shard-0 lease before budgeted work.

        A replica that lost shard 0 between ticks (lease taken over
        while it was mid-pass) must not run the disruption-budget
        arbiter concurrently with the new owner: the budget math admits
        against a cap, and two arbiters each admitting under the cap
        jointly exceed it. The check reads the Lease live (never the
        informer cache) and on failure demotes this replica immediately
        — the caller degrades the pass to scoped-worker work."""
        if not self.owns_full_pass():
            return False
        try:
            holder = self._electors[FULL_PASS_SHARD].current_holder()
        except Exception:
            # unreadable lease (partition): fail CLOSED — skipping one
            # budget pass is safe, double-draining is not. But do NOT
            # demote: no peer could acquire through the same partition
            # either, and a spurious _lose tears down the whole-world
            # mirror for a full re-adopt (the same reason tick()
            # tolerates unproven renewals)
            log.warning("shard-0 lease unreadable; fencing this pass")
            with self._lock:
                self.fenced_passes += 1
            return False
        if holder == self.identity:
            return True
        with self._lock:
            self.fenced_passes += 1
        if holder is not None:
            # DEFINITIVE takeover (another live holder): demote now —
            # the expired/unheld case is left to tick()'s two-miss
            # tenure logic, which re-renews far more often than a peer
            # could steal
            self._lose(FULL_PASS_SHARD, reason="fenced")
        return False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self.tick()  # synchronous first round: know our shards up front
        interval = max(1.0, self.lease_seconds / 3.0)

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.tick()
                except Exception:
                    log.exception("shard lease tick failed")

        self._thread = threading.Thread(
            target=loop, name="shard-leases", daemon=True
        )
        self._thread.start()

    def stop(self, release: bool = False) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        if release:
            for shard in sorted(self.owned()):
                self._release_lease(shard)
                self._lose(shard, reason="shutdown")

    def _release_lease(self, shard: int) -> None:
        """Clear the holder SERVER-SIDE on graceful shutdown so peers
        see vacancy on their next tick instead of waiting out a full
        lease window — a planned rolling restart must not cost the
        fleet its shard-0 arbiter for GPU_SHARD_LEASE_S like a crash
        does. Best-effort: a failed release just degrades to expiry."""
        elector = self._electors[shard]
        try:
            lease = self.client.get_or_none(
                "coordination.k8s.io/v1",
                "Lease",
                elector.name,
                self.namespace,
            )
            if lease is None:
                return
            spec = (lease.get("spec") or {})
            if spec.get("holderIdentity") != self.identity:
                return  # someone else's lease: never clobber it
            from tpu_operator_torch.kube.frozen import thaw

            lease = thaw(lease)
            lease["spec"]["holderIdentity"] = ""
            self.client.update(lease)
        except Exception:
            log.debug(
                "shard %d lease release failed; peers wait out expiry",
                shard,
                exc_info=True,
            )

    def tick(self) -> None:
        """One acquisition/renewal round over every shard lease."""
        for i in range(self.shards):
            if self._stop.is_set():
                return
            elector = self._electors[i]
            if self.owns(i):
                try:
                    renewed = elector.try_acquire()
                except Exception:
                    log.exception("shard %d lease renewal failed", i)
                    renewed = False
                if renewed:
                    with self._lock:
                        self._renew_misses.pop(i, None)
                        self._held_by_other[i] = False
                    continue
                # a failed renewal is only DEFINITIVE when the lease
                # names another live holder — drop immediately then
                # (continuing to process a taken-over shard is the
                # split-brain). Otherwise it may be an apiserver
                # transient (a slammed server at fleet bootstrap):
                # kubernetes leader election keeps retrying inside the
                # lease window for the same reason, and a spurious drop
                # here costs a full handoff + re-seed. We lose only
                # once tenure is UNPROVEN for two consecutive ticks
                # (the lease could genuinely have expired under a peer
                # by then; budgeted work re-confirms live regardless).
                holder = None
                try:
                    holder = elector.current_holder()
                except Exception:
                    pass
                if holder is not None and holder != self.identity:
                    self._lose(i, reason="taken-over")
                elif holder == self.identity:
                    with self._lock:
                        self._renew_misses.pop(i, None)
                else:
                    with self._lock:
                        self._renew_misses[i] = (
                            self._renew_misses.get(i, 0) + 1
                        )
                        expired = self._renew_misses[i] >= 2
                    if expired:
                        self._lose(i, reason="renewal-expired")
                continue
            vacant = self._vacant(elector)
            with self._lock:
                self._held_by_other[i] = not vacant
                want = len(self._owned) < self.max_shards or (
                    i == FULL_PASS_SHARD and self.takeover_full
                )
            if not (vacant and want):
                continue
            try:
                got = elector.try_acquire()
            except Exception:
                log.exception("shard %d lease acquire failed", i)
                got = False
            if got:
                self._gain(i)
        self.publish_metrics(self.metrics)

    def _vacant(self, elector) -> bool:
        """Lease free, expired, or already ours."""
        try:
            holder = elector.current_holder()
        except Exception:
            return False
        return holder is None or holder == self.identity

    def _gain(self, shard: int) -> None:
        with self._lock:
            if shard in self._owned:
                return
            self._owned.add(shard)
            self._held_by_other[shard] = False
        log.info("acquired shard lease %d (%s)", shard, self.identity)
        flight.record("lease.acquire", shard=shard, identity=self.identity)
        for fn in list(self.on_gain):
            try:
                fn(shard)
            except Exception:
                log.exception("shard %d gain callback failed", shard)

    def _lose(self, shard: int, reason: str = "") -> None:
        with self._lock:
            if shard not in self._owned:
                return
            self._owned.discard(shard)
            self._held_by_other[shard] = True
            self.handoffs_total += 1
        log.warning(
            "lost shard lease %d (%s): %s", shard, self.identity, reason
        )
        flight.record(
            "lease.lose", shard=shard, identity=self.identity, why=reason
        )
        flight.record("shard.handoff", shard=shard, from_=self.identity)
        # loss callbacks run AFTER ownership flipped: the router is
        # already dropping this shard's events, and the drain callback
        # can therefore empty the queue without racing new enqueues
        for fn in list(self.on_lose):
            try:
                fn(shard)
            except Exception:
                log.exception("shard %d loss callback failed", shard)

    # -- observability ---------------------------------------------------
    def publish_metrics(self, metrics) -> None:
        if metrics is None:
            return
        gauge = getattr(metrics, "shard_ownership", None)
        if gauge is not None:
            owned = self.owned()
            for i in range(self.shards):
                gauge.labels(shard=str(i)).set(1 if i in owned else 0)
        with self._lock:
            handoffs = self.handoffs_total
            dropped = self.events_dropped_total
        if getattr(metrics, "shard_handoff_total", None) is not None:
            metrics.shard_handoff_total.set(handoffs)
        if getattr(metrics, "shard_events_dropped_total", None) is not None:
            metrics.shard_events_dropped_total.set(dropped)

    def stats(self) -> Dict[str, object]:
        """/debug/vars ``shards`` payload."""
        with self._lock:
            return {
                "enabled": True,
                "shards": self.shards,
                "identity": self.identity,
                "owned": sorted(self._owned),
                "owns_full_pass": FULL_PASS_SHARD in self._owned,
                "max_shards": self.max_shards,
                "lease_seconds": self.lease_seconds,
                "handoffs_total": self.handoffs_total,
                "events_dropped_total": self.events_dropped_total,
                "events_routed": {
                    str(k): v for k, v in sorted(self.events_routed.items())
                },
                "fenced_passes": self.fenced_passes,
                "node_map_size": len(self._node_shard),
                "failover": dict(self.failover),
            }


