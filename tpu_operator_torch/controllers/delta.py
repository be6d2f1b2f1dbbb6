"""Event-scoped delta reconciliation.

The port's copy of ``tpu_operator/controllers/delta.py``, whole. A full
pass over the 18 states costs O(fleet); the reference model is
per-object (``Reconcile(ctx, req)`` driven by watch predicates feeding a
keyed workqueue). This module is that shape for the level-triggered
reconciler, in two halves:

* :class:`EventRouter` maps each watch event to the *minimal* affected
  unit as a typed queue key, with predicates dropping no-op deliveries
  (status-only CR echoes, irrelevant label churn) before they enqueue:

  ============================  =======================================
  event                         routed key
  ============================  =======================================
  node label/status change      ``("node", name)`` — that node's label
                                FSM step (+ its slice when the change is
                                readiness-relevant)
  pod (validator) transition    ``("slice", sid)`` — its slice's
                                readiness aggregate
  node DELETE                   ``("node", name)`` + ``("slice", sid)``
                                — ledger prune + slice regroup at event
                                speed (plus the upgrade wake)
  CR generation/spec change     full render pass (barrier key)
  card facts change (join,      full pass — cluster facts (variant
  variant flip)                 set, counts) feed the render fan-out
  ============================  =======================================

* :class:`DeltaReconciler` holds the per-key entry points
  (``reconcile_node``/``reconcile_slice``) that reuse the label lane, the
  slice aggregation and the write pipeline but read and write only the
  keyed unit. Anything needing fleet context (the budgeted remediation
  FSM, slice formation on join) escalates to the full pass.

The periodic full pass is a low-frequency resync safety net
(``RECONCILE_RESYNC_S``, default 300 s) that still converges anything the
delta path missed.

What the port decides here (the reconcilers' decisions, also in
``clusterpolicy_controller.py``, ``rollout.py`` and ROADMAP):

* Internal names stay the reference's (``DeltaReconciler``,
  ``EventRouter``, the key kinds, the ``delta.reconcile`` span).
* The router's switch is ``GPU_DELTA_RECONCILE`` (``DELTA_RECONCILE_ENV``;
  the reference's ``TPU_DELTA_RECONCILE``): ``GPU_DELTA_RECONCILE=0``
  routes every event to the full-pass keys. ``RECONCILE_RESYNC_S`` names
  no accelerator and stays.
* ``_on_pod`` routes a pod whose ``app`` starts with
  ``consts.OPERAND_APP_PREFIX`` (``gpu-``; the reference's literal
  ``tpu-``), so a crash-looping ``gpu-*`` operand wakes a sub-reconcile
  and a user pod does not.
* ``_READINESS_LABELS`` drops the reference's GKE topology label: a GPU
  node's host count comes from the slice-hosts label alone. The node-pool
  label stays, because ``slice_id_for_node`` reads it.
* ``wake_full``, ``enqueue_slice`` and ``enqueue_status`` stay ``None``
  until a manager wires them; every path tolerates that, as the
  reference's does. Sharded mode (``_owns``, ``invalidate_context``,
  ``ingest_foreign_verdict``, ``EventRouter._shard_allows``) is ported
  whole and idle while ``shard_state`` is ``None``.
* The imports of ``clusterpolicy_controller`` stay lazy: that module
  builds this one's ``DeltaReconciler``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.obs import trace

log = logging.getLogger("gpu-operator.delta")

# the router's switch: the reference's TPU_DELTA_RECONCILE
DELTA_RECONCILE_ENV = "GPU_DELTA_RECONCILE"

NODE_KIND = "node"
SLICE_KIND = "slice"

# node labels whose change flips a slice's readiness verdict (or its
# identity/expected-host math) without touching cluster facts: route to
# the slice aggregate, not the full pass. A GPU node's host count comes
# from the slice-hosts label alone; the node-pool label feeds
# slice_id_for_node when feature discovery has not stamped a slice id.
_READINESS_LABELS = (
    consts.MAINTENANCE_STATE_LABEL,
    consts.REMEDIATION_STATE_LABEL,
    consts.REPARTITION_STATE_LABEL,
    consts.SLICE_READY_LABEL,
    consts.TFD_SLICE_HOSTS_LABEL,
    consts.GKE_NODEPOOL_LABEL,
)


def delta_enabled() -> bool:
    """Router default from ``GPU_DELTA_RECONCILE`` (on unless 0/false)."""
    return os.environ.get(DELTA_RECONCILE_ENV, "1").lower() not in (
        "0",
        "false",
        "off",
    )


def default_resync_s() -> float:
    """Full-pass safety-net cadence (``RECONCILE_RESYNC_S``, 300 s)."""
    try:
        return float(os.environ.get("RECONCILE_RESYNC_S", "300"))
    except ValueError:
        return 300.0


def _labels(obj: Optional[dict]) -> dict:
    return ((obj or {}).get("metadata", {}).get("labels") or {}) if obj else {}


class DeltaReconciler:
    """Targeted sub-reconciles riding the keyed workqueue.

    Owned by the :class:`ClusterPolicyReconciler`; the full pass feeds it
    the authoritative slice aggregate (``note_full_pass``) and the delta
    passes keep that mirror — and ``status.slices`` — current at event
    speed between full passes. All shared state sits under ``_lock``
    because independent keys run on different workers concurrently (the
    queue only serializes per key)."""

    def __init__(self, reconciler):
        self.rec = reconciler
        self.client = reconciler.client
        # wired by build_manager: wake the full pass / enqueue a slice
        # key / schedule a coalesced status publish (the delta path
        # itself has no queue handle)
        self.wake_full = None
        self.enqueue_slice = None
        self.enqueue_status = None
        self._lock = threading.Lock()
        # one status.slices writer at a time: concurrent slice workers
        # would otherwise trade 409s on the CR for no information
        self._status_lock = threading.Lock()
        # sid -> SliceInfo: mirror of the last authoritative aggregate,
        # per-slice entries replaced by slice sub-reconciles
        self._slices: Dict[str, object] = {}
        # sid -> ready: verdicts INGESTED from other replicas' label
        # writes (sharded mode, full-pass owner only) — status.slices
        # stays event-fresh for shards this replica doesn't recompute;
        # cleared whenever a full aggregation re-seeds the mirror
        self._foreign: Dict[str, bool] = {}
        self._have_full = False
        # sub-reconciles dispatched for keys this replica no longer
        # owns (a handoff raced the queue): skipped, counted
        self.shard_skips = 0
        # counters (under _lock: sub-reconciles run on N workers)
        self.node_passes = 0
        self.slice_passes = 0
        self.delta_ms_total = 0.0
        self.escalations = 0
        self.status_writes = 0
        self.last: Dict[str, object] = {}

    # ------------------------------------------------------------------
    # full-pass handshake
    # ------------------------------------------------------------------
    def note_full_pass(self, slice_summary) -> None:
        """Seed the slice mirror from a completed full aggregation —
        the delta path refines per-slice entries from here on.

        Sharded takeover race: a SCOPED pass that was already in flight
        when this replica gained shard 0 would otherwise re-mark its
        one-shard mirror as full context right after the takeover's
        ``invalidate_context`` — and the new owner would publish a
        shrunken global ``status.slices`` from it. A scoped summary may
        only seed context while this replica is NOT the full-pass
        owner."""
        if slice_summary is None:
            return
        sm = self._shard_state()
        if (
            getattr(self.rec, "_scoped_pass_active", False)
            and sm is not None
            and sm.owns_full_pass()
        ):
            return
        with self._lock:
            self._slices = dict(slice_summary.slices)
            self._foreign.clear()
            self._have_full = True

    # ------------------------------------------------------------------
    # sharded scale-out helpers
    # ------------------------------------------------------------------
    def _shard_state(self):
        return getattr(self.rec, "shard_state", None)

    def _owns(self, kind: str, key: str) -> bool:
        """Dispatch-time ownership re-check: a key enqueued before a
        handoff may dispatch after it — skipping is always safe (the
        new owner re-derives from its own events/resync), running is
        the overlap the handoff contract forbids."""
        sm = self._shard_state()
        if sm is None:
            return True
        owned = (
            sm.owns_node_name(key)
            if kind == NODE_KIND
            else sm.owns_slice(key)
        )
        if not owned:
            with self._lock:
                self.shard_skips += 1
        return owned

    def invalidate_context(self) -> None:
        """Drop the full-pass context (sharded takeover of shard 0): a
        mirror seeded by a SCOPED pass holds a partial world, and
        publishing global status from it would shrink ``status.slices``
        to one shard's counts — every delta path escalates/holds until
        the first GLOBAL aggregation re-seeds."""
        with self._lock:
            self._have_full = False
            self._slices = {}
            self._foreign.clear()

    def ingest_foreign_verdict(self, sid: str, ready: bool) -> None:
        """A non-owned slice's verdict label, written by its owning
        replica and observed through the watch: fold it into
        ``status.slices`` without recomputing the slice (O(1) — the
        owner already did the O(members) work). Context-gated like
        every other status path: before the first GLOBAL aggregation
        the mirror is empty/partial and publishing from it would
        overwrite a correct block with a shrunken one."""
        if not self._context_ready():
            return
        with self._lock:
            if self._foreign.get(sid) == ready:
                return
            self._foreign[sid] = ready
        enq = self.enqueue_status
        if enq is not None:
            # this runs on the WATCH-DISPATCH hook thread: a blocking
            # CR status write here would stall event ingestion for
            # every kind behind one slow apiserver round-trip — hand
            # the publish to the workqueue (same-key bursts coalesce)
            enq()
        else:
            self._publish_status()

    def publish_status_now(self):
        """Keyed-queue entry point for the coalesced status publish."""
        self._publish_status()
        return None

    def _context_ready(self) -> bool:
        ctrl = self.rec.ctrl
        return bool(
            self.rec.passes_total >= 1
            and ctrl.cp_obj
            and ctrl.namespace
            and self._have_full
        )

    def _escalate(self, why: str, delay: float = 0.0) -> None:
        with self._lock:
            self.escalations += 1
            self.last = {"escalated": why}
        wake = self.wake_full
        if wake is not None:
            wake(delay)

    def expected_verdict(self, sid: str) -> Optional[str]:
        """The verdict the mirror believes this slice carries — the
        router's echo predicate: a node event whose ONLY change is the
        slice-ready label landing at this value is our own write
        bouncing back through the watch, not new information."""
        with self._lock:
            info = self._slices.get(sid)
        if info is None:
            return None
        return "true" if info.ready else "false"

    def remediation_enabled(self) -> bool:
        """Router hint: only when the remediation FSM is actually
        enabled does a health transition need the budgeted full pass."""
        try:
            spec = self.rec.ctrl.cp.spec.remediation
        except Exception:
            return False
        return bool(spec is not None and spec.is_enabled())

    # ------------------------------------------------------------------
    # per-node sub-reconcile
    # ------------------------------------------------------------------
    def reconcile_node(self, name: str):
        """The minimal unit for a node event: this node's operator-label
        delta (the label FSM step) through the batched label lane, or —
        on deletion — event-speed ledger pruning. Fleet context
        (remediation budget math, join-driven cluster facts) escalates
        to the full pass."""
        if not self._owns(NODE_KIND, name):
            return None
        if not self._context_ready():
            self._escalate(f"node/{name}: no full-pass context yet")
            return None
        t0 = time.perf_counter()
        with trace.span("delta.reconcile", kind=NODE_KIND, key=name):
            try:
                self._reconcile_node(name)
            finally:
                self._account(NODE_KIND, name, t0)
        return None

    def _reconcile_node(self, name: str) -> None:
        from tpu_operator_torch.controllers.state_manager import (
            _label_apply_payload,
        )

        node = self.client.get_or_none("v1", "Node", name)
        if node is None:
            self._forget_node(name)
            return
        ctrl = self.rec.ctrl
        changes = ctrl._node_label_changes(node)
        if changes:
            fut = ctrl.label_lane.submit(
                ("Node", "", name), _label_apply_payload(name, changes)
            )
            # None = the node vanished mid-label (the outcome handler
            # absorbs the 404): prune ledgers now, not at the resync
            if ctrl._label_outcome(node, changes, fut) is None:
                self._forget_node(name)
                return
        if self._needs_remediation(node):
            # the remediation FSM steps under a fleet-wide shared
            # disruption budget + systemic breaker — per-node math would
            # guess; run the budgeted pass now instead of at resync
            self._escalate(f"node/{name}: remediation-relevant", 0.05)

    def _needs_remediation(self, node: dict) -> bool:
        if not self.remediation_enabled():
            return False
        from tpu_operator_torch.controllers.slice_status import host_allocatable_ok

        if _labels(node).get(consts.REMEDIATION_STATE_LABEL):
            return True
        return host_allocatable_ok(node) is False

    def _forget_node(self, name: str) -> None:
        """Event-speed ledger prune for a vanished node: drop its
        remediation log-once state and re-aggregate every slice that
        counted it as a member (the delete storm satellite — stale
        verdicts must not wait out the resync)."""
        self.rec.remediation.forget_node(name)
        sm = self._shard_state()
        if sm is not None:
            sm.forget_node(name)
        with self._lock:
            sids = [
                sid
                for sid, info in self._slices.items()
                if name in info.member_nodes
            ]
        enqueue = self.enqueue_slice
        for sid in sids:
            if enqueue is not None:
                enqueue(sid)
            else:
                self.reconcile_slice(sid)

    # ------------------------------------------------------------------
    # per-slice sub-reconcile
    # ------------------------------------------------------------------
    def reconcile_slice(self, sid: str):
        """The minimal unit for a readiness-relevant event: recompute ONE
        slice's aggregate from live member reads, publish its verdict
        labels through the batched label lane, and fold the result into
        ``status.slices`` — O(slice members), never O(fleet)."""
        if not self._owns(SLICE_KIND, sid):
            return None
        if not self._context_ready():
            self._escalate(f"slice/{sid}: no full-pass context yet")
            return None
        t0 = time.perf_counter()
        with trace.span("delta.reconcile", kind=SLICE_KIND, key=sid):
            try:
                self._reconcile_slice(sid)
            finally:
                self._account(SLICE_KIND, sid, t0)
        return None

    def _reconcile_slice(self, sid: str) -> None:
        from tpu_operator_torch.controllers import slice_status
        from tpu_operator_torch.controllers.state_manager import has_gpu_labels

        ctrl = self.rec.ctrl
        members = self._slice_members_live(sid)
        tpu_members = [n for n in members if has_gpu_labels(n)]
        if not tpu_members:
            with self._lock:
                removed = self._slices.pop(sid, None) is not None
            if removed:
                self._publish_status()
            return
        validated = slice_status.validated_on_nodes(
            self.client,
            ctrl.namespace,
            [n["metadata"]["name"] for n in tpu_members],
        )
        summary = slice_status.aggregate(
            self.client,
            ctrl.namespace,
            tpu_members,
            validated=validated,
            lane=ctrl.label_lane,
        )
        # members were filtered to slice_id_for_node(n) == sid, and
        # group_slices re-derives keys with the same function over the
        # same views — the summary holds exactly this sid. (A member
        # whose identity CHANGED is the router's old_sid != sid path.)
        info = summary.slices.get(sid)
        with self._lock:
            if info is not None:
                self._slices[sid] = info
            else:
                self._slices.pop(sid, None)
        self._publish_status()

    def _slice_members_live(self, sid: str) -> List[dict]:
        """Fresh member node views for one slice, resolved through the
        informer indexes in O(members): the explicit TFD slice-id label,
        the GKE node-pool fallback (all hosts of one multi-host slice
        share a pool), and the node's own name for single-host slices.
        The sid computation is authoritative — candidates that compute a
        different sid are dropped."""
        from tpu_operator_torch.controllers.slice_status import slice_id_for_node

        members: Dict[str, dict] = {}
        for selector in (
            {consts.TFD_SLICE_ID_LABEL: sid},
            {consts.GKE_NODEPOOL_LABEL: sid},
        ):
            try:
                candidates = self.client.list(
                    "v1", "Node", label_selector=selector
                )
            except Exception:
                candidates = []
            for n in candidates:
                members.setdefault(n["metadata"]["name"], n)
        if sid not in members:
            single = self.client.get_or_none("v1", "Node", sid)
            if single is not None:
                members[sid] = single
        return [
            n for n in members.values() if slice_id_for_node(n) == sid
        ]

    # ------------------------------------------------------------------
    # status.slices delta writer
    # ------------------------------------------------------------------
    def _publish_status(self) -> None:
        """Fold the slice mirror into ``status.slices`` (and the slice
        gauges) — only this block: the CR ``state``/conditions/errored
        picture belongs to the full pass and is left untouched."""
        from tpu_operator_torch.controllers.clusterpolicy_controller import (
            select_primary,
        )
        from tpu_operator_torch.kube.client import ConflictError

        sm = self._shard_state()
        if sm is not None and not sm.owns_full_pass():
            # CR status belongs to the shard-0 owner (one writer for the
            # global aggregate); this replica's verdict labels are its
            # contribution — the owner ingests them from the watch
            return
        with self._lock:
            infos = list(self._slices.values())
            foreign = dict(self._foreign)
            block = {
                "total": len(infos),
                "ready": sum(
                    1 for s in infos if foreign.get(s.slice_id, s.ready)
                ),
            }
            degraded = sorted(
                s.slice_id
                for s in infos
                if not foreign.get(s.slice_id, s.ready)
            )
            if degraded:
                block["degraded"] = degraded
        metrics = self.rec.metrics
        if metrics and getattr(metrics, "slices_total", None):
            metrics.slices_total.set(block["total"])
            metrics.slices_ready.set(block["ready"])
        # one writer at a time: N slice workers racing the CR's status
        # revision would only trade 409s for no information
        with self._status_lock:
            try:
                policies = self.client.list(
                    consts.API_VERSION,
                    consts.CLUSTER_POLICY_KIND,
                    copy=True,
                )
                if not policies:
                    return
                primary, _ = select_primary(policies)
                wrote = False
                for attempt in range(3):
                    status = primary.setdefault("status", {})
                    if status.get("slices") == block:
                        wrote = attempt > 0
                        break
                    status["slices"] = block
                    try:
                        self.client.update_status(primary)
                        wrote = True
                        break
                    except ConflictError:
                        # the full pass's status writer (or a spec
                        # edit) moved the CR: re-read LIVE and re-apply
                        # only our block to the fresh revision
                        primary = getattr(
                            self.client, "get_live", self.client.get
                        )(
                            primary["apiVersion"],
                            primary["kind"],
                            primary["metadata"]["name"],
                            primary["metadata"].get("namespace", ""),
                        )
                else:
                    log.warning(
                        "delta status update lost its conflict race; "
                        "the resync pass converges it"
                    )
                if wrote:
                    with self._lock:
                        self.status_writes += 1
            except Exception:
                log.exception(
                    "delta status update failed; the resync pass "
                    "converges it"
                )

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _account(self, kind: str, key: str, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            if kind == NODE_KIND:
                self.node_passes += 1
            else:
                self.slice_passes += 1
            self.delta_ms_total += ms
            self.last = {"kind": kind, "key": key, "ms": round(ms, 3)}
        metrics = self.rec.metrics
        hist = getattr(metrics, "delta_reconcile_ms_hist", None)
        if hist is not None:
            hist.observe(ms)

    def stats(self) -> Dict[str, object]:
        """/debug/vars "delta_reconcile" payload: delta-vs-full pass
        counts and cumulative self-time, plus the router's trigger and
        drop disposition when wired."""
        with self._lock:
            out: Dict[str, object] = {
                "enabled": delta_enabled(),
                "have_full_context": self._have_full,
                "node_passes": self.node_passes,
                "slice_passes": self.slice_passes,
                "delta_passes": self.node_passes + self.slice_passes,
                "delta_ms_total": round(self.delta_ms_total, 3),
                "escalations": self.escalations,
                "status_writes": self.status_writes,
                "shard_skips": self.shard_skips,
                "slices_tracked": len(self._slices),
                "last": dict(self.last),
            }
        out["full_passes"] = self.rec.passes_total
        out["full_ms_total"] = round(
            getattr(self.rec, "full_ms_total", 0.0), 3
        )
        router = getattr(self, "router", None)
        if router is not None:
            out["router"] = router.stats()
        return out


class EventRouter:
    """Watch-event → minimal-queue-key routing with no-op predicates.

    Replaces the ``wire_event_sources`` closure: the legacy behavior
    (every relevant event wakes a full pass) is the ``enabled=False``
    branch and stays byte-compatible — the chaos soak's router-off
    variant and ``GPU_DELTA_RECONCILE=0`` both ride it."""

    def __init__(self, mgr, delta: Optional[DeltaReconciler], cp_key, upgrade_key):
        self.mgr = mgr
        self.delta = delta
        self.cp_key = cp_key
        self.upgrade_key = upgrade_key
        self.enabled = delta_enabled() and delta is not None
        # sharded scale-out (a ``shard.py`` the port has not yet ported): when the manager
        # carries a shard-ownership view, events for keys outside the
        # replica's owned shards are dropped BEFORE they enqueue — the
        # other replica that owns them sees the same watch stream
        self.shard = getattr(mgr, "shard_state", None)
        if delta is not None:
            delta.router = self
        self._lock = threading.Lock()
        # object caches for old/new diffs (the hook only carries new)
        self._node_cache: Dict[str, dict] = {}
        self._cp_cache: Dict[str, dict] = {}
        # pods currently in CrashLoopBackOff (namespace/name)
        self._crashlooping = set()
        # validator pods currently counting as Running+ready
        self._validator_ready = set()
        # nodes with an in-flight upgrade FSM label
        self._upgrading = set()
        self._upgrade_wake_states = (
            consts.UPGRADE_STATE_UPGRADE_REQUIRED,
        ) + tuple(consts.UPGRADE_ACTIVE_STATES)
        # (source, key_kind) -> count; mirrored into
        # reconcile_trigger_total{source,key_kind}
        self._triggers: Dict[tuple, int] = {}
        self.dropped_total = 0

    # ------------------------------------------------------------------
    def _count(self, source: str, key_kind: str) -> None:
        with self._lock:
            self._triggers[(source, key_kind)] = (
                self._triggers.get((source, key_kind), 0) + 1
            )
            if key_kind == "drop":
                self.dropped_total += 1
        metrics = (
            self.delta.rec.metrics if self.delta is not None else None
        )
        counter = getattr(metrics, "reconcile_triggers", None)
        if counter is not None:
            counter.labels(source=source, key_kind=key_kind).inc()

    def _fire(self, source: str, key, delay: float = 0.0) -> None:
        if key == self.cp_key:
            kind = "full"
        elif key == self.upgrade_key:
            kind = "upgrade"
        else:
            kind = key[0]
        if not self._shard_allows(key):
            # outside this replica's owned shards: the owning replica's
            # router enqueues it from the same watch stream
            self._count(source, "shard_drop")
            self.shard.note_event_dropped()
            return
        self._count(source, kind)
        self.mgr.enqueue(key, delay)

    def _shard_allows(self, key) -> bool:
        """Shard routing discipline (single choke point):

        * full-pass key — every replica (the non-owner dispatch runs
          the SCOPED shard pass: its own shards' label/verdict work);
        * upgrade key — shard-0 owner only (the FSM admits against the
          global disruption budget);
        * ``(node, name)`` / ``(slice, sid)`` — the owning replica only.
        """
        sm = self.shard
        if sm is None:
            return True
        if key == self.cp_key:
            return True
        if key == self.upgrade_key:
            return sm.owns_full_pass()
        if isinstance(key, tuple) and len(key) == 2:
            kind, name = key
            if kind == NODE_KIND:
                allowed = sm.owns_node_name(name)
            elif kind == SLICE_KIND:
                allowed = sm.owns_slice(name)
            else:
                return True
            if allowed:
                sm.note_event_routed(
                    sm.shard_of_node_name(name)
                    if kind == NODE_KIND
                    else sm.shard_of_slice(name)
                )
            return allowed
        return True

    def stats(self) -> Dict[str, object]:
        with self._lock:
            triggers = {
                f"{source}:{kind}": n
                for (source, kind), n in sorted(self._triggers.items())
            }
            return {
                "enabled": self.enabled,
                "triggers": triggers,
                "dropped_total": self.dropped_total,
            }

    # ------------------------------------------------------------------
    # the hook
    # ------------------------------------------------------------------
    def on_event(self, event: str, obj: dict) -> None:
        kind = obj.get("kind")
        if kind == "ClusterPolicy":
            self._on_clusterpolicy(event, obj)
        elif kind == "Node":
            self._on_node(event, obj)
        elif kind == "Pod":
            self._on_pod(event, obj)
        elif kind == "DaemonSet":
            # owned-operand drift (reference watch on owned DaemonSets):
            # DS status feeds per-state readiness, which only the full
            # pass aggregates; the 0.1 s delay coalesces update storms
            self._fire("daemonset", self.cp_key, 0.1)

    # -- ClusterPolicy --------------------------------------------------
    def _on_clusterpolicy(self, event: str, obj: dict) -> None:
        name = obj.get("metadata", {}).get("name", "")
        with self._lock:
            old = self._cp_cache.get(name)
            if event == "DELETED":
                self._cp_cache.pop(name, None)
            else:
                self._cp_cache[name] = obj
        if self.enabled and not self._cp_significant(event, old, obj):
            # status-only echo — our own status writer (full or delta
            # pass) bouncing back through the watch; nothing to converge
            self._count("clusterpolicy", "drop")
            return
        self._fire("clusterpolicy", self.cp_key)
        self._fire("clusterpolicy", self.upgrade_key)

    @staticmethod
    def _cp_significant(event: str, old: Optional[dict], new: dict) -> bool:
        """True when the CR change can alter desired state: spec,
        labels, annotations (the rollout ledger lives there), deletion.
        A status-only write — rv moved, everything else equal — is our
        own echo."""
        if event != "MODIFIED" or old is None:
            return True
        if old.get("spec") != new.get("spec"):
            return True
        om, nm = old.get("metadata", {}), new.get("metadata", {})
        return (
            (om.get("labels") or {}) != (nm.get("labels") or {})
            or (om.get("annotations") or {}) != (nm.get("annotations") or {})
            or om.get("generation") != nm.get("generation")
        )

    # -- Node -----------------------------------------------------------
    def _on_node(self, event: str, obj: dict) -> None:
        from tpu_operator_torch.controllers.clusterpolicy_controller import (
            node_event_needs_reconcile,
        )

        name = obj["metadata"]["name"]
        with self._lock:
            old = self._node_cache.get(name)
            if event == "DELETED":
                # drop the entry entirely: a tombstone-per-name under
                # join/preemption storms of unique node names grew this
                # cache without bound
                self._node_cache.pop(name, None)
                self._upgrading.discard(name)
            else:
                self._node_cache[name] = obj
        if event == "DELETED":
            # a node vanishing mid-upgrade must wake the upgrade
            # reconciler: its slice's budget hold releases on the next
            # build_state, and waiting out the 120 s requeue starves
            # pending sibling slices meanwhile
            self._fire("node", self.upgrade_key)
            if self.enabled:
                # delete storm satellite: ledgers prune and the slice
                # regroups at event speed, not at the resync
                self._fire("node", (NODE_KIND, name))
                sid = self._sid_of(old or obj)
                if sid:
                    self._fire("node", (SLICE_KIND, sid))
            elif node_event_needs_reconcile(event, old, obj):
                self._fire("node", self.cp_key)
            if self.shard is not None and (
                not self.enabled or not self.shard.owns_node_name(name)
            ):
                # prune the name→shard mapping wherever no delta
                # (node, name) prune will ever dispatch for it: on
                # non-owners the router just dropped the key, and with
                # the delta router disabled (GPU_DELTA_RECONCILE=0) the
                # keyed path is off EVERYWHERE — without this,
                # unique-name churn leaks one map entry per deleted
                # node. The delta-enabled owner keeps its entry until
                # its delta prune runs, so the dispatch-time ownership
                # re-check stays exact.
                self.shard.forget_node(name)
            return
        self._track_upgrade_state(name, old, obj)
        if self.shard is not None:
            # keep the name→shard map current (the slice identity needs
            # the node's labels, which only this hook sees)
            self.shard.shard_of_node_obj(obj)
        if not node_event_needs_reconcile(event, old, obj):
            self._count("node", "drop")
            return
        if (
            self.shard is not None
            and self.shard.owns_full_pass()
            and old is not None
        ):
            # another replica's verdict write on a shard we don't own:
            # fold it into status.slices at O(1) instead of letting the
            # shard filter silently stale the global aggregate
            self._maybe_ingest_foreign_verdict(old, obj)
        if not self.enabled:
            self._fire("node", self.cp_key)
            return
        if old is None or self._changes_cluster_facts(old, obj):
            # a joining GPU node / variant flip changes the facts the
            # render fan-out and slice formation derive from — full pass
            self._fire("node", self.cp_key)
            return
        if self._is_own_verdict_echo(old, obj):
            # our slice-ready write bouncing back through the watch: the
            # mirror already holds this verdict, nothing to recompute
            self._count("node", "drop")
            return
        with self._lock:
            rolling = bool(self._upgrading)
        if rolling:
            # a staged roll in flight: version-label flips, FSM
            # transitions and health edges are the rollout
            # orchestrator's gate EVIDENCE, and promotion/rollback
            # decisions live in the full pass — it must observe at
            # event speed (the canary contract), not at the 5 s
            # requeue. The empty-set common case keeps steady churn off
            # the full pass entirely.
            self._fire("node", self.cp_key, 0.1)
        if _labels(old) != _labels(obj):
            # only a label change can move the node's own label-FSM
            # step; a status-only event (chip health) skips straight to
            # the slice aggregate below
            self._fire("node", (NODE_KIND, name))
        if self._readiness_relevant(old, obj):
            sid = self._sid_of(obj)
            if sid:
                self._fire("node", (SLICE_KIND, sid))
            old_sid = self._sid_of(old)
            if old_sid and old_sid != sid:
                self._fire("node", (SLICE_KIND, old_sid))
        if self.delta is not None and self.delta.remediation_enabled():
            if self._health_transition(old, obj):
                # budgeted FSM territory: run the full pass now instead
                # of waiting out the resync
                self._fire("node", self.cp_key, 0.05)

    def _track_upgrade_state(
        self, name: str, old: Optional[dict], new: dict
    ) -> None:
        ustate = _labels(new).get(consts.UPGRADE_STATE_LABEL) or ""
        old_ustate = _labels(old).get(consts.UPGRADE_STATE_LABEL) or ""
        with self._lock:
            (
                self._upgrading.add
                if ustate in self._upgrade_wake_states
                else self._upgrading.discard
            )(name)
        if ustate != old_ustate:
            # an FSM transition landed (ours or another replica's): the
            # next step is level-triggered off the labels — run it now,
            # not at the 120 s resync
            self._fire("node", self.upgrade_key, 0.1)

    @staticmethod
    def _changes_cluster_facts(old: dict, new: dict) -> bool:
        from tpu_operator_torch.controllers.state_manager import (
            has_gpu_labels,
            node_generation,
        )

        if has_gpu_labels(old) != has_gpu_labels(new):
            return True
        if node_generation(old) != node_generation(new):
            return True
        return _labels(old).get(consts.WORKLOAD_CONFIG_LABEL) != _labels(
            new
        ).get(consts.WORKLOAD_CONFIG_LABEL)

    @staticmethod
    def _readiness_relevant(old: dict, new: dict) -> bool:
        from tpu_operator_torch.controllers.clusterpolicy_controller import (
            _tpu_resource_view,
        )

        if _tpu_resource_view(old) != _tpu_resource_view(new):
            return True
        ol, nl = _labels(old), _labels(new)
        if any(ol.get(k) != nl.get(k) for k in _READINESS_LABELS):
            return True
        return ol.get(consts.TFD_SLICE_ID_LABEL) != nl.get(
            consts.TFD_SLICE_ID_LABEL
        )

    def _is_own_verdict_echo(self, old: dict, new: dict) -> bool:
        """True when the ONLY change is the slice-ready label landing at
        exactly the verdict the delta mirror computed — the watch echo
        of our own publish. A foreign writer flipping the verdict to
        anything ELSE fails the predicate and reaches the slice key,
        which reclaims the label."""
        if self.delta is None:
            return False
        from tpu_operator_torch.controllers.clusterpolicy_controller import (
            _tpu_resource_view,
        )

        if _tpu_resource_view(old) != _tpu_resource_view(new):
            return False
        ol, nl = dict(_labels(old)), dict(_labels(new))
        verdict = nl.get(consts.SLICE_READY_LABEL)
        ol.pop(consts.SLICE_READY_LABEL, None)
        nl.pop(consts.SLICE_READY_LABEL, None)
        if ol != nl or verdict is None:
            return False
        sid = self._sid_of(new)
        return sid is not None and (
            self.delta.expected_verdict(sid) == verdict
        )

    def _maybe_ingest_foreign_verdict(self, old: dict, new: dict) -> None:
        if self.delta is None:
            return
        sid = self._sid_of(new)
        if sid is None or self.shard.owns_slice(sid):
            return
        verdict = _labels(new).get(consts.SLICE_READY_LABEL)
        if verdict is None:
            return
        if _labels(old).get(consts.SLICE_READY_LABEL) == verdict:
            return
        self.delta.ingest_foreign_verdict(sid, verdict == "true")

    def _health_transition(self, old: dict, new: dict) -> bool:
        from tpu_operator_torch.controllers.slice_status import host_allocatable_ok

        if _labels(old).get(consts.REMEDIATION_STATE_LABEL) != _labels(
            new
        ).get(consts.REMEDIATION_STATE_LABEL):
            return True
        return host_allocatable_ok(new) is False and (
            host_allocatable_ok(old) is not False
        )

    def _sid_of(self, node: Optional[dict]) -> Optional[str]:
        if not node:
            return None
        from tpu_operator_torch.controllers.slice_status import slice_id_for_node

        try:
            return slice_id_for_node(node)
        except Exception:
            return None

    # -- Pod ------------------------------------------------------------
    def _on_pod(self, event: str, obj: dict) -> None:
        from tpu_operator_torch.controllers.remediation import pod_crashlooping
        from tpu_operator_torch.controllers.slice_status import VALIDATOR_APP

        meta = obj.get("metadata", {})
        # same gpu-* operand filter the remediator's health verdict
        # applies: a user pod's crashloop is not a node-health signal
        # and must not burn reconcile passes
        app = (meta.get("labels") or {}).get("app") or ""
        if not app.startswith(consts.OPERAND_APP_PREFIX):
            return
        with self._lock:
            upgrading = bool(self._upgrading)
        if upgrading:
            # operand/validator pod movement advances FSM steps
            # (pod-restart completion, validation) — coalesced by the
            # workqueue, and only while an upgrade is in flight
            self._fire("pod", self.upgrade_key, 0.25)
        key = f"{meta.get('namespace', '')}/{meta.get('name', '')}"
        now = event != "DELETED" and pod_crashlooping(obj)
        with self._lock:
            # read-and-update under ONE lock hold: hooks dispatch from
            # both the watch thread and the resync repair thread, and a
            # stale 'was' read would silently drop a flip's wake
            was = key in self._crashlooping
            (self._crashlooping.add if now else self._crashlooping.discard)(
                key
            )
        crash_flip = was != now
        if not self.enabled:
            if crash_flip:
                self._fire("pod", self.cp_key, 0.1)
            return
        remediation_on = (
            self.delta is not None and self.delta.remediation_enabled()
        )
        if crash_flip and (remediation_on or upgrading):
            # crashloop health is remediation-FSM input (fleet budget)
            # AND rollout gate evidence while a staged roll is in
            # flight: full pass, as before the router existed
            self._fire("pod", self.cp_key, 0.1)
        slice_hit = False
        if app == VALIDATOR_APP:
            from tpu_operator_torch.controllers.slice_status import (
                validator_pod_ready,
            )

            ready = event != "DELETED" and validator_pod_ready(obj)
            with self._lock:
                was_ready = key in self._validator_ready
                (
                    self._validator_ready.add
                    if ready
                    else self._validator_ready.discard
                )(key)
            if ready != was_ready:
                # pod event → its slice's readiness aggregate: the
                # validator verdict is the slice gate
                slice_hit = self._fire_slice_for_pod(obj)
        elif crash_flip and not remediation_on:
            slice_hit = self._fire_slice_for_pod(obj)
        if not (upgrading or crash_flip or slice_hit):
            self._count("pod", "drop")

    def _fire_slice_for_pod(self, pod: dict) -> bool:
        node_name = pod.get("spec", {}).get("nodeName")
        if not node_name:
            return False
        with self._lock:
            node = self._node_cache.get(node_name)
        if node is None:
            node = self._node_obj_fallback(node_name)
        sid = self._sid_of(node)
        if sid:
            self._fire("pod", (SLICE_KIND, sid), 0.05)
            return True
        # node unknown to the router (cache not warm yet): the full
        # pass regroups safely
        self._fire("pod", self.cp_key, 0.1)
        return True

    def _node_obj_fallback(self, name: str) -> Optional[dict]:
        try:
            client = (
                self.delta.client if self.delta is not None else None
            )
            if client is None:
                return None
            return client.get_or_none("v1", "Node", name)
        except Exception:
            return None
