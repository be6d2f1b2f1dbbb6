"""ClusterPolicy reconciler.

The port's copy of ``tpu_operator/controllers/clusterpolicy_controller.py``,
the analogue of ``controllers/clusterpolicy_controller.go``:

* singleton enforcement: extra CRs get status ``Ignored`` (``:104-109``);
* every reconcile runs the full state machine (``:134-158``), relying on
  hash idempotency to no-op; each state's exception is isolated, reported
  in ``status.erroredStates``, a ``Degraded`` condition and a
  ``StatesDegraded`` Event, and dumps the flight recorder once per new
  errored set;
* after the states: remediation, then the rollout orchestrator, then the
  re-partition roll (``fsm.remediation``, ``fsm.rollout``,
  ``fsm.repartition``), then the slice aggregate (``pass.slices``),
  memoized on the (Node, Pod) store versions;
* 5 s requeue while NotReady (``:140,167``), 45 s poll when no node
  carries the card yet (``:170-182``);
* CR status (state, conditions, slices, remediation, rollout; no write
  when nothing changed, a conflict retried on a live read) and operator
  metrics (``:184-196``).

What the port decides here (the reconcilers' decisions, also in
``rollout.py``, ``delta.py`` and ROADMAP):

* Internal names stay the reference's: ``ClusterPolicyReconciler``,
  ``Result``, ``select_primary``, ``_tpu_resource_view``,
  ``node_event_needs_reconcile``, the ``tpu_nodes`` locals, the trace span
  names (``pass.reconcile``, ``pass.shard_scope``, ``fsm.remediation``,
  ``fsm.rollout``, ``fsm.repartition``, ``pass.slices``), the Event
  reasons and the condition types and reasons. The reference's
  ``has_tpu_labels`` is the port's ``has_gpu_labels``, imported under that
  name; the metrics keep the reference's attribute names
  (``tpu_nodes_total``, ``libtpu_generations_total``) in the
  ``gpu_operator`` namespace.
* What names the card comes from ``consts``: ``_tpu_resource_view`` reads
  ``consts.GPU_RESOURCE`` and ``consts.MIG_RESOURCE_PREFIX`` (so a card the
  device plugin marks unhealthy after validation wakes a reconcile), and
  ``node_event_needs_reconcile`` watches ``nvidia.com/gpu.`` (feature
  discovery's labels, ``consts.GPU_PRODUCT_LABEL`` among them, which
  decides ``has_gpu_labels``) where the reference watches
  GKE's TPU label prefix; NFD's ``feature.node.kubernetes.io/`` and
  the operator's ``tpu.k8s.io/`` stay.
* Human-readable messages name the card ("all GPU operand states are
  ready", "... GPU nodes unhealthy").
* Sharded mode is ported, not wired: ``shard_state`` stays ``None`` until
  a manager sets it, and ``_shard_scoped_pass`` and ``_slice_owns_gate``
  are the reference's, whole.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import State
from tpu_operator_torch.kube.events import TYPE_NORMAL, TYPE_WARNING, record_event
from tpu_operator_torch.controllers.operator_metrics import OperatorMetrics
from tpu_operator_torch.controllers.state_manager import (
    ClusterPolicyController,
    has_gpu_labels,
)
from tpu_operator_torch.kube.client import Client, ConflictError
from tpu_operator_torch.obs import flight, trace

log = logging.getLogger("gpu-operator.reconcile")

# requeue cadences (reference :140,167,173)
REQUEUE_NOT_READY_S = 5.0
REQUEUE_NO_LABELS_S = 45.0


@dataclass
class Result:
    requeue_after: Optional[float] = None
    ready: bool = False


def select_primary(policies):
    """Deterministic singleton selection shared by both reconcilers: oldest
    creationTimestamp wins, name as tiebreak. resourceVersion is opaque and
    bumped by our own status writes, so it must not participate."""
    policies = sorted(
        policies,
        key=lambda o: (
            o["metadata"].get("creationTimestamp", ""),
            o["metadata"].get("name", ""),
        ),
    )
    return policies[0], policies[1:]


class ClusterPolicyReconciler:
    def __init__(self, client: Client, assets_dir: Optional[str] = None):
        self.client = client
        self.ctrl = ClusterPolicyController(client, assets_dir=assets_dir)
        self.metrics = OperatorMetrics()
        self.ctrl.metrics = self.metrics
        # node-health remediation FSM (runs inside the reconcile pass,
        # after label_tpu_nodes has produced the pass's node list)
        from tpu_operator_torch.controllers.remediation import (
            NodeRemediationController,
        )

        self.remediation = NodeRemediationController(client)
        # live slice re-partition roll (third consumer of the shared
        # disruption budget; no-op without spec.sliceManager.config.default)
        from tpu_operator_torch.controllers.repartition import (
            SliceRepartitionController,
        )

        self.repartition = SliceRepartitionController(client)
        # health-gated progressive rollout orchestrator (canary waves +
        # automatic rollback; no-op without spec.rollout.enabled). Runs
        # after remediation (fresh quarantines are gate evidence) and
        # before repartition (which consumes the computed cohort gate).
        from tpu_operator_torch.controllers.rollout import RolloutController

        self.rollout = RolloutController(client)
        # (Node, Pod) store versions of the last clean slice aggregation
        # — while both hold, the per-node slice grouping and readiness
        # math is a pure recomputation over an unchanged world, so the
        # memoized summary is served instead (see _aggregate_slices)
        self._slice_world = None
        self._slice_summary = None
        # state_render_ms label values currently exported (so series for
        # states gone from the render cost map can be removed)
        self._render_ms_states = set()
        # completed reconcile passes (plain int, no prometheus needed):
        # external health/invariant checkers use this to reason in
        # operator-pass units instead of wall time — "stale for N
        # passes" is meaningful on any box, "stale for N seconds" only
        # on an idle one
        self.passes_total = 0
        # cumulative full-pass wall time (ms): the churn-storm bench's
        # delta-vs-full A/B reads this next to delta.delta_ms_total
        self.full_ms_total = 0.0
        # event-scoped delta sub-reconciles (controllers/delta.py):
        # targeted node/slice entry points the keyed workqueue drives
        # between full passes; each full pass re-seeds its slice mirror
        from tpu_operator_torch.controllers.delta import DeltaReconciler

        self.delta = DeltaReconciler(self)
        # sharded scale-out (a ``shard.py`` the port has not yet ported): the replica's shard
        # ownership view, or None (single-process default). Non-owners
        # of shard 0 run the SCOPED pass (label + verdict work for
        # owned shards only); the shard-0 owner runs the global pass
        # with every budgeted section behind a live lease re-check.
        self.shard_state = None
        # True while a scoped pass body runs (the CP barrier key keeps
        # passes serial): note_full_pass reads it to tell a scoped
        # aggregate from a global one across a mid-pass takeover
        self._scoped_pass_active = False
        # Degraded-transition tracker: the flight recorder dumps once
        # per NEW errored-state picture, not once per 5 s requeue
        self._last_errored_states: frozenset = frozenset()
        # the last pass's self-time-by-layer trace summary (populated
        # while tracing is enabled; /debug/vars "trace" mirrors it)
        self.last_trace_summary = {}
        # flight dumps post a warning Event against the primary CR.
        # Weakly bound: the process-global recorder must not pin a
        # retired reconciler (test fixtures build many per process)
        import weakref

        self_ref = weakref.ref(self)

        def _sink(reason: str, detail: str, path: str) -> None:
            live = self_ref()
            if live is not None:
                live._flight_dump_event(reason, detail, path)

        flight.RECORDER.event_sink = _sink

    def _flight_dump_event(self, reason: str, detail: str, path: str) -> None:
        """Flight-recorder dump notifier: a warning Event on the CR so
        the dump is discoverable from ``kubectl describe``."""
        cp = self.ctrl.cp_obj
        ns = self.ctrl.namespace
        if not cp or not ns:
            return
        record_event(
            self.client,
            ns,
            cp,
            TYPE_WARNING,
            "FlightRecorderDump",
            f"flight recorder dumped ({reason}"
            + (f": {detail}" if detail else "")
            + f") -> {path}",
        )

    def reconcile(self, name: str = "") -> Result:
        import time as _time

        # copy=True: the CR objects are mutated below (_set_status writes
        # status in place; init stores the primary as cp_obj) — they must
        # be private copies, not the informer's shared frozen views
        policies = self.client.list(
            consts.API_VERSION, consts.CLUSTER_POLICY_KIND, copy=True
        )
        if not policies:
            self.metrics.observe_reconcile(-2)
            return Result()
        # one cluster snapshot per pass: the 18 states' readiness checks
        # share one node scan + one indexed pod read per app instead of
        # each issuing their own (end_pass also feeds the hit-rate debug
        # surface and metrics)
        t0 = _time.perf_counter()
        self.ctrl.begin_pass()
        try:
            with trace.span("pass.reconcile", n=self.passes_total):
                return self._reconcile_pass(policies)
        finally:
            self.ctrl.end_pass()
            self.passes_total += 1
            pass_ms = (_time.perf_counter() - t0) * 1000.0
            self.full_ms_total += pass_ms
            hist = getattr(self.metrics, "reconcile_pass_ms_hist", None)
            if hist is not None:
                hist.observe(pass_ms)
            if trace.TRACER.enabled:
                self.last_trace_summary = trace.TRACER.mark_pass()
            self._update_snapshot_metrics()

    def _reconcile_pass(self, policies) -> Result:
        ss = self.shard_state
        if ss is not None:
            if not ss.owns_full_pass():
                return self._shard_scoped_pass(policies)
            if not ss.confirm_full_pass_owner():
                # split-brain guard: this replica BELIEVED it held
                # shard 0 but a live lease read says otherwise (taken
                # over mid-window). Running the budget arbiter now
                # would double-drain against the new owner — degrade
                # to scoped-worker work instead (confirm already
                # demoted our ownership view).
                log.warning(
                    "shard-0 lease lost mid-window; fencing the "
                    "budgeted full pass and degrading to scoped work"
                )
                flight.record("shard.fenced", identity=ss.identity)
                return self._shard_scoped_pass(policies)
        primary, extras = select_primary(policies)
        for extra in extras:
            self._set_status(extra, State.IGNORED)

        try:
            self.ctrl.init(primary)
        except Exception:
            log.exception("init failed")
            # init may have opened an apply-set pass before raising; an
            # empty commit would read as "prune everything"
            self.ctrl.applyset.abort()
            self._set_status(primary, State.NOT_READY)
            self.metrics.observe_reconcile(-1)
            raise

        # no GPU nodes and no hardware labels yet: keep polling NFD
        # (reference :170-182); has_tpu_nodes (nodes that carry the card) was computed by init's
        # label_tpu_nodes pass over the node list
        if not self.ctrl.has_tpu_nodes:
            # no states ran, nothing registered: sealing this pass would
            # prune every previously-applied object
            self.ctrl.applyset.abort()
            self._set_status(primary, State.NOT_READY)
            self.metrics.observe_reconcile(0)
            self._update_fleet_metrics()
            return Result(requeue_after=REQUEUE_NO_LABELS_S)

        overall = State.READY
        not_ready_states = []
        errored_states = []  # (state, "ExcType: message") — this pass
        # DAG-pipelined deployment: states with no ordering edge deploy
        # concurrently; outcomes come back in STATE_ORDER order.
        # Per-state error isolation is preserved: one state's exception
        # (a busted asset, a write that exhausted its retries) never
        # aborts the INDEPENDENT states — the reference reports
        # reconciliation_status per run rather than losing the whole
        # pass. A pass starting from Ready is a zero-write steady pass:
        # it runs the waves sequentially (see run_states).
        steady = (primary.get("status", {}) or {}).get("state") == State.READY
        for state_name, outcome in self.ctrl.run_states(
            concurrent=not steady
        ):
            if isinstance(outcome, BaseException):
                log.error(
                    "state %s failed; isolating and continuing",
                    state_name,
                    exc_info=outcome,
                )
                overall = State.NOT_READY
                errored_states.append(
                    (state_name, f"{type(outcome).__name__}: {outcome}")
                )
                self.metrics.set_state(state_name, -2)
                continue
            status = outcome
            self.metrics.set_state(
                state_name,
                {State.READY: 1, State.NOT_READY: 0}.get(status, -1),
            )
            if status == State.NOT_READY:
                overall = State.NOT_READY
                not_ready_states.append(state_name)
                log.info("state %s not ready; will requeue", state_name)
        if self.metrics and getattr(self.metrics, "states_errored", None):
            self.metrics.states_errored.set(len(errored_states))
        # flush barrier: nothing of this pass's write fan-out may
        # outlive the pass (remediation/slice aggregation below read the
        # world the states just wrote). Errors already surfaced through
        # the per-state futures; drain only collects stragglers.
        self.ctrl.writes.drain()

        # apply-set pruning: a pass that ran EVERY state to completion
        # holds the complete intended-object picture — seal it and
        # delete what an earlier pass applied but this one abandoned
        # (the renamed-DaemonSet leak). An errored state's registrations
        # are incomplete, so that pass aborts instead: membership stays
        # at the last complete picture and nothing is pruned on partial
        # information.
        if errored_states:
            self.ctrl.applyset.abort()
        else:
            self.ctrl.prune_abandoned()

        # node-health remediation (its quarantine label writes move the
        # Node store version, so the slice aggregate below never memoizes
        # a pre-quarantine world; the labels themselves land in the next
        # pass's node list — level-triggered, like every other writer)
        with trace.span("fsm.remediation"):
            remediation_summary = self._run_remediation()

        # health-gated rollout orchestration (canary→wave→fleet staging
        # of any fleet-wide version/layout change, with automatic
        # rollback on failing canary evidence): consumes the fresh
        # remediation verdicts as gate evidence and computes the cohort
        # admission gate the re-partition roll (below) and the upgrade
        # reconciler both honor
        with trace.span("fsm.rollout"):
            rollout_summary = self._run_rollout(primary, remediation_summary)

        # live slice re-partition roll (after remediation, and handed
        # remediation's in-pass disrupted set: the quarantine labels it
        # just wrote are on the wire but NOT in this pass's node
        # snapshot, and the label-derived joint set alone would let the
        # two consumers jointly over-admit past the one cap)
        with trace.span("fsm.repartition"):
            repartition_summary = self._run_repartition(
                remediation_summary, rollout_summary
            )

        with trace.span("pass.slices"):
            slice_summary = self._aggregate_slices()

        was_ready = (primary.get("status", {}) or {}).get("state") == State.READY
        if overall == State.READY and not was_ready:
            record_event(
                self.client,
                self.ctrl.namespace,
                primary,
                TYPE_NORMAL,
                "Ready",
                "all GPU operand states are ready",
            )
        elif not_ready_states:
            record_event(
                self.client,
                self.ctrl.namespace,
                primary,
                TYPE_WARNING,
                "OperandsNotReady",
                f"states not ready: {', '.join(not_ready_states)}",
            )
        if errored_states:
            record_event(
                self.client,
                self.ctrl.namespace,
                primary,
                TYPE_WARNING,
                "StatesDegraded",
                "states errored: "
                + "; ".join(f"{n} ({e})" for n, e in errored_states),
            )
        # flight recorder: a NEW Degraded picture dumps the recent
        # causal timeline once (the 5 s requeue re-reporting the same
        # errored set must not dump every pass)
        errored_now = frozenset(n for n, _ in errored_states)
        if errored_states and errored_now != self._last_errored_states:
            for state_name, err in errored_states:
                flight.record("state.degraded", state=state_name, error=err)
            flight.RECORDER.dump(
                "state-degraded",
                detail=", ".join(sorted(errored_now)),
            )
        self._last_errored_states = errored_now

        self._set_status(
            primary, overall, slice_summary, errored_states,
            remediation_summary, rollout_summary,
        )
        self._update_fleet_metrics()
        if errored_states:
            # the run is degraded even though it completed: report it
            # like the reference's reconciliation_status=-1, and keep the
            # level-triggered 5s requeue converging the healthy states
            self.metrics.observe_reconcile(-1)
            return Result(requeue_after=REQUEUE_NOT_READY_S)
        if overall == State.NOT_READY:
            self.metrics.observe_reconcile(0)
            return Result(requeue_after=REQUEUE_NOT_READY_S)
        self.metrics.observe_reconcile(1)
        if remediation_summary is not None and remediation_summary.active:
            # unhealthy nodes mid-FSM: their escalation backoffs elapse
            # without any cluster event to wake the reconciler, so the
            # level-triggered requeue is the remediation clock
            return Result(ready=True, requeue_after=REQUEUE_NOT_READY_S)
        if repartition_summary is not None and repartition_summary.active:
            # an in-flight/pending layout roll: budget headroom opens
            # when ANOTHER consumer releases a slice — no cluster event
            # of ours fires for that, so the requeue is the roll's clock
            return Result(ready=True, requeue_after=REQUEUE_NOT_READY_S)
        if rollout_summary is not None and rollout_summary.active:
            # a staged roll in flight: the observation window and the
            # rollback's re-roll elapse without any cluster event — the
            # requeue is the rollout's clock
            return Result(ready=True, requeue_after=REQUEUE_NOT_READY_S)
        return Result(ready=True)

    # ------------------------------------------------------------------
    def _shard_scoped_pass(self, policies) -> Result:
        """The non-shard-0 replica's pass (sharded scale-out): label and
        slice-verdict convergence for the shards THIS replica owns —
        O(owned nodes), riding the scoped informer stores — while CR
        render, operand deployment, the three budgeted FSMs and status
        stay pinned to the shard-0 owner. Also seeds the delta
        reconciler's context so keyed sub-reconciles run here at event
        speed between passes."""
        primary, _ = select_primary(policies)
        ctrl = self.ctrl
        # the SAME decode preamble as the owner's init (rollback
        # override included): label decisions must agree across
        # replicas, so the preamble is shared, not mirrored
        ctrl.decode_primary(primary)
        # marks this pass's aggregate as SCOPED for note_full_pass: a
        # shard-0 takeover landing mid-pass must not let the partial
        # mirror masquerade as global context
        self._scoped_pass_active = True
        try:
            with trace.span("pass.shard_scope"):
                ctrl.label_tpu_nodes()
                ctrl.writes.drain()
                self._aggregate_slices()
        finally:
            self._scoped_pass_active = False
        self.metrics.observe_reconcile(1)
        return Result(ready=True)

    def _slice_owns_gate(self):
        """The verdict-publish gate for ``slice_status.aggregate``:
        ``covers_slice`` of the shard view, or None (publish all) for
        the single-process operator."""
        ss = self.shard_state
        if ss is None:
            return None
        return ss.covers_slice

    def _run_remediation(self):
        """Node-health remediation pass (tentpole of the robustness
        story): derives per-node health from the pass's in-hand node
        list + one namespace pod listing, steps each unhealthy node's
        FSM, and reports counts for status/metrics. Failure-isolated
        like any state: a remediation exception must not abort the
        reconcile."""
        from tpu_operator_torch.controllers.state_manager import has_gpu_labels

        try:
            tpu_nodes = [
                n for n in (self.ctrl._nodes_cache or ()) if has_gpu_labels(n)
            ]
            summary = self.remediation.reconcile(
                tpu_nodes, self.ctrl.cp.spec.remediation, self.ctrl.namespace
            )
        except Exception:
            log.exception("node remediation pass failed")
            # zero the gauges AND hand back an errored (all-zero) summary:
            # freezing metrics or status at the LAST pass's picture (an
            # open breaker, a quarantine count) while remediation is not
            # actually running would keep alerts — and the CR — on stale
            # data; errored=True keeps the 5s requeue retrying the pass
            self._update_remediation_metrics(None)
            from tpu_operator_torch.controllers.remediation import (
                RemediationSummary,
            )

            return RemediationSummary(errored=True)
        self._update_remediation_metrics(summary)
        return summary

    def _run_rollout(self, primary, remediation_summary=None):
        """Health-gated rollout orchestration pass. Failure-isolated
        like remediation: an orchestrator exception must not abort the
        reconcile — the 5s requeue retries it, and an errored pass
        reports active so the clock keeps ticking."""
        from tpu_operator_torch.controllers.rollout import RolloutSummary
        from tpu_operator_torch.controllers.state_manager import has_gpu_labels

        try:
            tpu_nodes = [
                n for n in (self.ctrl._nodes_cache or ()) if has_gpu_labels(n)
            ]
            return self.rollout.reconcile(
                tpu_nodes,
                primary,
                self.ctrl.cp.spec.rollout,
                getattr(self.ctrl, "raw_roll_targets", None) or {},
                self.ctrl.namespace,
                remediation_summary=remediation_summary,
            )
        except Exception:
            log.exception("rollout orchestration pass failed")
            # FAIL CLOSED: an errored orchestrator must freeze fresh
            # staged admissions (admit_sids=set()), not leave the
            # same-pass repartition roll unrestricted — the 5s errored
            # retry re-opens the gate as soon as a pass succeeds
            return RolloutSummary(errored=True, admit_sids=set())

    def _run_repartition(self, remediation_summary=None, rollout_summary=None):
        """Live slice re-partition pass (third shared-budget consumer).
        Failure-isolated like remediation: a roll exception must not
        abort the reconcile; the 5s requeue retries it."""
        from tpu_operator_torch.controllers.state_manager import has_gpu_labels

        try:
            tpu_nodes = [
                n for n in (self.ctrl._nodes_cache or ()) if has_gpu_labels(n)
            ]
            return self.repartition.reconcile(
                tpu_nodes,
                self.ctrl.cp.spec.slice_manager,
                self.ctrl.namespace,
                extra_disrupted=getattr(
                    remediation_summary, "disrupted_sids", None
                ),
                admit_filter=getattr(rollout_summary, "admit_sids", None),
            )
        except Exception:
            log.exception("slice re-partition pass failed")
            from tpu_operator_torch.controllers.repartition import (
                RepartitionSummary,
            )

            # rolling_slices=1 keeps .active truthy so the 5s requeue
            # retries the errored pass (any held slices stay honest)
            return RepartitionSummary(rolling_slices=1)

    def _update_remediation_metrics(self, summary) -> None:
        m = self.metrics
        if not m or not getattr(m, "remediation_nodes_unhealthy", None):
            return
        rc = self.remediation
        if summary is None:
            m.remediation_nodes_unhealthy.set(0)
            m.remediation_nodes_quarantined.set(0)
            m.remediation_nodes_exhausted.set(0)
            m.remediation_breaker_open.set(0)
        else:
            m.remediation_nodes_unhealthy.set(summary.unhealthy)
            m.remediation_nodes_quarantined.set(summary.quarantined)
            m.remediation_nodes_exhausted.set(summary.exhausted)
            m.remediation_breaker_open.set(1 if summary.breaker_open else 0)
        m.remediation_drains_vetoed.set(rc.drains_vetoed_total)
        m.remediation_attempts_total.set(rc.attempts_total)

    def _aggregate_slices(self):
        """Slice-scoped readiness (SURVEY.md §7 hard part): a multi-host
        pod-slice is only Ready when every member host validated. Publishes
        ``consts.SLICE_READY_LABEL`` node labels + metrics; summarized in
        the CR status by ``_set_status``."""
        from tpu_operator_torch.controllers import slice_status
        from tpu_operator_torch.controllers.state_manager import has_gpu_labels

        versions = self._store_versions()
        if (
            versions is not None
            and versions == self._slice_world
            and self._slice_summary is not None
        ):
            # unchanged (Node, Pod) world: slice identity, membership,
            # health and the published labels are all still exactly what
            # the memoized aggregation computed
            summary = self._slice_summary
        else:
            self._slice_world = None
            try:
                tpu_nodes = [
                    n
                    for n in (self.ctrl._nodes_cache or ())
                    if has_gpu_labels(n)
                ]
                summary = slice_status.aggregate(
                    self.client,
                    self.ctrl.namespace,
                    tpu_nodes,
                    pipeline=self.ctrl.writes,
                    lane=self.ctrl.label_lane,
                    owns=self._slice_owns_gate(),
                )
            except Exception:
                log.exception("slice readiness aggregation failed")
                return None
            if versions is not None and versions == self._store_versions():
                # nothing moved during the aggregation (it published no
                # labels and no event raced it): memoize until the world
                # does
                self._slice_world = versions
                self._slice_summary = summary
        if self.metrics and getattr(self.metrics, "slices_total", None):
            self.metrics.slices_total.set(summary.total)
            self.metrics.slices_ready.set(summary.ready)
        # re-seed the delta path's slice mirror IMMEDIATELY (not at pass
        # end): the aggregation just published its verdict labels, and
        # every publish echoes back through the watch as a node event —
        # the router's echo predicate can only drop those once the
        # mirror agrees, so a late seed turns a 1000-node flip into a
        # 1000-key no-op backlog on the delta workers
        self.delta.note_full_pass(summary)
        return summary

    def _store_versions(self):
        """(Node, Pod) world key for the slice memo, or None whenever a
        memo would be unsafe.

        The node component is the version ``_nodes_cache`` — the list
        the aggregation actually consumes — was taken at (stamped by
        ``label_tpu_nodes``), and it only counts while the LIVE store
        still sits at that version: a node event landing mid-pass (after
        the label scan, before/while aggregating) makes the consumed
        list stale, and memoizing its summary under the newer version
        would mask the event until some unrelated change. The pod
        component is read live — the validator-pod list is read inside
        the aggregation itself."""
        fn = getattr(self.client, "store_version", None)
        if fn is None:
            return None
        node_v = self.ctrl._nodes_cache_version
        pod_v = fn("v1", "Pod")
        if node_v is None or pod_v is None or fn("v1", "Node") != node_v:
            return None
        return (node_v, pod_v)

    def _update_fleet_metrics(self) -> None:
        if (
            self.metrics
            and getattr(self.metrics, "informer_drift_repairs", None)
            and hasattr(self.client, "drift_repairs_total")
        ):
            self.metrics.informer_drift_repairs.set(
                self.client.drift_repairs_total()
            )
        if self.metrics and getattr(self.metrics, "tpu_nodes_total", None):
            self.metrics.tpu_nodes_total.set(self.ctrl.tpu_node_count)
            self.metrics.feature_labels_present.set(
                1 if self.ctrl.has_tpu_nodes else 0
            )
            self.metrics.libtpu_generations_total.set(
                len(self.ctrl.tpu_generations)
            )
            under_maintenance = sum(
                1
                for n in (self.ctrl._nodes_cache or ())
                if (n.get("metadata", {}).get("labels") or {}).get(
                    consts.MAINTENANCE_STATE_LABEL
                )
            )
            self.metrics.nodes_under_maintenance.set(under_maintenance)

    def _update_snapshot_metrics(self) -> None:
        """Cache-read observability: informer read counters + list
        latency, the per-pass snapshot hit profile, and the render
        cache's hit/miss + per-state render cost — so both halves of the
        hot loop (reads AND renders) show up on the metrics surface
        instead of only in bench output."""
        m = self.metrics
        if not m or not getattr(m, "snapshot_hits", None):
            return
        stats = self.ctrl.last_snapshot_stats or {}
        m.snapshot_hits.set(stats.get("hits", 0))
        m.snapshot_misses.set(stats.get("misses", 0))
        if hasattr(self.client, "read_stats"):
            reads = self.client.read_stats()
            m.cache_gets.set(reads["gets"])
            m.cache_lists.set(reads["lists"])
            m.cache_list_seconds.set(reads["list_seconds"])
            m.cache_indexed_lists.set(reads["indexed_lists"])
            m.cache_copied_reads.set(reads["copied_reads"])
        if getattr(m, "render_cache_hits", None):
            render = self.ctrl.render_cache.stats()
            m.render_cache_hits.set(render["last_pass"]["hits"])
            m.render_cache_misses.set(render["last_pass"]["misses"])
            m.render_cache_entries.set(render["entries"])
            m.render_cache_invalidations.set(render["invalidations"])
            # a fingerprint invalidation resets the per-state render
            # cost; label series for states not re-rendered since must
            # not keep serving pre-invalidation readings
            current = set(render["render_ms_by_state"])
            for state in self._render_ms_states - current:
                try:
                    m.state_render_ms.remove(state)
                except KeyError:
                    pass
            self._render_ms_states = current
            for state, ms in render["render_ms_by_state"].items():
                m.state_render_ms.labels(state=state).set(ms)
        if getattr(m, "write_pipeline_depth", None):
            ws = self.ctrl.writes.stats()
            m.write_pipeline_depth.set(ws["depth"])
            m.write_pipeline_inflight.set(ws["inflight"])
            m.write_pipeline_queue_wait_ms.set(ws["queue_wait_ms_avg"])
            m.write_pipeline_errors_total.set(ws["errors_total"])
        if getattr(m, "apiserver_retries", None) and hasattr(
            self.client, "fault_stats"
        ):
            fault = self.client.fault_stats()
            retry = fault.get("retry")
            if retry:
                m.apiserver_retries.set(retry["retries_total"])
                m.apiserver_retry_giveups.set(retry["giveups_total"])
            breaker = fault.get("breaker")
            if breaker:
                m.apiserver_breaker_open.set(
                    1 if breaker["state"] == "open" else 0
                )
                m.apiserver_breaker_trips.set(breaker["trips_total"])

    def _set_status(
        self,
        cp_obj,
        state: str,
        slice_summary=None,
        errored=None,
        remediation_summary=None,
        rollout_summary=None,
    ) -> None:
        """reference ``updateCRState`` (``:198``) + Ready and Degraded
        conditions, the per-state error block, the slice-readiness
        aggregate, and the node-remediation counts (no reference
        analogues)."""
        status = cp_obj.setdefault("status", {})
        slices = None
        if slice_summary is not None:
            slices = {
                "total": slice_summary.total,
                "ready": slice_summary.ready,
            }
            if slice_summary.degraded:
                slices["degraded"] = slice_summary.degraded
        errored_block = [
            {"state": n, "error": e} for n, e in (errored or ())
        ]
        breaker_open = bool(
            remediation_summary is not None
            and remediation_summary.breaker_open
        )
        # the effective block: present only while there is something to
        # report (an all-healthy fleet keeps status clean, and the
        # no-change comparison below must agree with what gets stored)
        remediation_block = None
        if remediation_summary is not None:
            block = remediation_summary.status_block()
            if any(block.values()):
                remediation_block = block
        rollout_block = (
            rollout_summary.status_block()
            if rollout_summary is not None
            else None
        )
        if (
            status.get("state") == state
            and status.get("namespace")
            == (self.ctrl.namespace or status.get("namespace"))
            and (slices is None or status.get("slices") == slices)
            and (status.get("erroredStates") or []) == errored_block
            and (
                remediation_summary is None
                or status.get("remediation") == remediation_block
            )
            and (
                rollout_summary is None
                or status.get("rollout") == rollout_block
            )
        ):
            return
        from datetime import datetime, timezone

        prev_conditions = {
            c.get("type"): c for c in (status.get("conditions") or [])
        }
        status["state"] = state
        status["namespace"] = self.ctrl.namespace
        if slices is not None:
            status["slices"] = slices
        if errored_block:
            status["erroredStates"] = errored_block
        else:
            status.pop("erroredStates", None)
        if remediation_summary is not None:
            if remediation_block is not None:
                status["remediation"] = remediation_block
            else:
                status.pop("remediation", None)
        if rollout_summary is not None:
            if rollout_block is not None:
                status["rollout"] = rollout_block
            else:
                status.pop("rollout", None)

        now = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")

        def condition(ctype, value, reason, message=None):
            # k8s condition semantics: lastTransitionTime only moves when
            # the condition's status actually flips, not on every status
            # write (e.g. a slices-aggregate fluctuation while Ready
            # stays True)
            prev = prev_conditions.get(ctype)
            cond = {
                "type": ctype,
                "status": value,
                "reason": reason,
                "lastTransitionTime": (
                    prev.get("lastTransitionTime")
                    if prev is not None and prev.get("status") == value
                    else now
                ),
            }
            if message:
                cond["message"] = message
            return cond

        status["conditions"] = [
            condition(
                "Ready",
                "True" if state == State.READY else "False",
                {
                    State.READY: "OperandsReady",
                    State.NOT_READY: "OperandsNotReady",
                    State.IGNORED: "IgnoredDuplicate",
                }.get(state, "Unknown"),
            ),
            condition(
                "Degraded",
                "True" if (errored_block or breaker_open) else "False",
                # the systemic breaker outranks per-state errors: a
                # fleet-wide node failure is the headline, not a busted
                # asset dir
                (
                    "SystemicNodeFailure"
                    if breaker_open
                    else "StatesErrored"
                    if errored_block
                    else "AllStatesHealthy"
                ),
                message=(
                    "; ".join(
                        (
                            [
                                f"{remediation_summary.unhealthy} of "
                                f"{remediation_summary.total} GPU nodes "
                                f"unhealthy; remediation halted with zero "
                                f"drains"
                            ]
                            if breaker_open
                            else []
                        )
                        + [
                            f"{b['state']}: {b['error']}"
                            for b in errored_block
                        ]
                    )
                    or None
                ),
            ),
        ]
        try:
            self.client.update_status(cp_obj)
        except ConflictError:
            # the CR moved while we reconciled (self-inflicted spec writes
            # or another writer): re-read and re-apply the status to the
            # fresh revision — standard status-writer retry, no logspam
            try:
                meta = cp_obj.get("metadata", {})
                # live read: behind an informer cache, re-reading the
                # cached revision would carry the same stale rv forever
                fresh = getattr(self.client, "get_live", self.client.get)(
                    cp_obj["apiVersion"], cp_obj["kind"], meta["name"],
                    meta.get("namespace", ""),
                )
                fresh["status"] = status
                self.client.update_status(fresh)
            except Exception:
                log.exception(
                    "failed to update ClusterPolicy status after conflict "
                    "retry; next reconcile will converge it"
                )
        except Exception:
            log.exception("failed to update ClusterPolicy status")


# ---------------------------------------------------------------------------
# watch predicates (reference addWatchNewGPUNode, :220-314)
# ---------------------------------------------------------------------------


def _tpu_resource_view(node: dict) -> tuple:
    """The node-status slice the operator's readiness logic consumes:
    the card's capacity/allocatable entries (``nvidia.com/gpu`` and
    ``nvidia.com/mig-*``; kubelet-derived card
    health feeding slice-scoped readiness)."""
    status = node.get("status", {}) or {}
    out = []
    for bucket in ("capacity", "allocatable"):
        for k, v in sorted((status.get(bucket) or {}).items()):
            if k == consts.GPU_RESOURCE or k.startswith(
                consts.MIG_RESOURCE_PREFIX
            ):
                out.append((bucket, k, v))
    return tuple(out)


def node_event_needs_reconcile(event: str, old: Optional[dict], new: dict) -> bool:
    """Predicate deciding whether a Node event triggers a reconcile
    (reference ``:247-306``): a new GPU node arrives, feature discovery's
    labels change,
    operator labels were externally modified — or the kubelet changed
    the node's card capacity/allocatable (the reference's predicates are
    label-only, but slice-scoped readiness consumes kubelet-derived card
    health, so a card souring AFTER validation must wake the reconciler
    too)."""
    if event == "ADDED":
        return has_gpu_labels(new)
    if event == "DELETED":
        return True
    if old is None:
        return True
    if _tpu_resource_view(old) != _tpu_resource_view(new):
        return True
    old_labels = old.get("metadata", {}).get("labels", {}) or {}
    new_labels = new.get("metadata", {}).get("labels", {}) or {}
    if old_labels == new_labels:
        return False
    watched_prefixes = (
        "nvidia.com/gpu.",
        "feature.node.kubernetes.io/",
        f"{consts.GROUP}/",
    )
    keys = set(old_labels) | set(new_labels)
    return any(
        old_labels.get(k) != new_labels.get(k)
        for k in keys
        if k.startswith(watched_prefixes)
    )
