"""Operator self-metrics.

The port's copy of ``tpu_operator/controllers/operator_metrics.py``. Its
series are the reference's under the namespace
``consts.METRICS_NAMESPACE``, ``gpu_operator`` (the reference's is
``tpu_operator``): both singletons register in ``prometheus_client``'s
one global registry, and under one namespace a process holding both
packages would raise ``Duplicated timeseries``. Its hooks go into the
port's kube layer (``kube.client.on_conflict_retry``,
``kube.write_pipeline.on_queue_wait_ms``, ``kube.rest.on_write_rtt_ms``),
never into the reference's. Without ``prometheus_client`` every series
is a shared no-op.

The surface of ``controllers/operator_metrics.go:13-185``, extended to
**21 series**: 4 reconciliation (status/total/failed/last-success), the
node gauge, feature-label presence, the per-variant driver DaemonSet
gauge (DTK slot), per-state operand gauge, and eight upgrade-FSM gauges —
six node-state gauges plus the slice-granular in-progress/pinned pair
(the disruption unit). Additions beyond that shape: slice totals/ready
pair, maintenance gauge, the PDB-veto pressure counter
(``upgrade_evictions_blocked_total``), and the informer drift-repair
gauge.
"""

from __future__ import annotations

import time

from tpu_operator_torch import consts

try:
    from prometheus_client import REGISTRY, Counter, Gauge, Histogram

    HAVE_PROM = True
except Exception:  # pragma: no cover - prometheus always present in image
    HAVE_PROM = False


class _NoopMetric:
    """Stand-in for every collector when ``prometheus_client`` is
    absent: the operator runs metric-less instead of raising
    AttributeError on the first gauge access. One shared instance backs
    every series — all operations are no-ops."""

    def labels(self, *a, **kw):
        return self

    def inc(self, *a, **kw):
        pass

    def dec(self, *a, **kw):
        pass

    def set(self, *a, **kw):
        pass

    def observe(self, *a, **kw):
        pass

    def remove(self, *a, **kw):
        pass


_NOOP_METRIC = _NoopMetric()

# Histogram buckets (milliseconds), fixed so dashboards/alerts compare
# across releases (docs/observability.md has the rationale). Each set
# brackets the measured steady/loaded range with ~2-2.5x steps: the
# steady 1000-node pass sits ~12-25 ms (bench gate 50 ms), converging
# passes run 100s of ms; renders are sub-ms to tens of ms; queue waits
# are sub-ms healthy and grow past 10 ms when the pipeline saturates;
# in-process apply RTT is ~0.5-5 ms (real apiserver: tens); allocate
# p99 gates at 850 ms.
PASS_MS_BUCKETS = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000)
RENDER_MS_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100)
QUEUE_WAIT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 500)
RTT_MS_BUCKETS = (0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1000)
ALLOC_MS_BUCKETS = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500)
# a delta sub-reconcile touches ONE node's label step or ONE slice's
# readiness aggregate: sub-ms to low-ms healthy, tens of ms only when a
# status write conflicts — an order of magnitude under the full pass
DELTA_MS_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100)


class OperatorMetrics:
    """reference ``OperatorMetrics`` (``controllers/operator_metrics.go:13-34``)."""

    _singleton = None

    def __new__(cls, *a, **kw):
        # prometheus_client registers collectors globally; keep one instance
        if cls._singleton is None:
            cls._singleton = super().__new__(cls)
            cls._singleton._init_collectors()
        return cls._singleton

    def _init_collectors(self):
        ns = consts.METRICS_NAMESPACE
        if HAVE_PROM:
            g = lambda name, doc, labels=(): Gauge(f"{ns}_{name}", doc, labels)  # noqa: E731
            c = lambda name, doc, labels=(): Counter(f"{ns}_{name}", doc, labels)  # noqa: E731
            h = lambda name, doc, buckets, labels=(): Histogram(  # noqa: E731
                f"{ns}_{name}", doc, labels, buckets=buckets
            )
        else:
            # metric-less mode: every series is the shared no-op stub
            g = lambda *a, **kw: _NOOP_METRIC  # noqa: E731
            c = lambda *a, **kw: _NOOP_METRIC  # noqa: E731
            h = lambda *a, **kw: _NOOP_METRIC  # noqa: E731
        # reconciliation (reference :64-100)
        self.reconciliation_status = g(
            "reconciliation_status",
            "1 success / 0 not-ready / -1 failed / -2 no ClusterPolicy",
        )
        self.reconciliation_total = c(
            "reconciliation_total", "Total reconciliation attempts"
        )
        self.reconciliation_failed = c(
            "reconciliation_failed_total", "Failed reconciliations"
        )
        self.reconciliation_last_success = g(
            "reconciliation_last_success_ts_seconds",
            "Timestamp of last successful reconciliation",
        )
        # fleet (reference :52-57)
        self.tpu_nodes_total = g("tpu_nodes_total", "Number of GPU nodes")
        self.feature_labels_present = g(
            "tpu_feature_labels",
            "1 if GPU hardware labels (feature discovery/NFD) were found on any node",
        )
        # per-variant driver fan-out (DTK-gauge slot, reference :102-140)
        self.libtpu_generations_total = g(
            "libtpu_generations_total",
            "Distinct card variants driving driver DaemonSet fan-out",
        )
        self.operand_states = g(
            "operand_state",
            "Per-state readiness: 1 ready / 0 not-ready / -1 disabled / "
            "-2 errored (isolated this pass, see status.erroredStates)",
            ("state",),
        )
        # per-state error isolation: how many states raised this pass and
        # were isolated instead of aborting the run (Degraded condition)
        self.states_errored = g(
            "states_errored",
            "States whose step() raised this pass (isolated; the pass "
            "continued to independent states)",
        )
        # slice-scoped readiness (no reference analogue; SURVEY.md §7)
        self.slices_total = g(
            "tpu_slices_total", "Slices (multi-host groups + single hosts)"
        )
        self.slices_ready = g(
            "tpu_slices_ready", "Slices with every member host validated"
        )
        # host-maintenance visibility (no reference analogue)
        self.nodes_under_maintenance = g(
            "nodes_under_maintenance",
            "GPU nodes with an active metadata-announced maintenance window "
            "(tpu.k8s.io/maintenance=pending)",
        )
        # upgrade FSM gauges (reference :142-185)
        self.upgrades_in_progress = g(
            "libtpu_upgrades_in_progress", "Nodes currently upgrading the driver"
        )
        self.upgrades_done = g("libtpu_upgrades_done", "Nodes at upgrade-done")
        self.upgrades_failed = g("libtpu_upgrades_failed", "Nodes at upgrade-failed")
        self.upgrades_available = g(
            "libtpu_upgrades_available",
            "Slices (disruption units; single-host nodes are slices of "
            "one) the upgrade budget would admit now",
        )
        self.upgrades_pending = g(
            "libtpu_upgrades_pending", "Nodes with upgrade-required"
        )
        self.upgrades_unknown = g(
            "libtpu_upgrades_unknown", "Nodes with unknown upgrade state"
        )
        # slice-granular disruption (a redesign of the reference's
        # per-node budgets): the roll admits/batches whole slices, so the
        # in-flight/pinned truth is per slice, not per node
        self.upgrade_slices_in_progress = g(
            "libtpu_upgrade_slices_in_progress",
            "Slices (disruption units) with at least one member host "
            "mid-upgrade",
        )
        self.upgrade_slices_pinned = g(
            "libtpu_upgrade_slices_pinned",
            "Slices whose upgrade drain is pinned by a disruption-budget "
            "veto on a member host",
        )
        # PDB-veto pressure (reference drain path
        # vendor/.../upgrade/drain_manager.go:76-89): each count is one
        # eviction a PodDisruptionBudget refused — sustained growth means
        # a drain is stuck behind a budget and the upgrade cannot proceed
        self.evictions_blocked = c(
            "upgrade_evictions_blocked_total",
            "Drain evictions vetoed by a PodDisruptionBudget across every "
            "drain path (driver upgrades, host maintenance, node "
            "remediation — all share PodManager.evict_pods)",
        )
        # node-health remediation FSM (controllers/remediation.py): the
        # fleet-repair surface — how many hosts are unhealthy, how many
        # the FSM holds quarantined/exhausted, drain vetoes, escalation
        # attempts, and the systemic-failure breaker's disposition
        self.remediation_nodes_unhealthy = g(
            "remediation_nodes_unhealthy",
            "GPU nodes derived unhealthy this pass (0-allocatable cards, "
            "CrashLoopBackOff operands, or validator not Running)",
        )
        self.remediation_nodes_quarantined = g(
            "remediation_nodes_quarantined",
            "GPU nodes the remediation FSM holds cordoned + tainted "
            "(cordon-drain or quarantined)",
        )
        self.remediation_nodes_exhausted = g(
            "remediation_nodes_exhausted",
            "GPU nodes that hit the remediation attempt cap (flapping) "
            "and stay quarantined until a human intervenes",
        )
        self.remediation_drains_vetoed = g(
            "remediation_drains_vetoed",
            "Remediation-drain evictions vetoed by a PodDisruptionBudget "
            "(each veto defers, never fails, the FSM step)",
        )
        self.remediation_breaker_open = g(
            "remediation_breaker_open",
            "1 while the systemic-failure breaker is open (>= "
            "systemicThreshold of the fleet unhealthy: remediation "
            "halted, zero drains)",
        )
        self.remediation_attempts_total = g(
            "remediation_attempts_total",
            "Escalation steps executed by the remediation FSM "
            "(operand restarts + cordon-drains) since process start",
        )
        # allocation traffic (schedsim churn engine, the device-plugin
        # path's foreground workload): admission volume/outcomes, gang
        # holds taken, fleet fragmentation, and the p99 the bench-alloc
        # gate rides. Gauges fed from the engine's own counters (the
        # render_cache_invalidations convention) whenever it runs.
        self.alloc_requests = g(
            "alloc_requests",
            "Allocation requests admitted through the device-plugin path "
            "(successes + failures + cancellations) by the churn engine",
        )
        self.alloc_failures = g(
            "alloc_failures",
            "Allocation requests that failed admission (no host with "
            "enough free cards, gang admission timeout, insufficient "
            "cards at allocate time)",
        )
        self.alloc_gang_holds = g(
            "alloc_gang_holds",
            "Gang-admission hold sets acquired (all member hosts held "
            "atomically) by the hold-and-release coordinator",
        )
        self.alloc_fragmentation_pct = g(
            "alloc_fragmentation_pct",
            "Fleet fragmentation: percent of free cards outside their "
            "host's largest NVLink-contiguous free block (last sample)",
        )
        self.alloc_latency_ms_p99 = g(
            "alloc_latency_ms_p99",
            "p99 device-plugin allocation latency (GetPreferredAllocation "
            "-> Allocate -> ledger hold) in milliseconds",
        )
        # sharded scale-out: per-shard lease
        # ownership from THIS replica's view, handoffs it lost, and
        # watch events its router dropped as another replica's work —
        # the balance/health surface the bench gate and the failover
        # post-mortems read
        self.shard_ownership = g(
            "shard_ownership",
            "1 while this replica holds the shard's lease "
            "(tpu-operator-shard-<i>), 0 otherwise",
            ("shard",),
        )
        self.shard_handoff_total = g(
            "shard_handoff_total",
            "Shard leases this replica lost (renewal lost, fenced, or "
            "released at shutdown) — each one is a handoff to a peer",
        )
        self.shard_events_dropped_total = g(
            "shard_events_dropped_total",
            "Watch events dropped before enqueue because their key "
            "belongs to a shard another replica owns",
        )
        # informer health (client-go reflector resync analogue): nonzero
        # means a watch stream silently swallowed an event and the
        # periodic re-list repaired the cache
        self.informer_drift_repairs = g(
            "informer_drift_repairs_total",
            "Cache objects repaired by informer resync (missed watch events)",
        )
        # zero-copy read path (client-go indexed-store analogue): reads
        # served from the informer stores, cumulative list latency, how
        # many lists the indexers answered in O(result), and how many
        # reads paid a deep copy (explicit copy=True writers only)
        self.cache_gets = g(
            "informer_cache_gets_total", "Gets served from informer stores"
        )
        self.cache_lists = g(
            "informer_cache_lists_total", "Lists served from informer stores"
        )
        self.cache_list_seconds = g(
            "informer_cache_list_seconds_total",
            "Cumulative wall time spent inside informer list()",
        )
        self.cache_indexed_lists = g(
            "informer_cache_indexed_lists_total",
            "Informer lists answered from an index bucket (O(result))",
        )
        self.cache_copied_reads = g(
            "informer_cache_copied_reads_total",
            "Cached objects deep-copied for explicit copy=True readers",
        )
        # per-pass reconcile snapshot (node scans + per-app pod lists
        # shared across the 18 states): last pass's hit/miss profile
        self.snapshot_hits = g(
            "reconcile_snapshot_hits",
            "Reads served by the per-pass cluster snapshot memo (last pass)",
        )
        self.snapshot_misses = g(
            "reconcile_snapshot_misses",
            "Reads the per-pass cluster snapshot had to compute (last pass)",
        )
        # memoized manifest render pipeline (desired-state fingerprint
        # short-circuit): a steady-state pass renders nothing — misses
        # staying 0 and the hit gauge at ~the control count is the tell
        self.render_cache_hits = g(
            "render_cache_hits",
            "Manifest renders served from the render cache (last pass)",
        )
        self.render_cache_misses = g(
            "render_cache_misses",
            "Manifests the render cache had to render (last pass)",
        )
        self.render_cache_entries = g(
            "render_cache_entries",
            "Rendered manifests currently memoized under the desired-state "
            "fingerprint",
        )
        # a gauge fed by .set() from the cache's own counter — no _total
        # suffix, which Prometheus conventions reserve for true Counters
        self.render_cache_invalidations = g(
            "render_cache_invalidations",
            "Full render-cache invalidations (desired-state fingerprint "
            "changes: spec edit, runtime flip, CR recreate)",
        )
        self.state_render_ms = g(
            "state_render_ms",
            "Cumulative manifest render wall time per state since the last "
            "fingerprint invalidation (ms)",
            ("state",),
        )
        # concurrent write pipeline (kube/write_pipeline.py): the
        # convergence fan-out's disposition — configured depth, live
        # in-flight writes, how long tasks wait for a worker, and task
        # failures (each also surfaced to its submitter)
        self.write_pipeline_depth = g(
            "write_pipeline_depth",
            "Configured write-pipeline concurrency (WRITE_PIPELINE_DEPTH; "
            "1 = serial escape hatch)",
        )
        self.write_pipeline_inflight = g(
            "write_pipeline_inflight",
            "Write-pipeline tasks currently executing",
        )
        self.write_pipeline_queue_wait_ms = g(
            "write_pipeline_queue_wait_ms",
            "Average queue wait before a pipeline worker picked a write up",
        )
        self.write_pipeline_errors_total = g(
            "write_pipeline_errors",
            "Write-pipeline tasks that raised (after the client's own "
            "retry/breaker policy gave up)",
        )
        # apiserver fault-tolerance surface (kube/retry.py): gauges fed
        # from the client's own counters each pass — retry pressure and
        # the global circuit breaker's disposition
        self.apiserver_retries = g(
            "apiserver_request_retries",
            "API requests retried by the client's fault-tolerance policy "
            "(transient 5xx/429/connection failures)",
        )
        self.apiserver_retry_giveups = g(
            "apiserver_retry_giveups",
            "API calls that exhausted their per-call retry budget",
        )
        self.apiserver_breaker_open = g(
            "apiserver_breaker_open",
            "1 while the global apiserver circuit breaker is open "
            "(requests fail fast instead of hammering a dead server)",
        )
        self.apiserver_breaker_trips = g(
            "apiserver_breaker_trips",
            "Times the apiserver circuit breaker tripped open",
        )
        # optimistic-concurrency pressure: each count is one 409 retry
        # inside mutate_with_retry (shared-object writers re-reading and
        # re-applying); sustained growth means writers are fighting.
        # Installed as the kube layer's hook so client.py never imports
        # upward into controllers.
        self.conflict_retries = c(
            "conflict_retries_total",
            "Optimistic-concurrency (409) retries in mutate_with_retry",
        )
        from tpu_operator_torch.kube import client as _kube_client

        _kube_client.on_conflict_retry = self.conflict_retries.inc

        # latency HISTOGRAMS: the key point-in-time gauges
        # promoted to real fixed-bucket distributions — p50/p99 over
        # time instead of "whatever the last pass happened to read".
        # The legacy gauges stay (dashboards/tests read them); the
        # histograms are the alerting-grade series.
        self.reconcile_pass_ms_hist = h(
            "reconcile_pass_duration_ms",
            "Full reconcile pass wall time (ms)",
            PASS_MS_BUCKETS,
        )
        self.state_render_ms_hist = h(
            "state_render_duration_ms",
            "One manifest render+transform+hash on a render-cache miss "
            "(ms), per state",
            RENDER_MS_BUCKETS,
            ("state",),
        )
        self.write_pipeline_queue_wait_hist = h(
            "write_pipeline_queue_wait_duration_ms",
            "Queue wait before a write-pipeline worker picked a task up "
            "(ms)",
            QUEUE_WAIT_MS_BUCKETS,
        )
        self.apply_rtt_ms_hist = h(
            "apiserver_write_rtt_ms",
            "apiserver write round-trip (ms) by verb, retries included "
            "(APPLY is the server-side-apply hot path)",
            RTT_MS_BUCKETS,
            ("verb",),
        )
        self.alloc_latency_ms_hist = h(
            "alloc_latency_duration_ms",
            "Device-plugin allocation latency (GetPreferredAllocation -> "
            "Allocate -> ledger hold) in ms",
            ALLOC_MS_BUCKETS,
        )
        # event-scoped delta reconciliation: router trigger
        # disposition + sub-reconcile cost. source = watch kind that
        # fired (node/pod/clusterpolicy/daemonset); key_kind = routed
        # target (node/slice/full/upgrade, or drop for predicate-killed
        # no-op deliveries)
        self.reconcile_triggers = c(
            "reconcile_trigger_total",
            "Watch-event reconcile triggers routed by the delta router, "
            "by event source and target key kind",
            ("source", "key_kind"),
        )
        self.delta_reconcile_ms_hist = h(
            "delta_reconcile_duration_ms",
            "One event-scoped delta sub-reconcile (node label step or "
            "slice readiness aggregate) wall time in ms",
            DELTA_MS_BUCKETS,
        )
        # the kube layer feeds the queue-wait and write-RTT histograms
        # through module hooks (the on_conflict_retry convention: kube/
        # never imports upward into controllers/)
        from tpu_operator_torch.kube import rest as _rest
        from tpu_operator_torch.kube import write_pipeline as _wp

        _wp.on_queue_wait_ms = self.write_pipeline_queue_wait_hist.observe
        _rest.on_write_rtt_ms = self._observe_write_rtt

    def _observe_write_rtt(self, verb: str, ms: float) -> None:
        self.apply_rtt_ms_hist.labels(verb=verb).observe(ms)

    # -- convenience ----------------------------------------------------
    def observe_reconcile(self, status_value: int) -> None:
        self.reconciliation_total.inc()
        self.reconciliation_status.set(status_value)
        if status_value == 1:
            self.reconciliation_last_success.set(time.time())
        elif status_value < 0:
            self.reconciliation_failed.inc()

    def set_state(self, state: str, value: int) -> None:
        self.operand_states.labels(state=state).set(value)
