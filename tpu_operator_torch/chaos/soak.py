"""The chaos soak: execute a seeded schedule against a converging fleet
and assert the global invariants after every sample.

The soak is the regime of fleet-lifecycle storms: autoscale join storms,
spot-preemption waves vanishing nodes mid-upgrade/mid-remediation, chip
faults, apiserver faults, and one live slice re-partition — all while
the schedsim churn engine pushes allocation traffic through the device
plugin path. The operator under test is the REAL wiring (``build_manager``
+ ``wire_event_sources`` over kubesim's HTTP apiserver), not a harness
double.

**Invariants** (``InvariantChecker``):

* **budget**: non-exhausted disrupted slices (upgrade-active/failed +
  remediation cordon-drain/quarantined + re-partition rolling) never
  exceed the shared maxUnavailable cap — flagged only when the overage
  persists past the grace AND a NEW slice was admitted while over (a
  shrinking fleet legitimately lowers the cap under existing holds; the
  ``exhausted`` entry bypasses the budget by design and is exempt);
* **slice-ready honesty**: no slice labeled Ready while a member is
  unvalidated, quarantined, mid-roll, chips-dead, or missing;
* **zero zombie holds**: the allocation registry never holds chips on a
  node outside the live fleet (grace covers the in-flight reap window);
* **zero double-allocated chips / partial gangs**: immediate, no grace.

Transient divergence is expected mid-chaos — a kill needs a reconcile
pass to flip labels — so label-derived checks use persistence: a
violation counts only when it survives ``grace_s`` of consecutive
samples. The final post-settle check is strict.

The port's copy of ``tpu_operator/chaos/soak.py``:

* Internal names stay the reference's: ``InvariantChecker``,
  ``SoakRunner``, the invariant keys (``budget:``, ``slice-ready:``,
  ``zombie-holds``, ``double-alloc``, ``partial-gang``), the report's keys
  and the ``chaos.*``/``invariant.violation`` flight events. The grace and
  pass counts are the reference's: a violation counts only after
  ``grace_s`` *and* ``min_passes`` completed reconcile passes, frozen
  while the apiserver recovers from an injected fault.
* What names the card comes from ``consts``, never a literal: the
  validator pods are selected by ``consts.VALIDATOR_APP`` (the reference's
  literal ``tpu-operator-validator`` would see no pod of the port's
  validator DaemonSet, and every slice-ready check would pass without
  checking anything); a flap reads ``consts.GPU_RESOURCE``; the settle
  predicate waits for ``consts.DRIVER_VERSION_LABEL``; the roll edits
  ``spec.driver`` and its event is ``driver_roll``; the bad version is a
  driver version; the re-partition profile is the card slice manager's
  ``all-1x2``; the logger is ``gpu-chaos``. The namespace, the CR group
  ``tpu.k8s.io/v1``, ``TPU_PRESENT_LABEL`` and the feature-discovery
  slice labels are the label bus and stay.
* The fleet is ``make_gpu_node`` nodes under the port's operator
  (``main.build_manager`` + ``wire_event_sources``), the port's simulated
  kubelet and a ``schedsim`` ``ChurnEngine``. A GPU node reports its
  driver from the start (``testing.DEFAULT_DRIVER_VERSION``; the
  reference's TPU nodes carry no version label until the simulated agent
  writes one), so the soak's ClusterPolicy names that driver: the one
  roll is the scheduled bad one, never a fleet-wide roll from the sample
  CR's version in the first pass.
* No fallback hides a failure: a failed read of the rollout record or the
  admitted nodes after the settle fails the soak (the reference drops the
  keys), and a failed read of the validator pods fails the sample (counted
  in ``sample_errors``) instead of skipping the slice-ready check.
* The admission witness counts what the roll admitted: a node whose first
  admission (seen by a node watch) found it already on the bad driver
  came up on it outside the roll — a join created, or a remediation
  restart recreated, its driver pod from the bad template — and was
  admitted only to roll back. ``rollout_nodes_admitted`` leaves it out and
  ``rollout_nodes_rolled_back`` names it with what it did; a member of a
  cohort the rollout ledger records is never left out. The reference lists
  every node carrying the annotation at the end, so its bound of 2 fails
  on such nodes (ROADMAP queue 3, item 5).
* The report adds ``timings`` (converge, chaos and settle seconds, the
  driver roll's epoch second). Every server, operator, thread and engine
  a run starts is stopped before ``run`` returns or raises.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional, Set

from tpu_operator_torch import consts
from tpu_operator_torch.obs import flight

log = logging.getLogger("gpu-chaos")

NS = consts.DEFAULT_NAMESPACE
CPV = consts.API_VERSION
# the soak's bad driver version: its validator readings scale by
# ``bad_tflops_factor``
BAD_VERSION = "550.163.01"
# the layout the soak's one live re-partition rolls to
REPARTITION_PROFILE = "all-1x2"


class InvariantChecker:
    """Grace-windowed global invariant sampling over a live cluster."""

    def __init__(
        self,
        client,
        namespace: str = NS,
        *,
        max_unavailable: str = "25%",
        engine=None,
        grace_s: float = 4.0,
        on_rolling=None,
        sim=None,
        recovery_s: float = 35.0,
        pass_counter=None,
        min_passes: int = 3,
    ):
        self.client = client
        self.namespace = namespace
        self.max_unavailable = max_unavailable
        self.engine = engine
        self.grace_s = grace_s
        # apiserver-health awareness: while the sim is partitioned or
        # has injected faults queued — and for ``recovery_s`` after (the
        # client breaker's doubling cooldown caps at 30 s, during which
        # every write fast-fails) — the grace clock FREEZES for the
        # checks that depend on the operator landing writes (slice-ready
        # honesty, zombie holds). No controller can flip a label through
        # an unavailable apiserver; staleness there is physics, not an
        # operator bug. Admission-correctness checks (budget overage via
        # fresh admission, double allocations) are never frozen: those
        # are wrong WRITES, which an outage cannot excuse.
        self.sim = sim
        self.recovery_s = recovery_s
        self._last_unhealthy = float("-inf")
        self._fault_counters = (0, 0)
        # pass-aware grace: wall-clock alone misjudges a loaded box —
        # one storm-time reconcile pass at 1000 nodes can outlast any
        # fixed grace while the operator is making perfectly good
        # progress. A freezable violation therefore also needs
        # ``min_passes`` COMPLETED reconcile passes since first seen:
        # the operator had that many whole chances to fix it and didn't.
        self.pass_counter = pass_counter
        self.min_passes = min_passes
        # called with a node name the first time it is seen mid-roll —
        # the soak couples this to ``engine.evict_host`` so gang jobs
        # get rescheduled as layouts shift
        self.on_rolling = on_rolling
        self._seen_rolling: Set[str] = set()
        # violation key -> (first_seen, context, passes-at-first-seen)
        self._pending: Dict[str, tuple] = {}
        # the disrupted set at the LAST under-cap sample — the baseline
        # the budget check diffs fresh admissions against. Diffing
        # against the first OVER-cap sample instead would exempt the
        # very admissions that caused the overage: a one-pass burst that
        # lands 3 holds under a cap of 2 and then sits still would never
        # produce a post-overage delta and never be flagged.
        self._budget_baseline: Set[str] = set()
        self.violations: List[str] = []
        self.samples = 0
        self.sample_errors = 0

    # ------------------------------------------------------------------
    def _unhealthy_window(self, now: float) -> bool:
        if self.sim is None:
            return False
        try:
            # counter deltas, not instantaneous state: an injected fault
            # is consumed in milliseconds, between two checker samples —
            # but the client breaker it tripped fail-fasts for up to its
            # 30 s cooldown cap afterwards
            counters = (
                self.sim.faults_injected,
                self.sim.partition_rejects,
            )
            if (
                counters != self._fault_counters
                or self.sim.partitioned()
                or self.sim.faults_pending() > 0
            ):
                self._fault_counters = counters
                self._last_unhealthy = now
        except Exception:
            pass
        return now - self._last_unhealthy < self.recovery_s

    def _passes(self) -> Optional[int]:
        if self.pass_counter is None:
            return None
        try:
            return int(self.pass_counter())
        except Exception:
            return None

    def _confirm(
        self,
        key: str,
        detail: str,
        now: float,
        extra=None,
        freezable: bool = True,
    ) -> None:
        """A violation must persist for ``grace_s`` — and, when a pass
        counter is wired, across ``min_passes`` completed reconcile
        passes — before it counts; ``freezable`` checks additionally
        restart their clock while the apiserver is (recovering from)
        injected unhealthiness."""
        passes = self._passes()
        if freezable and self._unhealthy_window(now):
            self._pending[key] = (now, extra, passes)
            return
        if key not in self._pending:
            self._pending[key] = (now, extra, passes)
            return
        first, ctx, pass0 = self._pending[key]
        if now - first < self.grace_s:
            return
        if (
            freezable
            and passes is not None
            and pass0 is not None
            and passes - pass0 < self.min_passes
        ):
            return
        if key.startswith("budget:") and extra is not None:
            # budget overage only counts when someone ADMITTED a slice
            # not held at the last under-cap sample (a preemption
            # shrinking the fleet — and thus the cap — under existing
            # holds is not a consumer bug; a fresh hold while over is)
            if not (extra - self._budget_baseline):
                return
        record = f"{key}: {detail}"
        if record not in self.violations:
            self.violations.append(record)
            log.error("INVARIANT VIOLATION %s", record)
            # post-mortem: freeze the recent causal timeline (budget
            # admissions, label writes, FSM transitions, chaos events,
            # breaker trips) the moment the invariant flags — "violation
            # at seed 5, round 37" becomes a replayable dump naming the
            # violating write/admission
            flight.record("invariant.violation", key=key, detail=detail)
            flight.RECORDER.dump(f"invariant-{key}", detail=record)

    def _clear(self, key_prefix: str, active: Set[str]) -> None:
        for key in [k for k in self._pending if k.startswith(key_prefix)]:
            if key not in active:
                del self._pending[key]

    # ------------------------------------------------------------------
    def check_once(self) -> None:
        from tpu_operator_torch.controllers.slice_status import (
            group_slices,
            host_allocatable_ok,
        )
        from tpu_operator_torch.controllers.state_manager import (
            has_gpu_labels as has_tpu_labels,
        )
        from tpu_operator_torch.upgrade.upgrade_state import (
            ACTIVE_STATES,
            STATE_FAILED,
            parse_max_unavailable,
        )

        now = time.monotonic()
        self.samples += 1
        nodes = [
            n for n in self.client.list("v1", "Node") if has_tpu_labels(n)
        ]
        live_names = {n["metadata"]["name"] for n in nodes}
        slices = group_slices(nodes)
        slice_of = {
            m: sid for sid, i in slices.items() for m in i.member_nodes
        }
        labels_of = {
            n["metadata"]["name"]: (
                n.get("metadata", {}).get("labels", {}) or {}
            )
            for n in nodes
        }

        # -- budget: non-exhausted disrupted slices <= shared cap ------
        disrupted: Set[str] = set()
        for name, labels in labels_of.items():
            ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
            rstate = labels.get(consts.REMEDIATION_STATE_LABEL, "")
            if (
                ustate in ACTIVE_STATES
                or ustate == STATE_FAILED
                or rstate
                in (
                    consts.REMEDIATION_STATE_CORDON_DRAIN,
                    consts.REMEDIATION_STATE_QUARANTINED,
                )
                or labels.get(consts.REPARTITION_STATE_LABEL)
                == consts.REPARTITION_STATE_ROLLING
            ):
                disrupted.add(slice_of.get(name, name))
        cap = parse_max_unavailable(self.max_unavailable, len(slices))
        active: Set[str] = set()
        if len(disrupted) > cap:
            key = "budget:cap"
            active.add(key)
            self._confirm(
                key,
                f"{len(disrupted)} non-exhausted disrupted slice(s) "
                f"{sorted(disrupted)} > maxUnavailable {cap} "
                f"({len(slices)} slices)",
                now,
                extra=set(disrupted),
                freezable=False,  # over-cap ADMISSION is a wrong write
            )
        else:
            self._budget_baseline = set(disrupted)
        self._clear("budget:", active)

        # -- slice-ready honesty ---------------------------------------
        validated = self._validator_nodes()
        by_name = {n["metadata"]["name"]: n for n in nodes}
        active = set()
        for sid, info in slices.items():
            labeled_ready = any(
                labels_of[m].get(consts.SLICE_READY_LABEL) == "true"
                for m in info.member_nodes
            )
            if not labeled_ready:
                continue
            bad = []
            want = info.expected_hosts or len(info.member_nodes)
            if len(info.member_nodes) < want:
                bad.append(
                    f"{len(info.member_nodes)}/{want} members present"
                )
            for m in info.member_nodes:
                lab = labels_of[m]
                node = by_name[m]
                if m not in validated:
                    bad.append(f"{m} unvalidated")
                if (
                    lab.get(consts.REMEDIATION_STATE_LABEL)
                    in consts.REMEDIATION_DISRUPTED_STATES
                ):
                    bad.append(f"{m} quarantined")
                if (
                    lab.get(consts.REPARTITION_STATE_LABEL)
                    == consts.REPARTITION_STATE_ROLLING
                ):
                    bad.append(f"{m} mid-repartition")
                if host_allocatable_ok(node) is False:
                    bad.append(f"{m} zero allocatable")
            if bad:
                key = f"slice-ready:{sid}"
                active.add(key)
                self._confirm(
                    key, f"slice {sid} labeled Ready but {bad}", now
                )
        self._clear("slice-ready:", active)

        # -- zombie holds + allocation invariants ----------------------
        if self.engine is not None:
            active = set()
            zombies = self.engine.registry.nodes_holding() - live_names
            if zombies:
                key = "zombie-holds"
                active.add(key)
                self._confirm(
                    key,
                    f"registry holds chips on dead node(s) "
                    f"{sorted(zombies)}",
                    now,
                )
            self._clear("zombie-holds", active)
            doubles = self.engine.registry.double_allocation_attempts
            if doubles:
                record = f"double-alloc: {doubles} double allocation(s)"
                if record not in self.violations:
                    self.violations.append(record)
            partial = self.engine.partial_gang_violations
            if partial:
                record = f"partial-gang: {partial} partial gang(s)"
                if record not in self.violations:
                    self.violations.append(record)

        # -- repartition coupling: gang rescheduling -------------------
        if self.on_rolling is not None:
            for name, labels in labels_of.items():
                if (
                    labels.get(consts.REPARTITION_STATE_LABEL)
                    == consts.REPARTITION_STATE_ROLLING
                    and name not in self._seen_rolling
                ):
                    self._seen_rolling.add(name)
                    try:
                        self.on_rolling(name)
                    except Exception:
                        log.debug("on_rolling hook failed", exc_info=True)
            self._seen_rolling &= live_names

    def _validator_nodes(self) -> Set[str]:
        out: Set[str] = set()
        pods = self.client.list(
            "v1",
            "Pod",
            self.namespace,
            label_selector={"app": consts.VALIDATOR_APP},
        )
        for pod in pods:
            if pod.get("status", {}).get("phase") != "Running":
                continue
            statuses = pod.get("status", {}).get("containerStatuses")
            if statuses is not None and not all(
                cs.get("ready", True) for cs in statuses
            ):
                continue
            node = pod.get("spec", {}).get("nodeName")
            if node:
                out.add(node)
        return out

    # ------------------------------------------------------------------
    def loop(self, halt: threading.Event, interval_s: float = 0.25) -> None:
        while not halt.is_set():
            try:
                self.check_once()
            except Exception:
                # partitions/injected faults starve reads; skip the
                # sample rather than misread a half-listed world
                self.sample_errors += 1
            halt.wait(interval_s)


class _AdmissionWitness:
    """Every value each node's admission-time previous-version annotation
    took, in the order a node watch delivered them: the first is the
    driver the node ran when the upgrade FSM first admitted it."""

    def __init__(self, client):
        self.client = client
        self._lock = threading.Lock()
        self._values: Dict[str, List[str]] = {}
        self._halt = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="soak-admission-witness"
        )

    def _on_event(self, etype: str, obj: dict) -> None:
        meta = obj.get("metadata") or {}
        value = (meta.get("annotations") or {}).get(
            consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION
        )
        if etype == "DELETED" or not value:
            return
        with self._lock:
            seen = self._values.setdefault(meta.get("name", ""), [])
            if not seen or seen[-1] != value:
                seen.append(value)

    def _watch(self) -> None:
        while not self._halt.is_set():
            try:
                self.client.watch(
                    "v1", "Node", self._on_event, stop_event=self._halt
                )
            except Exception:
                # an injected fault or a partition: re-list and go on
                log.debug("admission witness watch failed", exc_info=True)
                self._halt.wait(0.1)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(timeout=10)

    def came_up_on(self, version: str, names: List[str]) -> Dict[str, str]:
        """Of ``names``, those first admitted while already running
        ``version``, each with what it did."""
        with self._lock:
            return {
                name: (
                    f"first admitted while running {version!r} (annotations "
                    f"seen: {self._values[name]}): it came up on the bad "
                    "driver outside the roll and was admitted to roll back"
                )
                for name in names
                if self._values.get(name, [""])[0] == version
            }


class SoakRunner:
    """One seeded chaos soak against a fresh kubesim fleet: build the
    rig, converge, execute the schedule, settle, final-check. Returns a
    JSON-able report with the replayable trace."""

    def __init__(
        self,
        *,
        nodes: int = 12,
        slice_pairs: int = 2,
        seed: int = 7,
        duration_s: float = 8.0,
        churn: bool = True,
        repartition: bool = True,
        schedule=None,
        chips: int = 8,
        alloc_rate_per_min: float = 400.0,
        checker_interval_s: float = 0.25,
        grace_s: float = 4.0,
        converge_timeout_s: float = 120.0,
        settle_timeout_s: float = 120.0,
        max_unavailable: str = "25%",
        time_scale: float = 1.0,
        preempt_fraction: float = 0.08,
        mean_gap_s: float = 0.6,
        bad_version_roll: bool = False,
        bad_version: str = BAD_VERSION,
        bad_tflops_factor: float = 0.4,
        observe_seconds: float = 2.0,
    ):
        self.n_nodes = nodes
        self.slice_pairs = slice_pairs
        self.seed = seed
        self.duration_s = duration_s
        self.churn = churn
        self.repartition = repartition
        self.schedule = schedule
        self.chips = chips
        self.alloc_rate_per_min = alloc_rate_per_min
        self.checker_interval_s = checker_interval_s
        self.grace_s = grace_s
        self.converge_timeout_s = converge_timeout_s
        self.settle_timeout_s = settle_timeout_s
        self.max_unavailable = max_unavailable
        self.time_scale = time_scale
        # storm intensity: fraction of the fleet each preemption wave
        # takes, and the mean gap between events. The grace must exceed
        # the operator's reconcile latency UNDER the configured storm —
        # at 1000 nodes a wave deletes ~fraction×fleet hosts at once,
        # and the label flips that re-verdict every wounded slice take
        # whole passes to land
        self.preempt_fraction = preempt_fraction
        self.mean_gap_s = mean_gap_s
        # health-gated rollout scenario: enable
        # autoUpgrade + spec.rollout, inject a seeded bad driver version
        # mid-run and flip the fleet target to it — the canary cohort
        # must report degraded validator TFLOPS, the orchestrator must
        # roll back automatically, and the fleet must settle on the OLD
        # version with zero slices lost
        self.bad_version_roll = bad_version_roll
        self.bad_version = bad_version
        self.bad_tflops_factor = bad_tflops_factor
        self.observe_seconds = observe_seconds
        # set by the driver_roll executor: the version the fleet ran
        # before the flip — the rollback target settle waits for
        self._expect_version: Optional[str] = None

    # ------------------------------------------------------------------
    def _initial_nodes(self) -> List[tuple]:
        """(name, extra_labels) for the seed fleet: ``slice_pairs``
        2-host slices, the rest single-host."""
        out = []
        for i in range(self.n_nodes):
            extra = {}
            if i < self.slice_pairs * 2:
                sid = f"soak-slice-{i // 2}"
                extra = {
                    consts.TFD_SLICE_ID_LABEL: sid,
                    consts.TFD_SLICE_HOSTS_LABEL: "2",
                }
            out.append((f"soak-{i}", extra))
        return out

    def run(self) -> dict:
        """Build the rig, converge, execute, settle, check. Every server,
        operator, thread and engine it starts is stopped before it
        returns or raises."""
        with contextlib.ExitStack() as stack:
            return self._run(stack)

    def _run(self, stack: contextlib.ExitStack) -> dict:
        import yaml

        from tpu_operator_torch.cfg.crdgen import build_crd
        from tpu_operator_torch.chaos.schedule import ChaosSchedule
        from tpu_operator_torch.kube.client import (
            ConflictError,
            NotFoundError,
        )
        from tpu_operator_torch.kube.kubesim import (
            KubeSim,
            KubeSimServer,
            make_client,
        )
        from tpu_operator_torch.kube.rest import TransientAPIError
        from tpu_operator_torch.kube.testing import (
            DEFAULT_DRIVER_VERSION,
            edit_clusterpolicy,
            make_gpu_node,
            sample_clusterpolicy_path,
            simulate_kubelet_nodes,
        )
        from tpu_operator_torch.main import (
            CP_KEY,
            UPGRADE_KEY,
            build_manager,
            wire_event_sources,
        )

        server = KubeSimServer(KubeSim(bookmark_interval_s=1.0)).start()
        stack.callback(server.stop)
        if self.bad_version_roll:
            from tpu_operator_torch.kube.testing import clear_bad_versions

            stack.callback(clear_bad_versions)
        sim = server.sim
        client = make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05

        initial = self._initial_nodes()
        client.create(
            {
                "apiVersion": "v1",
                "kind": "Namespace",
                "metadata": {"name": NS},
            }
        )
        client.create(build_crd())
        for name, extra in initial:
            client.create(make_gpu_node(name, extra_labels=extra))
            sim.set_node_chips(name, self.chips)
        with open(sample_clusterpolicy_path()) as f:
            client.create(yaml.safe_load(f))

        def _remediation(cp):
            cp["spec"].update(
                remediation={
                    "enabled": True,
                    "maxAttempts": 4,
                    "backoffSeconds": 1,
                    "maxUnavailable": self.max_unavailable,
                    "systemicThreshold": "75%",
                }
            )
            # the driver the simulated fleet's nodes report from the
            # start (the reference's nodes carry no version label): a CR
            # naming another would make its first pass a fleet-wide roll
            cp["spec"]["driver"]["version"] = DEFAULT_DRIVER_VERSION

        edit_clusterpolicy(client, _remediation)
        if self.bad_version_roll:
            # staged health-gated rolls: canary of 1 slice, one 50%
            # wave, then the fleet; short observation so the fast tier
            # finishes. Drain is forced (churn pods are the workload)
            # and bounded so a wedged drain can't stall the canary past
            # the soak budget.
            def _enable_rollout(cp):
                cp["spec"]["driver"]["upgradePolicy"] = {
                    "autoUpgrade": True,
                    "maxParallelUpgrades": 4,
                    "maxUnavailable": self.max_unavailable,
                    "drain": {
                        "enable": True,
                        "force": True,
                        "timeoutSeconds": 30,
                    },
                }
                cp["spec"]["rollout"] = {
                    "enabled": True,
                    "canary": 1,
                    "waves": ["50%"],
                    "observeSeconds": int(self.observe_seconds),
                }

            edit_clusterpolicy(client, _enable_rollout)

        # the live fleet list the kubelet sim sweeps — lifecycle hooks
        # keep it current as joins/preemptions land
        fleet_lock = threading.Lock()
        fleet = [name for name, _ in initial]

        def fleet_hook(event: str, name: str) -> None:
            with fleet_lock:
                if event == "ADDED" and name not in fleet:
                    fleet.append(name)
                elif event == "DELETED" and name in fleet:
                    fleet.remove(name)

        sim.add_lifecycle_hook(fleet_hook)

        mgr, reconciler, _ = build_manager(
            client, NS, metrics_port=0, probe_port=0
        )
        self._reconciler = reconciler
        stop = threading.Event()
        wire_event_sources(mgr, client, NS, stop_event=stop)
        mgr.start()
        stack.callback(mgr.stop)
        stack.callback(stop.set)
        mgr.enqueue(CP_KEY)
        halt = threading.Event()
        stack.callback(halt.set)
        witness = None
        if self.bad_version_roll:
            witness = _AdmissionWitness(make_client(server.port))
            witness.start()
            stack.callback(witness.stop)
        if self.bad_version_roll:
            # the upgrade reconciler must actually run (non-rollout
            # soaks never enqueue it): event wiring wakes it on FSM
            # label/pod movement, and a pump provides the step clock at
            # test cadence (production re-queues at 5 s while staged)
            mgr.enqueue(UPGRADE_KEY)

            def upgrade_pump():
                while not halt.is_set():
                    mgr.enqueue(UPGRADE_KEY)
                    halt.wait(0.3)

            threading.Thread(target=upgrade_pump, daemon=True).start()

        def kubelet():
            while not halt.is_set():
                with fleet_lock:
                    names = list(fleet)
                try:
                    simulate_kubelet_nodes(
                        client, NS, names, halt_event=halt
                    )
                except (
                    ConflictError,
                    NotFoundError,
                    TransientAPIError,
                    OSError,
                ):
                    pass  # chaos races; retried next sweep
                halt.wait(0.15)

        threading.Thread(target=kubelet, daemon=True).start()

        engine = None
        if self.churn:
            from tpu_operator_torch.schedsim.engine import ChurnEngine

            churn_client = make_client(server.port)
            churn_client.GET_RETRY_BACKOFF_S = 0.05
            engine = ChurnEngine(
                churn_client,
                [name for name, _ in initial],
                workers=3,
                rate_per_min=self.alloc_rate_per_min,
                gang_fraction=0.2,
                seed=self.seed,
            )
            engine.wire_lifecycle(sim)
            engine.start()
            stack.callback(engine.stop)

        checker_client = make_client(server.port)
        checker_client.GET_RETRY_BACKOFF_S = 0.05
        checker = InvariantChecker(
            checker_client,
            NS,
            max_unavailable=self.max_unavailable,
            engine=engine,
            grace_s=self.grace_s,
            sim=sim,
            pass_counter=lambda: reconciler.passes_total,
            on_rolling=(
                (lambda name: engine.evict_host(name))
                if engine is not None
                else None
            ),
        )
        checker_halt = threading.Event()
        checker_thread = threading.Thread(
            target=checker.loop,
            args=(checker_halt, self.checker_interval_s),
            daemon=True,
        )
        checker_thread.start()
        stack.callback(checker_thread.join, 10)
        stack.callback(checker_halt.set)

        def cp_state() -> str:
            try:
                cp = (
                    client.get_or_none(CPV, "ClusterPolicy", "cluster-policy")
                    or {}
                )
                return cp.get("status", {}).get("state", "")
            except Exception:
                return ""

        def wait_until(pred, timeout_s: float) -> bool:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                try:
                    if pred():
                        return True
                except Exception:
                    pass
                time.sleep(0.2)
            return False

        # wall seconds of the run's stages (the port's own key);
        # ``driver_roll_at`` is the epoch second the roll was flipped
        timings: Dict[str, float] = {}
        self._timings = timings
        report: Dict[str, object] = {
            "seed": self.seed,
            "nodes_initial": self.n_nodes,
            "timings": timings,
        }
        # set-diff, not a length slice: dump_paths is a bounded ring and
        # a wrap during a long run would silently drop this run's dumps
        # (snapshot accessor: the live deque may be appended mid-read)
        dumps_before = set(flight.RECORDER.dump_paths_snapshot())
        try:
            t_converge = time.monotonic()
            converged = wait_until(
                lambda: cp_state() == "ready", self.converge_timeout_s
            )
            report["converged_before_chaos"] = converged
            timings["converge_s"] = time.monotonic() - t_converge

            schedule = self.schedule or ChaosSchedule(
                self.seed,
                self.duration_s,
                [name for name, _ in initial],
                preempt_fraction=self.preempt_fraction,
                mean_gap_s=self.mean_gap_s,
                repartition_profiles=(
                    [REPARTITION_PROFILE] if self.repartition else []
                ),
                rollout=(
                    {
                        "version": self.bad_version,
                        "tflops_factor": self.bad_tflops_factor,
                    }
                    if self.bad_version_roll
                    else None
                ),
            )
            report["trace"] = schedule.trace()
            self._applied_profile = None  # set by the repartition event
            # the executor gets its OWN client: chaos-injected faults
            # legitimately trip the operator client's circuit breaker,
            # and the executor's spec edit must not fast-fail on it
            chaos_client = make_client(server.port)
            chaos_client.GET_RETRY_BACKOFF_S = 0.05
            t_chaos = time.monotonic()
            executed = self._execute(schedule, sim, chaos_client, engine)
            report["events_executed"] = executed
            timings["chaos_s"] = time.monotonic() - t_chaos

            # chaos over: heal the fleet and let it settle
            self._heal(sim, engine)
            t_settle = time.monotonic()
            settled = wait_until(
                lambda: self._settled(client, cp_state),
                self.settle_timeout_s,
            )
            report["settled"] = settled
            timings["settle_s"] = time.monotonic() - t_settle
            if not settled:
                report["settle_blockers"] = getattr(
                    self, "last_settle_blockers", []
                )
            if self.bad_version_roll:
                from tpu_operator_torch.controllers.rollout import load_record

                report["rollout"] = reconciler.rollout.stats()
                # a failed read fails the soak: the keys are the verdict
                cp = (
                    client.get_or_none(CPV, "ClusterPolicy", "cluster-policy")
                    or {}
                )
                report["rollout_record"] = load_record(cp)
                # the admission witness: only nodes the FSM actually
                # admitted carry the rollback-target annotation —
                # "zero wave-2 admissions" is this list staying
                # within the canary cohort. A node whose FIRST admission
                # found it already running the bad version came up on it
                # outside the roll (a join created, or a remediation
                # restart recreated, its driver pod from the bad
                # template) and was
                # admitted only to roll it back: it is named apart, with
                # what it did, and never counted as admitted by the roll
                # (the witness never exempts a member of a cohort the
                # ledger says the roll admitted)
                from tpu_operator_torch.controllers.slice_status import (
                    group_slices,
                )

                nodes = client.list("v1", "Node")
                carrying = sorted(
                    n["metadata"]["name"]
                    for n in nodes
                    if consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION
                    in (n["metadata"].get("annotations") or {})
                )
                slices = group_slices(nodes)
                cohorts = (report["rollout_record"] or {}).get("cohorts") or []
                in_cohorts = {
                    m
                    for stage in cohorts
                    for sid in stage
                    if sid in slices
                    for m in slices[sid].member_nodes
                }
                came_up_bad = witness.came_up_on(
                    self.bad_version,
                    [n for n in carrying if n not in in_cohorts],
                )
                report["rollout_nodes_admitted"] = [
                    n for n in carrying if n not in came_up_bad
                ]
                report["rollout_nodes_rolled_back"] = came_up_bad
        finally:
            checker_halt.set()
            checker_thread.join(timeout=10)
            alloc_ok = True
            if engine is not None:
                engine.stop()
                verdict = engine.drain_check()
                report["alloc"] = engine.stats()
                report["alloc_drain"] = verdict
                alloc_ok = (
                    verdict["chips_held"] == 0
                    and verdict["pods_holding"] == 0
                    and verdict["double_allocations"] == 0
                    and verdict["invariant_violations"] == 0
                )
            final = self._final_check(client)
            if final:
                # name the split-brain, if any: which side is stale —
                # the live store or the operator's informer view?
                try:
                    live_names = {
                        n["metadata"]["name"]
                        for n in client.list("v1", "Node")
                    }
                    inf_names = {
                        n["metadata"]["name"]
                        for n in mgr.client.list("v1", "Node")
                    }
                    report["final_diag"] = {
                        "live_not_in_informer": sorted(
                            live_names - inf_names
                        ),
                        "informer_not_live": sorted(
                            inf_names - live_names
                        ),
                    }
                except Exception as e:
                    report["final_diag"] = {"error": repr(e)}

        report["checker_samples"] = checker.samples
        report["checker_sample_errors"] = checker.sample_errors
        report["violations"] = checker.violations + final
        # flight-recorder dumps fired during THIS run: each violation's
        # replayable causal timeline
        report["flight_dumps"] = [
            p
            for p in flight.RECORDER.dump_paths_snapshot()
            if p not in dumps_before
        ]
        report["ok"] = bool(
            report.get("converged_before_chaos")
            and report.get("settled")
            and not report["violations"]
            and alloc_ok
        )
        return report

    # ------------------------------------------------------------------
    def _execute(self, schedule, sim, client, engine) -> int:
        from tpu_operator_torch.kube.testing import edit_clusterpolicy

        t0 = time.monotonic()
        executed = 0
        for ev in schedule.events:
            delay = t0 + ev.at_s * self.time_scale - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            # the injected chaos is half the post-mortem timeline: a
            # dump must show WHAT was done to the fleet next to how the
            # operator responded (victim lists truncated to stay small)
            flight.record(
                "chaos." + ev.kind,
                at_s=round(ev.at_s, 3),
                **{
                    k: (list(v[:8]) if isinstance(v, (list, tuple)) else v)
                    for k, v in ev.args.items()
                },
            )
            try:
                if ev.kind == "join":
                    extra = None
                    if ev.args.get("slice_id"):
                        extra = {
                            consts.TFD_SLICE_ID_LABEL: ev.args["slice_id"],
                            consts.TFD_SLICE_HOSTS_LABEL: str(
                                ev.args["slice_hosts"]
                            ),
                        }
                    sim.add_nodes(
                        len(ev.args["names"]),
                        names=list(ev.args["names"]),
                        chips=self.chips,
                        extra_labels=extra,
                    )
                elif ev.kind == "preempt":
                    for name in ev.args["names"]:
                        sim.delete_node(name)
                elif ev.kind == "kill_chips":
                    sim.kill_node_chips(ev.args["node"])
                    if engine is not None:
                        engine.set_node_health(ev.args["node"], False)
                elif ev.kind == "restore":
                    sim.restore_node_chips(ev.args["node"], self.chips)
                    if engine is not None:
                        engine.set_node_health(ev.args["node"], True)
                elif ev.kind == "flap":
                    node = sim.flap_node_chips(ev.args["node"], self.chips)
                    if engine is not None:
                        alive = (
                            node.get("status", {}).get("allocatable", {})
                            or {}
                        ).get(consts.GPU_RESOURCE) not in (None, "0")
                        engine.set_node_health(ev.args["node"], alive)
                elif ev.kind == "fault":
                    sim.inject_fault(
                        ev.args["verb"],
                        "*",
                        code=ev.args["code"],
                        retry_after=ev.args.get("retry_after"),
                        count=int(ev.args.get("count", 1)),
                    )
                elif ev.kind == "partition":
                    sim.partition(float(ev.args["duration_s"]))
                elif ev.kind == "bad_version":
                    from tpu_operator_torch.kube.testing import (
                        inject_bad_version,
                    )

                    inject_bad_version(
                        str(ev.args["version"]),
                        tflops_factor=float(
                            ev.args.get("tflops_factor", 1.0)
                        ),
                        crashloop=bool(ev.args.get("crashloop", False)),
                    )
                elif ev.kind == "driver_roll":
                    target = str(ev.args["version"])
                    cur = (
                        client.get_or_none(
                            CPV, "ClusterPolicy", "cluster-policy"
                        )
                        or {}
                    )
                    # the version the fleet runs NOW is the rollback
                    # target the settle predicate waits for (the bad
                    # version above guarantees the gate trips)
                    self._expect_version = (
                        ((cur.get("spec") or {}).get("driver") or {}).get(
                            "version"
                        )
                        or None
                    )

                    def flip_roll():
                        edit_clusterpolicy(
                            client,
                            lambda cp: cp["spec"]["driver"].update(
                                version=target
                            ),
                        )

                    last_err: Optional[Exception] = None
                    for _attempt in range(20):
                        try:
                            flip_roll()
                            self._timings["driver_roll_at"] = time.time()
                            last_err = None
                            break
                        except Exception as e:  # 503s, breaker, 409s
                            last_err = e
                            time.sleep(0.2)
                    if last_err is not None:
                        raise last_err
                elif ev.kind == "repartition":
                    profile = ev.args["profile"]
                    self._applied_profile = profile

                    def flip():
                        edit_clusterpolicy(
                            client,
                            lambda cp: cp["spec"].update(
                                sliceManager={
                                    "config": {
                                        "name": "layouts",
                                        "default": profile,
                                    },
                                    "maxUnavailable": self.max_unavailable,
                                }
                            ),
                        )

                    # the flip is the soak's ONE live re-partition: it
                    # must land even if it arrives inside an injected
                    # fault window — ride out transient refusals
                    last: Optional[Exception] = None
                    for _attempt in range(20):
                        try:
                            flip()
                            last = None
                            break
                        except Exception as e:  # 503s, breaker, 409s
                            last = e
                            time.sleep(0.2)
                    if last is not None:
                        raise last
                executed += 1
            except KeyError:
                # victim vanished (e.g. preempted between generation's
                # projection and a racing cascade): the schedule is
                # still deterministic — the no-op is part of the replay
                executed += 1
            except Exception:
                log.exception("chaos event %s failed", ev.kind)
        return executed

    def _heal(self, sim, engine) -> None:
        """End of chaos: restore every live host's chips so the fleet
        can converge for the strict final check. Goes straight at the
        sim store (no HTTP): the operator client's breaker may still be
        riding out the last injected fault wave, and a heal that aborts
        on it leaves dead chips pinning remediation forever."""
        with sim._lock:
            names = sorted(
                key[4] for key in sim._objs if key[2] == "nodes"
            )
        for name in names:
            try:
                sim.restore_node_chips(name, self.chips)
            except KeyError:
                continue  # preempted between snapshot and restore
            if engine is not None:
                engine.set_node_health(name, True)

    def _settled(self, client, cp_state) -> bool:
        """Quiesce predicate — the fleet is FULLY converged: CP Ready,
        every live TPU node labeled, every non-exhausted node's FSM
        state cleared (an ``exhausted`` flapper legitimately persists
        until a human), and — when a re-partition ran — every rollable
        node actually ON the new layout, not merely between admission
        waves (sampling 'zero rolling labels' mid-roll is a race: the
        next wave lands right after). Records what blocked in
        ``last_settle_blockers`` so a timed-out soak names its wedge."""
        from tpu_operator_torch.controllers.slice_status import group_slices
        from tpu_operator_torch.controllers.state_manager import (
            has_gpu_labels as has_tpu_labels,
        )
        from tpu_operator_torch.sliceman.slice_manager import STATE_SUCCESS

        blockers: List[str] = []
        state = cp_state()
        if state != "ready":
            blockers.append(f"clusterpolicy state={state!r}")
        nodes = [
            n for n in client.list("v1", "Node") if has_tpu_labels(n)
        ]
        desired = getattr(self, "_applied_profile", None)
        slices = group_slices(nodes)
        labels_by = {
            n["metadata"]["name"]: (
                n.get("metadata", {}).get("labels", {}) or {}
            )
            for n in nodes
        }
        # slices wedged by an exhausted member never roll (the shared
        # budget interlock defers them until a human acts) — exempt
        exhausted_sids = {
            sid
            for sid, info in slices.items()
            if any(
                labels_by[m].get(consts.REMEDIATION_STATE_LABEL)
                == consts.REMEDIATION_STATE_EXHAUSTED
                for m in info.member_nodes
            )
        }
        slice_of = {
            m: sid for sid, i in slices.items() for m in i.member_nodes
        }
        for node in nodes:
            name = node["metadata"]["name"]
            labels = node.get("metadata", {}).get("labels", {}) or {}
            if (
                labels.get(consts.REPARTITION_STATE_LABEL)
                == consts.REPARTITION_STATE_ROLLING
            ):
                blockers.append(f"{name} still rolling")
            ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
            if ustate in consts.UPGRADE_ACTIVE_STATES or ustate in (
                consts.UPGRADE_STATE_UPGRADE_REQUIRED,
                consts.UPGRADE_STATE_FAILED,
            ):
                blockers.append(f"{name} upgrade={ustate}")
            if (
                self._expect_version
                and labels.get(consts.DRIVER_VERSION_LABEL)
                != self._expect_version
            ):
                # a rolled-back fleet must actually END on the old
                # version — not merely stop rolling the bad one
                blockers.append(
                    f"{name} awaiting driver {self._expect_version!r}"
                )
            rstate = labels.get(consts.REMEDIATION_STATE_LABEL)
            if rstate and rstate != consts.REMEDIATION_STATE_EXHAUSTED:
                blockers.append(f"{name} remediation={rstate}")
            if labels.get(consts.TPU_PRESENT_LABEL) != "true" or not any(
                k.startswith(consts.DEPLOY_LABEL_PREFIX) for k in labels
            ):
                blockers.append(f"{name} unlabeled")
            if (
                desired
                and rstate != consts.REMEDIATION_STATE_EXHAUSTED
                and slice_of.get(name, name) not in exhausted_sids
                and not (
                    labels.get(consts.SLICE_CONFIG_LABEL) == desired
                    and labels.get(consts.SLICE_CONFIG_STATE_LABEL)
                    == STATE_SUCCESS
                )
            ):
                blockers.append(f"{name} awaiting layout {desired!r}")
        self.last_settle_blockers = blockers
        return not blockers

    def _final_check(self, client) -> List[str]:
        """Strict post-settle assertions (no grace): lost label writes,
        leaked budget holds, dishonest slice readiness."""
        from tpu_operator_torch.controllers.slice_status import group_slices
        from tpu_operator_torch.controllers.state_manager import (
            has_gpu_labels as has_tpu_labels,
        )

        problems: List[str] = []
        try:
            nodes = [
                n
                for n in client.list("v1", "Node")
                if has_tpu_labels(n)
            ]
        except Exception as e:
            return [f"final: node listing failed ({e})"]
        for n in nodes:
            labels = n.get("metadata", {}).get("labels", {}) or {}
            name = n["metadata"]["name"]
            # no lost label writes: every live TPU node converged its
            # operator-owned labels (present + at least one deploy label)
            if labels.get(consts.TPU_PRESENT_LABEL) != "true":
                problems.append(f"final: {name} lost {consts.TPU_PRESENT_LABEL}")
            if not any(
                k.startswith(consts.DEPLOY_LABEL_PREFIX) for k in labels
            ):
                problems.append(f"final: {name} has no deploy labels")
            # zero leaked budget holds
            if (
                labels.get(consts.REPARTITION_STATE_LABEL)
                == consts.REPARTITION_STATE_ROLLING
            ):
                problems.append(f"final: {name} leaked a repartition hold")
        # slice honesty, strict: Ready implies full membership
        slices = group_slices(nodes)
        by_name = {n["metadata"]["name"]: n for n in nodes}
        for sid, info in slices.items():
            ready = all(
                (
                    by_name[m].get("metadata", {}).get("labels", {}) or {}
                ).get(consts.SLICE_READY_LABEL)
                == "true"
                for m in info.member_nodes
            )
            want = info.expected_hosts or len(info.member_nodes)
            if ready and len(info.member_nodes) < want:
                problems.append(
                    f"final: slice {sid} Ready with "
                    f"{len(info.member_nodes)}/{want} members"
                )
        return problems
