"""Node-health remediation FSM — detect, quarantine, recover failing hosts.

The port's copy of ``tpu_operator/controllers/remediation.py``. What it
decides (with ``upgrade/upgrade_state.py``, whose docstring holds the
rest): internal names stay the reference's (``tpu_nodes``, the
``REMEDIATION_STATE_*`` values); the zero-allocatable reason names
``consts.GPU_RESOURCE``, read through the port's ``host_allocatable_ok``
(``nvidia.com/gpu`` and ``nvidia.com/mig-*``); the validator pods are the
port's ``slice_status.VALIDATOR_APP``; and an operand pod is one whose
``app`` starts with ``consts.OPERAND_APP_PREFIX`` (``gpu-``), the
reference's ``tpu-`` rule under the port's names, both for the crash-loop
signal and for the restart rung. The interlocks are the reference's.

SURVEY §5 calls failure detection the operator's weakest story: the
device plugin flips chips ``Unhealthy`` (``plugin/server.py``) and
``slice_status.host_allocatable_ok`` sees zero-allocatable hosts, but
before this controller **nothing acted on either signal** — a host with
dead chips kept its schedulable bit and its slice just read
``ready=false`` forever. This controller closes the loop, reusing the
upgrade engine's durable per-node-FSM pattern (node labels as the store,
``upgrade_state.go:419-429`` initial-state annotations, ``maxUnavailable``
budgeting) for *remediation* instead of upgrades.

**Health derivation** (pure, over the pass's in-hand node list plus ONE
namespace pod listing — no per-node reads):

* the kubelet advertises the GPU resource with **zero allocatable**
  (``host_allocatable_ok(node) is False``);
* an **operand pod on the node sits in CrashLoopBackOff**;
* the node carries the operator-validator deploy label but **no Running
  validator pod** backs it.

**The FSM** (persisted in ``tpu.k8s.io/remediation-state`` so it survives
operator restarts)::

    observed ──▶ restart-operands ──▶ revalidate ──▶ cordon-drain ──▶
    quarantined ──▶ recovered        (any step, on health returning)
                └──▶ exhausted       (attempt cap hit — flapping host)

Each escalation step is gated by a jittered exponential backoff and a
per-node attempt cap (``spec.remediation.maxAttempts``), both recorded in
the ``tpu.k8s.io/remediation-attempts`` annotation. Quarantine applies a
``tpu.k8s.io/repair=pending`` **NoSchedule taint + label** and cordons the
node (remembering whether it was already cordoned, the upgrade FSM's
initial-state pattern); the drain evicts GPU workload pods through the
Eviction subresource, so a PodDisruptionBudget veto (429) **defers** the
step instead of failing it. Recovery (chips reappear, validator passes)
uncordons, untaints and clears the FSM; the attempt record survives
recovery so a *flapping* host lands ``exhausted`` instead of looping.

**Two fleet-level guards**:

* a **remediation budget**: disruptions are counted in SLICE units over
  one JOINT disrupted set shared with rolling driver upgrades
  (``upgrade_state.slice_budget`` subtracts remediation-disrupted slices
  from upgrade admission and excludes them from pending; this controller
  counts upgrade-active/failed slices against its own admission). Each
  side enforces its own ``maxUnavailable`` over the joint set — with the
  two knobs equal (both default "25%") that is exactly one pool, and
  upgrades + repairs never jointly exceed the cap. One deliberate exception: ``exhausted`` entry (a
  flapping host past its attempt cap) quarantines WITHOUT waiting for
  budget headroom — the host's slice is already out of service either
  way, so fencing it reduces nothing, while leaving a known-bad flapper
  schedulable would; the exhausted slice still counts against both
  sides' admission from then on;
* a **systemic-failure breaker**: when at least
  ``spec.remediation.systemicThreshold`` of the GPU fleet turns unhealthy
  in one pass, remediation halts — zero drains, zero node writes — and
  the CR gets a ``Degraded/SystemicNodeFailure`` condition plus a Warning
  Event. A bad driver push must not drain the fleet.

**Interlocks**: the remediator never fights another actor's disruption —
nodes inside an announced host-maintenance window
(``tpu.k8s.io/maintenance=pending``), nodes with an in-flight (or failed)
driver-upgrade FSM state, and nodes carrying the
``tpu.k8s.io/remediation.skip`` escape hatch are skipped with a single
log-once note.
"""

from __future__ import annotations

import json
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from tpu_operator_torch import consts
from tpu_operator_torch.obs import LogOnce, flight, trace
from tpu_operator_torch.kube.client import (
    Client,
    ConflictError,
    NotFoundError,
    Obj,
    merge_taint,
    mutate_with_retry,
)

log = logging.getLogger("gpu-operator.remediation")

# a recovered node's attempt record decays after this much quiet time:
# flap detection must span recoveries, but a failure months later is a
# new incident, not attempt N+1 of the old one
ATTEMPTS_DECAY_S = 3600.0

# the systemic breaker never opens on a single unhealthy node, whatever
# the percentage arithmetic says about tiny fleets: one dead host is
# exactly what remediation exists for
BREAKER_MIN_NODES = 2

def _threshold_count(value, total: int) -> int:
    """Node count for the systemic threshold, rounding UP on percentages
    ("at least this fraction" semantics) — unlike the budget's
    ``parse_max_unavailable``, which floors by design: a floor here would
    open the breaker BELOW the configured fraction on odd-sized fleets
    (5 nodes at "50%" must need 3 unhealthy, not 2)."""
    import math

    if total <= 0:
        return 0
    if value is None:
        value = "50%"
    s = str(value).strip()
    if s.endswith("%"):
        try:
            pct = float(s[:-1])
        except ValueError:
            pct = 50.0
        return min(max(1, math.ceil(total * pct / 100.0)), total)
    try:
        return max(1, min(int(s), total))
    except ValueError:
        return total


def pod_crashlooping(pod: Obj) -> bool:
    """Whether any container sits in CrashLoopBackOff — the health
    signal shared by the verdict derivation here and the watch
    predicate in ``main.wire_event_sources`` (a pod entering/leaving
    crashloop must WAKE the reconciler: unlike chip death, it is a Pod
    event, which nothing else watches)."""
    for cs in pod.get("status", {}).get("containerStatuses") or []:
        waiting = (cs.get("state") or {}).get("waiting") or {}
        if waiting.get("reason") == "CrashLoopBackOff":
            return True
    return False


def _now_iso() -> str:
    from datetime import datetime, timezone

    return datetime.now(timezone.utc).isoformat()


def _parse_iso(ts: str) -> float:
    from datetime import datetime, timezone

    try:
        dt = datetime.fromisoformat(ts)
    except (TypeError, ValueError):
        return 0.0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def _utc_now() -> float:
    return time.time()


@dataclass
class NodeVerdict:
    """One node's derived health this pass."""

    name: str
    node: Obj
    state: str  # current FSM label ("" = not in the FSM)
    reasons: List[str] = field(default_factory=list)
    skip_reason: Optional[str] = None  # interlock: why we must not act

    @property
    def unhealthy(self) -> bool:
        return bool(self.reasons)


@dataclass
class RemediationSummary:
    """What one remediation pass saw and did — feeds ``status.remediation``,
    the gauges, and the reconciler's requeue decision."""

    total: int = 0
    unhealthy: int = 0
    quarantined: int = 0
    exhausted: int = 0
    skipped: int = 0  # interlocked nodes left alone (log-once)
    errored: bool = False  # the pass itself raised (counts unknown)
    breaker_open: bool = False
    breaker_threshold: int = 0
    budget_cap: int = 0  # maxUnavailable in slice units
    disrupted_slices: int = 0  # upgrades + repairs jointly
    budget_deferred: int = 0  # drains the budget refused this pass
    unhealthy_hosts: List[str] = field(default_factory=list)
    # the slice ids behind disrupted_slices, INCLUDING escalations this
    # pass wrote — the same-pass repartition roll reads these so its
    # admission is not blind to quarantine labels still on the wire
    # (the pass-start node snapshot predates them)
    disrupted_sids: Set[str] = field(default_factory=set)
    # hosts THIS pass escalated into a disrupted state (cordon-drain /
    # exhausted entry): the same-pass rollout health gate reads these —
    # the quarantine labels are on the wire but not in the pass-start
    # node snapshot, and a canary quarantined in the very pass its
    # observation window elapses must block the promotion
    newly_disrupted_hosts: List[str] = field(default_factory=list)

    @property
    def active(self) -> bool:
        """Whether remediation has in-flight work (level-triggered
        requeue wanted even when the operands are all Ready — backoffs
        elapse without any cluster event to wake the reconciler). An
        errored pass counts: the retry needs a clock too."""
        return self.unhealthy > 0 or self.breaker_open or self.errored

    def status_block(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "unhealthy": self.unhealthy,
            "quarantined": self.quarantined,
            "exhausted": self.exhausted,
        }
        if self.breaker_open:
            out["breakerOpen"] = True
        return out


class NodeRemediationController:
    """Level-triggered remediation pass, one step per node per pass —
    wired into the reconcile pass after ``label_tpu_nodes`` (the node
    list it consumes is the pass's labeled list; no extra node reads)."""

    def __init__(self, client: Client, namespace: str = ""):
        self.client = client
        self.namespace = namespace
        # process-lifetime counters (gauges + /debug/vars)
        self.attempts_total = 0
        self.drains_vetoed_total = 0
        self.budget_deferred_total = 0
        self.breaker_opens_total = 0
        self.last_summary: Dict[str, object] = {}
        # log-once state: (node, reason-kind) pairs already noted; an
        # entry is dropped when the condition clears so a recurrence
        # logs again (once per stretch, not once per process)
        self._logged = LogOnce()
        self._breaker_was_open = False

    def forget_node(self, name: str) -> None:
        """Event-speed ledger prune for a deleted node (the keyed delta
        path routes node DELETEs here, controllers/delta.py): its
        log-once suppressions die with it so a same-named rejoin starts
        clean, without waiting for the next full pass's liveness
        ``prune``."""
        self._logged.discard_subject(name)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """/debug/vars "remediation" payload."""
        return {
            "last_pass": self.last_summary,
            "attempts_total": self.attempts_total,
            "drains_vetoed_total": self.drains_vetoed_total,
            "budget_deferred_total": self.budget_deferred_total,
            "breaker_opens_total": self.breaker_opens_total,
        }

    # ------------------------------------------------------------------
    # the pass
    # ------------------------------------------------------------------
    def reconcile(
        self, tpu_nodes: List[Obj], spec, namespace: str
    ) -> Optional[RemediationSummary]:
        """One remediation pass over the labeled GPU node list. When
        remediation is disabled, strips any leftover FSM state and
        returns an all-zero summary (so a stale ``status.remediation``
        block clears); else the pass summary."""
        self.namespace = namespace
        if spec is None or not spec.is_enabled():
            self._cleanup_disabled(tpu_nodes)
            self.last_summary = {"enabled": False}
            return RemediationSummary(total=len(tpu_nodes))

        pods_by_node, validator_nodes = self._namespace_pods_by_node()
        verdicts = [
            self._verdict(node, pods_by_node, validator_nodes)
            for node in tpu_nodes
        ]
        verdicts.sort(key=lambda v: v.name)

        summary = RemediationSummary(total=len(verdicts))
        summary.unhealthy = sum(1 for v in verdicts if v.unhealthy)
        summary.unhealthy_hosts = [v.name for v in verdicts if v.unhealthy]

        # --- systemic-failure breaker --------------------------------
        # keyed on ACTIONABLE unhealthy nodes only: a rolling upgrade
        # legitimately takes validators/chips down on the nodes it owns
        # (interlocked = skipped anyway), and counting those would open
        # the breaker on every wide upgrade roll. Already-disrupted
        # nodes (quarantined/exhausted) are excluded too — the breaker
        # detects a fleet TURNING unhealthy at once, and independent
        # failures accumulating over weeks, each already contained,
        # must not add up to a false "systemic" verdict
        from tpu_operator_torch.upgrade.upgrade_state import parse_max_unavailable

        actionable = sum(
            1
            for v in verdicts
            if v.unhealthy
            and not v.skip_reason
            and v.state not in consts.REMEDIATION_DISRUPTED_STATES
        )
        summary.breaker_threshold = max(
            BREAKER_MIN_NODES,
            _threshold_count(
                getattr(spec, "systemic_threshold", None), len(verdicts)
            ),
        )
        if actionable >= summary.breaker_threshold:
            summary.breaker_open = True
            self._open_breaker(summary)
            self._finish(summary, verdicts)
            return summary
        if self._breaker_was_open:
            self._breaker_was_open = False
            log.warning(
                "systemic-failure breaker closed: %d of %d GPU nodes "
                "unhealthy (threshold %d); remediation resumes",
                summary.unhealthy,
                summary.total,
                summary.breaker_threshold,
            )

        # --- shared disruption budget, in slice units ----------------
        from tpu_operator_torch.controllers.slice_status import group_slices
        from tpu_operator_torch.upgrade.upgrade_state import (
            ACTIVE_STATES as UPGRADE_ACTIVE,
        )
        from tpu_operator_torch.upgrade.upgrade_state import STATE_FAILED

        slices = group_slices(tpu_nodes)
        slice_of = {
            member: sid
            for sid, info in slices.items()
            for member in info.member_nodes
        }
        from tpu_operator_torch.kube.disruption import repartition_disrupted

        disrupted: Set[str] = set()
        for v in verdicts:
            labels = v.node.get("metadata", {}).get("labels", {}) or {}
            ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
            if (
                v.state in consts.REMEDIATION_DISRUPTED_STATES
                or ustate in UPGRADE_ACTIVE
                or ustate == STATE_FAILED
                # third consumer of the one pool: a slice mid live
                # re-partition roll consumes remediation headroom too
                or repartition_disrupted(v.node)
            ):
                disrupted.add(slice_of.get(v.name, v.name))
        max_unavailable = getattr(spec, "max_unavailable", None)
        summary.budget_cap = parse_max_unavailable(
            max_unavailable, len(slices)
        )

        # --- per-node FSM step ---------------------------------------
        for v in verdicts:
            try:
                self._step_node(v, spec, summary, disrupted, slice_of)
            except NotFoundError:
                log.info("node %s vanished mid-remediation-pass", v.name)
            except ConflictError:
                log.warning(
                    "node %s kept conflicting mid-remediation-pass; "
                    "retrying next reconcile",
                    v.name,
                )
        summary.disrupted_slices = len(disrupted)
        summary.disrupted_sids = set(disrupted)
        # retire log-once state for vanished nodes: lifecycle churn
        # (preemption waves deleting quarantined hosts) would otherwise
        # grow the set without bound, and a rejoin under the same name
        # would inherit the old suppression
        live = {v.name for v in verdicts}
        self._logged.prune(live)
        self._finish(summary, verdicts)
        return summary

    def _finish(self, summary: RemediationSummary, verdicts) -> None:
        # quarantine counts reflect post-step labels where we wrote them
        # this pass; a label we just set is mirrored in v.state
        summary.quarantined = sum(
            1
            for v in verdicts
            if v.state
            in (
                consts.REMEDIATION_STATE_CORDON_DRAIN,
                consts.REMEDIATION_STATE_QUARANTINED,
            )
        )
        summary.exhausted = sum(
            1
            for v in verdicts
            if v.state == consts.REMEDIATION_STATE_EXHAUSTED
        )
        summary.skipped = sum(1 for v in verdicts if v.skip_reason)
        self.last_summary = {
            "enabled": True,
            "total": summary.total,
            "unhealthy": summary.unhealthy,
            "unhealthy_hosts": summary.unhealthy_hosts,
            "quarantined": summary.quarantined,
            "exhausted": summary.exhausted,
            "skipped": summary.skipped,
            "breaker_open": summary.breaker_open,
            "breaker_threshold": summary.breaker_threshold,
            "budget_cap": summary.budget_cap,
            "disrupted_slices": summary.disrupted_slices,
        }

    # ------------------------------------------------------------------
    # health derivation (pure over in-hand objects)
    # ------------------------------------------------------------------
    def _namespace_pods_by_node(self):
        """ONE namespace pod listing for the whole pass (served by the
        scope-filtered Pod informer), indexed by node; also returns the
        set of nodes with a Running+ready validator pod."""
        from tpu_operator_torch.controllers.slice_status import VALIDATOR_APP

        pods_by_node: Dict[str, List[Obj]] = {}
        validator_nodes: Set[str] = set()
        for pod in self.client.list("v1", "Pod", self.namespace):
            node = pod.get("spec", {}).get("nodeName")
            if not node:
                continue
            pods_by_node.setdefault(node, []).append(pod)
            if (pod.get("metadata", {}).get("labels") or {}).get(
                "app"
            ) == VALIDATOR_APP and pod.get("status", {}).get(
                "phase"
            ) == "Running":
                statuses = pod.get("status", {}).get("containerStatuses")
                if statuses is None or all(
                    cs.get("ready", True) for cs in statuses
                ):
                    validator_nodes.add(node)
        return pods_by_node, validator_nodes

    def _verdict(
        self,
        node: Obj,
        pods_by_node: Dict[str, List[Obj]],
        validator_nodes: Set[str],
    ) -> NodeVerdict:
        from tpu_operator_torch.controllers.slice_status import host_allocatable_ok
        from tpu_operator_torch.upgrade.upgrade_state import (
            ACTIVE_STATES as UPGRADE_ACTIVE,
        )
        from tpu_operator_torch.upgrade.upgrade_state import STATE_FAILED

        name = node["metadata"]["name"]
        labels = node.get("metadata", {}).get("labels", {}) or {}
        v = NodeVerdict(
            name=name,
            node=node,
            state=labels.get(consts.REMEDIATION_STATE_LABEL, ""),
        )
        if host_allocatable_ok(node) is False:
            v.reasons.append(f"0 allocatable {consts.GPU_RESOURCE}")
        crash = sorted(
            p["metadata"]["name"]
            for p in pods_by_node.get(name, ())
            if pod_crashlooping(p)
            # same gpu-* operand filter as the restart rung: a user pod
            # crashlooping in the operator namespace is not a node-health
            # signal, and restarting operands could never clear it — the
            # FSM would escalate a healthy host all the way to quarantine
            and (
                (p["metadata"].get("labels") or {}).get("app") or ""
            ).startswith(consts.OPERAND_APP_PREFIX)
        )
        if crash:
            v.reasons.append(
                "operand pod(s) in CrashLoopBackOff: " + ", ".join(crash)
            )
        if (
            labels.get(
                consts.DEPLOY_LABEL_PREFIX
                + consts.COMPONENT_OPERATOR_VALIDATOR
            )
            == "true"
            and name not in validator_nodes
        ):
            v.reasons.append("validator pod not Running")

        # interlocks: another actor owns this node's disruption
        if labels.get(consts.REMEDIATION_SKIP_LABEL) == "true":
            v.skip_reason = f"{consts.REMEDIATION_SKIP_LABEL}=true"
        elif labels.get(consts.MAINTENANCE_STATE_LABEL):
            v.skip_reason = "active host-maintenance window"
        elif (
            labels.get(consts.REPARTITION_STATE_LABEL)
            == consts.REPARTITION_STATE_ROLLING
        ):
            # a live re-partition pauses the node's chip clients on
            # purpose — the resulting zero-allocatable / validator-down
            # window is self-inflicted, not a node-health incident
            v.skip_reason = "in-flight slice re-partition roll"
        else:
            ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
            if ustate in UPGRADE_ACTIVE or ustate == STATE_FAILED:
                v.skip_reason = f"in-flight driver upgrade ({ustate})"
        return v

    # ------------------------------------------------------------------
    # FSM bookkeeping on the node object (labels + annotations)
    # ------------------------------------------------------------------
    def _read_attempts(self, node: Obj):
        """(attempts, retry_at_epoch) from the attempts annotation.

        Decay applies ONLY to a node that is OUT of the FSM (no state
        label): a record quiet for ``ATTEMPTS_DECAY_S`` after recovery
        reads as zero attempts — a relapse an hour later is a new
        incident, not attempt N+1 of the old one. A node mid-FSM never
        decays, however long the incident runs: decaying an ACTIVE
        record would erase the maxAttempts cap (long quarantines, large
        backoffs) and let a wedged host cycle restarts/drains forever.
        Recovery re-stamps ``updatedAt`` (``_touch_attempts``) so the
        quiet clock starts at recovery, not at the last escalation."""
        raw = (node["metadata"].get("annotations", {}) or {}).get(
            consts.REMEDIATION_ATTEMPTS_ANNOTATION, ""
        )
        if not raw:
            return 0, 0.0
        try:
            rec = json.loads(raw)
            attempts = int(rec.get("attempts", 0))
            retry_at = _parse_iso(rec.get("retryAt", ""))
            updated = _parse_iso(rec.get("updatedAt", ""))
        except (ValueError, TypeError, AttributeError):
            return 0, 0.0
        in_fsm = consts.REMEDIATION_STATE_LABEL in (
            node["metadata"].get("labels", {}) or {}
        )
        if (
            not in_fsm
            and updated
            and _utc_now() - updated > ATTEMPTS_DECAY_S
        ):
            return 0, 0.0
        return attempts, retry_at

    def _touch_attempts(self, name: str) -> None:
        """Re-stamp the attempt record's ``updatedAt`` without changing
        the count — called at recovery so the decay window measures
        quiet-time SINCE recovery."""

        def mutate(node):
            ann = node["metadata"].setdefault("annotations", {})
            raw = ann.get(consts.REMEDIATION_ATTEMPTS_ANNOTATION)
            if not raw:
                return False
            try:
                rec = json.loads(raw)
            except (ValueError, TypeError):
                return False
            rec["updatedAt"] = _now_iso()
            ann[consts.REMEDIATION_ATTEMPTS_ANNOTATION] = json.dumps(rec)
            return True

        mutate_with_retry(self.client, "v1", "Node", name, mutate=mutate)

    def _write_attempts(self, name: str, attempts: int, delay_s: float):
        """Persist the attempt count and the jittered next-step deadline
        (equal jitter: uniform(d/2, d)) — sampled ONCE and recorded, so
        an operator restart resumes the same clock."""
        retry_at = _utc_now() + random.uniform(delay_s / 2, delay_s)
        record = json.dumps(
            {
                "attempts": attempts,
                "retryAt": _iso_at(retry_at),
                "updatedAt": _now_iso(),
            }
        )

        def mutate(node):
            ann = node["metadata"].setdefault("annotations", {})
            if ann.get(consts.REMEDIATION_ATTEMPTS_ANNOTATION) == record:
                return False
            ann[consts.REMEDIATION_ATTEMPTS_ANNOTATION] = record
            return True

        mutate_with_retry(self.client, "v1", "Node", name, mutate=mutate)

    def _backoff_s(self, spec, attempts: int) -> float:
        base = getattr(spec, "backoff_seconds", None)
        base = 30.0 if base is None else float(base)  # 0 is a legal value
        return min(base * 16, base * (2**attempts))

    def _set_state(self, name: str, state: Optional[str]) -> None:
        """Write (or, with None, clear) the FSM label + since stamp."""

        def mutate(node):
            meta = node["metadata"]
            labels = meta.setdefault("labels", {})
            ann = meta.setdefault("annotations", {})
            if state is None:
                changed = False
                if consts.REMEDIATION_STATE_LABEL in labels:
                    del labels[consts.REMEDIATION_STATE_LABEL]
                    changed = True
                if consts.REMEDIATION_STATE_SINCE_ANNOTATION in ann:
                    del ann[consts.REMEDIATION_STATE_SINCE_ANNOTATION]
                    changed = True
                return changed
            if labels.get(consts.REMEDIATION_STATE_LABEL) == state:
                return False
            labels[consts.REMEDIATION_STATE_LABEL] = state
            ann[consts.REMEDIATION_STATE_SINCE_ANNOTATION] = _now_iso()
            return True

        mutate_with_retry(self.client, "v1", "Node", name, mutate=mutate)
        # flight timeline: every FSM transition is a causal post-mortem
        # event (low rate — at most one per unhealthy node per pass)
        flight.record(
            "remediation.fsm", node=name, state=state or "cleared"
        )
        if state in (
            consts.REMEDIATION_STATE_CORDON_DRAIN,
            consts.REMEDIATION_STATE_QUARANTINED,
        ):
            # the FSM just consumed (or confirmed) a shared-budget
            # disruption unit on this host's slice
            flight.record("budget.admit", owner="remediation", node=name)
        trace.instant("fsm.remediation_transition", node=name, state=state)
        if state is not None:
            log.info("node %s remediation-state -> %s", name, state)

    # ------------------------------------------------------------------
    # FSM actions
    # ------------------------------------------------------------------
    def _step_node(
        self,
        v: NodeVerdict,
        spec,
        summary: RemediationSummary,
        disrupted: Set[str],
        slice_of: Dict[str, str],
    ) -> None:
        name = v.name
        if v.skip_reason and (v.unhealthy or v.state):
            self._log_once(
                (name, "interlock"),
                "node %s: unhealthy/in-FSM but deferring to %s",
                name,
                v.skip_reason,
            )
            return
        self._logged.discard((name, "interlock"))

        if not v.unhealthy:
            self._step_healthy(v, spec)
            return

        max_attempts = int(getattr(spec, "max_attempts", 5) or 0)
        attempts, retry_at = self._read_attempts(v.node)
        now = _utc_now()
        state = v.state
        sid = slice_of.get(name, name)

        if state in ("", consts.REMEDIATION_STATE_RECOVERED):
            # (re-)entry: a fresh failure — or a relapse. A relapsed node
            # whose attempt budget is already spent is FLAPPING: it goes
            # straight to exhausted instead of burning another cycle of
            # restarts and drains.
            if attempts >= max_attempts > 0:
                self._enter_exhausted(v, summary, sid, disrupted)
                return
            self._set_state(name, consts.REMEDIATION_STATE_OBSERVED)
            self._write_attempts(
                name, attempts, self._backoff_s(spec, attempts)
            )
            v.state = consts.REMEDIATION_STATE_OBSERVED
            log.warning(
                "node %s unhealthy (%s); observing before remediation",
                name,
                "; ".join(v.reasons),
            )
            return

        if state == consts.REMEDIATION_STATE_OBSERVED:
            if now < retry_at:
                return  # dwell: debounce a transient blip
            self._set_state(name, consts.REMEDIATION_STATE_RESTART)
            v.state = consts.REMEDIATION_STATE_RESTART
            attempts += 1
            self.attempts_total += 1
            self._write_attempts(
                name, attempts, self._backoff_s(spec, attempts)
            )
            self._restart_operands(v)
            self._set_state(name, consts.REMEDIATION_STATE_REVALIDATE)
            v.state = consts.REMEDIATION_STATE_REVALIDATE
            return

        if state == consts.REMEDIATION_STATE_RESTART:
            # operator restarted mid-step: redo the (idempotent) restart
            self._restart_operands(v)
            self._set_state(name, consts.REMEDIATION_STATE_REVALIDATE)
            v.state = consts.REMEDIATION_STATE_REVALIDATE
            return

        if state == consts.REMEDIATION_STATE_REVALIDATE:
            if now < retry_at:
                return  # give the restarted operands time to validate
            if attempts >= max_attempts > 0:
                self._enter_exhausted(v, summary, sid, disrupted)
                return
            # escalate to cordon-drain — within the SHARED budget. A
            # slice already disrupted (sibling host mid-upgrade or
            # already quarantined) costs nothing extra; a fresh slice
            # needs headroom under the cap.
            if sid not in disrupted and len(disrupted) >= summary.budget_cap:
                summary.budget_deferred += 1
                self.budget_deferred_total += 1
                self._log_once(
                    (name, "budget"),
                    "node %s: cordon-drain deferred — %d slice(s) already "
                    "disrupted (upgrades + repairs) at the maxUnavailable "
                    "cap of %d",
                    name,
                    len(disrupted),
                    summary.budget_cap,
                )
                return
            self._logged.discard((name, "budget"))
            attempts += 1
            self.attempts_total += 1
            self._write_attempts(
                name, attempts, self._backoff_s(spec, attempts)
            )
            self._apply_quarantine(name)
            self._set_state(name, consts.REMEDIATION_STATE_CORDON_DRAIN)
            v.state = consts.REMEDIATION_STATE_CORDON_DRAIN
            disrupted.add(sid)
            summary.newly_disrupted_hosts.append(name)
            self._record_event(
                "Warning",
                "NodeQuarantined",
                f"node {name} cordoned and tainted "
                f"{consts.REPAIR_TAINT_KEY}={consts.REPAIR_PENDING} for "
                f"repair ({'; '.join(v.reasons)}); slice {sid} is degraded "
                f"until the host recovers",
                dedup_extra=name,
            )
            # fall through into the drain below
            state = consts.REMEDIATION_STATE_CORDON_DRAIN

        if state == consts.REMEDIATION_STATE_CORDON_DRAIN:
            disrupted.add(sid)
            self._apply_quarantine(name)  # idempotent (restart-safe)
            if self._drain(v):
                self._set_state(name, consts.REMEDIATION_STATE_QUARANTINED)
                v.state = consts.REMEDIATION_STATE_QUARANTINED
            return

        if state == consts.REMEDIATION_STATE_QUARANTINED:
            disrupted.add(sid)
            return  # hold until health returns (handled above) or a human acts

        if state == consts.REMEDIATION_STATE_EXHAUSTED:
            disrupted.add(sid)
            self._apply_quarantine(name)  # keep the quarantine asserted
            # keep draining too: workloads still pinned to the known-bad
            # host (e.g. an exhausted entry whose eviction was vetoed)
            # must not ride it until the chips die mid-job
            self._drain(v)
            return

    def _step_healthy(self, v: NodeVerdict, spec) -> None:
        """Health returned: unwind whatever the FSM had applied. An
        ``exhausted`` node stays quarantined — it flapped past the
        attempt cap, and only a human (clearing the state label or the
        attempts annotation) puts it back in service."""
        name = v.name
        state = v.state
        if not state:
            return
        if state == consts.REMEDIATION_STATE_EXHAUSTED:
            return
        if state == consts.REMEDIATION_STATE_RECOVERED:
            # stable through a full pass: leave the FSM (the attempts
            # record stays, decaying after ATTEMPTS_DECAY_S, so a flap
            # re-entering soon is recognized as one)
            self._set_state(name, None)
            v.state = ""
            return
        if state in (
            consts.REMEDIATION_STATE_CORDON_DRAIN,
            consts.REMEDIATION_STATE_QUARANTINED,
        ):
            self._lift_quarantine(name)
        # decay measures quiet-time from RECOVERY (flap detection wants
        # "relapsed soon after recovering", not "soon after escalating")
        self._touch_attempts(name)
        self._set_state(name, consts.REMEDIATION_STATE_RECOVERED)
        v.state = consts.REMEDIATION_STATE_RECOVERED
        self._record_event(
            "Normal",
            "NodeRemediationRecovered",
            f"node {name} is healthy again; quarantine lifted and "
            f"remediation state cleared",
            dedup_extra=name,
        )
        log.info("node %s recovered (was %s)", name, state)

    def _enter_exhausted(
        self,
        v: NodeVerdict,
        summary: RemediationSummary,
        sid: str,
        disrupted: Set[str],
    ) -> None:
        """Attempt cap hit: quarantine hard and stop escalating — a
        flapping host must not consume restarts and drains forever."""
        self._apply_quarantine(v.name)
        self._set_state(v.name, consts.REMEDIATION_STATE_EXHAUSTED)
        v.state = consts.REMEDIATION_STATE_EXHAUSTED
        disrupted.add(sid)
        summary.newly_disrupted_hosts.append(v.name)
        # a quarantine without a drain would leave already-scheduled GPU
        # jobs riding the known-bad host (NoSchedule only gates NEW
        # placement); best-effort here, retried from the exhausted hold
        self._drain(v)
        self._record_event(
            "Warning",
            "NodeRemediationExhausted",
            f"node {v.name} hit the remediation attempt cap and stays "
            f"quarantined ({'; '.join(v.reasons) or 'flapping health'}); "
            f"clear the {consts.REMEDIATION_STATE_LABEL} label after "
            f"repairing the host to return it to service",
            dedup_extra=v.name,
        )
        log.error(
            "node %s: remediation attempts exhausted; quarantined until "
            "a human intervenes",
            v.name,
        )

    def _restart_operands(self, v: NodeVerdict) -> None:
        """Delete the node's operand pods (the DaemonSets recreate them)
        — the cheapest remediation: a wedged plugin/validator often
        clears with a restart, and revalidation then proves it."""
        deleted = []
        for pod in self.client.list(
            "v1",
            "Pod",
            self.namespace,
            field_selector={"spec.nodeName": v.name},
        ):
            meta = pod["metadata"]
            app = (meta.get("labels") or {}).get("app") or ""
            if not app.startswith(consts.OPERAND_APP_PREFIX):
                # only operand (DaemonSet) pods — every operator-rendered
                # app is gpu-*; a user pod that merely lives in the
                # operator namespace must not be restarted
                continue
            if self.client.delete_if_exists(
                "v1", "Pod", meta["name"], meta.get("namespace", "")
            ):
                deleted.append(meta["name"])
        log.warning(
            "node %s: restarted %d operand pod(s) for remediation (%s)",
            v.name,
            len(deleted),
            ", ".join(deleted) or "none found",
        )

    def _apply_quarantine(self, name: str) -> None:
        """Cordon + repair taint + repair label, remembering whether the
        node was already cordoned (recovery restores, not resets).
        Idempotent: re-asserting an applied quarantine writes nothing."""

        def mutate(node):
            changed = False
            meta = node["metadata"]
            labels = meta.setdefault("labels", {})
            ann = meta.setdefault("annotations", {})
            spec_ = node.setdefault("spec", {})
            if consts.REMEDIATION_INITIAL_STATE_ANNOTATION not in ann:
                ann[consts.REMEDIATION_INITIAL_STATE_ANNOTATION] = (
                    "true" if spec_.get("unschedulable", False) else "false"
                )
                changed = True
            if not spec_.get("unschedulable", False):
                spec_["unschedulable"] = True
                changed = True
            if labels.get(consts.REPAIR_LABEL) != consts.REPAIR_PENDING:
                labels[consts.REPAIR_LABEL] = consts.REPAIR_PENDING
                changed = True
            taints = spec_.setdefault("taints", [])
            if merge_taint(
                taints,
                consts.REPAIR_TAINT_KEY,
                consts.REPAIR_PENDING,
                "NoSchedule",
            ):
                changed = True
            return changed

        mutate_with_retry(self.client, "v1", "Node", name, mutate=mutate)

    def _lift_quarantine(self, name: str) -> None:
        """Untaint, unlabel, and uncordon (unless the node was cordoned
        before remediation touched it)."""

        def mutate(node):
            changed = False
            meta = node["metadata"]
            labels = meta.setdefault("labels", {})
            ann = meta.setdefault("annotations", {})
            spec_ = node.setdefault("spec", {})
            if labels.pop(consts.REPAIR_LABEL, None) is not None:
                changed = True
            taints = spec_.get("taints") or []
            kept = [
                t for t in taints if t.get("key") != consts.REPAIR_TAINT_KEY
            ]
            if len(kept) != len(taints):
                if kept:
                    spec_["taints"] = kept
                else:
                    spec_.pop("taints", None)
                changed = True
            initial = ann.pop(
                consts.REMEDIATION_INITIAL_STATE_ANNOTATION, None
            )
            if initial is not None:
                changed = True
            if initial != "true" and spec_.get("unschedulable", False):
                spec_["unschedulable"] = False
                changed = True
            return changed

        mutate_with_retry(self.client, "v1", "Node", name, mutate=mutate)

    def _drain(self, v: NodeVerdict) -> bool:
        """Evict the node's GPU workload pods through the Eviction
        subresource. A PDB veto (429) DEFERS the step — the FSM stays in
        cordon-drain and the level-triggered requeue retries; the budget
        may free up (a replica turns Ready elsewhere) before we ever
        need to give up. Returns True when the node is clear."""
        from tpu_operator_torch.upgrade.upgrade_state import PodManager

        pods = PodManager(self.client, self.namespace)
        victims = pods.tpu_pods_on_node(v.name)
        if not victims:
            return True
        res = pods.evict_pods(victims, force=False)
        if res.blocked:
            self.drains_vetoed_total += len(res.blocked)
            self._log_once(
                (v.name, "pdb"),
                "node %s: remediation drain vetoed by a disruption budget "
                "(%s); deferring — will retry each pass",
                v.name,
                res.blocked[0],
            )
            return False
        self._logged.discard((v.name, "pdb"))
        if res.skipped:
            # unmanaged (ownerless) pods are never force-deleted by
            # remediation: nothing would recreate the work. The drain
            # holds — SAY SO, once, with the way out (unlike the PDB
            # veto, nothing here ever frees up by itself)
            self._log_once(
                (v.name, "unmanaged"),
                "node %s: remediation drain held by %d unmanaged "
                "(ownerless) GPU pod(s) that will not be force-deleted; "
                "delete them by hand, or set %s=true to leave the node "
                "to a human",
                v.name,
                res.skipped,
                consts.REMEDIATION_SKIP_LABEL,
            )
            return False
        self._logged.discard((v.name, "unmanaged"))
        return not pods.tpu_pods_on_node(v.name)

    # ------------------------------------------------------------------
    # breaker + cleanup
    # ------------------------------------------------------------------
    def _open_breaker(self, summary: RemediationSummary) -> None:
        """Systemic failure: better a degraded-but-diagnosable fleet than
        an operator-inflicted total outage. ZERO node writes happen while
        the breaker is open."""
        if not self._breaker_was_open:
            self._breaker_was_open = True
            self.breaker_opens_total += 1
            log.error(
                "SYSTEMIC node failure: %d of %d GPU nodes unhealthy "
                "(threshold %d) — remediation halted, zero drains issued "
                "(a bad driver push must not drain the fleet)",
                summary.unhealthy,
                summary.total,
                summary.breaker_threshold,
            )
        self._record_event(
            "Warning",
            "SystemicNodeFailure",
            f"{summary.unhealthy} of {summary.total} GPU nodes are "
            f"unhealthy (threshold {summary.breaker_threshold}); "
            f"remediation is halted with zero drains until the fleet "
            f"recovers — investigate a fleet-wide cause (bad driver "
            f"push, network partition) before clearing",
            dedup_extra="systemic",
        )

    def _cleanup_disabled(self, tpu_nodes: List[Obj]) -> None:
        """Remediation switched off: strip FSM state and lift quarantines
        (the reference's cleanup_state_labels discipline). Touches only
        nodes that actually carry our labels — the steady disabled path
        scans label dicts and writes nothing."""
        for node in tpu_nodes:
            labels = node.get("metadata", {}).get("labels", {}) or {}
            if (
                consts.REMEDIATION_STATE_LABEL not in labels
                and consts.REPAIR_LABEL not in labels
            ):
                continue
            name = node["metadata"]["name"]
            try:
                state = labels.get(consts.REMEDIATION_STATE_LABEL)
                if state in consts.REMEDIATION_DISRUPTED_STATES:
                    self._lift_quarantine(name)
                self._set_state(name, None)

                def mutate(fresh):
                    changed = False
                    meta = fresh["metadata"]
                    fl = meta.setdefault("labels", {})
                    ann = meta.setdefault("annotations", {})
                    if fl.pop(consts.REPAIR_LABEL, None) is not None:
                        changed = True
                    for key in (
                        consts.REMEDIATION_ATTEMPTS_ANNOTATION,
                        consts.REMEDIATION_INITIAL_STATE_ANNOTATION,
                    ):
                        if ann.pop(key, None) is not None:
                            changed = True
                    return changed

                mutate_with_retry(
                    self.client, "v1", "Node", name, mutate=mutate
                )
                log.info(
                    "node %s: remediation disabled; state stripped", name
                )
            except (NotFoundError, ConflictError):
                continue

    # ------------------------------------------------------------------
    def _log_once(self, key: tuple, msg: str, *args) -> None:
        self._logged.log(log, key, msg, *args)

    def _record_event(
        self, etype: str, reason: str, message: str, dedup_extra: str = ""
    ) -> None:
        from tpu_operator_torch.kube.events import cluster_policy_ref, record_event

        record_event(
            self.client,
            self.namespace,
            cluster_policy_ref(),
            etype,
            reason,
            message,
            dedup_extra=dedup_extra,
        )


def _iso_at(epoch: float) -> str:
    from datetime import datetime, timezone

    return datetime.fromtimestamp(epoch, tz=timezone.utc).isoformat()
