"""Live slice re-partition roll — the fleet half of the MIG-reconfigure
story, and the THIRD consumer of the shared disruption budget.

The per-node slice manager (``sliceman/slice_manager.py``) is a daemon:
it sees ``tpu.k8s.io/tpu.slice.config`` change on ITS node, pauses the
chip clients, applies the named layout, reports through
``…slice.config.state``. What nothing did before this controller is
change that label across a BUSY fleet safely: flipping a thousand nodes
at once would pause every device plugin in the cluster simultaneously —
a self-inflicted full outage the reference's mig-manager avoids only by
being operated by hand.

This controller rolls a changed fleet-wide layout (``spec.sliceManager
.config.default``) node-by-node at SLICE granularity through the same
``maxUnavailable`` pool rolling driver upgrades and node-health
remediation already share (``kube/disruption.py`` joint accounting):

* a slice is admitted into the roll as ONE unit — every member host gets
  ``tpu.k8s.io/repartition-state=rolling`` plus the new desired config
  label (state reset to ``pending``) in one write each;
* while any member rolls, the slice counts against the joint disrupted
  set, so upgrades and remediation admissions both see it (and vice
  versa: a slice mid-upgrade or quarantined is never admitted here);
* the hold releases when the node's slice manager reports the new
  layout applied (``state=success`` under the desired config) — the
  ``rolling`` label is cleared and the budget unit returns to the pool;
* all state lives on node labels, so the roll survives operator
  restarts, and a node deleted mid-roll (spot preemption) releases its
  hold the moment it leaves the node listing — nothing to retire.

Like remediation, the controller runs inside the reconcile pass over the
pass's in-hand node list; with no desired layout configured it costs a
label-dict scan and writes nothing (the 50 ms steady-pass gate holds).

The port's copy of ``tpu_operator/controllers/repartition.py``. A layout
name is opaque to it: the controller rolls whatever string
``spec.sliceManager.config.default`` names, and the port's slice manager
reads it from its layout file (``all-1x1``, ``all-1x2``, ...). The states
it waits on are the port's ``sliceman.slice_manager.STATE_*``; the names
it keeps are the reference's (``tpu_nodes``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from tpu_operator_torch import consts
from tpu_operator_torch.obs import LogOnce, flight
from tpu_operator_torch.kube.client import (
    Client,
    ConflictError,
    NotFoundError,
    Obj,
    mutate_with_retry,
)

log = logging.getLogger("gpu-operator.repartition")


@dataclass
class RepartitionSummary:
    """What one roll pass saw and did — feeds /debug/vars and the
    reconciler's requeue decision."""

    total: int = 0  # GPU nodes considered
    desired: str = ""  # the fleet-wide layout profile (empty = no roll)
    pending_slices: int = 0  # slices still needing the new layout
    rolling_slices: int = 0  # slices currently holding a budget unit
    completed_nodes: int = 0  # holds released this pass
    admitted_slices: int = 0  # slices admitted this pass
    deferred_slices: int = 0  # admissions the budget refused this pass
    failed_nodes: List[str] = field(default_factory=list)
    budget_cap: int = 0
    disrupted_slices: int = 0  # joint set (upgrades+remediation+this)

    @property
    def active(self) -> bool:
        """In-flight or pending work wants the level-triggered requeue:
        budget headroom opens without any cluster event when another
        consumer's disruption completes."""
        return self.rolling_slices > 0 or self.pending_slices > 0


class SliceRepartitionController:
    """Level-triggered fleet roll, at most one admission wave per pass."""

    def __init__(self, client: Client, namespace: str = ""):
        self.client = client
        self.namespace = namespace
        self.rolls_started_total = 0
        self.rolls_completed_total = 0
        self.budget_deferred_total = 0
        self.last_summary: Dict[str, object] = {}
        self._logged = LogOnce()

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """/debug/vars "repartition" payload."""
        return {
            "last_pass": self.last_summary,
            "rolls_started_total": self.rolls_started_total,
            "rolls_completed_total": self.rolls_completed_total,
            "budget_deferred_total": self.budget_deferred_total,
        }

    # ------------------------------------------------------------------
    def reconcile(
        self,
        tpu_nodes: List[Obj],
        spec,
        namespace: str,
        extra_disrupted: Optional[Set[str]] = None,
        admit_filter: Optional[Set[str]] = None,
    ) -> RepartitionSummary:
        """One roll pass over the labeled GPU node list. ``spec`` is
        ``cp.spec.slice_manager``; with no ``config.default`` the pass
        only clears leftover ``rolling`` labels (an aborted roll must not
        hold budget forever). ``extra_disrupted`` is the same-pass
        remediation disrupted slice set: its label writes are on the wire
        but not yet in ``tpu_nodes``, and counting them here is what
        keeps the two same-pass consumers under the ONE shared cap.
        ``admit_filter`` (optional set of slice ids) restricts FRESH
        admissions to the named slices — the health-gated rollout
        orchestrator's cohort gate (``controllers/rollout.py``); slices
        already rolling always finish."""
        self.namespace = namespace
        desired = ""
        if spec is not None and spec.config is not None:
            desired = spec.config.default or ""
        summary = RepartitionSummary(total=len(tpu_nodes), desired=desired)
        if not desired:
            self._cleanup_abandoned(tpu_nodes)
            self.last_summary = {"desired": ""}
            return summary

        from tpu_operator_torch.controllers.slice_status import group_slices
        from tpu_operator_torch.kube.disruption import (
            OWNER_REPARTITION,
            joint_disrupted_slices,
        )
        from tpu_operator_torch.sliceman.slice_manager import (
            STATE_FAILED,
            STATE_SUCCESS,
        )
        from tpu_operator_torch.upgrade.upgrade_state import parse_max_unavailable

        slices = group_slices(tpu_nodes)
        slice_of = {
            member: sid
            for sid, info in slices.items()
            for member in info.member_nodes
        }
        joint = joint_disrupted_slices(tpu_nodes, slice_of)
        disrupted: Set[str] = set(joint["all"])
        if extra_disrupted:
            disrupted |= set(extra_disrupted)
        rolling_sids: Set[str] = set(joint[OWNER_REPARTITION])
        summary.budget_cap = parse_max_unavailable(
            getattr(spec, "max_unavailable", None), len(slices)
        )

        nodes_by_name = {n["metadata"]["name"]: n for n in tpu_nodes}
        pending_sids: Set[str] = set()
        for name, node in nodes_by_name.items():
            labels = node.get("metadata", {}).get("labels", {}) or {}
            rolling = (
                labels.get(consts.REPARTITION_STATE_LABEL)
                == consts.REPARTITION_STATE_ROLLING
            )
            done = (
                labels.get(consts.SLICE_CONFIG_LABEL) == desired
                and labels.get(consts.SLICE_CONFIG_STATE_LABEL)
                == STATE_SUCCESS
            )
            if rolling and done:
                # layout applied: release the hold
                try:
                    self._clear_rolling(name)
                    summary.completed_nodes += 1
                    self.rolls_completed_total += 1
                except (NotFoundError, ConflictError):
                    pass  # vanished/contended: next pass retries
                continue
            if rolling and labels.get(
                consts.SLICE_CONFIG_STATE_LABEL
            ) == STATE_FAILED:
                summary.failed_nodes.append(name)
                self._log_once(
                    (name, "failed"),
                    "node %s: slice re-partition to %r reported failed; "
                    "holding the slice disrupted while the node's slice "
                    "manager retries",
                    name,
                    desired,
                )
                continue
            if not rolling and not done:
                pending_sids.add(slice_of.get(name, name))

        # a slice PARTIALLY admitted (operator crashed mid-wave, or a
        # member joined mid-roll) finishes its batch without new budget:
        # the slice is already disrupted
        for sid in sorted(pending_sids & rolling_sids):
            self._admit_slice(
                sid, slices[sid].member_nodes, nodes_by_name, desired
            )
        pending_sids -= rolling_sids

        # fresh admissions within the JOINT headroom, whole slices only
        admitted = 0
        for sid in sorted(pending_sids):
            if admit_filter is not None and sid not in admit_filter:
                # outside the rollout's current cohort: the slice waits
                # for its wave (the orchestrator widens the gate when it
                # promotes a stage)
                continue
            if sid in disrupted:
                # another actor (upgrade roll, quarantine) owns this
                # slice's disruption: never double-disrupt — it becomes
                # eligible when that actor releases it
                self._log_once(
                    (sid, "interlock"),
                    "slice %s: re-partition deferred — another actor "
                    "holds it disrupted",
                    sid,
                )
                continue
            self._logged.discard((sid, "interlock"))
            if self._under_maintenance(sid, slices, nodes_by_name):
                continue
            if len(disrupted) >= summary.budget_cap:
                summary.deferred_slices += 1
                self.budget_deferred_total += 1
                self._log_once(
                    (sid, "budget"),
                    "slice %s: re-partition deferred — %d slice(s) "
                    "already disrupted (upgrades + repairs + rolls) at "
                    "the maxUnavailable cap of %d",
                    sid,
                    len(disrupted),
                    summary.budget_cap,
                )
                continue
            self._logged.discard((sid, "budget"))
            started = self._admit_slice(
                sid, slices[sid].member_nodes, nodes_by_name, desired
            )
            if started:
                disrupted.add(sid)
                rolling_sids.add(sid)
                admitted += 1
                self.rolls_started_total += started
                self._record_event(
                    "Normal",
                    "SliceRepartitionStarted",
                    f"slice {sid}: rolling {started} member host(s) to "
                    f"slice layout {desired!r} (one shared-budget "
                    f"disruption unit)",
                    dedup_extra=sid,
                )

        summary.admitted_slices = admitted
        summary.rolling_slices = len(rolling_sids)
        summary.pending_slices = len(pending_sids - rolling_sids)
        summary.disrupted_slices = len(disrupted)
        # retire log-once state for vanished nodes/slices
        live = set(nodes_by_name) | set(slices)
        self._logged.prune(live)
        self.last_summary = {
            "desired": desired,
            "total": summary.total,
            "pending_slices": summary.pending_slices,
            "rolling_slices": summary.rolling_slices,
            "admitted_slices": summary.admitted_slices,
            "deferred_slices": summary.deferred_slices,
            "completed_nodes": summary.completed_nodes,
            "failed_nodes": summary.failed_nodes,
            "budget_cap": summary.budget_cap,
            "disrupted_slices": summary.disrupted_slices,
        }
        return summary

    # ------------------------------------------------------------------
    def _admit_slice(
        self,
        sid: str,
        member_nodes: List[str],
        nodes_by_name: Dict[str, Obj],
        desired: str,
    ) -> int:
        """Mark every not-yet-done member of one slice rolling + desired
        (state reset to pending so a stale ``success`` from the PREVIOUS
        layout can't read as done). Returns members actually started."""
        from tpu_operator_torch.sliceman.slice_manager import (
            STATE_PENDING,
            STATE_SUCCESS,
        )

        started = 0
        for name in sorted(member_nodes):
            node = nodes_by_name.get(name)
            if node is None:
                continue
            labels = node.get("metadata", {}).get("labels", {}) or {}
            if (
                labels.get(consts.SLICE_CONFIG_LABEL) == desired
                and labels.get(consts.SLICE_CONFIG_STATE_LABEL)
                == STATE_SUCCESS
            ):
                continue  # this member already runs the layout
            if (
                labels.get(consts.REPARTITION_STATE_LABEL)
                == consts.REPARTITION_STATE_ROLLING
                and labels.get(consts.SLICE_CONFIG_LABEL) == desired
            ):
                continue  # already admitted (crash-resume)

            def mutate(fresh):
                fl = fresh["metadata"].setdefault("labels", {})
                changed = False
                for key, value in (
                    (consts.SLICE_CONFIG_LABEL, desired),
                    (consts.SLICE_CONFIG_STATE_LABEL, STATE_PENDING),
                    (
                        consts.REPARTITION_STATE_LABEL,
                        consts.REPARTITION_STATE_ROLLING,
                    ),
                ):
                    if fl.get(key) != value:
                        fl[key] = value
                        changed = True
                # rollback fact for the health-gated rollout: the
                # pre-roll validator perf reading becomes the baseline
                # its TFLOPS/membw deltas are measured against (the
                # upgrade FSM records the same at ITS admission)
                ann = fresh["metadata"].setdefault("annotations", {})
                perf = ann.get(consts.VALIDATOR_PERF_ANNOTATION)
                if perf and (
                    ann.get(consts.VALIDATOR_PERF_BASELINE_ANNOTATION)
                    != perf
                ):
                    ann[consts.VALIDATOR_PERF_BASELINE_ANNOTATION] = perf
                    changed = True
                return changed

            try:
                mutate_with_retry(
                    self.client, "v1", "Node", name, mutate=mutate
                )
                started += 1
                # flight timeline: each admitted member is one budget-
                # consuming write — the event a budget post-mortem names
                flight.record(
                    "budget.admit",
                    owner="repartition",
                    sid=sid,
                    node=name,
                    layout=desired,
                )
                log.info(
                    "node %s: rolling slice layout -> %r (slice %s)",
                    name,
                    desired,
                    sid,
                )
            except (NotFoundError, ConflictError):
                # vanished/contended member: the slice stays rolling via
                # whoever was marked; the partial-admission sweep above
                # finishes the batch next pass
                log.warning(
                    "node %s: re-partition admit write failed; retrying "
                    "next pass",
                    name,
                )
        return started

    def _clear_rolling(self, name: str) -> None:
        def mutate(fresh):
            labels = fresh["metadata"].setdefault("labels", {})
            if consts.REPARTITION_STATE_LABEL not in labels:
                return False
            del labels[consts.REPARTITION_STATE_LABEL]
            return True

        mutate_with_retry(self.client, "v1", "Node", name, mutate=mutate)
        flight.record("budget.release", owner="repartition", node=name)
        log.info("node %s: slice re-partition complete; hold released", name)

    def _under_maintenance(
        self, sid: str, slices, nodes_by_name: Dict[str, Obj]
    ) -> bool:
        for name in slices[sid].member_nodes:
            node = nodes_by_name.get(name)
            if node is None:
                continue
            if (node.get("metadata", {}).get("labels", {}) or {}).get(
                consts.MAINTENANCE_STATE_LABEL
            ):
                self._log_once(
                    (sid, "maintenance"),
                    "slice %s: re-partition deferred during host "
                    "maintenance on %s",
                    sid,
                    name,
                )
                return True
        self._logged.discard((sid, "maintenance"))
        return False

    def _cleanup_abandoned(self, tpu_nodes: List[Obj]) -> None:
        """No desired layout configured: any leftover ``rolling`` label
        is an abandoned roll still holding budget — release it. Steady
        path writes nothing (label-dict scan only)."""
        for node in tpu_nodes:
            labels = node.get("metadata", {}).get("labels", {}) or {}
            if consts.REPARTITION_STATE_LABEL not in labels:
                continue
            try:
                self._clear_rolling(node["metadata"]["name"])
            except (NotFoundError, ConflictError):
                continue

    # ------------------------------------------------------------------
    def _log_once(self, key: tuple, msg: str, *args) -> None:
        self._logged.log(log, key, msg, *args)

    def _record_event(
        self, etype: str, reason: str, message: str, dedup_extra: str = ""
    ) -> None:
        from tpu_operator_torch.kube.events import cluster_policy_ref, record_event

        try:
            record_event(
                self.client,
                self.namespace,
                cluster_policy_ref(),
                etype,
                reason,
                message,
                dedup_extra=dedup_extra,
            )
        except Exception:
            log.debug("repartition event write failed", exc_info=True)
