"""Upgrade reconciler (reference ``controllers/upgrade_controller.go``).

The port's copy of ``tpu_operator/upgrade/upgrade_controller.py``. Gated
on ``spec.driver.upgradePolicy.autoUpgrade`` (the reference's
``spec.libtpu``) and sandbox-off (``:93-111``); builds cluster state from
the driver's operand pods, applies the FSM (``upgrade_state.py``) with
maxUnavailable throttling under the rollout's cohort gate (``:125-153``),
re-queues every 2 min, or every 5 s while a staged roll is in flight or a
rollback still re-rolls (``:153-163``); on disable, removes per-node
state labels (``:168-194``). ``select_primary`` is imported lazily: the
ClusterPolicy reconciler's module imports this package's FSM, and the two
reconcilers share the one singleton rule.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import clusterpolicy_from_obj
from tpu_operator_torch.controllers.operator_metrics import OperatorMetrics
from tpu_operator_torch.kube.client import Client
from tpu_operator_torch.upgrade import upgrade_state as us

log = logging.getLogger("gpu-operator.upgrade")

REQUEUE_S = 120.0  # reference :53,163

# FSM states with in-flight work (active steps or awaiting admission):
# the staged-rollout fast requeue only matters while any node is here
ACTIVE_WITH_PENDING = tuple(us.ACTIVE_STATES) + (
    us.STATE_UPGRADE_REQUIRED,
)


@dataclass
class Result:
    requeue_after: Optional[float] = None


class UpgradeReconciler:
    def __init__(self, client: Client, namespace: str):
        self.client = client
        self.namespace = namespace
        self.manager = us.ClusterUpgradeStateManager(client, namespace)
        self.metrics = OperatorMetrics()

    def reconcile(self) -> Result:
        policies = self.client.list(consts.API_VERSION, consts.CLUSTER_POLICY_KIND)
        if not policies:
            return Result()
        from tpu_operator_torch.controllers.clusterpolicy_controller import select_primary

        primary, _ = select_primary(policies)
        cp = clusterpolicy_from_obj(primary)
        pol = cp.spec.driver.upgrade_policy
        if (
            cp.spec.sandbox_enabled()
            or pol is None
            or not pol.is_auto_upgrade_enabled()
        ):
            self.manager.cleanup_state_labels()
            return Result()

        # health-gated rollout cohort gate (controllers/rollout.py): a
        # pure function of the CR's rollout ledger + the slice universe,
        # so this reconciler and the orchestrator cannot drift and a
        # restarted operator is gated from its first pass. None =
        # unrestricted (no staged roll).
        from tpu_operator_torch.controllers import rollout as ro

        rec = ro.load_record(primary)
        rolled_back = bool(rec) and rec.get("state") == ro.STATE_ROLLED_BACK
        # while a rollback is in force, a pending node whose pod already
        # matches the (re-pinned previous) revision is reset to done
        # instead of being needlessly cordoned/drained
        state = self.manager.build_state(reset_in_sync_pending=rolled_back)
        admit = ro.admission_filter(primary, state.slices.keys())
        if admit is None:
            # rolled-back refinement: only slices actually running (or
            # mid-roll to) the abandoned version re-roll — see
            # rollback_admission_filter for the window this closes
            admit = ro.rollback_admission_filter(
                primary,
                {
                    sid: [e.node for e in entries]
                    for sid, entries in state.fsm_by_slice().items()
                },
            )
        self.manager.apply_state(state, pol, admit_filter=admit)
        self._update_metrics(state, pol)
        busy = any(
            e.state in ACTIVE_WITH_PENDING for e in state.all()
        )
        if (bool(rec) and rec.get("state") == ro.STATE_ROLLING) or (
            rolled_back and busy
        ):
            # staged roll in flight (or a rollback still re-rolling):
            # stage promotions and rollback re-pins land as CR
            # annotation edits (which wake this reconciler), but FSM
            # step completions need a clock faster than the 2 min
            # default to keep a canary wave moving. A CONVERGED parked
            # rollback takes the slow path — days of 5 s full-fleet
            # passes while the ledger waits for a human would be pure
            # load.
            return Result(requeue_after=5.0)
        return Result(requeue_after=REQUEUE_S)

    def _update_metrics(self, state: us.ClusterUpgradeState, pol) -> None:
        m = self.metrics
        if not getattr(m, "upgrades_in_progress", None):
            return
        in_progress = sum(state.count(s) for s in us.ACTIVE_STATES)
        m.upgrades_in_progress.set(in_progress)
        m.upgrades_done.set(state.count(us.STATE_DONE))
        m.upgrades_failed.set(state.count(us.STATE_FAILED))
        m.upgrades_pending.set(state.count(us.STATE_UPGRADE_REQUIRED))
        m.upgrades_unknown.set(state.count(us.STATE_UNKNOWN))
        # budget arithmetic in SLICE units — slice_budget is the SAME
        # computation apply_state admits with, so the exported "available"
        # cannot drift from real admission
        budget = us.slice_budget(state, pol)
        m.upgrades_available.set(min(budget.admit, len(budget.pending_sids)))
        if getattr(m, "upgrade_slices_in_progress", None):
            m.upgrade_slices_in_progress.set(len(budget.active_sids))
            m.upgrade_slices_pinned.set(len(self.manager.pinned_slices))
