"""Health-gated progressive rollouts: canary waves with automatic
version rollback.

The port's copy of ``tpu_operator/controllers/rollout.py``, whole: the
ledger's pure head (``raw_targets``, ``load_record``, ``apply_override``,
which ``state_manager.ClusterPolicyController`` calls on its private CR
copy before decoding it), the pure planners (``cohort_stages``,
``planned_stages``, ``admission_filter``, ``rollback_admission_filter``)
and the orchestrator (``RolloutSummary``, ``RolloutController``) that the
ClusterPolicy reconciler runs inside its pass, after remediation and
before the re-partition roll.

What the port decides here (the reconcilers' decisions, also in
``clusterpolicy_controller.py``, ``delta.py`` and ROADMAP):

* Internal names stay the reference's: ``RolloutController``,
  ``RolloutSummary``, the ``tpu_nodes`` parameters, the Event reasons
  (``RolloutStarted``, ``RolloutStagePromoted``, ``RolloutComplete``,
  ``RolloutRolledBack``, ``RolloutPaused``, ``RolloutSuperseded``) and the
  flight-recorder kinds.
* The driver's ledger kind is ``KIND_DRIVER`` (``driver``) where the
  reference writes its ``libtpu`` kind, the defaults of
  ``rec.get("kind", ...)`` included: a ledger without a kind reads as a
  driver roll, never as a layout roll that skips the version checks.
  ``raw_targets`` reads ``spec.driver.version``.
* The version a node runs is ``consts.DRIVER_VERSION_LABEL``, the label
  the port's feature discovery writes (the reference's
  libtpu version label); an operand pod is one whose ``app``
  starts with ``consts.OPERAND_APP_PREFIX`` (``gpu-``; the reference's
  literal ``tpu-``), so a crash-looping ``gpu-*`` operand fails a canary.
* ``cohort_stages`` orders slice ids by ``sha1(target:sid)``; slice ids
  cross ``convert`` unchanged, so both packages pick the same canary.
* One deliberate difference: ``rollback_admission_filter`` reads a node's
  admission-time previous-version annotation only when it names the
  restored previous version, so a bad roll that follows a finished one
  admits no slice outside its canary (see the function).

Cohorts are a deterministic pure function of ``(target, slice ids)``,
sized by ``spec.rollout.canary``/``waves`` (int-or-percent of slices), so
every consumer, pass and restarted operator computes the same assignment
with nothing to persist. Progress lives in one ledger annotation on the
ClusterPolicy (``tpu.k8s.io/rollout-state``: kind, target, previous,
stage, state, failing evidence); the per-node rollback facts (previous
version and the pre-roll validator-perf baseline) are written by the
upgrade FSM at admission. The gate reads live evidence per cohort:
validator TFLOPS and memory-bandwidth ratios against the node's baseline,
new remediation quarantines among cohort members, upgrade failures,
operand CrashLoopBackOff, a Degraded CR condition and, where a latency
source is wired, alloc-latency p99. Admission stays under the shared
three-consumer disruption budget: the orchestrator only narrows which
slices the upgrade FSM and the re-partition roller may admit. A
regressing canary pauses the roll or, with ``autoRollback`` (default on),
flips the ledger to ``rolled-back``; ``apply_override`` then re-pins the
effective desired version to the recorded previous one and the FSM
re-rolls the cohort back. Every pause and rollback is flight-recorded
with a dump and a Warning Event naming the evidence.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import Client, Obj, mutate_with_retry
from tpu_operator_torch.obs import LogOnce, flight

log = logging.getLogger("gpu-operator.rollout")

# ledger kinds: which roller the staged change flows through
KIND_DRIVER = "driver"  # the reference's libtpu kind
KIND_LAYOUT = "layout"

# ledger states
STATE_ROLLING = "rolling"
STATE_PAUSED = "paused"
STATE_ROLLED_BACK = "rolled-back"
STATE_COMPLETE = "complete"

# evidence list cap: a fleet-wide regression names the first few nodes,
# not a thousand of them, in Events and the ledger annotation
EVIDENCE_MAX = 8


def raw_targets(cp_obj: Obj) -> Dict[str, str]:
    """The user-authored fleet-wide targets straight off the spec dict
    (before any rollback override): the driver version and the desired
    slice layout."""
    spec = cp_obj.get("spec", {}) or {}
    return {
        KIND_DRIVER: (spec.get("driver") or {}).get("version") or "",
        KIND_LAYOUT: (((spec.get("sliceManager") or {}).get("config") or {}).get("default") or ""),
    }


def load_record(cp_obj: Obj) -> Optional[dict]:
    """The rollout ledger off the CR's annotations (None when absent or
    garbled: a hand-edited annotation reads as 'no rollout')."""
    raw = ((cp_obj.get("metadata") or {}).get("annotations") or {}).get(consts.ROLLOUT_STATE_ANNOTATION)
    if not raw:
        return None
    try:
        rec = json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(rec, dict) or not rec.get("target"):
        return None
    return rec


def apply_override(cp_obj: Obj) -> Dict[str, str]:
    """Pin the effective desired version/layout back to the recorded
    previous value while a rollback is in force, on the caller's private
    CR copy, before the spec is decoded and fingerprinted. Returns the raw
    user targets. The override lapses the moment the user moves the target
    off the failed version."""
    raw = raw_targets(cp_obj)
    rec = load_record(cp_obj)
    if not rec or rec.get("state") != STATE_ROLLED_BACK:
        return raw
    prev = rec.get("previous") or ""
    if not prev or raw.get(rec.get("kind", "")) != rec.get("target"):
        return raw
    spec = cp_obj.setdefault("spec", {})
    if rec["kind"] == KIND_DRIVER:
        spec.setdefault("driver", {})["version"] = prev
    elif rec["kind"] == KIND_LAYOUT:
        spec.setdefault("sliceManager", {}).setdefault("config", {})["default"] = prev
    return raw


def _scaled_count(value, total: int) -> int:
    """int-or-percent stage size over ``total`` slices, minimum 1 (an
    empty canary would gate nothing)."""
    if total <= 0:
        return 0
    if value is None:
        return 1
    s = str(value).strip()
    try:
        if s.endswith("%"):
            return min(max(1, math.ceil(total * float(s[:-1]) / 100.0)), total)
        return min(max(1, int(s)), total)
    except (TypeError, ValueError):
        return 1


def cohort_stages(all_sids, target: str, spec) -> List[List[str]]:
    """Deterministic canary→wave(s)→fleet cohort assignment for a FRESH
    plan: slice ids ordered by ``sha1(target:sid)`` (stable across
    passes, restarts and processes; a different target draws a
    different canary), sliced into ``[canary] + waves + [remainder]``
    counts. Thin wrapper over ``planned_stages`` with no pinned
    cohorts, so the two can never drift."""
    return planned_stages({"target": target}, all_sids, spec)


def planned_stages(rec: dict, all_sids, spec) -> List[List[str]]:
    """The roll's stage plan with begun stages PINNED: cohorts already
    recorded in the ledger (``rec["cohorts"]`` — appended when a stage
    starts admitting) keep their membership verbatim, and only FUTURE
    stages are computed from the slices not yet claimed. Without the
    pin, a slice joining mid-roll could hash ahead of the live canary
    and silently grow stage 0's blast radius past its configured size;
    with it, late arrivals land in not-yet-begun stages only. Pure over
    ``(rec, all_sids, spec)`` — both reconcilers and a restarted
    operator compute the same plan."""
    live = set(all_sids)
    recorded: List[List[str]] = [
        [s for s in cohort]
        for cohort in (rec.get("cohorts") or [])
        if isinstance(cohort, (list, tuple))
    ]
    claimed = {s for cohort in recorded for s in cohort}
    target = rec.get("target", "")
    ordered = sorted(
        (s for s in live if s not in claimed),
        key=lambda s: hashlib.sha1(
            f"{target}:{s}".encode("utf-8", "replace")
        ).hexdigest(),
    )
    total = max(len(live | claimed), 1)
    counts = [_scaled_count(getattr(spec, "canary", "1"), total)]
    for wave in getattr(spec, "waves", None) or []:
        counts.append(_scaled_count(wave, total))
    stages: List[List[str]] = list(recorded)
    i = 0
    for idx in range(len(recorded), len(counts)):
        if i >= len(ordered):
            break
        stages.append(ordered[i : i + counts[idx]])
        i += counts[idx]
    if i < len(ordered):
        stages.append(ordered[i:])
    return [s for s in stages if s]


def admission_filter(cp_obj: Obj, all_sids) -> Optional[Set[str]]:
    """The slice ids the active rollout allows FRESH admissions for —
    ``None`` means unrestricted (no staged roll). Pure over the in-hand
    CR, so the upgrade reconciler computes the same gate the
    orchestrator does without shared mutable state, and a restarted
    operator is gated from its very first pass.

    Fail-closed discipline: while a version target exists but the
    ledger hasn't been written yet (the CP pass that stages it hasn't
    run), or the user just moved the target and the ledger is stale,
    admissions FREEZE rather than let a race admit the whole fleet
    ungated."""
    spec_d = ((cp_obj.get("spec") or {}).get("rollout")) or {}
    if not spec_d.get("enabled"):
        return None
    from tpu_operator_torch.api.v1.clusterpolicy_types import RolloutSpec

    spec = RolloutSpec.from_dict(spec_d)
    raw = raw_targets(cp_obj)
    rec = load_record(cp_obj)
    if rec is None:
        # no ledger yet: a stageable (version) target freezes admission
        # until the orchestrator stages it; a version-less hash drift is
        # not stageable and rolls ungated
        return set() if raw[KIND_DRIVER] else None
    kind = rec.get("kind", KIND_DRIVER)
    if (
        raw.get(kind)
        and raw[kind] != rec.get("target")
        and raw[kind] != (rec.get("previous") or "")
    ):
        # the target moved somewhere NEW: freeze until the CP pass
        # re-stages. A spec reading as the recorded PREVIOUS version is
        # not a move — it is either the rollback override on the CP
        # pass's own (pinned) copy, or the user reverting, which the
        # orchestrator resolves by clearing the ledger
        return set()
    state = rec.get("state")
    if state == STATE_PAUSED:
        return set()
    if state in (STATE_ROLLED_BACK, STATE_COMPLETE):
        # rolled-back: desired is pinned to the previous version, so the
        # only stale slices ARE the rolled cohort — re-roll freely (the
        # shared disruption budget still caps concurrency);
        # complete: nothing left to stage
        return None
    stages = planned_stages(rec, all_sids, spec)
    if not stages:
        return None
    stage = min(max(int(rec.get("stage", 0) or 0), 0), len(stages) - 1)
    allowed: Set[str] = set()
    for cohort in stages[: stage + 1]:
        allowed.update(cohort)
    return allowed


def rollback_admission_filter(cp_obj: Obj, slice_nodes) -> Optional[Set[str]]:
    """The rolled-back refinement of ``admission_filter``: while a
    driver ledger says rolled-back, restrict fresh admissions to slices
    that actually NEED re-rolling — a member publishes a version other
    than the restored previous one, or carries the admission-time
    rollback annotation. This closes the one-pass window between the
    rollback decision and the re-render of the previous version, during
    which never-admitted waves still look stale against the ABANDONED
    target and an unrestricted gate would cordon/drain them for
    nothing; late joiners that came up on the bad version remain
    admissible. ``slice_nodes``: sid -> member node objects. Returns
    None when no driver rollback is in force.

    The admission-time annotation counts only when it names the restored
    previous version, i.e. when this roll wrote it. The FSM leaves the
    annotation on a node after its roll completes, so after one finished
    roll every node carries one from that roll; the reference admits any
    annotated slice and, on a roll that follows a finished one, lets the
    window admit slices outside the canary."""
    rec = load_record(cp_obj)
    if (
        not rec
        or rec.get("state") != STATE_ROLLED_BACK
        or rec.get("kind") != KIND_DRIVER
    ):
        return None
    prev = rec.get("previous") or ""
    if not prev:
        return None
    admit: Set[str] = set()
    for sid, nodes in slice_nodes.items():
        for node in nodes:
            labels = node.get("metadata", {}).get("labels", {}) or {}
            ann = node.get("metadata", {}).get("annotations", {}) or {}
            version = labels.get(consts.DRIVER_VERSION_LABEL, "")
            if (version and version != prev) or (
                ann.get(consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION) == prev
            ):
                admit.add(sid)
                break
    return admit


def _parse_perf(raw: str) -> Optional[dict]:
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except (ValueError, TypeError):
        return None
    return doc if isinstance(doc, dict) else None


def _iso_now() -> str:
    from datetime import datetime, timezone

    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _parse_iso_s(ts: str) -> float:
    from datetime import datetime, timezone

    try:
        dt = datetime.fromisoformat(str(ts).replace("Z", "+00:00"))
    except (TypeError, ValueError):
        return 0.0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


# ---------------------------------------------------------------------------
# summary + controller
# ---------------------------------------------------------------------------


@dataclass
class RolloutSummary:
    """What one orchestrator pass saw/decided — feeds ``status.rollout``,
    /debug/vars, and the reconciler's requeue decision."""

    enabled: bool = False
    kind: str = ""
    target: str = ""
    previous: str = ""
    state: str = ""  # "" = no roll staged
    stage: int = 0
    stages_total: int = 0
    cohort_sids: List[str] = field(default_factory=list)
    evidence: List[str] = field(default_factory=list)
    errored: bool = False
    # rolled-back only: whether every node is back on the previous
    # version/layout (a converged rollback parks without a requeue
    # clock; the ledger stays for the user to acknowledge)
    rollback_converged: bool = False
    # the admission gate this pass computed (None = unrestricted) —
    # consumed by the same-pass repartition roll
    admit_sids: Optional[Set[str]] = None

    @property
    def active(self) -> bool:
        """In-flight staged work wants the level-triggered requeue: the
        observation window and the rollback's re-roll both elapse
        without any cluster event of ours. A paused roll — and a
        rollback that has fully converged back — waits for a human and
        needs no clock; an errored pass retries on it."""
        if self.errored or self.state == STATE_ROLLING:
            return True
        if self.state == STATE_ROLLED_BACK:
            return not self.rollback_converged
        return False

    def status_block(self) -> Optional[Dict[str, object]]:
        if not self.state:
            return None
        out: Dict[str, object] = {
            "kind": self.kind,
            "target": self.target,
            "state": self.state,
            "stage": f"{min(self.stage + 1, self.stages_total)}/{self.stages_total}"
            if self.stages_total
            else "0/0",
        }
        if self.previous:
            out["previous"] = self.previous
        if self.evidence:
            out["evidence"] = list(self.evidence)
        return out


class RolloutController:
    """Level-triggered rollout orchestration, run inside the reconcile
    pass (after remediation — whose fresh verdicts are gate evidence —
    and before the re-partition roll, which consumes the computed
    admission gate). With ``spec.rollout`` absent/disabled the pass is a
    label-dict scan that writes nothing."""

    def __init__(self, client: Client, namespace: str = ""):
        self.client = client
        self.namespace = namespace
        self.promotions_total = 0
        self.rollbacks_total = 0
        self.pauses_total = 0
        self.rollouts_started_total = 0
        self.rollouts_completed_total = 0
        self.last_summary: Dict[str, object] = {}
        self._logged = LogOnce()
        # optional live alloc-latency source (callable -> p99 ms or
        # None), wired by harnesses that run the schedsim engine; the
        # pre-roll reading is recorded in the ledger and regressions
        # past spec.rollout.allocP99DegradedPct count as evidence
        self.alloc_p99_source = None

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """/debug/vars "rollout" payload."""
        return {
            "last_pass": self.last_summary,
            "promotions_total": self.promotions_total,
            "rollbacks_total": self.rollbacks_total,
            "pauses_total": self.pauses_total,
            "rollouts_started_total": self.rollouts_started_total,
            "rollouts_completed_total": self.rollouts_completed_total,
        }

    def _alloc_p99(self) -> Optional[float]:
        src = self.alloc_p99_source
        if src is None:
            return None
        try:
            v = src()
            return float(v) if v is not None else None
        except Exception:
            return None

    # ------------------------------------------------------------------
    def reconcile(
        self,
        tpu_nodes: List[Obj],
        cp_obj: Obj,
        spec,
        raw: Dict[str, str],
        namespace: str,
        remediation_summary=None,
    ) -> RolloutSummary:
        """One orchestration pass over the labeled GPU node list.
        ``cp_obj`` is the reconciler's private CR copy (override already
        applied by init); ``raw`` is the user-authored targets
        ``apply_override`` returned; ``spec`` is ``cp.spec.rollout``."""
        self.namespace = namespace
        summary = RolloutSummary(enabled=bool(spec and spec.is_enabled()))
        if not summary.enabled:
            # rollout switched off: drop the ledger so a stale override
            # can't keep pinning the desired version
            if load_record(cp_obj) is not None:
                self._save_record(cp_obj, None)
                log.info("rollout disabled; ledger cleared")
            self.last_summary = {"enabled": False}
            return summary

        from tpu_operator_torch.controllers.slice_status import group_slices

        slices = group_slices(tpu_nodes)
        labels_of = {
            n["metadata"]["name"]: (
                n.get("metadata", {}).get("labels", {}) or {}
            )
            for n in tpu_nodes
        }
        rec = load_record(cp_obj)

        # user moved the target away from the recorded roll: the old
        # ledger (and any rollback override) is superseded
        if rec is not None:
            kind = rec.get("kind", KIND_DRIVER)
            if raw.get(kind, "") != rec.get("target"):
                self._record_event(
                    "Normal",
                    "RolloutSuperseded",
                    f"rollout of {kind} {rec.get('target')!r} superseded by "
                    f"a new target {raw.get(kind)!r}; restaging",
                    dedup_extra=str(raw.get(kind)),
                )
                self._save_record(cp_obj, None)
                rec = None

        if rec is None:
            rec = self._maybe_start(cp_obj, raw, labels_of, slices, spec)
        if rec is None:
            self.last_summary = {"enabled": True, "state": ""}
            return summary

        summary.kind = rec.get("kind", KIND_DRIVER)
        summary.target = rec.get("target", "")
        summary.previous = rec.get("previous", "")
        summary.state = rec.get("state", STATE_ROLLING)

        stages = planned_stages(rec, slices.keys(), spec)
        summary.stages_total = len(stages)
        summary.stage = (
            min(max(int(rec.get("stage", 0) or 0), 0), len(stages) - 1)
            if stages
            else 0
        )
        cohort_sids: List[str] = []
        for s in stages[: summary.stage + 1]:
            cohort_sids.extend(s)
        summary.cohort_sids = cohort_sids
        summary.evidence = list(rec.get("evidence") or [])

        if summary.state == STATE_ROLLING and stages:
            self._step_rolling(
                cp_obj, rec, spec, summary, stages, slices, labels_of,
                tpu_nodes, remediation_summary,
            )
        elif summary.state == STATE_ROLLED_BACK:
            self._step_rolled_back(summary, labels_of)

        summary.admit_sids = admission_filter(cp_obj, slices.keys())
        if (
            summary.state == STATE_ROLLED_BACK
            and summary.kind == KIND_LAYOUT
            and summary.target
        ):
            # layout analogue of rollback_admission_filter: restrict the
            # same-pass repartition admission to slices actually ON (or
            # mid-roll to) the abandoned layout. Closes the one-pass
            # window between the rollback decision and the next init's
            # override re-pinning the desired layout, during which the
            # roller's desired value is still the BAD target and an
            # unrestricted gate would admit never-rolled waves to it.
            summary.admit_sids = {
                sid
                for sid, info in slices.items()
                if any(
                    labels_of.get(m, {}).get(consts.SLICE_CONFIG_LABEL)
                    == summary.target
                    or labels_of.get(m, {}).get(
                        consts.REPARTITION_STATE_LABEL
                    )
                    == consts.REPARTITION_STATE_ROLLING
                    for m in info.member_nodes
                )
            }
        self.last_summary = {
            "enabled": True,
            "kind": summary.kind,
            "target": summary.target,
            "previous": summary.previous,
            "state": summary.state,
            "stage": summary.stage,
            "stages_total": summary.stages_total,
            "cohort_size": len(summary.cohort_sids),
            "evidence": summary.evidence,
        }
        return summary

    # ------------------------------------------------------------------
    def _maybe_start(
        self, cp_obj, raw, labels_of, slices, spec
    ) -> Optional[dict]:
        """Stage a new roll when a fleet-wide target differs from what
        the fleet runs. The previous (rollback) version is the consensus
        of what the not-yet-rolled nodes report — recorded up front so
        the rollback target exists even if every cohort node is
        re-imaged before the gate trips."""
        from tpu_operator_torch.sliceman.slice_manager import STATE_SUCCESS

        target = raw.get(KIND_DRIVER, "")
        kind = None
        previous = ""
        if target:
            behind: Dict[str, int] = {}
            fsm_pending = False
            for labels in labels_of.values():
                v = labels.get(consts.DRIVER_VERSION_LABEL, "")
                if v and v != target:
                    behind[v] = behind.get(v, 0) + 1
                ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
                if (
                    ustate == consts.UPGRADE_STATE_UPGRADE_REQUIRED
                    or ustate in consts.UPGRADE_ACTIVE_STATES
                ):
                    fsm_pending = True
            if behind or fsm_pending:
                kind = KIND_DRIVER
                previous = (
                    max(behind.items(), key=lambda kv: (kv[1], kv[0]))[0]
                    if behind
                    else ""
                )
        if kind is None:
            layout = raw.get(KIND_LAYOUT, "")
            if layout:
                behind = {}
                pending = False
                for labels in labels_of.values():
                    cur = labels.get(consts.SLICE_CONFIG_LABEL, "")
                    done = (
                        cur == layout
                        and labels.get(consts.SLICE_CONFIG_STATE_LABEL)
                        == STATE_SUCCESS
                    )
                    if not done:
                        pending = True
                        if cur and cur != layout:
                            behind[cur] = behind.get(cur, 0) + 1
                if pending:
                    kind = KIND_LAYOUT
                    target = layout
                    previous = (
                        max(behind.items(), key=lambda kv: (kv[1], kv[0]))[0]
                        if behind
                        else ""
                    )
        if kind is None:
            return None
        rec = {
            "kind": kind,
            "target": target,
            "previous": previous,
            "stage": 0,
            "state": STATE_ROLLING,
            "createdAt": _iso_now(),
            "stageStartedAt": _iso_now(),
        }
        # pin the canary cohort in the ledger the moment the roll is
        # staged: slices joining mid-roll must land in future stages,
        # never grow a begun stage's blast radius
        first = planned_stages(rec, slices.keys(), spec)
        if first:
            rec["cohorts"] = [list(first[0])]
        p99 = self._alloc_p99()
        if p99 is not None:
            rec["allocP99Baseline"] = round(p99, 2)
        self._save_record(cp_obj, rec)
        self.rollouts_started_total += 1
        flight.record(
            "rollout.start", kind=kind, target=target, previous=previous
        )
        self._record_event(
            "Normal",
            "RolloutStarted",
            f"staged {kind} rollout to {target!r} started "
            f"(previous {previous!r}; canary first, health-gated)",
            dedup_extra=target,
        )
        log.info(
            "rollout: staging %s %r -> %r (canary first)",
            kind,
            previous,
            target,
        )
        return rec

    # ------------------------------------------------------------------
    def _step_rolling(
        self, cp_obj, rec, spec, summary, stages, slices, labels_of,
        tpu_nodes, remediation_summary=None,
    ) -> None:
        cohort_nodes = []
        for sid in summary.cohort_sids:
            info = slices.get(sid)
            if info is None:
                continue
            cohort_nodes.extend(info.member_nodes)
        evidence = self._collect_evidence(
            cp_obj, rec, spec, summary, cohort_nodes, labels_of, tpu_nodes,
            remediation_summary,
        )
        if evidence:
            summary.evidence = evidence
            rec["evidence"] = evidence
            if spec.rollback_enabled() and rec.get("previous"):
                rec["state"] = STATE_ROLLED_BACK
                rec["rolledBackAt"] = _iso_now()
                summary.state = STATE_ROLLED_BACK
                self.rollbacks_total += 1
                self._save_record(cp_obj, rec)
                for ev in evidence:
                    flight.record("rollout.evidence", detail=ev)
                flight.record(
                    "rollout.rollback",
                    kind=summary.kind,
                    target=summary.target,
                    previous=summary.previous,
                    stage=summary.stage,
                )
                detail = "; ".join(evidence)
                flight.RECORDER.dump(
                    "rollout-rollback",
                    detail=detail,
                    extra={
                        "target": summary.target,
                        "previous": summary.previous,
                        "stage": summary.stage,
                        "evidence": evidence,
                    },
                )
                self._record_event(
                    "Warning",
                    "RolloutRolledBack",
                    f"{summary.kind} rollout to {summary.target!r} failed "
                    f"its health gate at stage "
                    f"{summary.stage + 1}/{summary.stages_total} and is "
                    f"rolling back to {summary.previous!r}: {detail}",
                    dedup_extra=summary.target,
                )
                log.error(
                    "rollout: ROLLING BACK %s %r -> %r (stage %d): %s",
                    summary.kind,
                    summary.target,
                    summary.previous,
                    summary.stage,
                    detail,
                )
            else:
                rec["state"] = STATE_PAUSED
                rec["pausedAt"] = _iso_now()
                summary.state = STATE_PAUSED
                self.pauses_total += 1
                self._save_record(cp_obj, rec)
                for ev in evidence:
                    flight.record("rollout.evidence", detail=ev)
                flight.record(
                    "rollout.pause",
                    kind=summary.kind,
                    target=summary.target,
                    stage=summary.stage,
                )
                detail = "; ".join(evidence)
                flight.RECORDER.dump(
                    "rollout-paused",
                    detail=detail,
                    extra={"target": summary.target, "evidence": evidence},
                )
                self._record_event(
                    "Warning",
                    "RolloutPaused",
                    f"{summary.kind} rollout to {summary.target!r} paused "
                    f"at stage {summary.stage + 1}/{summary.stages_total} "
                    f"on failing health evidence (no rollback target or "
                    f"autoRollback off): {detail}",
                    dedup_extra=summary.target,
                )
                log.error(
                    "rollout: PAUSED %s -> %r (stage %d): %s",
                    summary.kind,
                    summary.target,
                    summary.stage,
                    detail,
                )
            return

        # healthy: promote when the current stage finished rolling and
        # soaked for observeSeconds
        stage_sids = stages[summary.stage]
        live_stage = [sid for sid in stage_sids if sid in slices]
        if not live_stage and any(s in slices for st in stages for s in st):
            # the ENTIRE begun cohort left the fleet (preemption wave):
            # promoting would gate on zero evidence — re-pin this stage
            # from the surviving universe and restart its clock instead
            pins = [list(s) for s in (rec.get("cohorts") or [])][
                : summary.stage
            ]
            rec["cohorts"] = pins
            replanned = planned_stages(rec, slices.keys(), spec)
            if len(replanned) > summary.stage:
                rec["cohorts"] = pins + [list(replanned[summary.stage])]
                rec.pop("stageRolledAt", None)
                rec["stageStartedAt"] = _iso_now()
                self._save_record(cp_obj, rec)
                self._log_once(
                    ("restage", summary.target, summary.stage),
                    "rollout: stage %d cohort vanished from the fleet; "
                    "restaged with %d surviving slice(s)",
                    summary.stage + 1,
                    len(replanned[summary.stage]),
                )
                return
        rolled = all(
            self._slice_rolled(
                slices[sid], rec, labels_of
            )
            for sid in live_stage
        )
        if not rolled:
            if rec.get("stageRolledAt"):
                rec.pop("stageRolledAt", None)
                self._save_record(cp_obj, rec)
            return
        now = time.time()
        rolled_at = _parse_iso_s(rec.get("stageRolledAt", ""))
        if not rolled_at:
            rec["stageRolledAt"] = _iso_now()
            self._save_record(cp_obj, rec)
            return
        observe = float(getattr(spec, "observe_seconds", 60) or 0)
        if now - rolled_at < observe:
            return
        # observation clean: promote
        next_stage = summary.stage + 1
        if next_stage >= len(stages):
            rec["state"] = STATE_COMPLETE
            rec["completedAt"] = _iso_now()
            rec.pop("stageRolledAt", None)
            summary.state = STATE_COMPLETE
            self.rollouts_completed_total += 1
            self._save_record(cp_obj, rec)
            flight.record(
                "rollout.complete", kind=summary.kind, target=summary.target
            )
            self._record_event(
                "Normal",
                "RolloutComplete",
                f"{summary.kind} rollout to {summary.target!r} completed "
                f"through all {len(stages)} stage(s) with a clean health "
                f"gate at every promotion",
                dedup_extra=summary.target,
            )
            log.info(
                "rollout: %s -> %r COMPLETE (%d stages)",
                summary.kind,
                summary.target,
                len(stages),
            )
            return
        rec["stage"] = next_stage
        rec["stageStartedAt"] = _iso_now()
        rec.pop("stageRolledAt", None)
        # pin the stage that is about to start admitting (see
        # planned_stages: begun stages keep their membership verbatim)
        rec["cohorts"] = [list(s) for s in stages[: next_stage + 1]]
        summary.stage = next_stage
        self.promotions_total += 1
        self._save_record(cp_obj, rec)
        flight.record(
            "rollout.promote",
            kind=summary.kind,
            target=summary.target,
            stage=next_stage,
            cohort=len(stages[next_stage]),
        )
        self._record_event(
            "Normal",
            "RolloutStagePromoted",
            f"{summary.kind} rollout to {summary.target!r}: stage "
            f"{summary.stage}/{len(stages) - 1} healthy through its "
            f"observation window; promoting to stage "
            f"{next_stage + 1}/{len(stages)} "
            f"({len(stages[next_stage])} slice(s))",
            dedup_extra=f"{summary.target}:{next_stage}",
        )
        log.info(
            "rollout: %s -> %r promoted to stage %d/%d",
            summary.kind,
            summary.target,
            next_stage + 1,
            len(stages),
        )

    def _slice_rolled(self, info, rec, labels_of) -> bool:
        """Whether every member host of one slice finished this roll.
        For the driver: version label at target (when published) and the
        upgrade FSM idle/done — a node the FSM hasn't even entered yet
        does NOT read as done unless its version already matches. For a
        layout: config label at target with state success and the
        rolling hold released."""
        from tpu_operator_torch.sliceman.slice_manager import STATE_SUCCESS

        target = rec.get("target", "")
        kind = rec.get("kind", KIND_DRIVER)
        for member in info.member_nodes:
            labels = labels_of.get(member)
            if labels is None:
                return False
            if kind == KIND_DRIVER:
                ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
                if ustate not in ("", consts.UPGRADE_STATE_DONE):
                    return False
                version = labels.get(consts.DRIVER_VERSION_LABEL, "")
                if version and version != target:
                    # publishing a non-target version = not rolled. A
                    # version-LESS node with an idle FSM counts as done
                    # (nothing distinguishes it from never-stale); the
                    # observation window re-checks after the FSM's next
                    # pass would have entered it, so a premature read
                    # self-corrects before promotion
                    return False
            else:
                if (
                    labels.get(consts.SLICE_CONFIG_LABEL) != target
                    or labels.get(consts.SLICE_CONFIG_STATE_LABEL)
                    != STATE_SUCCESS
                    or labels.get(consts.REPARTITION_STATE_LABEL)
                    == consts.REPARTITION_STATE_ROLLING
                ):
                    return False
        return True

    def _step_rolled_back(self, summary, labels_of) -> None:
        """While rolled back, track how far the fleet is from the
        restored previous version (the FSM / re-partition roller do the
        actual re-rolling — the override makes the previous value the
        desired state). A fully-converged rollback parks: the ledger
        stays for the user, but the requeue clock stops."""
        from tpu_operator_torch.sliceman.slice_manager import STATE_SUCCESS

        previous = summary.previous
        if not previous:
            summary.rollback_converged = True
            return
        if summary.kind == KIND_DRIVER:
            behind = sorted(
                name
                for name, labels in labels_of.items()
                if labels.get(consts.DRIVER_VERSION_LABEL, "")
                not in ("", previous)
                or labels.get(consts.UPGRADE_STATE_LABEL, "")
                in consts.UPGRADE_ACTIVE_STATES
            )
        else:
            behind = sorted(
                name
                for name, labels in labels_of.items()
                if labels.get(consts.SLICE_CONFIG_LABEL, "") != previous
                or labels.get(consts.SLICE_CONFIG_STATE_LABEL)
                != STATE_SUCCESS
            )
        summary.rollback_converged = not behind
        if behind:
            self._log_once(
                ("rollback", summary.target),
                "rollout: rolling %d node(s) back to %r (%s)",
                len(behind),
                previous,
                ", ".join(behind[:5]),
            )
        else:
            self._logged.discard(("rollback", summary.target))

    # ------------------------------------------------------------------
    def _collect_evidence(
        self, cp_obj, rec, spec, summary, cohort_nodes, labels_of, tpu_nodes,
        remediation_summary=None,
    ) -> List[str]:
        """The health gate: live failure evidence among cohort members.
        Every returned string names the node and the failing signal —
        these go verbatim into the ledger, the Warning Event, and the
        flight-recorder dump."""
        from tpu_operator_torch.upgrade.upgrade_state import (
            FAILED_RETRY_MAX,
            failed_retry_count,
        )

        evidence: List[str] = []
        created_at = _parse_iso_s(rec.get("createdAt", ""))
        target = rec.get("target", "")
        nodes_by_name = {n["metadata"]["name"]: n for n in tpu_nodes}
        crash_by_node, validator_nodes = self._operand_health()

        tflops_pct = float(getattr(spec, "tflops_degraded_pct", 10) or 0)
        membw_pct = float(getattr(spec, "membw_degraded_pct", 10) or 0)

        # SAME-PASS quarantines: labels the remediation pass wrote this
        # very reconcile are on the wire but not in the pass-start node
        # snapshot — a canary quarantined in the pass its observation
        # window elapses must still block the promotion
        fresh_quarantines = set(cohort_nodes) & set(
            getattr(remediation_summary, "newly_disrupted_hosts", None)
            or ()
        )
        for name in sorted(fresh_quarantines)[:EVIDENCE_MAX]:
            evidence.append(
                f"node {name}: remediation quarantine during the roll "
                f"(this pass)"
            )

        for name in sorted(set(cohort_nodes)):
            if len(evidence) >= EVIDENCE_MAX:
                break
            labels = labels_of.get(name)
            node = nodes_by_name.get(name)
            if labels is None or node is None:
                continue
            ann = node["metadata"].get("annotations", {}) or {}

            # new remediation quarantine among cohort members
            rstate = labels.get(consts.REMEDIATION_STATE_LABEL, "")
            if rstate in consts.REMEDIATION_DISRUPTED_STATES:
                since = _parse_iso_s(
                    ann.get(consts.REMEDIATION_STATE_SINCE_ANNOTATION, "")
                )
                if not created_at or not since or since >= created_at:
                    evidence.append(
                        f"node {name}: remediation {rstate} during the roll"
                    )
                    continue

            version = labels.get(consts.DRIVER_VERSION_LABEL, "")
            rolled = (
                version == target
                if summary.kind == KIND_DRIVER
                else labels.get(consts.SLICE_CONFIG_LABEL) == target
            )
            # signals scoped to THIS roll: the node rolled to the
            # target, or its FSM state was (re)stamped after the roll
            # was staged — a node parked upgrade-failed/crashlooping
            # since BEFORE the roll must not veto a healthy new roll
            ustate_since = _parse_iso_s(
                ann.get(consts.UPGRADE_STATE_SINCE_ANNOTATION, "")
            )
            in_this_roll = (
                rolled
                or not created_at
                or (ustate_since and ustate_since >= created_at)
            )

            # upgrade failure — an exhausted canary is evidence, not a
            # silent stall (pre-gate it just parked as failed while the
            # roll neither advanced nor rolled back)
            ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
            if ustate == consts.UPGRADE_STATE_FAILED and in_this_roll:
                retries = failed_retry_count(node)
                exhausted = (
                    ", retries exhausted"
                    if retries >= FAILED_RETRY_MAX
                    else f", retry {retries}/{FAILED_RETRY_MAX}"
                )
                evidence.append(
                    f"node {name}: upgrade-failed{exhausted}"
                )
                continue

            # operand crashloop (an optionally-crashlooping bad version)
            crash = crash_by_node.get(name)
            if crash and in_this_roll:
                evidence.append(
                    f"node {name}: operand pod(s) in CrashLoopBackOff "
                    f"({', '.join(sorted(crash)[:3])})"
                )
                continue

            # validator down AFTER the node rolled to the target
            if (
                rolled
                and labels.get(
                    consts.DEPLOY_LABEL_PREFIX
                    + consts.COMPONENT_OPERATOR_VALIDATOR
                )
                == "true"
                and validator_nodes is not None
                and name not in validator_nodes
                and ustate in ("", consts.UPGRADE_STATE_DONE)
            ):
                evidence.append(
                    f"node {name}: validator not Running after rolling to "
                    f"{target!r}"
                )
                continue

            # validator perf regression vs the pre-roll baseline (the
            # headline case: a version that passes validation but tanks
            # matmul TFLOPS / HBM bandwidth). For a driver roll the
            # reading must be TAGGED with the target version (a stale
            # pre-roll reading equals the baseline and must not mask the
            # window); for a layout roll the version tag is unrelated —
            # readings count once the node reports the layout applied
            perf = _parse_perf(ann.get(consts.VALIDATOR_PERF_ANNOTATION, ""))
            base = _parse_perf(
                ann.get(consts.VALIDATOR_PERF_BASELINE_ANNOTATION, "")
            )
            perf_applicable = (
                perf is not None
                and base is not None
                and (
                    perf.get("version") == target
                    if summary.kind == KIND_DRIVER
                    else rolled
                )
            )
            if perf_applicable:
                for key, pct, unit in (
                    ("tflops", tflops_pct, "TFLOPS"),
                    ("gbps", membw_pct, "GB/s membw"),
                ):
                    try:
                        now_v = float(perf.get(key))
                        base_v = float(base.get(key))
                    except (TypeError, ValueError):
                        continue
                    if base_v <= 0 or pct <= 0:
                        continue
                    if now_v < base_v * (1.0 - pct / 100.0):
                        evidence.append(
                            f"node {name}: {now_v:g} {unit} at {target!r} "
                            f"vs pre-roll baseline {base_v:g} "
                            f"(> {pct:g}% regression)"
                        )
                        break

        # a Degraded CR condition is fleet-level evidence
        if len(evidence) < EVIDENCE_MAX:
            for cond in (
                (cp_obj.get("status") or {}).get("conditions") or []
            ):
                if (
                    cond.get("type") == "Degraded"
                    and cond.get("status") == "True"
                ):
                    evidence.append(
                        "ClusterPolicy Degraded "
                        f"({cond.get('reason', 'unknown')})"
                    )
                    break

        # alloc-latency p99 regression vs the pre-roll reading
        if len(evidence) < EVIDENCE_MAX:
            base_p99 = rec.get("allocP99Baseline")
            now_p99 = self._alloc_p99()
            pct = float(getattr(spec, "alloc_p99_degraded_pct", 100) or 0)
            if (
                base_p99 is not None
                and now_p99 is not None
                and pct > 0
                and float(base_p99) > 0
                and now_p99 > float(base_p99) * (1.0 + pct / 100.0)
            ):
                evidence.append(
                    f"alloc p99 {now_p99:.0f} ms vs pre-roll "
                    f"{float(base_p99):.0f} ms (> {pct:g}% regression)"
                )
        return evidence[:EVIDENCE_MAX]

    def _operand_health(self):
        """ONE namespace pod listing (informer-served) per ACTIVE pass:
        crashlooping gpu-* operand pods by node + the set of nodes with
        a Running, ready validator pod. Steady state (no staged roll)
        never calls this."""
        from tpu_operator_torch.controllers.remediation import pod_crashlooping
        from tpu_operator_torch.controllers.slice_status import VALIDATOR_APP

        crash_by_node: Dict[str, List[str]] = {}
        validator_nodes: Optional[Set[str]] = set()
        try:
            pods = self.client.list("v1", "Pod", self.namespace)
        except Exception:
            return {}, None  # listing failed: no pod-derived evidence
        for pod in pods:
            node = pod.get("spec", {}).get("nodeName")
            if not node:
                continue
            app = (
                (pod.get("metadata", {}).get("labels") or {}).get("app") or ""
            )
            if app.startswith(consts.OPERAND_APP_PREFIX) and pod_crashlooping(pod):
                crash_by_node.setdefault(node, []).append(
                    pod["metadata"]["name"]
                )
            if app == VALIDATOR_APP and pod.get("status", {}).get(
                "phase"
            ) == "Running":
                statuses = pod.get("status", {}).get("containerStatuses")
                if statuses is None or all(
                    cs.get("ready", True) for cs in statuses
                ):
                    validator_nodes.add(node)
        return crash_by_node, validator_nodes

    # ------------------------------------------------------------------
    def _save_record(self, cp_obj: Obj, rec: Optional[dict]) -> None:
        """Persist the ledger annotation (conflict-retried; the CR is
        shared with the status writer and user spec edits) and keep the
        in-hand copy coherent for same-pass readers (the admission
        filter computed right after)."""
        desired = (
            json.dumps(rec, sort_keys=True) if rec is not None else None
        )
        meta = cp_obj.setdefault("metadata", {})
        name = meta.get("name", "")

        def mutate(obj):
            ann = obj["metadata"].setdefault("annotations", {})
            if desired is None:
                if consts.ROLLOUT_STATE_ANNOTATION not in ann:
                    return False
                del ann[consts.ROLLOUT_STATE_ANNOTATION]
                return True
            if ann.get(consts.ROLLOUT_STATE_ANNOTATION) == desired:
                return False
            ann[consts.ROLLOUT_STATE_ANNOTATION] = desired
            return True

        try:
            mutate_with_retry(
                self.client,
                consts.API_VERSION,
                consts.CLUSTER_POLICY_KIND,
                name,
                mutate=mutate,
            )
        except Exception:
            # the in-hand copy still carries the new ledger for this
            # pass's gate; the next pass retries the write
            log.exception("rollout ledger write failed")
        ann = meta.setdefault("annotations", {})
        if desired is None:
            ann.pop(consts.ROLLOUT_STATE_ANNOTATION, None)
        else:
            ann[consts.ROLLOUT_STATE_ANNOTATION] = desired

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
            log.debug("rollout event write failed", exc_info=True)
