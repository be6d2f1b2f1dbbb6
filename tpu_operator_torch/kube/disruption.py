"""PodDisruptionBudget semantics shared by kubesim and the FakeClient.

The port's copy of ``tpu_operator/kube/disruption.py``; it reads only
``consts`` (the driver's upgrade label where the reference reads
libtpu's).

The reference's drain goes through the Eviction subresource via kubectl's
drain helper (``vendor/.../upgrade/drain_manager.go:76-89``,
``vendor/k8s.io/kubectl/pkg/drain/drain.go:43-45``), which means a user's
PDB can veto a disruption with 429 TooManyRequests. Both API doubles
enforce the same arithmetic through this module so operator code sees
apiserver-faithful behavior: an eviction is allowed only while every
matching budget keeps ``disruptionsAllowed > 0``.

Healthy counting follows the disruption controller: pods with a
``Ready=True`` condition, falling back to ``phase=Running`` for doubles
that don't model conditions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

Obj = Dict[str, Any]


def _selector_matches(selector: Optional[dict], pod: Obj) -> bool:
    """LabelSelector (matchLabels + matchExpressions) against pod labels.
    An empty/absent selector matches every pod in the namespace (PDB API
    semantics, unlike a plain list selector)."""
    labels = pod.get("metadata", {}).get("labels", {}) or {}
    if not selector:
        return True
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key = expr.get("key", "")
        op = expr.get("operator", "")
        values = expr.get("values") or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            return False  # unknown operator: fail closed
    return True


def _healthy(pod: Obj) -> bool:
    for cond in pod.get("status", {}).get("conditions") or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return pod.get("status", {}).get("phase") == "Running"


def _scaled(value, total: int) -> Optional[int]:
    """int-or-percent (k8s GetScaledValueFromIntOrPercent, rounding up
    for minAvailable-style fields as the disruption controller does).
    Malformed values ("10.5%", garbage) return None — the caller blocks
    the eviction with a message instead of surfacing a 500 / crash."""
    try:
        if isinstance(value, str) and value.endswith("%"):
            import math

            return math.ceil(total * int(value[:-1]) / 100.0)
        if isinstance(value, float) and value != int(value):
            # minAvailable: 1.5 is as malformed as "10.5%" — silently
            # truncating to 1 would weaken the budget; take the same
            # fail-closed block path
            return None
        return int(value)
    except (TypeError, ValueError, OverflowError):
        # OverflowError: float('inf') budgets (YAML `.inf`) must also
        # take the fail-closed path, not crash the evict handler
        return None


def eviction_blocked_by(
    pod: Obj, pods: List[Obj], pdbs: List[Obj]
) -> Optional[Tuple[str, str]]:
    """Would evicting ``pod`` violate any budget? Returns ``(pdb_name,
    message)`` for the first violated PDB, else None. ``pods`` is the
    namespace's pod population the budgets are measured against."""
    pod_ns = pod.get("metadata", {}).get("namespace", "")
    for pdb in pdbs:
        if pdb.get("metadata", {}).get("namespace", "") != pod_ns:
            continue
        spec = pdb.get("spec", {}) or {}
        selector = spec.get("selector")
        if not _selector_matches(selector, pod):
            continue
        matching = [
            p
            for p in pods
            if p.get("metadata", {}).get("namespace", "") == pod_ns
            and _selector_matches(selector, p)
        ]
        healthy = sum(1 for p in matching if _healthy(p))
        total = len(matching)
        if "minAvailable" in spec:
            required = _scaled(spec["minAvailable"], total)
            allowed = healthy - required if required is not None else None
        elif "maxUnavailable" in spec:
            unhealthy = total - healthy
            budget = _scaled(spec["maxUnavailable"], total)
            allowed = budget - unhealthy if budget is not None else None
        else:
            continue
        if allowed is None:
            # fail closed on an unparseable budget: block with a message
            # rather than crash the evict handler with a 500
            name = pdb.get("metadata", {}).get("name", "")
            return name, (
                f"Cannot evict pod: disruption budget {name} has a "
                f"malformed int-or-percent value "
                f"{spec.get('minAvailable', spec.get('maxUnavailable'))!r}"
            )
        if allowed <= 0:
            name = pdb.get("metadata", {}).get("name", "")
            return name, (
                f"Cannot evict pod as it would violate the pod's disruption "
                f"budget: the disruption budget {name} needs "
                f"{spec.get('minAvailable', spec.get('maxUnavailable'))} "
                f"available and disruptionsAllowed is 0 "
                f"({healthy} healthy of {total} matching)"
            )
    return None


# ---------------------------------------------------------------------------
# Shared slice-unit disruption accounting (operator-side, not PDB).
#
# THREE actors issue fleet disruptions, each at slice granularity: the
# rolling driver upgrade FSM, the node-health remediation FSM, and the
# live slice re-partition roll. They draw on ONE maxUnavailable pool —
# each side's admission counts the JOINT disrupted set — and every
# consumer derives that set through the predicates below so the three
# arithmetics cannot drift. All signals are durable node labels, so the
# accounting survives operator restarts and a vanished node releases its
# hold the moment it leaves the node listing (nothing retires by hand).
# ---------------------------------------------------------------------------

OWNER_UPGRADE = "upgrade"
OWNER_REMEDIATION = "remediation"
OWNER_REPARTITION = "repartition"


def repartition_disrupted(node: Obj) -> bool:
    """Whether the live re-partition roll currently holds this node
    disrupted (its chip clients are paused while the layout changes)."""
    from tpu_operator_torch import consts

    labels = node.get("metadata", {}).get("labels", {}) or {}
    return (
        labels.get(consts.REPARTITION_STATE_LABEL)
        == consts.REPARTITION_STATE_ROLLING
    )


def disruption_owner(node: Obj) -> Optional[str]:
    """Which actor currently holds this node disrupted — ``"upgrade"``
    (FSM active or failed), ``"remediation"`` (cordon-drain/quarantined/
    exhausted), ``"repartition"`` (mid layout roll) — or None. Checked in
    interlock order: the upgrade FSM outranks remediation (remediation
    defers to it), which outranks a re-partition roll."""
    from tpu_operator_torch import consts

    labels = node.get("metadata", {}).get("labels", {}) or {}
    ustate = labels.get(consts.UPGRADE_STATE_LABEL, "")
    if (
        ustate in consts.UPGRADE_ACTIVE_STATES
        or ustate == consts.UPGRADE_STATE_FAILED
    ):
        return OWNER_UPGRADE
    if (
        labels.get(consts.REMEDIATION_STATE_LABEL)
        in consts.REMEDIATION_DISRUPTED_STATES
    ):
        return OWNER_REMEDIATION
    if repartition_disrupted(node):
        return OWNER_REPARTITION
    return None


def joint_disrupted_slices(
    nodes: List[Obj], slice_of: Dict[str, str]
) -> Dict[str, set]:
    """The joint disrupted set in SLICE units, split by owner. Returns
    ``{"upgrade": sids, "remediation": sids, "repartition": sids,
    "all": union}`` — a slice is disrupted when ANY member host is.
    ``slice_of`` maps node name → slice id (missing names are slices of
    one, the same fallback every consumer uses)."""
    out: Dict[str, set] = {
        OWNER_UPGRADE: set(),
        OWNER_REMEDIATION: set(),
        OWNER_REPARTITION: set(),
    }
    for node in nodes:
        owner = disruption_owner(node)
        if owner is None:
            continue
        name = node.get("metadata", {}).get("name", "")
        out[owner].add(slice_of.get(name, name))
    out["all"] = out[OWNER_UPGRADE] | out[OWNER_REMEDIATION] | out[
        OWNER_REPARTITION
    ]
    return out
