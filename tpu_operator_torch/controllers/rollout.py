"""The rollout ledger's pure head: which version the fleet should run while a
rollback is in force.

The port's copy of ``tpu_operator/controllers/rollout.py:66-148``: the
ledger kinds and states, ``raw_targets``, ``load_record`` and
``apply_override``, which ``state_manager.ClusterPolicyController`` calls
on its private copy of the CR before decoding it. The orchestrator itself
(cohorts, the health gate, admission, the rollback decision) is the rest of
the reference's module and comes with the reconcilers.

The driver's ledger kind is ``driver`` where the reference writes
``libtpu``, and ``raw_targets`` reads ``spec.driver.version`` (the
reference's ``spec.libtpu.version``). ``convert.clusterpolicy_from_reference``
maps the kind inside the ledger annotation, so a CR the reference annotated
pins the port's effective version the same way.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from tpu_operator_torch import consts

Obj = Dict[str, Any]

# ledger kinds: which roller the staged change flows through
KIND_DRIVER = "driver"  # the reference's KIND_LIBTPU
KIND_LAYOUT = "layout"

# ledger states
STATE_ROLLING = "rolling"
STATE_PAUSED = "paused"
STATE_ROLLED_BACK = "rolled-back"
STATE_COMPLETE = "complete"


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
