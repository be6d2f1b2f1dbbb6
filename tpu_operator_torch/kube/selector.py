"""Kubernetes label-selector string parsing (set-based + equality), and
the pod-spec predicate of the node agents' pod sweeps.

The port's copy of ``tpu_operator/kube/selector.py``: ``parse_selector``,
``matches`` and ``encode_dict_selector`` as they are, and
``pod_requests_gpu`` for ``pod_requests_tpu`` (``:140``), over the card's
resource names.

The apiserver accepts ``k=v``, ``k==v``, ``k!=v``, ``k in (a,b)``,
``k notin (a,b)``, bare ``k`` (exists) and ``!k`` (does not exist),
comma-joined. kubesim serves the same grammar so operator code that
forwards user-authored selectors (e.g. ``waitForCompletion.podSelector``
on the upgrade policy, matching the reference upgrade lib's pod-selector
option) behaves exactly as against a real apiserver, and the FakeClient /
informer cache match identically off-wire.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

from tpu_operator_torch import consts

# (key, op, values) where op ∈ eq/neq/in/notin/exists/notexists
Requirement = Tuple[str, str, List[str]]

_SET_RE = re.compile(
    r"^\s*(?P<key>[^\s!=,()]+)\s+(?P<op>in|notin)\s+\((?P<vals>[^)]*)\)\s*$"
)


def _split_terms(selector: str) -> List[str]:
    """Split on commas that are NOT inside parentheses."""
    terms, depth, cur = [], 0, []
    for ch in selector:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            terms.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    terms.append("".join(cur))
    return [t for t in (t.strip() for t in terms) if t]


def parse_selector(selector: str) -> List[Requirement]:
    """Raises ``ValueError`` on malformed input (the apiserver answers
    400 Bad Request)."""
    reqs: List[Requirement] = []
    for term in _split_terms(selector):
        m = _SET_RE.match(term)
        if m:
            vals = [v.strip() for v in m.group("vals").split(",") if v.strip()]
            reqs.append((m.group("key"), m.group("op"), vals))
            continue
        if term.startswith("!"):
            key = term[1:].strip()
            if not key or any(c in key for c in "=!() "):
                raise ValueError(f"malformed selector term: {term!r}")
            reqs.append((key, "notexists", []))
            continue
        if "!=" in term:
            k, v = term.split("!=", 1)
            reqs.append((k.strip(), "neq", [v.strip()]))
            continue
        if "==" in term:
            k, v = term.split("==", 1)
            reqs.append((k.strip(), "eq", [v.strip()]))
            continue
        if "=" in term:
            k, v = term.split("=", 1)
            reqs.append((k.strip(), "eq", [v.strip()]))
            continue
        if any(c in term for c in "() "):
            raise ValueError(f"malformed selector term: {term!r}")
        reqs.append((term, "exists", []))
    return reqs


@lru_cache(maxsize=512)
def _parse_cached(selector: str) -> Tuple[Requirement, ...]:
    """Hot paths (kubesim LIST filtering, informer/FakeClient matching)
    re-match the same selector string per object — parse once per
    distinct string, not once per object."""
    return tuple(parse_selector(selector))


def requirements_match(labels: Dict[str, Any], reqs) -> bool:
    labels = labels or {}
    for key, op, values in reqs:
        if op == "eq":
            if key not in labels or str(labels[key]) != values[0]:
                return False
        elif op == "neq":
            # k8s semantics: a missing key SATISFIES !=
            if key in labels and str(labels[key]) == values[0]:
                return False
        elif op == "in":
            if key not in labels or str(labels[key]) not in values:
                return False
        elif op == "notin":
            # missing key satisfies notin
            if key in labels and str(labels[key]) in values:
                return False
        elif op == "exists":
            if key not in labels:
                return False
        elif op == "notexists":
            if key in labels:
                return False
        else:
            return False
    return True


def matches(labels: Dict[str, Any], selector: str) -> bool:
    return requirements_match(labels, _parse_cached(selector))


def encode_dict_selector(selector: Dict[str, Any]) -> Optional[str]:
    """Server-side encoding for the dict selector convenience API:
    ``{"k": "v"}`` → ``k=v``; ``{"k": ["a","b"]}`` → ``k in (a,b)``;
    ``{"k": ""}``/``{"k": None}`` → ``k`` (exists); ``{"!k": None}`` →
    ``!k``. Glob values (client-side only) are skipped — the caller
    re-filters locally."""
    parts = []
    for k, v in selector.items():
        if k.startswith("!"):
            parts.append(k)
        elif isinstance(v, (list, tuple)):
            parts.append(f"{k} in ({','.join(str(x) for x in v)})")
        elif v in (None, ""):
            parts.append(k)
        elif "*" in str(v):
            continue
        else:
            parts.append(f"{k}={v}")
    return ",".join(parts) if parts else None


def pod_requests_gpu(pod: Dict[str, Any]) -> bool:
    """Whether any container requests or limits ``nvidia.com/gpu`` or a
    MIG slice (``nvidia.com/mig-*``)."""
    for container in pod.get("spec", {}).get("containers", []) or []:
        res = container.get("resources", {}) or {}
        for bucket in ("limits", "requests"):
            for key in res.get(bucket) or {}:
                if key == consts.GPU_RESOURCE or key.startswith(consts.MIG_RESOURCE_PREFIX):
                    return True
    return False
