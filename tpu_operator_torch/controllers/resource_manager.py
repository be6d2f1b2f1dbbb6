"""Manifest loading: asset directory → typed resources + ordered controls.

The port's copy of ``tpu_operator/controllers/resource_manager.py``,
generic over an asset directory. PyYAML is imported where a directory is
loaded, so the module imports without it.

The analogue of ``controllers/resource_manager.go``: each state's
asset directory is walked in sorted-name order
(``controllers/resource_manager.go:70-89``), every YAML document is decoded
and bucketed by ``kind`` into a ``Resources`` struct, and a control-function
name is appended per document in file order (``:91-187``). The state
machine later executes those controls in order.

Unlike the reference (one object of each kind per state), ``Resources``
holds *lists* per kind, which removes the reference's implicit
one-ServiceMonitor-per-state restriction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

Obj = Dict[str, Any]

# kind -> control name (executed by object_controls)
KIND_TO_CONTROL = {
    "ServiceAccount": "service_account",
    "Role": "role",
    "RoleBinding": "role_binding",
    "ClusterRole": "cluster_role",
    "ClusterRoleBinding": "cluster_role_binding",
    "ConfigMap": "config_map",
    "DaemonSet": "daemonset",
    "Deployment": "deployment",
    "Service": "service",
    "ServiceMonitor": "service_monitor",
    "PrometheusRule": "prometheus_rule",
    "RuntimeClass": "runtime_class",
    "PriorityClass": "priority_class",
    "PodSecurityPolicy": "pod_security_policy",
    "SecurityContextConstraints": "security_context_constraints",
    "Pod": "pod",
}


@dataclass
class Resources:
    """Decoded manifests for one state (reference ``Resources`` struct,
    ``controllers/resource_manager.go:35-53``)."""

    by_kind: Dict[str, List[Obj]] = field(default_factory=dict)

    def add(self, obj: Obj) -> None:
        self.by_kind.setdefault(obj["kind"], []).append(obj)

    def of(self, kind: str) -> List[Obj]:
        return self.by_kind.get(kind, [])

    def first(self, kind: str) -> Obj:
        items = self.of(kind)
        if not items:
            raise KeyError(f"no {kind} in state resources")
        return items[0]


def get_assets_from(path: str, openshift: bool = False) -> List[str]:
    """Sorted asset file list; skips ``*openshift*`` files off-OCP
    (reference ``getAssetsFrom``, ``controllers/resource_manager.go:70-89``)."""
    files = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        if not name.endswith((".yaml", ".yml")):
            continue
        if not openshift and "openshift" in name:
            continue
        files.append(full)
    return files


def add_resources_controls(
    path: str, openshift: bool = False
) -> Tuple[Resources, List[Tuple[str, Obj]]]:
    """Load one state directory.

    Returns the decoded ``Resources`` plus the ordered control list as
    ``(control_name, obj)`` pairs — the Python shape of the reference's
    parallel ``controlFunc`` slice (``controllers/resource_manager.go:91-187``).
    """
    import yaml

    res = Resources()
    controls: List[Tuple[str, Obj]] = []
    for f in get_assets_from(path, openshift):
        with open(f) as fh:
            for doc in yaml.safe_load_all(fh):
                if not doc:
                    continue
                kind = doc.get("kind")
                if not kind:
                    raise ValueError(f"{f}: document without kind")
                control = KIND_TO_CONTROL.get(kind)
                if control is None:
                    raise ValueError(f"{f}: unhandled kind {kind}")
                res.add(doc)
                controls.append((control, doc))
    return res, controls
