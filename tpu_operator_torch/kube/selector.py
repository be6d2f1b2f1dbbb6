"""The pod-spec predicate of the node agents' pod sweeps.

The port's copy of ``tpu_operator/kube/selector.py::pod_requests_tpu``
(``:140``), for the card's resource names.
"""

from __future__ import annotations

from typing import Any, Dict

from tpu_operator_torch import consts


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
