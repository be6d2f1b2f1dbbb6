"""A node's workload config and card variant, as the node agents read them.

The port's copies of ``node_workload_config`` and ``node_generation``
(``tpu_operator/controllers/state_manager.py:190-202``).
"""

from __future__ import annotations

import logging

from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.workloads.topology import device_generation

log = logging.getLogger("tpu-validator")


def node_workload_config(node: dict) -> str:
    """The node's workload label; an unknown value warns and reads as
    ``container``."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    cfg = labels.get(consts.WORKLOAD_CONFIG_LABEL, consts.WORKLOAD_CONTAINER)
    if cfg not in (consts.WORKLOAD_CONTAINER, consts.WORKLOAD_VM_PASSTHROUGH):
        log.warning(
            "node %s: invalid workload config %r; using %s",
            node["metadata"]["name"],
            cfg,
            consts.WORKLOAD_CONTAINER,
        )
        cfg = consts.WORKLOAD_CONTAINER
    return cfg


def node_generation(node: dict) -> Optional[str]:
    """The H100 variant tag of the node's cards, from the product label
    feature discovery publishes (NVML's name with spaces as ``-``); None
    without the label or for another card. The reference reads the GKE
    accelerator label."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    return device_generation(labels.get(consts.GPU_PRODUCT_LABEL, "").replace("-", " "))
