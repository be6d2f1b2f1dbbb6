"""A node's workload config, as the sandbox components read it.

The port's copy of ``node_workload_config``
(``tpu_operator/controllers/state_manager.py:202``).
"""

from __future__ import annotations

import logging

from tpu_operator_torch import consts

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
