"""Slice identity of a node, as the slice-workload gang reads it.

The port's copy of ``slice_id_for_node``
(``tpu_operator/controllers/slice_status.py:96``). The reference derives a
multi-host slice's host count from the TPU topology labels when the
slice-hosts label is missing; a GPU node has no such labels, so here only
the slice-hosts label counts.
"""

from __future__ import annotations

from tpu_operator_torch import consts


def slice_id_for_node(node: dict) -> str:
    """The explicit slice-id label; else the node pool when the
    slice-hosts label says the slice spans more than one host; else the
    node is a single-host slice of its own."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    explicit = labels.get(consts.TFD_SLICE_ID_LABEL)
    if explicit:
        return explicit
    try:
        hosts = int(labels.get(consts.TFD_SLICE_HOSTS_LABEL, ""))
    except ValueError:
        hosts = 0
    if hosts > 1:
        pool = labels.get(consts.GKE_NODEPOOL_LABEL)
        if pool:
            return pool
    return node["metadata"]["name"]
