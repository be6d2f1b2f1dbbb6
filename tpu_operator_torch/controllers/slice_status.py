"""Slice-scoped readiness: group the card's nodes into slices, count the
validated hosts of each and publish the verdict on the label bus.

The port's copy of ``tpu_operator/controllers/slice_status.py``. A slice
is usable only when every host in it is validated: a host counts when its
validator pod (``consts.VALIDATOR_APP``) is Running with every container
ready, its cards are allocatable, and it is neither inside a maintenance
window, held by remediation, nor mid re-partition. The verdict lands on
each member as ``tpu.k8s.io/tpu.slice.ready=true|false``, and a slice
flipping from ready to not ready records a Warning Event naming the hosts
(``kube/events.py``).

A GPU node carries no TPU topology labels, so the expected host count
comes from the slice-hosts label alone (``_hosts_from_labels``): the
reference derives it from the GKE topology label when the slice-hosts
label is missing, and here no label means a single-host slice.
``host_allocatable_ok`` counts ``nvidia.com/gpu`` and the MIG resources
(``consts.GPU_RESOURCE``, ``consts.MIG_RESOURCE_PREFIX``) where the
reference counts ``google.com/tpu`` and its subslices.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Dict, Iterable, List, Optional, Set

from tpu_operator_torch import consts
from tpu_operator_torch.kube.apply import ApplyConflictError
from tpu_operator_torch.kube.client import Client, NotFoundError

log = logging.getLogger("gpu-operator.slices")

Obj = Dict[str, Any]

VALIDATOR_APP = consts.VALIDATOR_APP


@dataclass
class SliceInfo:
    slice_id: str
    member_nodes: List[str] = field(default_factory=list)
    expected_hosts: int = 0  # 0 = unknown; fall back to member count
    ready_nodes: int = 0
    # members advertising the card resource with zero allocatable cards
    unhealthy_hosts: List[str] = field(default_factory=list)
    # members inside an announced host-maintenance window
    maintenance_hosts: List[str] = field(default_factory=list)
    # members remediation holds cordoned and tainted
    quarantined_hosts: List[str] = field(default_factory=list)
    # members mid live slice re-partition
    repartitioning_hosts: List[str] = field(default_factory=list)

    @property
    def ready(self) -> bool:
        want = self.expected_hosts or len(self.member_nodes)
        return want > 0 and self.ready_nodes >= want and len(self.member_nodes) >= want


@dataclass
class SliceSummary:
    slices: Dict[str, SliceInfo] = field(default_factory=dict)

    @property
    def total(self) -> int:
        return len(self.slices)

    @property
    def ready(self) -> int:
        return sum(1 for s in self.slices.values() if s.ready)

    @property
    def degraded(self) -> List[str]:
        return sorted(k for k, s in self.slices.items() if not s.ready)


def slice_id_for_node(node: Obj) -> str:
    """The explicit slice-id label; else the node pool when the
    slice-hosts label says the slice spans more than one host; else the
    node is a single-host slice of its own."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    explicit = labels.get(consts.TFD_SLICE_ID_LABEL)
    if explicit:
        return explicit
    if _expected_hosts(node) > 1:
        pool = labels.get(consts.GKE_NODEPOOL_LABEL)
        if pool:
            return pool
    return node["metadata"]["name"]


def _expected_hosts(node: Obj) -> int:
    labels = node.get("metadata", {}).get("labels", {}) or {}
    return _hosts_from_labels(labels.get(consts.TFD_SLICE_HOSTS_LABEL, ""))


@lru_cache(maxsize=256)
def _hosts_from_labels(raw: str) -> int:
    """Expected host count from the slice-hosts label; 0 (unknown: the
    member count stands) without it."""
    try:
        return int(raw)
    except (TypeError, ValueError):
        return 0


def validator_pod_ready(pod: Obj) -> bool:
    """The validator-pod readiness predicate: phase Running with every
    container ready (its initContainer chain passed)."""
    status = pod.get("status", {}) or {}
    if status.get("phase") != "Running":
        return False
    statuses = status.get("containerStatuses")
    return statuses is None or all(cs.get("ready", True) for cs in statuses)


def validator_ready_nodes(client: Client, namespace: str, app: str = VALIDATOR_APP) -> Set[str]:
    """Nodes whose validator pod passes ``validator_pod_ready``."""
    ready: Set[str] = set()
    for pod in client.list("v1", "Pod", namespace, label_selector={"app": app}):
        if not validator_pod_ready(pod):
            continue
        node = pod.get("spec", {}).get("nodeName")
        if node:
            ready.add(node)
    return ready


def validated_on_nodes(
    client: Client, namespace: str, node_names: Iterable[str], app: str = VALIDATOR_APP
) -> Set[str]:
    """Per-node variant of ``validator_ready_nodes``: one indexed
    ``(app, spec.nodeName)`` pod list per member."""
    ready: Set[str] = set()
    for name in node_names:
        for pod in client.list(
            "v1", "Pod", namespace, label_selector={"app": app}, field_selector={"spec.nodeName": name}
        ):
            if validator_pod_ready(pod):
                ready.add(name)
                break
    return ready


def host_allocatable_ok(node: Obj) -> Optional[bool]:
    """The kubelet's view of a member's cards: ``None`` when no card
    resource is advertised yet, ``True`` when any of ``nvidia.com/gpu`` and
    the MIG resources has nonzero allocatable, ``False`` when everything
    advertised reads zero. MIG resources count: a mixed-strategy partition
    zeroes the plain resource while its cards live on under
    ``nvidia.com/mig-<shape>``."""
    status = node.get("status", {}) or {}
    cap = status.get("capacity", {}) or {}
    alloc = status.get("allocatable", {}) or {}
    resources = [k for k in cap if k == consts.GPU_RESOURCE or k.startswith(consts.MIG_RESOURCE_PREFIX)]
    if not resources:
        return None
    for k in resources:
        try:
            if int(alloc.get(k, "0")) > 0:
                return True
        except (TypeError, ValueError):
            continue
    return False


def slice_members(client: Client, node: Obj):
    """``(slice_id, member node objects)`` for the slice this node belongs
    to: the one membership computation every consumer shares."""
    sid = slice_id_for_node(node)
    members = [n for n in client.list("v1", "Node") if slice_id_for_node(n) == sid]
    return sid, members


def group_slices(gpu_nodes: List[Obj]) -> Dict[str, SliceInfo]:
    slices: Dict[str, SliceInfo] = {}
    for node in gpu_nodes:
        sid = slice_id_for_node(node)
        info = slices.setdefault(sid, SliceInfo(slice_id=sid))
        info.member_nodes.append(node["metadata"]["name"])
        info.expected_hosts = max(info.expected_hosts, _expected_hosts(node))
    return slices


def _label(node: Obj, key: str):
    return (node.get("metadata", {}).get("labels", {}) or {}).get(key)


def aggregate(
    client: Client,
    namespace: str,
    gpu_nodes: List[Obj],
    validated: Optional[Set[str]] = None,
    pipeline=None,
    lane=None,
    owns=None,
) -> SliceSummary:
    """Compute per-slice readiness and publish it to the members' labels.

    ``validated`` overrides the validator-pod scan. ``owns(slice_id)`` gates
    the writes of a sharded replica (slices it does not own are computed,
    not published). The verdict writes ride ``lane`` (a ``BatchLane`` over
    the label-apply flush), else ``pipeline`` (a ``WritePipeline`` of merge
    patches), else go inline; a never-labelled node whose verdict is false
    is not written, and the summary returns only after every write
    landed."""
    if validated is None:
        validated = validator_ready_nodes(client, namespace)
    label_futs = []
    slices = group_slices(gpu_nodes)
    cached = {n["metadata"]["name"]: n for n in gpu_nodes}
    for info in slices.values():
        members = info.member_nodes
        info.unhealthy_hosts = sorted(n for n in members if host_allocatable_ok(cached[n]) is False)
        info.maintenance_hosts = sorted(n for n in members if _label(cached[n], consts.MAINTENANCE_STATE_LABEL))
        info.quarantined_hosts = sorted(
            n for n in members
            if _label(cached[n], consts.REMEDIATION_STATE_LABEL) in consts.REMEDIATION_DISRUPTED_STATES
        )
        info.repartitioning_hosts = sorted(
            n for n in members if _label(cached[n], consts.REPARTITION_STATE_LABEL) == consts.REPARTITION_STATE_ROLLING
        )
        info.ready_nodes = sum(
            1
            for n in members
            if n in validated
            and n not in info.unhealthy_hosts
            and n not in info.maintenance_hosts
            and n not in info.quarantined_hosts
            and n not in info.repartitioning_hosts
        )
        verdict = "true" if info.ready else "false"
        if owns is not None and not owns(info.slice_id):
            continue
        was_ready = any(_label(cached[n], consts.SLICE_READY_LABEL) == "true" for n in members)
        if verdict == "false" and was_ready:
            _record_degradation(client, namespace, info)
        for node_name in members:
            current = _label(cached[node_name], consts.SLICE_READY_LABEL)
            if current == verdict or (current is None and verdict == "false"):
                continue
            if lane is not None:
                fut = lane.submit(("Node", "", node_name), _verdict_payload(node_name, verdict))
            elif pipeline is not None:
                fut = pipeline.submit(("Node", "", node_name), _publish_verdict, client, node_name, verdict)
            else:
                try:
                    _publish_verdict(client, node_name, verdict)
                except Exception:
                    log.exception("failed to label node %s slice.ready=%s", node_name, verdict)
                continue
            label_futs.append((node_name, verdict, fut))
    for node_name, verdict, fut in label_futs:
        try:
            fut.result()
        except NotFoundError:
            pass  # node deleted mid-pass: the next pass regroups without it
        except ApplyConflictError:
            # the aggregation is the verdict's only writer: a foreign
            # actor touched the key, so take it back once, forced
            _reclaim_verdict(client, node_name, verdict)
        except Exception:
            log.exception("failed to label node %s slice.ready=%s", node_name, verdict)
    return SliceSummary(slices=slices)


def _verdict_payload(node_name: str, verdict: str) -> Obj:
    """One node's verdict as an apply configuration for the label lane."""
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": node_name, "labels": {consts.SLICE_READY_LABEL: verdict}},
    }


def _reclaim_verdict(client: Client, node_name: str, verdict: str) -> None:
    fn = getattr(client, "apply_ssa", None)
    if not callable(fn):
        return
    try:
        fn(_verdict_payload(node_name, verdict), force=True, prune=False, update_only=True)
    except NotFoundError:
        pass
    except Exception:
        log.exception("failed to reclaim node %s slice.ready=%s", node_name, verdict)


def _publish_verdict(client: Client, node_name: str, verdict: str) -> None:
    """One node's verdict as a labels-only merge patch; only a vanished
    node is swallowed here."""
    try:
        client.patch_labels("v1", "Node", node_name, labels={consts.SLICE_READY_LABEL: verdict})
    except NotFoundError:
        pass


def _record_degradation(client: Client, namespace: str, info: SliceInfo) -> None:
    """Warning Event on the true -> false flip naming which hosts took the
    slice down, one Event per slice."""
    from tpu_operator_torch.kube.events import TYPE_WARNING, cluster_policy_ref, record_event

    if info.quarantined_hosts:
        detail = (
            f"host(s) {', '.join(info.quarantined_hosts)} are quarantined for repair "
            f"({consts.REPAIR_TAINT_KEY}={consts.REPAIR_PENDING} taint)"
        )
    elif info.repartitioning_hosts:
        detail = (
            f"host(s) {', '.join(info.repartitioning_hosts)} are mid slice re-partition "
            f"(chip clients paused for a layout roll)"
        )
    elif info.maintenance_hosts:
        detail = f"host(s) {', '.join(info.maintenance_hosts)} are inside a scheduled host-maintenance window"
    elif info.unhealthy_hosts:
        detail = f"host(s) {', '.join(info.unhealthy_hosts)} advertise 0 allocatable {consts.GPU_RESOURCE}"
    else:
        detail = f"{info.ready_nodes} of {info.expected_hosts or len(info.member_nodes)} member hosts validated"
    record_event(
        client,
        namespace,
        cluster_policy_ref(),
        TYPE_WARNING,
        "SliceDegraded",
        f"slice {info.slice_id} is no longer ready: {detail}",
        dedup_extra=info.slice_id,
    )
