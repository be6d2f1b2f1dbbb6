"""The ordered state machine: cluster facts, node labels and the 18 states.

The port's copy of ``tpu_operator/controllers/state_manager.py`` without
the reconciler that drives it. ``ClusterPolicyController.init`` decodes
the CR (after the rollout ledger's override, ``controllers/rollout.py``),
loads the 18 state directories of assets, labels the nodes that carry the
card, sets the upgrade annotation, discovers the container runtime and
gates the render cache; ``run_states`` then runs the states' controls
(``controllers/object_controls.py``) along the state DAG, the states of one
wave on a pool.

Decisions of the port:

* The state names are the reference's: the 18 asset directories,
  ``STATE_ORDER``, ``SANDBOX_STATES`` and ``_PARALLEL_AFTER_PREREQS``,
  ``state-libtpu``, ``state-runtime`` and ``tpu-feature-discovery``
  included. A state name is an internal key (a directory, a node of the
  DAG, the ``state`` label of ``gpu_operator_operand_states``), not a
  ClusterPolicy surface, so the DAG and the per-state outcomes compare
  across the two packages with no map. ``is_state_enabled`` reads the
  port's sub-specs: ``spec.driver`` for ``state-libtpu`` and
  ``spec.toolkit`` for ``state-runtime``.
* The assets are the package's own, ``tpu_operator_torch/assets/<state>/``,
  with the reference's file names and the card's names inside them. The
  default ``assets_dir`` is ``$GPU_OPERATOR_ASSETS`` (default
  ``/opt/gpu-operator``) where that directory exists, else the package's
  ``assets/``. A missing state directory raises.
* A node carries the card (``has_gpu_labels``, for ``has_tpu_labels``)
  when feature discovery's product label names an H100, or NFD's PCI label
  for vendor 10de, or the port's NodeFeatureRule label is ``true``. Its
  variant (``node_generation``, from the product label) is written as
  ``consts.GENERATION_LABEL`` and keys the driver's per-variant fan-out.
* The method and attribute names stay the reference's (``label_tpu_nodes``,
  ``has_tpu_nodes``, ``tpu_generations``, ``tpu_node_count``), so the
  reconciler ports against them unchanged; here they count the nodes that
  carry the card and the card variants present.
* The state pool shuts down through a ``weakref`` finalizer, as the write
  pipeline under the label and apply lanes does, so a collected controller
  leaves no thread behind.
"""

from __future__ import annotations

import logging
import os
import weakref
from typing import Dict, List, Optional, Set, Tuple

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import ClusterPolicy, State, clusterpolicy_from_obj
from tpu_operator_torch.controllers import object_controls
from tpu_operator_torch.controllers.cluster_snapshot import ClusterSnapshot
from tpu_operator_torch.controllers.render_cache import RenderCache, render_fingerprint
from tpu_operator_torch.controllers.resource_manager import Resources, add_resources_controls
from tpu_operator_torch.kube.apply import ApplyConflictError, ApplySet, batch_flush
from tpu_operator_torch.kube.client import Client, NotFoundError, Obj, apply_label_delta, mutate_with_retry
from tpu_operator_torch.kube.frozen import thaw
from tpu_operator_torch.kube.write_pipeline import BatchLane, WritePipeline
from tpu_operator_torch.obs import LogOnce, flight, trace
from tpu_operator_torch.workloads.topology import device_generation

log = logging.getLogger("gpu-operator.state")

DEFAULT_ASSETS_DIR = os.environ.get(consts.ASSETS_ENV, consts.DEFAULT_ASSETS_DIR)
PACKAGE_ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

STATE_ORDER: List[str] = [
    "pre-requisites",
    "state-operator-metrics",
    "state-libtpu",
    "state-runtime",
    "state-operator-validation",
    "state-device-plugin",
    "state-metricsd",
    "state-metrics-exporter",
    "tpu-feature-discovery",
    "state-slice-manager",
    "state-node-status-exporter",
    "state-maintenance-handler",
    "state-vm-manager",
    "state-vm-device-manager",
    "state-sandbox-validation",
    "state-vfio-manager",
    "state-sandbox-device-plugin",
    "state-kata-manager",
]

SANDBOX_STATES: Set[str] = {
    "state-vm-manager",
    "state-vm-device-manager",
    "state-sandbox-validation",
    "state-vfio-manager",
    "state-sandbox-device-plugin",
    "state-kata-manager",
}

# the container-workload operand states are mutually independent once the
# pre-requisites landed; a state outside this set depends on its
# predecessor in STATE_ORDER (the sandbox chain keeps its strict order)
_PARALLEL_AFTER_PREREQS: Set[str] = {
    "state-operator-metrics",
    "state-libtpu",
    "state-runtime",
    "state-operator-validation",
    "state-device-plugin",
    "state-metricsd",
    "state-metrics-exporter",
    "tpu-feature-discovery",
    "state-slice-manager",
    "state-node-status-exporter",
    "state-maintenance-handler",
}


def _build_state_dag() -> Dict[str, Tuple[str, ...]]:
    dag: Dict[str, Tuple[str, ...]] = {}
    for i, state in enumerate(STATE_ORDER):
        if i == 0:
            dag[state] = ()
        elif state in _PARALLEL_AFTER_PREREQS:
            dag[state] = (STATE_ORDER[0],)
        else:
            dag[state] = (STATE_ORDER[i - 1],)
    return dag


# state -> states that must complete before it starts
STATE_DAG: Dict[str, Tuple[str, ...]] = _build_state_dag()


def state_waves(state_names: List[str]) -> List[List[str]]:
    """Topological levels of ``STATE_DAG`` restricted to ``state_names``:
    the states of one wave may deploy concurrently, and wave N+1 starts
    after wave N completed. Order inside a wave follows the input."""
    present = set(state_names)
    level: Dict[str, int] = {}

    def lvl(state: str) -> int:
        got = level.get(state)
        if got is not None:
            return got
        deps = [d for d in STATE_DAG.get(state, ()) if d in present]
        got = 1 + max((lvl(d) for d in deps), default=-1)
        level[state] = got
        return got

    waves: Dict[int, List[str]] = {}
    for state in state_names:
        waves.setdefault(lvl(state), []).append(state)
    return [waves[i] for i in sorted(waves)]


# component -> deploy-label key, built once
_DEPLOY_KEYS: Dict[str, str] = {
    comp: consts.DEPLOY_LABEL_PREFIX + comp
    for comp in (*consts.CONTAINER_WORKLOAD_COMPONENTS, *consts.VM_WORKLOAD_COMPONENTS)
}


def has_gpu_labels(node: Obj) -> bool:
    """Whether the node carries the card: feature discovery's product label
    naming an H100, NFD's PCI label for vendor 10de, or the port's
    NodeFeatureRule label."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    if "H100" in labels.get(consts.GPU_PRODUCT_LABEL, "").upper():
        return True
    if labels.get(consts.NFD_GPU_PCI_LABEL) == "true":
        return True
    return labels.get(consts.NFD_RULE_GPU_PCI_LABEL) == "true"


def node_generation(node: Obj) -> Optional[str]:
    """The H100 variant tag of the node's cards, from the product label
    feature discovery publishes (NVML's name with spaces as ``-``); None
    without the label or for another card. The reference reads the GKE
    accelerator label."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    return device_generation(labels.get(consts.GPU_PRODUCT_LABEL, "").replace("-", " "))


def node_workload_config(node: Obj) -> str:
    """The node's workload label; an unknown value warns and reads as
    ``container``."""
    labels = node.get("metadata", {}).get("labels", {}) or {}
    cfg = labels.get(consts.WORKLOAD_CONFIG_LABEL, consts.WORKLOAD_CONTAINER)
    if cfg not in (consts.WORKLOAD_CONTAINER, consts.WORKLOAD_VM_PASSTHROUGH):
        log.warning(
            "node %s: invalid workload config %r; using %s", node["metadata"]["name"], cfg, consts.WORKLOAD_CONTAINER
        )
        cfg = consts.WORKLOAD_CONTAINER
    return cfg


def _apply_label_changes(node: Obj, changes: Dict[str, Optional[str]]) -> None:
    apply_label_delta(node["metadata"].setdefault("labels", {}), changes)


def _label_apply_payload(name: str, changes: Dict[str, Optional[str]]) -> Obj:
    """One node's label delta as an apply configuration (a ``None`` leaf
    deletes), applied by the label lane non-forced, non-pruned and
    update-only."""
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": dict(changes)}}


def _shutdown_pool(pool) -> None:
    pool.shutdown(wait=False)


class ClusterPolicyController:
    """The state machine over one client (``FakeClient``, ``RestClient`` or
    a ``CachedClient`` over either)."""

    def __init__(self, client: Client, assets_dir: Optional[str] = None):
        self.client = client
        self.assets_dir = assets_dir or (
            DEFAULT_ASSETS_DIR if os.path.isdir(DEFAULT_ASSETS_DIR) else PACKAGE_ASSETS_DIR
        )
        self.namespace = ""
        self.cp: ClusterPolicy = ClusterPolicy()
        self.cp_obj: Obj = {}
        # user-authored targets before any rollback override (init)
        self.raw_roll_targets: Dict[str, str] = {}
        self.openshift = False
        self.runtime = ""
        self.k8s_version = ""
        self.has_tpu_nodes = False  # nodes that carry the card
        self.has_nfd_labels = False
        self.tpu_node_count = 0
        self.tpu_generations: Set[str] = set()  # card variants present
        # the pass's node list: None = never listed, [] = listed and empty
        self._nodes_cache: Optional[List[Obj]] = None
        self.state_names: List[str] = []
        self.controls: Dict[str, List[Tuple[str, Obj]]] = {}
        self.resources: Dict[str, Resources] = {}
        self.idx = 0
        self.metrics = None  # wired by the reconciler
        # per-pass read memo (begin_pass/end_pass); None outside a pass
        self.snapshot: Optional[ClusterSnapshot] = None
        self.render_cache = RenderCache()
        # DaemonSets whose no-GPU skip was logged this no-GPU stretch
        self.no_tpu_skip_logged = LogOnce()
        # (node store version, sandbox flag) of the last clean labeling pass
        self._label_world: Optional[Tuple[int, bool]] = None
        # the node store version _nodes_cache was listed at
        self._nodes_cache_version: Optional[int] = None
        self._nodes_listed_at: Optional[int] = None
        self.snapshot_hits_total = 0
        self.snapshot_misses_total = 0
        self.last_snapshot_stats: Dict[str, float] = {}
        # a sharded replica's ownership view, or None
        self.shard_state = None
        # the label fan-out and every control's apply ride the write
        # pipeline; the label lane applies non-forced (a foreign override
        # conflicts instead of being reverted), non-pruned and update-only;
        # the manifest lane forced and pruning
        self.writes = WritePipeline(name="reconcile-writes")
        self.label_lane = BatchLane(
            self.writes,
            lambda payloads: batch_flush(self.client, payloads, force=False, prune=False, update_only=True),
            name="node-labels",
            shards=4,
        )
        self.apply_lane = BatchLane(
            self.writes,
            lambda payloads: batch_flush(self.client, payloads, force=True, prune=True),
            name="manifests",
        )
        self.applyset = ApplySet()
        self._state_pool = None

    def batch_stats(self) -> Dict[str, object]:
        """The batch lanes' counters, per lane and summed."""
        lanes = [self.label_lane.stats(), self.apply_lane.stats()]
        items = sum(s["items_total"] for s in lanes)
        batches = sum(s["batches_total"] for s in lanes)
        return {
            "lanes": {s["name"]: s for s in lanes},
            "items_total": items,
            "items_failed_total": sum(s["items_failed_total"] for s in lanes),
            "batches_total": batches,
            "fill_avg": round(items / batches, 2) if batches else 0.0,
        }

    def prune_abandoned(self) -> List[Tuple[str, str, str, str]]:
        """Seal the apply-set pass and delete what an earlier pass applied
        and this one no longer intends; a failed delete stays a member and
        is retried next pass."""
        abandoned = self.applyset.commit()
        for av, kind, ns, name in abandoned:
            try:
                if self.client.delete_if_exists(av, kind, name, ns):
                    log.info("pruned abandoned %s %s/%s (apply-set: no current pass intends it)", kind, ns or "-", name)
                self.applyset.record_pruned()
            except Exception:
                log.exception("failed to prune abandoned %s %s/%s", kind, ns, name)
                self.applyset.retain((av, kind, ns, name))
        return abandoned

    # ------------------------------------------------------------------
    # pass lifecycle
    # ------------------------------------------------------------------
    def begin_pass(self) -> ClusterSnapshot:
        self.snapshot = ClusterSnapshot(self.client, lambda: self.namespace)
        return self.snapshot

    def end_pass(self) -> Dict[str, float]:
        """Drain the write pipeline (on every exit, errors included) and
        fold the pass's snapshot counters into the totals."""
        try:
            self.writes.drain()
        except Exception:
            log.exception("write pipeline drain failed at pass end")
        snap, self.snapshot = self.snapshot, None
        if snap is None:
            return {}
        self.last_snapshot_stats = snap.stats()
        self.snapshot_hits_total += snap.hits
        self.snapshot_misses_total += snap.misses
        return self.last_snapshot_stats

    def snapshot_stats(self) -> Dict[str, float]:
        total = self.snapshot_hits_total + self.snapshot_misses_total
        return {
            "last_pass": self.last_snapshot_stats,
            "hits_total": self.snapshot_hits_total,
            "misses_total": self.snapshot_misses_total,
            "hit_rate_total": round(self.snapshot_hits_total / total, 4) if total else 0.0,
        }

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def decode_primary(self, cp_obj: Obj) -> None:
        """Apply the rollout ledger's override to the pass's private CR
        copy, decode it and resolve the operator namespace (raises without
        it: the operator pod crash-loops by design)."""
        from tpu_operator_torch.controllers.rollout import apply_override

        self.cp_obj = cp_obj
        self.raw_roll_targets = apply_override(cp_obj)
        self.cp = clusterpolicy_from_obj(cp_obj)
        self.namespace = os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "")
        if not self.namespace:
            raise RuntimeError(f"{consts.OPERATOR_NAMESPACE_ENV} environment variable not set")

    def init(self, cp_obj: Obj) -> None:
        self.decode_primary(cp_obj)
        self.idx = 0
        self.k8s_version = self._get_kubernetes_version()
        if not self.state_names:
            self._add_states()
        if self.cp.spec.psa.is_enabled():
            self.set_pod_security_labels_for_namespace()
        self.label_tpu_nodes()
        self.apply_upgrade_auto_annotation()
        self.runtime = self.get_runtime()
        self.render_cache.begin_pass(
            render_fingerprint(self.cp_obj, self.namespace, self.runtime, self.openshift), self.tpu_generations
        )
        self.applyset.begin_pass()
        log.info(
            "cluster init: k8s=%s runtime=%s gpuNodes=%s variants=%s",
            self.k8s_version,
            self.runtime,
            self.has_tpu_nodes,
            sorted(self.tpu_generations),
        )

    def _list_nodes(self) -> List[Obj]:
        """The pass's node list, stamping ``_nodes_listed_at`` with the
        store version bound to it."""
        if self.snapshot is not None:
            nodes = self.snapshot.nodes()
            self._nodes_listed_at = self.snapshot.nodes_version
            return nodes
        self._nodes_listed_at = self._node_store_version()
        return self.client.list("v1", "Node")

    def _get_kubernetes_version(self) -> str:
        for node in self._list_nodes():
            v = node.get("status", {}).get("nodeInfo", {}).get("kubeletVersion")
            if v:
                return v
        return ""

    def _add_states(self) -> None:
        for state in STATE_ORDER:
            path = os.path.join(self.assets_dir, state)
            if not os.path.isdir(path):
                raise FileNotFoundError(f"asset dir missing: {path}")
            res, controls = add_resources_controls(path, self.openshift)
            self.state_names.append(state)
            self.resources[state] = res
            self.controls[state] = controls

    # ------------------------------------------------------------------
    # node labeling
    # ------------------------------------------------------------------
    def _node_store_version(self) -> Optional[int]:
        fn = getattr(self.client, "store_version", None)
        return fn("v1", "Node") if fn is not None else None

    def label_tpu_nodes(self) -> None:
        """Scan the nodes (cluster facts and each node's label delta), then
        write the deltas through the label lane. While the node store
        version bound to this pass's list equals that of the last pass that
        wrote nothing, the scan is skipped."""
        nodes = self._list_nodes()
        version = self._nodes_listed_at
        world = (version, self.cp.spec.sandbox_enabled()) if version is not None else None
        if world is not None and world == self._label_world:
            self._nodes_cache = nodes
            self._nodes_cache_version = version
            return
        self._label_world = None
        self._nodes_cache_version = version
        self.has_tpu_nodes = False
        self.has_nfd_labels = False
        self.tpu_generations = set()
        self.tpu_node_count = 0
        results: List[Optional[Obj]] = [None] * len(nodes)
        to_write: List[Tuple[int, Obj, Dict[str, Optional[str]]]] = []
        for i, node in enumerate(nodes):
            labels = node["metadata"].get("labels") or {}
            if any(k.startswith("feature.node.kubernetes.io/") for k in labels):
                self.has_nfd_labels = True
            if has_gpu_labels(node):
                self.has_tpu_nodes = True
                self.tpu_node_count += 1
                gen = node_generation(node)
                if gen:
                    self.tpu_generations.add(gen)
            changes = self._node_label_changes(node)
            if changes:
                to_write.append((i, node, changes))
            else:
                results[i] = node
        skipped_foreign = 0
        if self.shard_state is not None and to_write:
            kept = []
            for i, node, changes in to_write:
                if self.shard_state.covers_node_obj(node):
                    kept.append((i, node, changes))
                else:
                    results[i] = node
            skipped_foreign = len(to_write) - len(kept)
            to_write = kept
        wrote = bool(to_write) or skipped_foreign > 0
        if to_write:
            flight.record(
                "labels.write", nodes=len(to_write), sample=[n["metadata"]["name"] for _, n, _ in to_write[:8]]
            )
            with trace.span("pass.label_writes", nodes=len(to_write)):
                futs = [
                    (
                        i,
                        node,
                        changes,
                        self.label_lane.submit(
                            ("Node", "", node["metadata"]["name"]),
                            _label_apply_payload(node["metadata"]["name"], changes),
                        ),
                    )
                    for i, node, changes in to_write
                ]
                for i, node, changes, fut in futs:
                    results[i] = self._label_outcome(node, changes, fut)
        self._nodes_cache = final_nodes = [n for n in results if n is not None]
        if self.has_tpu_nodes:
            self.no_tpu_skip_logged.clear()
        if self.snapshot is not None:
            self.snapshot.set_nodes(final_nodes)
        if world is not None and not wrote:
            self._label_world = world

    def _label_outcome(self, node: Obj, changes: Dict[str, Optional[str]], fut) -> Optional[Obj]:
        """Resolve one node's label apply: a conflict (a foreign writer's
        label) recomputes from a live read; a vanished node is None."""
        name = node["metadata"]["name"]
        try:
            return fut.result()
        except ApplyConflictError:
            return self._relabel_fresh(name, node, changes)
        except NotFoundError:
            log.info("node %s vanished during labeling", name)
            return None

    def _relabel_fresh(
        self, name: str, stale_node: Obj, stale_changes: Dict[str, Optional[str]]
    ) -> Optional[Obj]:
        """Conflict path: re-read the node live, recompute the delta
        against what the other writer wrote, and apply it forced."""
        try:
            fresh = getattr(self.client, "get_live", self.client.get)("v1", "Node", name)
        except NotFoundError:
            log.info("node %s vanished during labeling", name)
            return None
        changes = self._node_label_changes(fresh)
        if not changes:
            return fresh
        try:
            return self.client.apply_ssa(
                _label_apply_payload(name, changes), force=True, prune=False, update_only=True
            )
        except NotFoundError:
            log.info("node %s vanished during labeling", name)
            return None
        except Exception:
            log.warning("node %s label conflict retry failed; the requeue will converge it", name, exc_info=True)
            mutable = thaw(stale_node)
            _apply_label_changes(mutable, stale_changes)
            return mutable

    def _node_label_changes(self, node: Obj) -> Dict[str, Optional[str]]:
        """The desired operator-label delta of one node (``None`` deletes);
        {} in the labelled steady state. A node that lost its card loses
        every operator label."""
        labels = node["metadata"].get("labels") or {}
        changes: Dict[str, Optional[str]] = {}
        if has_gpu_labels(node):
            gen = node_generation(node)
            if gen and labels.get(consts.GENERATION_LABEL) != gen:
                changes[consts.GENERATION_LABEL] = gen
            if labels.get(consts.TPU_PRESENT_LABEL) != "true":
                changes[consts.TPU_PRESENT_LABEL] = "true"
            if self.shard_state is not None:
                want = str(self.shard_state.shard_of_node_obj(node))
                if labels.get(consts.SHARD_LABEL) != want:
                    changes[consts.SHARD_LABEL] = want
            changes.update(self._state_label_changes(node, labels))
        elif labels.get(consts.TPU_PRESENT_LABEL):
            for key in labels:
                if key.startswith(f"{consts.GROUP}/"):
                    changes[key] = None
        return changes

    def _state_label_changes(self, node: Obj, labels: Dict[str, str]) -> Dict[str, Optional[str]]:
        """Deploy labels by the node's workload config; an explicit
        ``false`` or ``paused-*`` a human set is left alone."""
        cfg = node_workload_config(node)
        if cfg == consts.WORKLOAD_VM_PASSTHROUGH and self.cp.spec.sandbox_enabled():
            enable, disable = consts.VM_WORKLOAD_COMPONENTS, consts.CONTAINER_WORKLOAD_COMPONENTS
        else:
            enable, disable = consts.CONTAINER_WORKLOAD_COMPONENTS, consts.VM_WORKLOAD_COMPONENTS
        changes: Dict[str, Optional[str]] = {}
        for comp in enable:
            key = _DEPLOY_KEYS[comp]
            value = labels.get(key)
            if value == "true" or value == "false" or (isinstance(value, str) and value.startswith("paused-")):
                continue
            changes[key] = "true"
        for comp in disable:
            key = _DEPLOY_KEYS[comp]
            if key in labels:
                changes[key] = None
        return changes

    # ------------------------------------------------------------------
    # PSA labels, the upgrade annotation, the runtime
    # ------------------------------------------------------------------
    def set_pod_security_labels_for_namespace(self) -> None:
        if self.client.get_or_none("v1", "Namespace", self.namespace) is None:
            return
        desired = {consts.PSA_LABEL_PREFIX + mode: "privileged" for mode in ("enforce", "audit", "warn")}

        def mutate(ns):
            labels = ns["metadata"].setdefault("labels", {})
            if all(labels.get(k) == v for k, v in desired.items()):
                return False
            labels.update(desired)
            return True

        mutate_with_retry(self.client, "v1", "Namespace", self.namespace, mutate=mutate)

    def apply_upgrade_auto_annotation(self) -> None:
        """``consts.UPGRADE_ENABLED_ANNOTATION`` on the CR while the driver's
        upgrade policy enables automatic upgrades."""
        pol = self.cp.spec.driver.upgrade_policy
        enabled = bool(pol and pol.is_auto_upgrade_enabled())
        if self.client.get_or_none(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, self.cp.name) is None:
            return
        want = "true" if enabled else None

        def mutate(obj):
            ann = obj["metadata"].setdefault("annotations", {})
            if want is None and consts.UPGRADE_ENABLED_ANNOTATION in ann:
                del ann[consts.UPGRADE_ENABLED_ANNOTATION]
                return True
            if want and ann.get(consts.UPGRADE_ENABLED_ANNOTATION) != want:
                ann[consts.UPGRADE_ENABLED_ANNOTATION] = want
                return True
            return False

        mutate_with_retry(self.client, consts.API_VERSION, consts.CLUSTER_POLICY_KIND, self.cp.name, mutate=mutate)

    def get_runtime(self) -> str:
        """The container runtime of the first node that carries the card,
        else ``spec.operator.defaultRuntime``."""
        runtime = self.cp.spec.operator.default_runtime or "containerd"
        nodes = self._nodes_cache if self._nodes_cache is not None else self._list_nodes()
        for node in nodes:
            if not has_gpu_labels(node):
                continue
            info = node.get("status", {}).get("nodeInfo", {}).get("containerRuntimeVersion", "")
            for name in ("containerd", "docker", "cri-o", "crio"):
                if info.startswith(name):
                    return "crio" if name in ("cri-o", "crio") else name
        return runtime

    # ------------------------------------------------------------------
    # state gating and stepping
    # ------------------------------------------------------------------
    def is_state_enabled(self, state_name: str) -> bool:
        spec = self.cp.spec
        sandbox = spec.sandbox_enabled()
        mapping = {
            "pre-requisites": True,
            "state-operator-metrics": True,
            "state-libtpu": spec.driver.is_enabled(),
            "state-runtime": spec.toolkit.is_enabled(),
            "state-operator-validation": True,  # cannot be disabled
            "state-device-plugin": spec.device_plugin.is_enabled(),
            "state-metricsd": spec.metricsd.is_enabled(),
            "state-metrics-exporter": spec.metrics_exporter.is_enabled(),
            "tpu-feature-discovery": spec.tfd.is_enabled(),
            "state-slice-manager": spec.slice_manager.is_enabled(),
            "state-node-status-exporter": spec.node_status_exporter.is_enabled(),
            "state-maintenance-handler": spec.maintenance_handler.is_enabled(),
            "state-vm-manager": sandbox and spec.vm_manager.is_enabled(),
            "state-vm-device-manager": sandbox and spec.vm_device_manager.is_enabled(),
            "state-sandbox-validation": sandbox,
            "state-vfio-manager": sandbox and spec.vfio_manager.is_enabled(),
            "state-sandbox-device-plugin": sandbox and spec.sandbox_device_plugin.is_enabled(),
            "state-kata-manager": sandbox and spec.kata_manager.is_enabled(),
        }
        return bool(mapping.get(state_name, True))

    def step(self) -> str:
        """Run the current state's controls and advance."""
        status = self.run_state(self.state_names[self.idx])
        self.idx += 1
        return status

    def run_state(self, state: str) -> str:
        """One state's controls in asset order; NotReady if any is."""
        overall = State.READY
        with trace.span("state.step", state=state) as sp:
            for control_name, obj in self.controls[state]:
                if object_controls.CONTROLS[control_name](self, state, obj) == State.NOT_READY:
                    overall = State.NOT_READY
            sp.set("status", overall)
        return overall

    def run_states(self, concurrent: Optional[bool] = None):
        """All states along ``STATE_DAG``: a wave's states on the state pool
        (``concurrent=False``, a pipeline of depth 1 or a one-state wave
        run them inline), a barrier between waves. Returns ``(state,
        outcome)`` in ``STATE_ORDER``, the outcome a ``State`` or the
        exception the state raised; one raising state never aborts its
        wave."""
        results: Dict[str, object] = {}
        if concurrent is None:
            concurrent = True

        def run_catching(state: str) -> object:
            try:
                return self.run_state(state)
            except Exception as e:  # noqa: BLE001 - isolated per state
                return e

        for wave_idx, wave in enumerate(state_waves(self.state_names)):
            inline = len(wave) == 1 or not concurrent or self.writes.depth == 1
            with trace.span("pass.wave", wave=wave_idx, states=len(wave), concurrent=not inline):
                if inline:
                    for state in wave:
                        results[state] = run_catching(state)
                    continue
                pool = self._ensure_state_pool()
                futs = [(s, pool.submit(run_catching, s)) for s in wave]
                with trace.span("wait.states", states=len(wave)):
                    for state, fut in futs:
                        results[state] = fut.result()
        self.idx = len(self.state_names)
        return [(s, results[s]) for s in self.state_names]

    def _ensure_state_pool(self):
        """The executor for wave-mate states, built on first use and shut
        down by a finalizer when the controller is collected."""
        if self._state_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._state_pool = ThreadPoolExecutor(
                max_workers=max(2, len(_PARALLEL_AFTER_PREREQS)), thread_name_prefix="state-wave"
            )
            weakref.finalize(self, _shutdown_pool, self._state_pool)
        return self._state_pool

    def last(self) -> bool:
        return self.idx == len(self.state_names)

    def current_state(self) -> str:
        return self.state_names[min(self.idx, len(self.state_names) - 1)]
