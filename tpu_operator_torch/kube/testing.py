"""Shared test and dev doubles: GPU and CPU nodes, and the simulated
fleet's kubelet and node agents, and ``running_operator``, the operator
process as ``main()`` wires it, for the wire tests and the card's check.

# lint: ignore-file[layering] — test/dev scaffolding: the doubles
# deliberately reach upward (sliceman verdicts, CRD generation) to stay
# faithful to what the full stack writes; runtime kube/ code never does.

The port's copy of ``tpu_operator/kube/testing.py``. A GPU node
(``make_gpu_node``) carries the labels the port's feature discovery
(``discovery/tfd.py``) publishes for one HGX H100 board of
``CARDS_PER_HOST`` cards in one NVLink domain, the NFD labels and the NFD
fallback ``pci-10de.present``.

The kubelet simulators (``simulate_kubelet_once``,
``simulate_kubelet_nodes``) write operand pods the way the DaemonSet
controller and the kubelet would, with OnDelete kept faithful,
``nodeSelector`` and NoSchedule taints honoured and orphan pods deleted;
the node agents' role (``_simulate_node_agents``) publishes each node's
driver version as ``consts.DRIVER_VERSION_LABEL`` and its validator
readings as the ``validator-perf`` annotation. Those readings are the
card variant's datasheet rates (``workloads/topology.py``
``PEAK_BF16_TFLOPS``, ``PEAK_HBM_GBPS``), scaled by an injected bad
version's ``tflops_factor``; the reference publishes fixed rates of its
own chip. The driver DaemonSet is the one whose ``app`` starts with
``consts.DRIVER_APP`` (``OPERAND_APPS``).
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager

from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import Client, ConflictError, Obj
from tpu_operator_torch.kube.write_pipeline import WritePipeline
from tpu_operator_torch.workloads import topology as topo

# per-client kubelet write pipeline: a 1000-node pool's kubelets are a
# thousand PARALLEL actors on a real cluster — simulating them as one
# serial RTT loop measured the simulator, not the operator. Keyed weakly
# so a test's client takes its pipeline (and threads) with it.
_kubelet_pipelines: "weakref.WeakKeyDictionary[Client, WritePipeline]" = (
    weakref.WeakKeyDictionary()
)


def _kubelet_pipeline(client: Client) -> WritePipeline:
    from tpu_operator_torch.kube.write_pipeline import default_depth

    pipe = _kubelet_pipelines.get(client)
    if pipe is None:
        # capped at 4: the simulated kubelets only ever talk to an
        # IN-PROCESS apiserver (FakeClient or same-interpreter kubesim),
        # where deeper fan-out buys no I/O overlap and pays GIL-convoy
        # latency per write (see write_pipeline.default_depth)
        pipe = _kubelet_pipelines.setdefault(
            client,
            WritePipeline(depth=min(4, default_depth()), name="kubelet-sim"),
        )
    return pipe


# per-client batched pod-apply lane over the kubelet pipeline: a fleet
# sweep's pod fan-out (N nodes × ~9 operand DaemonSets) group-commits
# into multi-object APPLY submissions (kube/write_pipeline.BatchLane →
# apply_ssa_batch) instead of one POST per pod — at 1000 nodes that is
# the difference between ~9k wire requests and ~150 on the convergence
# bench, without changing what ends up stored
_kubelet_lanes: "weakref.WeakKeyDictionary[Client, object]" = (
    weakref.WeakKeyDictionary()
)

#: the simulated kubelets' field-manager identity — pod leaves they
#: apply are owned by this manager, not the operator's
KUBELET_SIM_FIELD_MANAGER = "kubelet-sim"


def _kubelet_lane(client: Client):
    from tpu_operator_torch.kube.apply import batch_flush
    from tpu_operator_torch.kube.write_pipeline import BatchLane

    lane = _kubelet_lanes.get(client)
    if lane is None:
        # the flush closure must hold the client WEAKLY: this map's
        # values are strongly held, so a strong capture would pin the
        # key forever and defeat the weak keying both maps exist for
        # (a dead client would leak its lane AND its pipeline threads)
        client_ref = weakref.ref(client)

        def _flush(payloads):
            c = client_ref()
            if c is None:  # client died with a batch queued
                raise RuntimeError("kubelet-sim client was garbage-collected")
            return batch_flush(
                c,
                payloads,
                field_manager=KUBELET_SIM_FIELD_MANAGER,
                force=True,
                prune=True,
            )

        lane = _kubelet_lanes.setdefault(
            client,
            BatchLane(
                _kubelet_pipeline(client),
                _flush,
                name="kubelet-pods",
                # match the kubelet pipeline's depth: a fleet sweep's
                # pod fan-out overlaps 4 in-flight batches per client.
                # Bigger batches than the operator default: a sweep's
                # fan-out is thousands of independent creates against an
                # in-process server, where per-request framing is the
                # only overhead a batch can amortize
                max_batch=256,
                shards=4,
            ),
        )
    return lane


# ---------------------------------------------------------------------------
# seeded bad-version fault primitive: nodes running a version
# registered here report degraded validator TFLOPS/membw (and optionally
# a crashlooping driver operand), so the rollout orchestrator's health
# gate and automatic rollback are testable deterministically — the chaos
# schedule's ``bad_version`` event kind lands in this registry.
# ---------------------------------------------------------------------------

_BAD_VERSIONS: dict = {}


def perf_base(labels: dict) -> tuple:
    """A healthy node's validator readings, ``(tflops, gbps)``: the
    datasheet bf16 rate and device-memory rate of the card variant its
    product label names (``DEFAULT_VARIANT`` for another card or none). A
    bad version scales both."""
    product = (labels or {}).get(consts.GPU_PRODUCT_LABEL, "").replace("-", " ")
    variant = topo.device_generation(product) or DEFAULT_VARIANT
    return topo.PEAK_BF16_TFLOPS[variant], topo.PEAK_HBM_GBPS[variant]


def inject_bad_version(
    version: str, tflops_factor: float = 1.0, crashloop: bool = False
) -> None:
    """Register ``version`` as bad: every simulated node running it
    reports validator perf scaled by ``tflops_factor`` (applied to both
    TFLOPS and membw GB/s), and with ``crashloop`` its driver operand
    pod flips to CrashLoopBackOff. Deterministic and process-local —
    the replayable chaos trace carries the same args."""
    _BAD_VERSIONS[str(version)] = {
        "tflops_factor": float(tflops_factor),
        "crashloop": bool(crashloop),
    }


def clear_bad_versions() -> None:
    _BAD_VERSIONS.clear()


def _version_of_image(image: str) -> str:
    """The tag of an image ref ('' for digests/untagged refs)."""
    if not image or "@" in image:
        return ""
    head, sep, tag = image.rpartition(":")
    if not sep or "/" in tag:
        return ""
    return tag


def _driver_ds_version(ds: Obj) -> str:
    for c in ds["spec"]["template"]["spec"].get("containers") or []:
        v = _version_of_image(c.get("image", "") or "")
        if v:
            return v
    return ""


# per-client batched node-agent lane: the TFD/validator role's version
# label + perf annotation applies ride one update-only SSA batch lane
# (resurrecting a preempted node via a plain apply would be an invariant
# disaster, hence update_only)
_node_agent_lanes: "weakref.WeakKeyDictionary[Client, object]" = (
    weakref.WeakKeyDictionary()
)


def _node_agent_lane(client: Client):
    from tpu_operator_torch.kube.apply import batch_flush
    from tpu_operator_torch.kube.write_pipeline import BatchLane

    lane = _node_agent_lanes.get(client)
    if lane is None:
        client_ref = weakref.ref(client)

        def _flush(payloads):
            c = client_ref()
            if c is None:
                raise RuntimeError("kubelet-sim client was garbage-collected")
            return batch_flush(
                c,
                payloads,
                field_manager=KUBELET_SIM_FIELD_MANAGER,
                force=True,
                prune=False,
                update_only=True,
            )

        lane = _node_agent_lanes.setdefault(
            client,
            BatchLane(
                _kubelet_pipeline(client),
                _flush,
                name="kubelet-node-agents",
                max_batch=256,
                shards=2,
            ),
        )
    return lane


DEFAULT_VARIANT = "h100-sxm"
DEFAULT_PRODUCT = "NVIDIA-H100-80GB-HBM3"  # feature discovery's product label
DEFAULT_MEMORY_MIB = 81559  # NVML's memory total of one H100 80GB HBM3
DEFAULT_DRIVER_VERSION = "550.90.07"
# cards a simulated host advertises (one HGX H100 board); KubeSim reads
# it here, so kube/'s runtime modules never import workloads/
HOST_CARDS = topo.CARDS_PER_HOST[DEFAULT_VARIANT]


def make_gpu_node(
    name: str,
    variant: str = DEFAULT_VARIANT,
    product: str = DEFAULT_PRODUCT,
    extra_labels: dict | None = None,
) -> Obj:
    """A GPU node of one board: ``CARDS_PER_HOST[variant]`` cards in one
    NVLink domain (capacity is the kubelet's to write)."""
    cards = topo.CARDS_PER_HOST[variant]
    topology = topo.format_topology((1, cards))
    labels = {
        "kubernetes.io/hostname": name,
        consts.GPU_PRODUCT_LABEL: product,
        consts.GPU_COUNT_LABEL: str(cards),
        consts.GPU_MEMORY_LABEL: str(DEFAULT_MEMORY_MIB),
        consts.TFD_TOPOLOGY_LABEL: topology,
        consts.TFD_SLICE_HOSTS_LABEL: str(topo.host_count(topology, variant)),
        consts.DRIVER_VERSION_LABEL: DEFAULT_DRIVER_VERSION,
        consts.NFD_GPU_PCI_LABEL: "true",
        consts.NFD_KERNEL_LABEL: "6.1.0",
        consts.NFD_OS_LABEL: "ubuntu",
        consts.NFD_OS_VERSION_LABEL: "22.04",
    }
    labels.update(extra_labels or {})
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels, "annotations": {}},
        "status": {
            "capacity": {},
            "allocatable": {},
            "nodeInfo": {
                "containerRuntimeVersion": "containerd://1.7.0",
                "kernelVersion": "6.1.0",
                "osImage": "Ubuntu 22.04",
            },
        },
    }


def make_cpu_node(name: str) -> Obj:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {
            "capacity": {},
            "allocatable": {},
            "nodeInfo": {"containerRuntimeVersion": "containerd://1.7.0"},
        },
    }


def _stamp_ds_status(client: Client, ds: Obj, scheduled: int) -> None:
    status = {
        "desiredNumberScheduled": scheduled,
        "numberUnavailable": 0,
        "updatedNumberScheduled": scheduled,
    }
    if ds.get("status") != status:
        ds["status"] = status
        client.update_status(ds)


def _operand_pod_body(
    namespace: str, name: str, app: str, revision_hash, node_name: str
) -> Obj:
    """The single Running operand-pod shape every kubelet simulator
    writes (inline creates and batched applies share it, so the two
    write paths cannot drift)."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {"app": app},
            "annotations": {consts.LAST_APPLIED_HASH_ANNOTATION: revision_hash},
        },
        "spec": {"nodeName": node_name},
        "status": {"phase": "Running", "containerStatuses": [{"ready": True}]},
    }


def _ensure_operand_pod(
    client: Client,
    namespace: str,
    name: str,
    app: str,
    revision_hash,
    node_name: str,
    refresh_stale: bool,
    existing: Obj | None = None,
    probed: bool = False,
) -> None:
    """Create (or, when ``refresh_stale``, hash-refresh) one Running operand
    pod — the single pod shape both kubelet simulators use so they can't
    drift.

    ``existing``/``probed``: callers that already LISTed the namespace
    pods pass the (possibly absent) stored pod with ``probed=True`` —
    the fleet sweep used to re-GET every pod every 100 ms round, and
    those reads were the single largest request volume on the
    convergence bench (~9 DaemonSets × N nodes per sweep)."""
    pod = _operand_pod_body(namespace, name, app, revision_hash, node_name)
    if not probed:
        existing = client.get_or_none("v1", "Pod", name, namespace)
    if existing is None:
        try:
            client.create(pod)
        except ConflictError:
            if not probed:
                raise
            # the pre-sweep listing was stale about this pod (it exists)
            # — the next sweep's fresh listing reconciles its hash
    elif refresh_stale and (
        existing["metadata"].get("annotations", {}).get(
            consts.LAST_APPLIED_HASH_ANNOTATION
        )
        != revision_hash
    ):
        pod["metadata"]["resourceVersion"] = existing["metadata"]["resourceVersion"]
        client.update(pod)


def _ds_app_and_hash(ds: Obj):
    app = ds["spec"]["selector"]["matchLabels"]["app"]
    h = (
        ds["spec"]["template"]["metadata"]
        .get("annotations", {})
        .get(consts.LAST_APPLIED_HASH_ANNOTATION)
    )
    return app, h


def simulate_kubelet_once(
    client: Client,
    namespace: str,
    node_name: str = "fake-gpu-node-1",
    pods_per_ds: int = 1,
) -> None:
    """One kubelet pass: mark every DaemonSet fully scheduled/available and
    keep Running pods per OnDelete operand at the *current* revision hash —
    including refreshing a stale pod after a template change (the case an
    earlier diverged copy of this helper missed)."""
    for ds in client.list("apps/v1", "DaemonSet", namespace):
        if not ds.get("status"):
            _stamp_ds_status(client, ds, pods_per_ds)
        if ds["spec"].get("updateStrategy", {}).get("type") != "OnDelete":
            continue
        app, h = _ds_app_and_hash(ds)
        for i in range(pods_per_ds):
            _ensure_operand_pod(
                client,
                namespace,
                f"{app}-{i}",
                app,
                h,
                node_name,
                refresh_stale=True,
            )


def toleration_matches(tol: dict, taint: dict) -> bool:
    """Whether one toleration tolerates one taint (k8s semantics: empty
    key + Exists tolerates everything; effect empty matches any)."""
    op = tol.get("operator", "Equal")
    key = tol.get("key", "")
    if key:
        if key != taint.get("key"):
            return False
    elif op != "Exists":
        return False  # empty key only legal with Exists
    if op == "Equal" and tol.get("value", "") != taint.get("value", ""):
        return False
    effect = tol.get("effect", "")
    return not effect or effect == taint.get("effect", "")


def tolerates_node_taints(pod_spec: dict, node: Obj) -> bool:
    """Scheduler predicate: every NoSchedule taint on the node must be
    matched by some toleration on the pod spec — the half of taint
    semantics pod placement needs (NoSchedule gates placement only; it
    never evicts running pods, unlike NoExecute)."""
    tolerations = pod_spec.get("tolerations") or []
    for taint in node.get("spec", {}).get("taints") or []:
        if taint.get("effect") != "NoSchedule":
            continue
        if not any(toleration_matches(t, taint) for t in tolerations):
            return False
    return True


def simulate_kubelet_nodes(
    client: Client, namespace: str, node_names, halt_event=None
) -> None:
    """One kubelet pass over a multi-node pool with FAITHFUL OnDelete
    semantics: each node gets one Running pod per DaemonSet (named
    ``{app}-{node}``) stamped with the template revision hash at creation
    time. An OnDelete pod is never refreshed on a template change — a real
    OnDelete kubelet only re-creates a pod after something deletes it
    (reference apps/v1 OnDelete contract, the premise of the upgrade FSM's
    pod-restart step, ``upgrade_state.go:59-110``) — while a RollingUpdate
    pod IS hash-refreshed, the way the DS controller rolls it.

    ``simulate_kubelet_once`` (above) deliberately refreshes stale OnDelete
    pods too, so single-node dev mode converges without the upgrade FSM;
    this variant is the one upgrade e2e tests must use, otherwise the
    kubelet would upgrade the driver behind the FSM's back and the rolling
    upgrade would be untestable.

    Scheduling honors each DaemonSet template's ``nodeSelector`` the way
    the real DS controller does — a per-variant driver DS only gets
    pods (and desired-counts) on nodes of its variant."""
    node_names = list(node_names)
    node_objs = {
        n["metadata"]["name"]: n for n in client.list("v1", "Node")
    }
    node_labels = {
        name: n["metadata"].get("labels", {}) or {}
        for name, n in node_objs.items()
    }
    # DS-controller role first: delete operand pods bound to nodes that no
    # longer exist. A pod created in a race with its node's deletion
    # misses the apiserver's at-deletion cascade and would pin OnDelete
    # readiness NotReady forever; on a real cluster the DaemonSet
    # controller (and PodGC) clean exactly these.
    pods_by_name: dict = {}
    for pod in client.list("v1", "Pod", namespace):
        bound = pod.get("spec", {}).get("nodeName")
        app = (pod["metadata"].get("labels") or {}).get("app")
        if app and bound and bound not in node_labels:
            client.delete_if_exists(
                "v1", "Pod", pod["metadata"]["name"], namespace
            )
            continue
        # one listing serves the whole sweep's existence checks (the
        # per-pod re-GETs this replaces were the top request volume on
        # the fleet bench); a pod created/refreshed THIS sweep is keyed
        # uniquely, so the snapshot can't go stale against ourselves
        pods_by_name[pod["metadata"]["name"]] = pod
    lane = _kubelet_lane(client)
    futs = []
    halted = False
    # TFD/validator role inputs gathered during the DS sweep: which
    # driver version each node is effectively running (the version of
    # its operand pod's revision — a stale OnDelete pod keeps the OLD
    # version until the FSM restarts it), and its driver operand pod for
    # the bad-version crashloop flip
    driver_version_by_node: dict = {}
    driver_pod_by_node: dict = {}
    for ds in client.list("apps/v1", "DaemonSet", namespace):
        if halted:
            break
        selector = (
            ds["spec"]["template"]["spec"].get("nodeSelector", {}) or {}
        )
        # placement honors NoSchedule taints the way the real DS
        # controller does: a node quarantined with the repair taint only
        # gets pods from DaemonSets that tolerate it (operand templates
        # do — revalidation needs the plugin + validator running there)
        matching = [
            name
            for name in node_names
            if name in node_labels
            and all(node_labels[name].get(k) == v for k, v in selector.items())
            and tolerates_node_taints(
                ds["spec"]["template"]["spec"], node_objs[name]
            )
        ]
        _stamp_ds_status(client, ds, len(matching))
        on_delete = ds["spec"].get("updateStrategy", {}).get("type") == "OnDelete"
        app, h = _ds_app_and_hash(ds)
        driver_version = (
            _driver_ds_version(ds)
            if app.startswith(consts.DRIVER_APP)
            else ""
        )
        # per-node kubelets act in parallel, so the pod fan-out rides
        # the kubelet pipeline's BATCH LANE: writes that are actually
        # needed (missing pod, stale RollingUpdate hash) group-commit
        # into multi-object APPLY submissions — one wire request per
        # batch instead of one POST per pod, with per-item status
        # fan-back so one pod's failure stays its own. A pod the
        # pre-sweep listing already shows current costs NOTHING. The
        # whole sweep shares ONE drain barrier at the end: per-DS
        # drains would serialize DS k+1's fan-out behind DS k's
        # flushes and fragment the batches 18 ways.
        for node in matching:
            if halt_event is not None and halt_event.is_set():
                # a fleet-scale sweep takes a while; callers that halt
                # the kubelet (to measure a quiesced steady state) must
                # be able to abort MID-sweep, not just between sweeps —
                # the drain below keeps any in-flight write from
                # outliving the halt
                halted = True
                break
            pod_name = f"{app}-{node}"
            existing = pods_by_name.get(pod_name)
            if driver_version:
                at_current = (
                    existing is None
                    or existing["metadata"]
                    .get("annotations", {})
                    .get(consts.LAST_APPLIED_HASH_ANNOTATION)
                    == h
                )
                driver_pod_by_node[node] = existing
                driver_version_by_node[node] = (
                    driver_version
                    if at_current
                    else node_labels[node].get(
                        consts.DRIVER_VERSION_LABEL, ""
                    )
                )
            if existing is None:
                # create-only: a racing create of the same pod (stale
                # pre-sweep listing) answers AlreadyExists per-item,
                # tolerated below — the pod exists, which is the goal
                futs.append(
                    lane.submit(
                        ("Pod", namespace, pod_name),
                        (
                            _operand_pod_body(namespace, pod_name, app, h, node),
                            True,
                        ),
                    )
                )
            elif not on_delete and (
                existing["metadata"].get("annotations", {}).get(
                    consts.LAST_APPLIED_HASH_ANNOTATION
                )
                != h
            ):
                # RollingUpdate refresh: a forced apply rewrites the pod
                # at the current template hash (OnDelete pods are never
                # refreshed here — only deletion re-creates them)
                futs.append(
                    lane.submit(
                        ("Pod", namespace, pod_name),
                        (
                            _operand_pod_body(namespace, pod_name, app, h, node),
                            False,
                        ),
                    )
                )
    _kubelet_pipeline(client).drain()
    if halted:
        return  # quiescing: straggler errors are moot
    for fut in futs:
        try:
            fut.result()
        except ConflictError:
            pass  # create-only raced an existing pod: it exists
    # slice-manager daemon role: a node whose desired slice config label
    # changed (the live re-partition controller admitted it) gets the
    # layout "applied" and reports success — the per-node daemon's
    # contract (sliceman/slice_manager.py reconcile_once), one sweep
    # late so the roll holds its budget unit for at least one interval
    _simulate_slice_manager(client, node_labels)
    # TFD + node-status-exporter role: version labels, validator-perf
    # annotations (scaled by injected bad versions), crashloop flips —
    # write-on-change, so a converged fleet costs zero requests
    _simulate_node_agents(
        client, namespace, node_objs, driver_version_by_node,
        driver_pod_by_node,
    )


def _simulate_node_agents(
    client: Client,
    namespace: str,
    node_objs: dict,
    version_by_node: dict,
    driver_pod_by_node: dict,
) -> None:
    """TFD + node-status-exporter role for the sim fleet: publish each
    node's effective driver version as ``DRIVER_VERSION_LABEL`` and
    its validator perf readings (``perf_base``) as the ``validator-perf``
    annotation — scaled down by any ``inject_bad_version`` registration —
    and flip (or restore) CrashLoopBackOff on the driver operand of a
    crashlooping bad version. Only nodes whose driver DS carries an
    image TAG participate (a version-less spec stamps nothing), and
    every write is on-change only: a converged fleet costs zero
    requests. Applies ride an update-only batch lane so a node
    preempted mid-sweep 404s instead of being resurrected."""
    import json as _json

    from tpu_operator_torch.kube.client import ConflictError, NotFoundError

    lane = None
    futs = []
    for name, version in sorted(version_by_node.items()):
        if not version:
            continue
        node = node_objs.get(name)
        if node is None:
            continue
        labels = node["metadata"].get("labels", {}) or {}
        ann = node["metadata"].get("annotations", {}) or {}
        fault = _BAD_VERSIONS.get(version) or {}
        factor = float(fault.get("tflops_factor", 1.0))
        base_tflops, base_gbps = perf_base(labels)
        perf = _json.dumps(
            {
                "gbps": round(base_gbps * factor, 1),
                "tflops": round(base_tflops * factor, 1),
                "version": version,
            },
            sort_keys=True,
        )
        if (
            labels.get(consts.DRIVER_VERSION_LABEL) != version
            or ann.get(consts.VALIDATOR_PERF_ANNOTATION) != perf
        ):
            if lane is None:
                lane = _node_agent_lane(client)
            futs.append(
                lane.submit(
                    ("Node", "", name),
                    (
                        {
                            "apiVersion": "v1",
                            "kind": "Node",
                            "metadata": {
                                "name": name,
                                "labels": {
                                    consts.DRIVER_VERSION_LABEL: version
                                },
                                "annotations": {
                                    consts.VALIDATOR_PERF_ANNOTATION: perf
                                },
                            },
                        },
                        False,
                    ),
                )
            )
        # crashloop flip/restore on the node's driver operand pod (only
        # a pre-existing pod: one just created this sweep flips on the
        # NEXT sweep, like a real container needs a start to crash)
        pod = driver_pod_by_node.get(name)
        if pod is None:
            continue
        want_crash = bool(fault.get("crashloop"))
        is_crash = any(
            ((cs.get("state") or {}).get("waiting") or {}).get("reason")
            == "CrashLoopBackOff"
            for cs in pod.get("status", {}).get("containerStatuses") or []
        )
        if want_crash == is_crash:
            continue
        body = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod["metadata"]["name"],
                "namespace": namespace,
            },
            "status": (
                {
                    "phase": "Running",
                    "containerStatuses": [
                        {
                            "ready": False,
                            "state": {
                                "waiting": {"reason": "CrashLoopBackOff"}
                            },
                        }
                    ],
                }
                if want_crash
                else {
                    "phase": "Running",
                    "containerStatuses": [{"ready": True}],
                }
            ),
        }
        try:
            client.update_status(body)
        except (NotFoundError, ConflictError):
            continue  # pod churned mid-sweep; next sweep retries
    if futs:
        _kubelet_pipeline(client).drain()
        for fut in futs:
            try:
                fut.result()
            except (NotFoundError, ConflictError):
                pass  # preempted/contended mid-sweep: next sweep retries


def _simulate_slice_manager(client: Client, node_labels: dict) -> None:
    """Flip ``tpu.k8s.io/tpu.slice.config.state`` to ``success`` for
    nodes carrying a desired config whose state isn't success yet — the
    sim fleet's stand-in for the per-node slice-manager daemon (which in
    production pauses chip clients, partitions, and reports)."""
    from tpu_operator_torch.kube.client import NotFoundError
    from tpu_operator_torch.sliceman.slice_manager import STATE_SUCCESS

    for name, labels in node_labels.items():
        if not labels.get(consts.SLICE_CONFIG_LABEL):
            continue
        if labels.get(consts.SLICE_CONFIG_STATE_LABEL) == STATE_SUCCESS:
            continue
        try:
            client.patch_labels(
                "v1",
                "Node",
                name,
                labels={consts.SLICE_CONFIG_STATE_LABEL: STATE_SUCCESS},
            )
        except NotFoundError:
            continue  # preempted mid-sweep: normal lifecycle churn


def wait_for(what: str, pred, timeout_s: float = 60.0, poll_s: float = 0.2):
    """Poll ``pred`` until true or exit the process — the e2e scripts'
    shared readiness helper (one copy so timeout/reporting can't drift)."""
    import sys
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            print(f"ok: {what}")
            return
        time.sleep(poll_s)
    sys.exit(f"TIMEOUT waiting for {what}")


def make_validator_pod(node: str, ready: bool, namespace: str) -> Obj:
    """A validator operand pod as the slice-readiness aggregate sees it
    (app label + phase + container readiness) — shared by the e2e scripts
    so the pod shape can't drift between them."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"val-{node}",
            "namespace": namespace,
            "labels": {"app": consts.VALIDATOR_APP},
        },
        "spec": {"nodeName": node},
        "status": {
            "phase": "Running" if ready else "Pending",
            "containerStatuses": [{"ready": ready}],
        },
    }


def sample_clusterpolicy_path() -> str:
    """Path of the port's sample CR, ``api/v1/sample_clusterpolicy.yaml``
    (single resolution point)."""
    import os

    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "api",
        "v1",
        "sample_clusterpolicy.yaml",
    )


def seed_cluster(client, namespace: str, node_names=("fake-gpu-node-1",)) -> None:
    """Seed a kubesim/real cluster the way dev mode and the e2e fixtures
    need it: namespace, generated CRD, GPU node(s), sample CR — one
    helper so the dev loop and the tests cannot drift."""
    import yaml

    from tpu_operator_torch.cfg.crdgen import build_crd

    client.create(
        {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": namespace}}
    )
    client.create(build_crd())
    for name in node_names:
        client.create(make_gpu_node(name))
    with open(sample_clusterpolicy_path()) as f:
        client.create(yaml.safe_load(f))


def edit_clusterpolicy(client, fn, name="cluster-policy"):
    """Conflict-retried ClusterPolicy spec edit for tests racing a live
    operator: the annotation and status writers share the CR, so a raw
    get→update pair 409s under an active manager."""
    from tpu_operator_torch.kube.client import mutate_with_retry

    def mutate(cp):
        fn(cp)
        return True

    mutate_with_retry(
        client, consts.API_VERSION, consts.CLUSTER_POLICY_KIND, name, mutate=mutate
    )


def wait_until(pred, timeout_s: float = 60.0, poll_s: float = 0.1) -> bool:
    """Poll ``pred`` until true; False once ``timeout_s`` passed."""
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


@contextmanager
def running_operator(client, namespace: str, node_names, extra_threads=(), **manager_kw):
    """The full Manager wired exactly as ``main()`` ships it (both
    reconcilers, watch-fed queue), a faithful-OnDelete kubelet per node,
    and an upgrade-reconciler pump (production re-queues every 120 s,
    ``upgrade_controller.REQUEUE_S``; the same level-triggered loop at test
    cadence). ``extra_threads`` are ``fn(halt)`` loops joined to the same
    halt event; ``manager_kw`` go to ``build_manager`` (metrics and probe
    ports default to 0, none). Yields the manager; everything started
    here stops on exit."""
    import threading

    from tpu_operator_torch.kube.client import NotFoundError
    from tpu_operator_torch.kube.rest import TransientAPIError
    from tpu_operator_torch.main import UPGRADE_KEY, build_manager, wire_event_sources

    manager_kw.setdefault("metrics_port", 0)
    manager_kw.setdefault("probe_port", 0)
    mgr, _, _ = build_manager(client, namespace, **manager_kw)
    stop = threading.Event()
    halt = threading.Event()
    threads = []
    try:
        wire_event_sources(mgr, client, namespace, stop_event=stop)
        mgr.start()

        def kubelet():
            while not halt.is_set():
                try:
                    simulate_kubelet_nodes(client, namespace, node_names)
                except (ConflictError, NotFoundError, TransientAPIError, OSError):
                    pass  # races with the reconciler/FSM; retried next pass
                halt.wait(0.15)

        def pump():
            while not halt.is_set():
                mgr.enqueue(UPGRADE_KEY)
                halt.wait(0.25)

        for fn, args in [(kubelet, ()), (pump, ())] + [(fn, (halt,)) for fn in extra_threads]:
            t = threading.Thread(target=fn, args=args, daemon=True)
            t.start()
            threads.append(t)
        yield mgr
    finally:
        halt.set()
        stop.set()
        mgr.stop()
        for t in threads:
            t.join(timeout=10)
