"""Real-apiserver-wire end-to-end: the operator against KubeSim over HTTP.

The port's copy of ``tests/scripts/http_e2e.py``: everything the
fake-client e2e proves, re-proven through the production ``RestClient``
against a server that enforces apiserver behaviour — CRD schema
admission, status subresource isolation, resourceVersion conflicts,
ownerRef GC, and watch/re-list. Sequence:

  install (CRD + nodes + CR, malformed CR rejected at admission)
  → converge to Ready (status written via the /status subresource)
  → stale-write conflict (409 surfaced through the real wire)
  → disable/enable operand
  → rolling driver upgrade FSM across 3 nodes (cordon → drain/evict via
    the eviction subresource → validate → uncordon → done)
  → multi-host slice aggregate (degraded → ready)
  → sandbox posture (vm-passthrough node labelling)
  → node churn (the 45 s NFD posture, then recovery)
  → ``gpu-maintenance-handler`` window over the wire
  → uninstall (delete CR → SERVER-side ownerRef GC removes operands,
    proving the operator set its ownerReferences correctly)

Every assertion is the reference's, at the port's names: GPU nodes from
``kube.testing.make_gpu_node``, operand DaemonSets by
``consts.OPERAND_APPS``, the driver's upgrade policy under
``spec.driver``, workloads asking for ``nvidia.com/gpu``. The driver step
also holds that the roll recorded each node's ``DRIVER_VERSION_LABEL`` as
its rollback target and left ``spec.driver.version`` as it was.

Run: ``python -m tpu_operator_torch.e2e.http_e2e`` (exit 0 and
``HTTP-E2E PASSED``); ``OPERATOR_NAMESPACE`` defaults to the operator's
namespace and ``UNIT_TEST`` to ``true``. It needs no card.
"""

from __future__ import annotations

import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

CP = "tpu.k8s.io/v1"


def main() -> int:
    import yaml

    from tpu_operator_torch import consts

    os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    os.environ.setdefault("UNIT_TEST", "true")
    ns = os.environ[consts.OPERATOR_NAMESPACE_ENV]

    from tpu_operator_torch.cfg.crdgen import build_crd
    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler,
    )
    from tpu_operator_torch.kube.client import ConflictError
    from tpu_operator_torch.kube.kubesim import KubeSim, KubeSimServer, make_client
    from tpu_operator_torch.kube.testing import (
        make_gpu_node,
        make_validator_pod,
        sample_clusterpolicy_path,
        simulate_kubelet_once,
        wait_for,
    )
    from tpu_operator_torch.operands.maintenance import MaintenanceHandler
    from tpu_operator_torch.upgrade.upgrade_controller import UpgradeReconciler

    exporter_ds = consts.OPERAND_APPS["tpu-metrics-exporter"]
    vm_manager_ds = consts.OPERAND_APPS["tpu-vm-manager-daemonset"]
    handler_ds = consts.OPERAND_APPS["tpu-maintenance-handler"]

    server = KubeSimServer(KubeSim()).start()
    try:
        client = make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05

        print(f"=== kubesim up on 127.0.0.1:{server.port}")

        print("=== install (namespace + CRD + nodes + ClusterPolicy)")
        client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": ns}})
        client.create(build_crd())
        nodes = [f"gpu-node-{i}" for i in (1, 2, 3)]
        for n in nodes:
            client.create(make_gpu_node(n))

        # a malformed CR must die at ADMISSION — the schema-rejection
        # class of bug the fake client could never catch
        try:
            client.create(
                {
                    "apiVersion": CP,
                    "kind": "ClusterPolicy",
                    "metadata": {"name": "bad"},
                    "spec": {"daemonsets": {"updateStrategy": "Recreate"}},
                }
            )
            raise SystemExit("malformed CR was ADMITTED — schema not enforced")
        except RuntimeError as e:
            assert "422" in str(e), e
            print("ok: malformed CR rejected at admission (422)")

        with open(sample_clusterpolicy_path()) as f:
            cr = yaml.safe_load(f)
        client.create(cr)
        driver_version = cr["spec"]["driver"]["version"]

        print("=== converge to Ready over the wire")
        reconciler = ClusterPolicyReconciler(client)

        def converge(max_rounds=40):
            res = None
            for _ in range(max_rounds):
                res = reconciler.reconcile()
                # one simulated-kubelet pass per round keeps the operand
                # pods alive (one node is enough for DS readiness; the
                # upgrade step plays the per-node pods itself)
                simulate_kubelet_once(client, ns, node_name=nodes[0])
                if res.ready:
                    return res
            dump_not_ready()
            return res

        def dump_not_ready():
            """Which state/control holds NotReady: the CR's status and
            conditions as the failed reconcile wrote them, then each
            loaded control re-run once (idempotent, though the re-run
            re-applies manifests, so the walk is evidence about
            readiness, not a snapshot of the failed pass)."""
            from tpu_operator_torch.api.v1.clusterpolicy_types import State
            from tpu_operator_torch.controllers import object_controls

            cp_now = client.get_or_none(CP, "ClusterPolicy", "cluster-policy")
            status_now = (cp_now or {}).get("status", {})
            print(f"    CR status: state={status_now.get('state')!r}")
            for cond in status_now.get("conditions") or []:
                print(
                    f"    condition: type={cond.get('type')} "
                    f"status={cond.get('status')} reason={cond.get('reason')} "
                    f"message={cond.get('message')!r}"
                )
            ctrl = reconciler.ctrl
            found = False
            for state, controls in ctrl.controls.items():
                for control_name, obj in controls:
                    status = object_controls.CONTROLS[control_name](ctrl, state, obj)
                    if status == State.NOT_READY:
                        print(
                            f"    NOT READY: {state} {control_name} "
                            f"{obj.get('metadata', {}).get('name')}"
                        )
                        found = True
            if not found:
                print("    (every control reports ready when re-run — the "
                      "reconcile loop failed before/around the control walk; "
                      "see the CR status/conditions above for the early-return "
                      "cause, or it was a converge-round race)")

        res = converge()
        assert res is not None and res.ready, f"never converged: {res}"
        cp = client.get(CP, "ClusterPolicy", "cluster-policy")
        assert cp["status"]["state"] == "ready", cp.get("status")
        assert cp["metadata"].get("generation") == 1
        print("ok: CR Ready; status written via the /status subresource")

        print("=== optimistic-concurrency (stale writer gets 409)")
        a = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        b = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        a["spec"]["metricsExporter"]["enabled"] = True
        client.update(a)
        b["spec"]["metricsExporter"]["enabled"] = False
        try:
            client.update(b)
            raise SystemExit("stale update was accepted — no conflict detection")
        except ConflictError:
            print("ok: stale ClusterPolicy update conflicted (409)")

        print("=== disable/enable operand")
        cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        cp["spec"]["metricsExporter"]["enabled"] = False
        client.update(cp)
        converge()
        ds_names = {d["metadata"]["name"] for d in client.list("apps/v1", "DaemonSet", ns)}
        assert exporter_ds not in ds_names, sorted(ds_names)
        cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        cp["spec"]["metricsExporter"]["enabled"] = True
        client.update(cp)
        res = converge()
        assert res.ready
        print("ok: operand disable/enable")

        print("=== rolling driver upgrade FSM on 3 nodes")
        _driver_upgrade(client, ns, nodes, UpgradeReconciler)
        cp = client.get(CP, "ClusterPolicy", "cluster-policy")
        assert cp["spec"]["driver"]["version"] == driver_version, cp["spec"]["driver"]
        print("ok: 3-node rolling upgrade (cordon → evict → validate → uncordon)")

        print("=== multi-host slice readiness (all-hosts-or-nothing aggregate)")
        for i in range(2):
            client.create(
                make_gpu_node(
                    f"vp-host-{i}",
                    extra_labels={
                        consts.GKE_NODEPOOL_LABEL: "vp-pool",
                        consts.TFD_SLICE_HOSTS_LABEL: "2",
                        consts.TFD_WORKER_ID_LABEL: str(i),
                    },
                )
            )

        def slice_validator(node, ready):
            if client.get_or_none("v1", "Pod", f"val-{node}", ns) is not None:
                client.delete("v1", "Pod", f"val-{node}", ns)
            client.create(make_validator_pod(node, ready, ns))

        slice_validator("vp-host-0", True)
        slice_validator("vp-host-1", False)  # one host lags: slice degraded
        converge()
        cp = client.get(CP, "ClusterPolicy", "cluster-policy")
        slices = cp["status"].get("slices", {})
        assert "vp-pool" in slices.get("degraded", []), slices
        n0 = client.get("v1", "Node", "vp-host-0")
        # not-ready shows as label ABSENCE on a never-ready slice ("false"
        # is only written on a real true→false flip; the scheduler gate
        # selects on "true" either way)
        assert n0["metadata"]["labels"].get(consts.SLICE_READY_LABEL) != "true", (
            "a slice with a lagging host must not be ready on ANY member"
        )
        slice_validator("vp-host-1", True)  # last host validates → slice flips
        converge()
        cp = client.get(CP, "ClusterPolicy", "cluster-policy")
        assert "vp-pool" not in cp["status"]["slices"].get("degraded", [])
        for i in range(2):
            node = client.get("v1", "Node", f"vp-host-{i}")
            assert node["metadata"]["labels"][consts.SLICE_READY_LABEL] == "true"
        print("ok: slice aggregate degraded → ready over the wire")

        print("=== sandbox workloads (vm-passthrough posture over the wire)")
        cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        cp["spec"]["sandboxWorkloads"] = {"enabled": True}
        client.update(cp)
        client.create(
            make_gpu_node(
                "vm-host-1",
                extra_labels={consts.WORKLOAD_CONFIG_LABEL: consts.WORKLOAD_VM_PASSTHROUGH},
            )
        )
        res = converge()
        assert res is not None and res.ready, f"sandbox enable broke readiness: {res}"
        ds_names = {d["metadata"]["name"] for d in client.list("apps/v1", "DaemonSet", ns)}
        assert vm_manager_ds in ds_names, sorted(ds_names)
        vm_labels = client.get("v1", "Node", "vm-host-1")["metadata"]["labels"]
        assert (
            vm_labels.get(consts.DEPLOY_LABEL_PREFIX + consts.COMPONENT_VM_MANAGER) == "true"
        ), {k: v for k, v in vm_labels.items() if "deploy" in k}
        # container components must NOT deploy to the vm-passthrough node
        assert vm_labels.get(consts.DEPLOY_LABEL_PREFIX + consts.COMPONENT_DRIVER) != "true"
        cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        cp["spec"]["sandboxWorkloads"] = {"enabled": False}
        client.update(cp)
        client.delete("v1", "Node", "vm-host-1")
        res = converge()
        assert res is not None and res.ready
        print("ok: sandbox enable/disable with vm-passthrough node labeling")

        print("=== node churn (last GPU node gone → 45s NFD posture → recovery)")
        for n in nodes + [f"vp-host-{i}" for i in range(2)]:
            client.delete("v1", "Node", n)
        res = reconciler.reconcile()
        # reference semantics (clusterpolicy_controller.go:169-182): with
        # no NFD-labelled node left the CR drops to notReady, polls at 45s
        assert not res.ready and res.requeue_after == 45.0, res
        client.create(make_gpu_node(nodes[0]))
        res = converge()
        assert res is not None and res.ready, f"no recovery on node arrival: {res}"
        print("ok: node departure/arrival posture over the wire")

        print("=== host-maintenance handler (metadata window over the wire)")
        # enable the opt-in state; the DS must appear and the node get its
        # deploy label
        cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
        cp["spec"]["maintenanceHandler"] = {
            "enabled": True,
            "repository": "gcr.io/tpu-operator",
            "image": "gpu-operator",
            "version": "0.9.0",
        }
        client.update(cp)
        converge()
        ds_names = {d["metadata"]["name"] for d in client.list("apps/v1", "DaemonSet", ns)}
        assert handler_ds in ds_names, sorted(ds_names)
        mh_labels = client.get("v1", "Node", nodes[0])["metadata"]["labels"]
        assert (
            mh_labels.get(consts.DEPLOY_LABEL_PREFIX + consts.COMPONENT_MAINTENANCE_HANDLER)
            == "true"
        )
        _maintenance_window(client, nodes[0], MaintenanceHandler)
        # readiness unharmed by the excursion
        res = converge()
        assert res is not None and res.ready, f"maintenance flow broke readiness: {res}"
        print("ok: maintenance window → cordon+evict → outage held → restored")

        print("=== uninstall (CR delete → SERVER-side ownerRef GC)")
        client.delete(CP, "ClusterPolicy", "cluster-policy")
        wait_for(
            "server-side operand GC",
            lambda: not client.list("apps/v1", "DaemonSet", ns),
            timeout_s=10,
        )
    finally:
        server.stop()
    print("HTTP-E2E PASSED")
    return 0


def _driver_upgrade(client, ns, nodes, upgrade_reconciler) -> None:
    """The rolling driver upgrade on ``nodes``: stale driver pods on each,
    a GPU workload to evict on the second, the FSM driven to done while
    this function plays the DaemonSet controller."""
    from tpu_operator_torch import consts

    driver_ds = next(
        d
        for d in client.list("apps/v1", "DaemonSet", ns)
        if d["spec"]["selector"]["matchLabels"].get("app", "").startswith(consts.DRIVER_APP)
    )
    app = driver_ds["spec"]["selector"]["matchLabels"]["app"]
    desired_hash = driver_ds["spec"]["template"]["metadata"]["annotations"][
        consts.LAST_APPLIED_HASH_ANNOTATION
    ]

    def driver_pod(node, h):
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"driver-{node}",
                "namespace": ns,
                "labels": {"app": app},
                "annotations": {consts.LAST_APPLIED_HASH_ANNOTATION: h},
            },
            "spec": {"nodeName": node},
            "status": {"phase": "Running"},
        }

    def validator_pod(node):
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"validator-{node}",
                "namespace": ns,
                "labels": {"app": consts.VALIDATOR_APP},
            },
            "spec": {"nodeName": node},
            "status": {"phase": "Running"},
        }

    # clear the converge step's kubelet-simulator driver pods: this step
    # plays the per-node kubelet itself with stale revisions
    for pod in client.list("v1", "Pod", ns, label_selector={"app": app}):
        client.delete("v1", "Pod", pod["metadata"]["name"], ns)
    versions = {}
    for n in nodes:
        labels = client.get("v1", "Node", n)["metadata"]["labels"]
        assert (
            labels.get(consts.DEPLOY_LABEL_PREFIX + consts.COMPONENT_DRIVER) == "true"
        ), f"{n} missing driver deploy label"
        versions[n] = labels[consts.DRIVER_VERSION_LABEL]
        client.create(driver_pod(n, "stale-hash"))
        client.create(validator_pod(n))
    client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "default"}})
    client.create(
        {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": "train-1",
                "namespace": "default",
                "ownerReferences": [{"kind": "Job", "name": "t", "uid": "j1"}],
            },
            "spec": {
                "nodeName": nodes[1],
                "containers": [
                    {"name": "train", "resources": {"limits": {consts.GPU_RESOURCE: "4"}}}
                ],
            },
            "status": {"phase": "Running"},
        }
    )

    cp = client.get(CP, "ClusterPolicy", "cluster-policy", copy=True)
    cp["spec"].setdefault("driver", {})["upgradePolicy"] = {
        "autoUpgrade": True,
        "maxParallelUpgrades": 1,
        "maxUnavailable": "34%",
        "drain": {"enable": True, "timeoutSeconds": 30},
    }
    client.update(cp)

    upgrader = upgrade_reconciler(client, ns)
    states = {}
    for _ in range(40):
        upgrader.reconcile()
        # the DaemonSet controller's role: recreate evicted/deleted driver
        # pods at the NEW revision; the validator DS follows
        for n in nodes:
            if client.get_or_none("v1", "Pod", f"driver-{n}", ns) is None:
                client.create(driver_pod(n, desired_hash))
            if client.get_or_none("v1", "Pod", f"validator-{n}", ns) is None:
                client.create(validator_pod(n))
        states = {
            n: client.get("v1", "Node", n)["metadata"]["labels"].get(consts.UPGRADE_STATE_LABEL)
            for n in nodes
        }
        if all(s == consts.UPGRADE_STATE_DONE for s in states.values()):
            break
    else:
        raise SystemExit(f"upgrade FSM never completed: {states}")
    for n in nodes:
        node = client.get("v1", "Node", n)
        assert not node.get("spec", {}).get("unschedulable", False), f"{n} cordoned"
        # the rollback target the FSM recorded at admission is the
        # version feature discovery published for the node
        recorded = node["metadata"]["annotations"].get(consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION)
        assert recorded == versions[n], (n, recorded, versions[n])
    assert client.get_or_none("v1", "Pod", "train-1", "default") is None, (
        "workload survived the drain — eviction subresource not exercised"
    )
    # retire this step's hand-played per-node kubelet pods: later spec
    # changes re-hash the DS template, and outside this loop nothing
    # plays the DS controller recreating them at the new revision
    for n in nodes:
        client.delete_if_exists("v1", "Pod", f"driver-{n}", ns)
        client.delete_if_exists("v1", "Pod", f"validator-{n}", ns)


def _maintenance_window(client, node_name, handler_cls) -> None:
    """Drive the node agent against a REAL metadata stub: window → cordon
    + label + evict; outage → state held; all-clear → restore."""
    from tpu_operator_torch import consts

    meta_state = {"event": "NONE", "dead": False}

    class MetaStub(BaseHTTPRequestHandler):
        def do_GET(self):
            if meta_state["dead"]:
                self.send_response(500)
                self.end_headers()
                return
            assert self.headers.get("Metadata-Flavor") == "Google"
            body = meta_state["event"].encode()
            self.send_response(200)
            # real GCE responses carry the flavour marker; the handler
            # rejects responses without it
            self.send_header("Metadata-Flavor", "Google")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    meta_srv = ThreadingHTTPServer(("127.0.0.1", 0), MetaStub)
    threading.Thread(target=meta_srv.serve_forever, daemon=True).start()
    try:
        client.create(
            {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": "mh-train",
                    "namespace": "default",
                    "ownerReferences": [
                        {"apiVersion": "batch/v1", "kind": "Job", "name": "j", "uid": "mh-u"}
                    ],
                },
                "spec": {
                    "nodeName": node_name,
                    "containers": [
                        {"name": "t", "resources": {"limits": {consts.GPU_RESOURCE: "4"}}}
                    ],
                },
                "status": {"phase": "Running"},
            }
        )
        mh = handler_cls(
            client,
            node_name,
            metadata_url=f"http://127.0.0.1:{meta_srv.server_port}/maintenance-event",
        )
        meta_state["event"] = "TERMINATE_ON_HOST_MAINTENANCE"
        mh.reconcile_once()
        n = client.get("v1", "Node", node_name)
        assert n["spec"]["unschedulable"] is True
        assert n["metadata"]["labels"][consts.MAINTENANCE_STATE_LABEL] == "pending"
        assert client.get_or_none("v1", "Pod", "mh-train", "default") is None
        meta_state["dead"] = True  # metadata outage mid-window: hold state
        mh.reconcile_once()
        assert client.get("v1", "Node", node_name)["spec"]["unschedulable"] is True
        meta_state["dead"] = False
        meta_state["event"] = "NONE"
        mh.reconcile_once()
        n = client.get("v1", "Node", node_name)
        assert not n["spec"].get("unschedulable", False)
        assert consts.MAINTENANCE_STATE_LABEL not in n["metadata"]["labels"]
    finally:
        meta_srv.shutdown()
        meta_srv.server_close()


if __name__ == "__main__":
    sys.exit(main())
