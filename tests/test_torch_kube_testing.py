"""The port's simulated fleet (``kube/testing.py``) against the JAX
package's: the kubelet simulators, the node agents' role, bad versions,
the slice manager's role and the cluster seeding.

One DaemonSet script drives both sides' ``simulate_kubelet_nodes`` over
each side's ``FakeClient``: a driver DaemonSet with OnDelete updates, an
image tag and a ``nodeSelector``, a RollingUpdate DaemonSet, one that
tolerates a NoSchedule taint, then a template change, a node deleted
under its pods, a bad version with a crashloop and its clearing, and a
node given a slice layout. The reference's objects reach the port through
``convert.object_from_reference`` (operand ``app`` labels through
``OPERAND_APPS``, ``libtpu``'s version label as the driver's); the log of
pods, hashes, DaemonSet statuses, version labels and crashloop states
the port writes, mapped back with ``operand_app_to_reference``, must
equal the reference's exactly. The validator readings are the one
difference by design: the port publishes the card variant's datasheet
rates, the reference its own chip's, so the log holds each reading over
its side's healthy rate, which a bad version scales the same on both
sides. Both ``_BAD_VERSIONS`` registries are cleared in a ``finally``."""

import json
import os
from types import SimpleNamespace

import pytest
import yaml

from tpu_operator import consts as ref_consts
from tpu_operator.kube import client as ref_client
from tpu_operator.kube import testing as ref_testing
from tpu_operator_torch import consts, convert
from tpu_operator_torch.cfg import crdgen
from tpu_operator_torch.kube import client, kubesim, testing
from tpu_operator_torch.workloads import topology as topo

NS = "tpu-operator"
TAINT = {"key": "example.com/repair", "value": "pending", "effect": "NoSchedule"}
SIDES = {
    "reference": SimpleNamespace(consts=ref_consts, client=ref_client, testing=ref_testing, obj=lambda o: o, back=lambda s: s,
                                 base=lambda labels: (ref_testing.PERF_BASE_TFLOPS, ref_testing.PERF_BASE_GBPS)),
    "port": SimpleNamespace(consts=consts, client=client, testing=testing, obj=convert.object_from_reference, back=convert.operand_app_to_reference,
                            base=testing.perf_base),
}


def ds(app, strategy, h, image=None, selector=None, tolerations=None):
    spec = {"nodeSelector": selector or {}, "containers": [{"name": "c", "image": image or "registry/x"}]}
    if tolerations is not None:
        spec["tolerations"] = tolerations
    return {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": app, "namespace": NS},
            "spec": {"selector": {"matchLabels": {"app": app}}, "updateStrategy": {"type": strategy},
                     "template": {"metadata": {"labels": {"app": app},
                                               "annotations": {ref_consts.LAST_APPLIED_HASH_ANNOTATION: h}},
                                  "spec": spec}}}


def snapshot(side, c):
    version_label = side.consts.DRIVER_VERSION_LABEL if side is SIDES["port"] else ref_consts.TFD_LIBTPU_VERSION_LABEL
    pods = []
    for p in c.list("v1", "Pod", NS):
        statuses = p.get("status", {}).get("containerStatuses") or [{}]
        waiting = ((statuses[0].get("state") or {}).get("waiting") or {}).get("reason")
        pods.append((side.back(p["metadata"]["name"]), side.back(p["metadata"]["labels"]["app"]),
                     p["metadata"]["annotations"].get(side.consts.LAST_APPLIED_HASH_ANNOTATION), p["spec"]["nodeName"],
                     p["status"]["phase"], waiting))
    statuses = {side.back(d["metadata"]["name"]): d.get("status") for d in c.list("apps/v1", "DaemonSet", NS)}
    nodes = {}
    for n in c.list("v1", "Node"):
        labels = n["metadata"].get("labels", {}) or {}
        perf = (n["metadata"].get("annotations") or {}).get(side.consts.VALIDATOR_PERF_ANNOTATION)
        if perf:
            perf = json.loads(perf)
            tflops, gbps = side.base(labels)
            perf = (perf["version"], round(perf["tflops"] / tflops, 6), round(perf["gbps"] / gbps, 6))
        nodes[n["metadata"]["name"]] = (labels.get(version_label), perf,
                                        labels.get(side.consts.SLICE_CONFIG_STATE_LABEL))
    return [sorted(pods), statuses, nodes]


def fleet_script(side):
    t = side.testing
    c = side.client.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}]
                               + [side.obj(ref_testing.make_tpu_node(f"n{i}", extra_labels={"pool": "a" if i < 3 else "b"}))
                                  for i in range(5)])
    side.client.set_node_taint(c, "n2", TAINT["key"], TAINT["value"])
    for obj in (ds("tpu-libtpu-daemonset", "OnDelete", "h1", image="registry/libtpu:1.2.3", selector={"pool": "a"}),
                ds("tpu-device-plugin-daemonset", "RollingUpdate", "h1"),
                ds("tpu-operator-validator", "OnDelete", "h1",
                   tolerations=[{"key": TAINT["key"], "operator": "Exists", "effect": "NoSchedule"}])):
        c.create(side.obj(obj))
    names = [f"n{i}" for i in range(5)]
    log = []
    try:
        t.simulate_kubelet_nodes(c, NS, names)
        log.append(snapshot(side, c))
        for d in c.list("apps/v1", "DaemonSet", NS):  # a template change
            d = c.get("apps/v1", "DaemonSet", d["metadata"]["name"], NS)
            d["spec"]["template"]["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION] = "h2"
            c.update(d)
        t.simulate_kubelet_nodes(c, NS, names)
        log.append(snapshot(side, c))
        c.delete("v1", "Node", "n4")  # its pods are orphans now
        c.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "other-n4", "namespace": NS,
                                                                  "labels": {"app": "x"}},
                  "spec": {"nodeName": "n4"}, "status": {"phase": "Running"}})
        t.simulate_kubelet_nodes(c, NS, names[:4])
        log.append(snapshot(side, c))
        t.inject_bad_version("1.2.3", tflops_factor=0.5, crashloop=True)
        t.simulate_kubelet_nodes(c, NS, names[:4])
        t.simulate_kubelet_nodes(c, NS, names[:4])
        log.append(snapshot(side, c))
        t.clear_bad_versions()
        t.simulate_kubelet_nodes(c, NS, names[:4])
        log.append(snapshot(side, c))
        c.patch_labels("v1", "Node", "n1", labels={side.consts.SLICE_CONFIG_LABEL: "all-1"})
        t.simulate_kubelet_nodes(c, NS, names[:4])
        log.append(snapshot(side, c))
    finally:
        t.clear_bad_versions()
    return log


def test_fleet_simulator_matches_reference():
    ref = fleet_script(SIDES["reference"])
    port = fleet_script(SIDES["port"])
    assert len(port) == len(ref) == 6
    for step, (r, p) in enumerate(zip(ref, port)):
        assert p == r, step
    first, changed, orphaned, bad, cleared, sliced = ref
    driver = [p for p in first[0] if p[1] == "tpu-libtpu-daemonset"]
    assert [p[3] for p in driver] == ["n0", "n1"] and {p[2] for p in driver} == {"h1"}  # pool a, untainted
    validator = [p[3] for p in first[0] if p[1] == "tpu-operator-validator"]
    plugin = [p[3] for p in first[0] if p[1] == "tpu-device-plugin-daemonset"]
    assert validator == ["n0", "n1", "n2", "n3", "n4"] and plugin == ["n0", "n1", "n3", "n4"]  # n2 is tainted
    assert first[1]["tpu-libtpu-daemonset"]["desiredNumberScheduled"] == 2  # n2's taint is not tolerated
    assert {p[2] for p in changed[0] if p[1] == "tpu-libtpu-daemonset"} == {"h1"}  # OnDelete: left alone
    assert {p[2] for p in changed[0] if p[1] == "tpu-device-plugin-daemonset"} == {"h2"}  # RollingUpdate: rolled
    assert not [p for p in orphaned[0] if p[3] == "n4" and p[1] != "x"]
    assert first[2]["n0"][1] == ("1.2.3", 1.0, 1.0) and bad[2]["n0"][1] == ("1.2.3", 0.5, 0.5)
    assert {p[5] for p in bad[0] if p[1] == "tpu-libtpu-daemonset"} == {"CrashLoopBackOff"}
    assert {p[5] for p in cleared[0]} == {None} and cleared[2]["n0"][1] == ("1.2.3", 1.0, 1.0)
    assert sliced[2]["n1"][2] == "success" and sliced[2]["n0"][2] is None


def test_perf_readings_are_the_cards_datasheet_rates():
    c = client.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                           testing.make_gpu_node("sxm"),
                           testing.make_gpu_node("pcie", variant="h100-pcie", product="NVIDIA-H100-PCIe")])
    c.create(convert.object_from_reference(ds("tpu-libtpu-daemonset", "OnDelete", "h1", image="r/driver:550.1")))
    testing.simulate_kubelet_nodes(c, NS, ["sxm", "pcie"])
    perf = {n["metadata"]["name"]: json.loads(n["metadata"]["annotations"][consts.VALIDATOR_PERF_ANNOTATION])
            for n in c.list("v1", "Node")}
    assert perf["sxm"] == {"gbps": topo.PEAK_HBM_GBPS["h100-sxm"], "tflops": topo.PEAK_BF16_TFLOPS["h100-sxm"],
                           "version": "550.1"}
    assert perf["pcie"]["tflops"] == topo.PEAK_BF16_TFLOPS["h100-pcie"]
    assert testing.perf_base({}) == (topo.PEAK_BF16_TFLOPS["h100-sxm"], topo.PEAK_HBM_GBPS["h100-sxm"])
    assert {n["metadata"]["labels"][consts.DRIVER_VERSION_LABEL] for n in c.list("v1", "Node")} == {"550.1"}


def once_script(side):
    c = side.client.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}])
    for obj in (ds("tpu-libtpu-daemonset", "OnDelete", "h1"), ds("tpu-metricsd", "RollingUpdate", "h1")):
        c.create(side.obj(obj))
    side.testing.simulate_kubelet_once(c, NS, node_name="node-1", pods_per_ds=2)
    out = [snapshot(side, c)]
    d = c.get("apps/v1", "DaemonSet", c.list("apps/v1", "DaemonSet", NS)[0]["metadata"]["name"], NS)
    d["spec"]["template"]["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION] = "h2"
    c.update(d)
    side.testing.simulate_kubelet_once(c, NS, node_name="node-1", pods_per_ds=2)
    out.append(snapshot(side, c))
    return out


def test_simulate_kubelet_once_matches_reference():
    ref = once_script(SIDES["reference"])
    assert once_script(SIDES["port"]) == ref
    assert [p[0] for p in ref[0][0]] == ["tpu-libtpu-daemonset-0", "tpu-libtpu-daemonset-1"]
    assert {p[2] for p in ref[1][0]} == {"h2"}  # the one-node helper refreshes OnDelete pods too
    assert {p[3] for p in ref[0][0]} == {"node-1"}
    port_once = client.FakeClient([])
    port_once.create(convert.object_from_reference(ds("tpu-libtpu-daemonset", "OnDelete", "h1")))
    testing.simulate_kubelet_once(port_once, NS)
    assert [p["spec"]["nodeName"] for p in port_once.list("v1", "Pod", NS)] == ["fake-gpu-node-1"]


@pytest.mark.parametrize("tol,want", [
    ({"operator": "Exists"}, True),
    ({"key": TAINT["key"], "operator": "Exists"}, True),
    ({"key": TAINT["key"], "operator": "Equal", "value": "pending"}, True),
    ({"key": TAINT["key"], "value": "pending"}, True),
    ({"key": TAINT["key"], "operator": "Equal", "value": "x"}, False),
    ({"key": "other", "operator": "Exists"}, False),
    ({"key": TAINT["key"], "operator": "Exists", "effect": "NoExecute"}, False),
    ({"operator": "Equal", "value": "x"}, False),
])
def test_toleration_matches_reference(tol, want):
    assert testing.toleration_matches(tol, TAINT) == ref_testing.toleration_matches(tol, TAINT) == want
    node = {"spec": {"taints": [TAINT, {"key": "soft", "effect": "PreferNoSchedule"}]}}
    spec = {"tolerations": [tol]}
    assert testing.tolerates_node_taints(spec, node) == ref_testing.tolerates_node_taints(spec, node) == want
    assert testing.tolerates_node_taints({}, {"spec": {}}) is True


def test_helpers_match_reference():
    for ready in (True, False):
        pod = testing.make_validator_pod("n1", ready, NS)
        ref_pod = ref_testing.make_validator_pod("n1", ready, NS)
        assert convert.pod_to_reference(pod) == ref_pod
        assert pod["metadata"]["labels"]["app"] == consts.VALIDATOR_APP == "gpu-operator-validator"
    assert testing.KUBELET_SIM_FIELD_MANAGER == ref_testing.KUBELET_SIM_FIELD_MANAGER
    assert testing._version_of_image("r/x:1.2") == ref_testing._version_of_image("r/x:1.2") == "1.2"
    for image in ("r/x@sha256:ab", "r/x", "host:5000/x", ""):
        assert testing._version_of_image(image) == ref_testing._version_of_image(image) == ""
    with pytest.raises(SystemExit):
        testing.wait_for("never", lambda: False, timeout_s=0.05, poll_s=0.01)
    testing.wait_for("now", lambda: True, timeout_s=1)


def test_operand_apps_table():
    assert consts.OPERAND_APPS["tpu-libtpu-daemonset"] == consts.DRIVER_APP == "gpu-driver-daemonset"
    assert consts.OPERAND_APPS["tpu-runtime-daemonset"] == "gpu-toolkit-daemonset"
    assert consts.OPERAND_APPS["tpu-feature-discovery"] == "gpu-feature-discovery"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    apps = set()
    for root, _, files in os.walk(os.path.join(repo, "assets")):
        for f in files:
            with open(os.path.join(root, f)) as fh:
                for doc in yaml.safe_load_all(fh):
                    if doc and doc.get("kind") == "DaemonSet":
                        apps.add(doc["spec"]["selector"]["matchLabels"]["app"])
    assert set(consts.OPERAND_APPS) == apps
    for old, new in consts.OPERAND_APPS.items():
        assert new == old.replace("tpu-", "gpu-", 1).replace("libtpu", "driver").replace("runtime", "toolkit")
        assert convert.operand_app_to_reference(convert.operand_app_from_reference(old + "-v5e")) == old + "-v5e"
    assert convert.operand_app_from_reference("tpu-operator") == "tpu-operator"


def test_seed_cluster_and_edit(tmp_path):
    c = client.FakeClient()
    testing.seed_cluster(c, NS)
    assert [n["metadata"]["name"] for n in c.list("v1", "Node")] == ["fake-gpu-node-1"]
    crd = c.get("apiextensions.k8s.io/v1", "CustomResourceDefinition", consts.CRD_NAME)
    assert crd["spec"] == crdgen.build_crd()["spec"]
    with open(testing.sample_clusterpolicy_path()) as f:
        sample = yaml.safe_load(f)
    assert testing.sample_clusterpolicy_path().endswith(os.path.join("tpu_operator_torch", "api", "v1",
                                                                     "sample_clusterpolicy.yaml"))
    cp = c.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")
    assert cp["spec"] == sample["spec"]
    ref = ref_client.FakeClient()
    ref_testing.seed_cluster(ref, NS)
    ref_cp = ref.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")
    assert convert.clusterpolicy_from_reference(ref_cp)["spec"] == cp["spec"]
    assert [o["kind"] for o in c.list("v1", "Namespace")] == ["Namespace"]
    testing.edit_clusterpolicy(c, lambda o: o["spec"]["operator"].__setitem__("runtimeClass", "edited"))
    assert c.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")["spec"]["operator"][
        "runtimeClass"] == "edited"

    server = kubesim.KubeSimServer(port=0).start()
    try:
        rc = kubesim.make_client(server.port)
        testing.seed_cluster(rc, NS, node_names=("a", "b"))
        assert [n["metadata"]["name"] for n in rc.list("v1", "Node")] == ["a", "b"]
        assert rc.get(consts.API_VERSION, consts.CLUSTER_POLICY_KIND, "cluster-policy")["spec"]["driver"]
    finally:
        server.stop()
