"""The port's operator process driving the rolling driver upgrade over the
wire, and its dev loop's gRPC kubelet, against the JAX package's:
``tests/test_upgrade_kubesim.py``'s ``test_rolling_upgrade_three_nodes_over_the_wire``
and ``test_operator_restart_mid_upgrade_resumes_fsm``, and
``tests/test_kubelet_plugin_loop.py::test_dev_loop_grpc_kubelet_wiring``.

Each case runs one script on both packages, each side on its own KubeSim
seeded by its own ``seed_cluster`` (three nodes of one name on both) with
its own ``running_operator``, and compares what the script returns in the
port's names: the driver DaemonSet (``tpu-libtpu-daemonset`` ↔
``gpu-driver-daemonset``) and its spec section (``libtpu`` ↔ ``driver``),
the card resource (``google.com/tpu`` ↔ ``nvidia.com/gpu``) and the FSM's
renamed state label. Tolerance: exact equality. The dev loop's capacity is
the stub devfs's count on each side: 4 chips for the reference's v5e
host, ``CARDS_PER_HOST["h100-sxm"]`` (8) for the port, with NVML disabled
so a machine's real cards cannot answer instead. Every wait on a condition
has a limit of 60 s or more, and every manager, server and gRPC rig stops
in a ``finally``.
"""

from types import SimpleNamespace

import pytest

from tests import conftest
from tpu_operator import consts as ref_consts
from tpu_operator import main as ref_main
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import rest as ref_rest
from tpu_operator.kube import testing as ref_testing
from tpu_operator.upgrade import upgrade_state as ref_us
from tpu_operator_torch import consts, main
from tpu_operator_torch.kube import kubesim, rest, testing
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.upgrade import upgrade_state as us
from tpu_operator_torch.workloads.topology import CARDS_PER_HOST

NS = "tpu-operator"
CPV = consts.API_VERSION
NODES = ("up-node-1", "up-node-2", "up-node-3")

SIDES = {
    "reference": SimpleNamespace(
        name="reference", kubesim=ref_kubesim, testing=ref_testing, main=ref_main, consts=ref_consts, us=ref_us,
        rest=ref_rest, running_operator=conftest.running_operator, spec="libtpu", app="tpu-libtpu-daemonset",
        resource=ref_consts.TPU_RESOURCE, node="fake-tpu-node-1", chips=4),
    "port": SimpleNamespace(
        name="port", kubesim=kubesim, testing=testing, main=main, consts=consts, us=us, rest=rest,
        running_operator=testing.running_operator, spec="driver", app="gpu-driver-daemonset",
        resource=consts.GPU_RESOURCE, node="fake-gpu-node-1", chips=CARDS_PER_HOST[testing.DEFAULT_VARIANT]),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def wait(pred, timeout_s=60.0):
    return testing.wait_until(pred, timeout_s, 0.1)


def both(script):
    """``script(side, server, client)`` on each package, each on a fresh
    KubeSim seeded with ``NODES``; the results must agree. Returns the
    port's."""
    out = []
    for side in SIDES.values():
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0)).start()
        try:
            client = side.kubesim.make_client(server.port)
            client.GET_RETRY_BACKOFF_S = 0.05
            side.testing.seed_cluster(client, NS, node_names=NODES)
            out.append(script(side, server, client))
        finally:
            server.stop()
    assert out[0] == out[1]
    return out[1]


def cr_state(client):
    return ((client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}).get("status") or {}).get("state")


def upgrade_label(side, client, name):
    return (client.get("v1", "Node", name)["metadata"].get("labels") or {}).get(side.consts.UPGRADE_STATE_LABEL)


def test_rolling_upgrade_three_nodes_over_the_wire():
    """A driver version bump rolls node by node (``maxParallelUpgrades``
    1): cordon, drain (a running card workload is evicted), operand pod
    restart at the new revision, validation, uncordon, done."""

    def script(side, server, client):
        max_active, seen = [0], set()

        def sampler(halt):
            while not halt.is_set():
                try:
                    states = [upgrade_label(side, client, n) for n in NODES]
                    seen.update(s for s in states if s)
                    max_active[0] = max(max_active[0], sum(1 for s in states if s in side.us.ACTIVE_STATES))
                except (side.rest.TransientAPIError, OSError):
                    pass
                halt.wait(0.05)

        with side.running_operator(client, NS, NODES, extra_threads=(sampler,)):
            out = [wait(lambda: cr_state(client) == "ready", 90)]
            old = {p["metadata"]["name"]: p["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION]
                   for p in client.list("v1", "Pod", NS, label_selector={"app": side.app + "*"})}
            out.append(len(old))
            client.create({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "train-0", "namespace": NS, "ownerReferences": [
                    {"apiVersion": "batch/v1", "kind": "Job", "name": "train", "uid": "job-uid-1"}]},
                "spec": {"nodeName": NODES[0], "containers": [
                    {"name": "train", "resources": {"limits": {side.resource: "4"}}}]},
                "status": {"phase": "Running"}})
            side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"][side.spec].update(upgradePolicy={
                "autoUpgrade": True, "maxParallelUpgrades": 1, "maxUnavailable": 1,
                "drain": {"enable": True, "timeoutSeconds": 300}}))
            side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"][side.spec].update(version="2025.2.0"))
            out.append(wait(lambda: all(upgrade_label(side, client, n) == side.us.STATE_DONE for n in NODES), 180))
            out.append(client.get_or_none("v1", "Pod", "train-0", NS) is None)
            new = client.list("v1", "Pod", NS, label_selector={"app": side.app + "*"})
            out.append(sorted(p["metadata"]["annotations"][side.consts.LAST_APPLIED_HASH_ANNOTATION]
                              != old.get(p["metadata"]["name"]) for p in new))
            out.append([bool(client.get("v1", "Node", n).get("spec", {}).get("unschedulable")) for n in NODES])
            out.append(wait(lambda: cr_state(client) == "ready", 90))
        return out + [max_active[0] <= 1, side.us.STATE_DONE in seen, bool(seen & set(side.us.ACTIVE_STATES))]

    assert both(script) == [True, 3, True, True, [True] * 3, [False] * 3, True, True, True, True]


def test_operator_restart_mid_upgrade_resumes_fsm():
    """The operator stops with one node mid-upgrade; a fresh operator
    resumes the walk from the node labels alone and finishes all three."""

    def script(side, server, client):
        with side.running_operator(client, NS, NODES):
            out = [wait(lambda: cr_state(client) == "ready", 90)]
            side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"][side.spec].update(upgradePolicy={
                "autoUpgrade": True, "maxParallelUpgrades": 1, "maxUnavailable": 1}, version="2025.4.0"))
            out.append(wait(lambda: any(upgrade_label(side, client, n) in side.us.ACTIVE_STATES for n in NODES)))
        at_stop = [upgrade_label(side, client, n) for n in NODES]
        out.append(any(s != side.us.STATE_DONE for s in at_stop))
        with side.running_operator(client, NS, NODES):
            out.append(wait(lambda: all(upgrade_label(side, client, n) == side.us.STATE_DONE for n in NODES), 180))
            out.append([bool(client.get("v1", "Node", n).get("spec", {}).get("unschedulable")) for n in NODES])
            out.append(wait(lambda: cr_state(client) == "ready", 90))
        return out

    assert both(script) == [True, True, True, True, [False] * 3, True]


def test_dev_loop_grpc_kubelet_wiring(monkeypatch):
    """``main.start_grpc_kubelet`` closes the plugin loop inside
    ``--kubesim --grpc-kubelet``: the node's capacity comes from the gRPC
    advertisement alone, the stub devfs's count of cards."""
    pytest.importorskip("grpc")
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)

    def script(side):
        client = side.main.make_kubesim_client(1)
        kubelet, plugin = side.main.start_grpc_kubelet(client, side.node)
        try:
            got = wait(lambda: (client.get("v1", "Node", side.node).get("status", {}).get("allocatable", {}).get(
                side.resource) == str(side.chips)))
            return got, client.get("v1", "Node", side.node)["status"]["allocatable"][side.resource]
        finally:
            plugin.stop()
            kubelet.stop()
            client._kubesim_server.stop()

    ref, port = (script(side) for side in SIDES.values())
    assert ref == (True, "4") and port == (True, "8")
