"""The port's whole operator process over the wire (``main.build_manager``,
``main.wire_event_sources``, ``manager.Manager`` through the production
``RestClient`` against KubeSim) against the JAX package's, on the 6 cases
of ``tests/test_manager_kubesim.py``.

Each case runs one script on both packages (``both``), each side on its
own KubeSim seeded by its own ``seed_cluster`` (the reference's TPU nodes,
the port's H100 nodes, one name for both), and compares what the script
returns in the port's names: operand DaemonSets through
``convert.operand_app_from_reference`` and the card variant table
(``tests/test_torch_reconciler.py``'s ``ref_name``), the driver's
``libtpu``/``driver`` spec section, container and image tag. The
reference's v5e/v5p generation fan-out is the port's ``h100-sxm`` /
``h100-pcie`` fan-out. Tolerance: exact equality. Every wait on a
condition has a limit of 60 s or more (90 s for a convergence), no ratio of
two times is asserted, and every manager and server stops in a
``finally`` (``running_operator``).
"""

import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import yaml

from tests import conftest
from tests.test_torch_reconciler import ref_name
from tpu_operator import consts as ref_consts
from tpu_operator import main as ref_main
from tpu_operator import manager as ref_manager
from tpu_operator.controllers import state_manager as ref_sm
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator_torch import consts, main, manager
from tpu_operator_torch.controllers import state_manager as sm
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import kubesim, testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"
CPV = consts.API_VERSION
NODE = "card-node-1"


def _ref_node(name, gen="v5e"):
    if gen == "v5p":
        return ref_testing.make_tpu_node(name, accelerator="tpu-v5p-slice", topology="2x2x2")
    return ref_testing.make_tpu_node(name)


def _port_node(name, gen="h100-sxm"):
    product = {"h100-sxm": testing.DEFAULT_PRODUCT, "h100-pcie": "NVIDIA-H100-PCIe"}[gen]
    return testing.make_gpu_node(name, variant=gen, product=product)


SIDES = {
    "reference": SimpleNamespace(
        name="reference", kubesim=ref_kubesim, testing=ref_testing, main=ref_main, manager=ref_manager,
        consts=ref_consts, sm=ref_sm, kclient=ref_kclient, running_operator=conftest.running_operator,
        node=_ref_node, gens=("v5e", "v5p"), spec="libtpu", container="libtpu-ctr", module="tpu_operator.main",
        names=ref_name),
    "port": SimpleNamespace(
        name="port", kubesim=kubesim, testing=testing, main=main, manager=manager, consts=consts, sm=sm,
        kclient=kclient, running_operator=testing.running_operator, node=_port_node, gens=("h100-sxm", "h100-pcie"),
        spec="driver", container="driver-ctr", module="tpu_operator_torch.main", names=lambda n: n),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def both(script, *args):
    """``script(side, *args)`` on each package, each on a fresh KubeSim
    seeded with ``NODE``; the results must agree. Returns the port's."""
    out = []
    for side in SIDES.values():
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0)).start()
        try:
            client = side.kubesim.make_client(server.port)
            client.GET_RETRY_BACKOFF_S = 0.05
            side.testing.seed_cluster(client, NS, node_names=(NODE,))
            out.append(script(side, server, client, *args))
        finally:
            server.stop()
    assert out[0] == out[1]
    return out[1]


def wait(pred, timeout_s=60.0):
    return testing.wait_until(pred, timeout_s, 0.1)


def cr_state(client):
    return ((client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}).get("status") or {}).get("state")


def ds_names(side, client):
    return {side.names(d["metadata"]["name"]) for d in client.list("apps/v1", "DaemonSet", NS)}


def test_manager_converges_and_reacts_via_watches():
    """The CR converges off the watch-fed queue alone; a CR spec change
    and a deleted operand DaemonSet come back through the watches."""

    def script(side, server, client):
        mgr, _, _ = side.main.build_manager(client, NS, metrics_port=0, probe_port=0)
        stop, halt = threading.Event(), threading.Event()

        def kubelet():
            while not halt.is_set():
                try:
                    side.testing.simulate_kubelet_once(client, NS, node_name=NODE)
                except Exception:
                    pass
                halt.wait(0.2)

        try:
            side.main.wire_event_sources(mgr, client, NS, stop_event=stop)
            mgr.start()
            threading.Thread(target=kubelet, daemon=True).start()
            out = [wait(lambda: cr_state(client) == "ready", 90)]
            side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"]["metricsExporter"].update(enabled=False))
            out.append(wait(lambda: "gpu-metrics-exporter" not in ds_names(side, client)))
            fd = "tpu-feature-discovery" if side.name == "reference" else "gpu-feature-discovery"
            client.delete("apps/v1", "DaemonSet", fd, NS)
            out.append(wait(lambda: client.get_or_none("apps/v1", "DaemonSet", fd, NS) is not None))
            return out
        finally:
            halt.set()
            stop.set()
            mgr.stop()

    assert both(script) == [True, True, True]


def test_leader_election_failover_over_the_wire():
    """Two candidates on one KubeSim Lease: one leads, the other waits;
    when the leader stops, its 2 s lease expires and the other takes
    over. Each side's Lease is its own (``gpu-operator-leader``)."""

    def script(side, server, client):
        leads = []

        def candidate(name, stop):
            elector = side.manager.LeaderElector(side.kubesim.make_client(server.port), NS, identity=name,
                                                 lease_seconds=2)
            while not stop.is_set():
                if elector.try_acquire():
                    leads.append(name)
                    while not stop.is_set():
                        elector.try_acquire()
                        stop.wait(0.5)
                    return
                stop.wait(0.3)

        stop_a, stop_b = threading.Event(), threading.Event()
        ta = threading.Thread(target=candidate, args=("pod-a", stop_a), daemon=True)
        tb = threading.Thread(target=candidate, args=("pod-b", stop_b), daemon=True)
        try:
            ta.start()
            out = [wait(lambda: "pod-a" in leads)]
            tb.start()
            time.sleep(1.5)
            out.append("pod-b" in leads)
            stop_a.set()
            ta.join(timeout=30)
            out.append(wait(lambda: "pod-b" in leads))
            lease = client.get("coordination.k8s.io/v1", "Lease", side.manager.LeaderElector(
                client, NS).name, NS)
            return out + [lease["spec"]["holderIdentity"], lease["metadata"]["name"].startswith(
                "gpu-" if side.name == "port" else "tpu-")]
        finally:
            stop_a.set()
            stop_b.set()
            ta.join(timeout=30)
            tb.join(timeout=30)

    assert both(script) == [True, False, True, "pod-b", True]


def test_generation_fanout_and_gc_over_the_wire():
    """A node of the second variant joins: one driver DaemonSet a variant,
    each with its variant's image and node selector; the node leaving
    collects its DaemonSet. All through the watches."""

    def script(side, server, client):
        nodes = [NODE]
        gen_a, gen_b = side.gens
        driver = "tpu-libtpu-daemonset" if side.name == "reference" else "gpu-driver-daemonset"
        with side.running_operator(client, NS, nodes):
            out = [wait(lambda: cr_state(client) == "ready", 90)]
            client.create(side.node("card-node-2", gen_b))
            nodes.append("card-node-2")
            side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"][side.spec].update(
                generationConfigs={gen_a: f"2025.1.0-{gen_a}", gen_b: f"2025.1.0-{gen_b}"}))
            per_variant = {f"{driver}-{gen_a}", f"{driver}-{gen_b}"}
            out.append(wait(lambda: per_variant <= {d["metadata"]["name"] for d in client.list(
                "apps/v1", "DaemonSet", NS)} and driver not in {d["metadata"]["name"] for d in client.list(
                    "apps/v1", "DaemonSet", NS)}))
            for gen in (gen_a, gen_b):
                ds = client.get("apps/v1", "DaemonSet", f"{driver}-{gen}", NS)
                img = [c for c in ds["spec"]["template"]["spec"]["containers"] if c["name"] == side.container][0][
                    "image"]
                out.append((img.endswith(f":2025.1.0-{gen}"),
                            ds["spec"]["template"]["spec"]["nodeSelector"][f"{side.consts.GROUP}/tpu.generation"]
                            == gen))

            def placed():
                for gen, node in ((gen_a, NODE), (gen_b, "card-node-2")):
                    pods = client.list("v1", "Pod", NS, label_selector={"app": f"{driver}-{gen}"})
                    if [p["spec"]["nodeName"] for p in pods] != [node]:
                        return False
                return True

            out += [wait(placed), wait(lambda: cr_state(client) == "ready", 90)]
            nodes.remove("card-node-2")
            client.delete("v1", "Node", "card-node-2")
            names = lambda: {d["metadata"]["name"] for d in client.list("apps/v1", "DaemonSet", NS)}  # noqa: E731
            out.append(wait(lambda: f"{driver}-{gen_b}" not in names() and f"{driver}-{gen_a}" in names()))
            out.append(wait(lambda: cr_state(client) == "ready", 90))
            return out, sorted(side.names(n) for n in names())

    out, names = both(script)
    assert out == [True, True, (True, True), (True, True), True, True, True, True]
    assert "gpu-driver-daemonset-h100-sxm" in names


def test_kubesim_dev_mode_once_converges():
    """``main --kubesim --simulate-kubelet --once --nodes 3`` exits 0 with
    the cluster READY, for each package's module."""

    def script(side):
        res = subprocess.run(
            [sys.executable, "-m", side.module, "--kubesim", "--simulate-kubelet", "--once", "--nodes", "3",
             "--metrics-port", "0", "--probe-port", "0"],
            env=dict(os.environ, OPERATOR_NAMESPACE=NS), capture_output=True, text=True, timeout=300, cwd=REPO)
        return res.returncode, "ready=True" in res.stderr, "3 nodes" in res.stderr

    ref, port = (script(side) for side in SIDES.values())
    assert ref == port == (0, True, True)


def test_node_labeling_survives_concurrent_label_writers():
    """A storm of foreign label writes on every node while
    ``ClusterPolicyController.init`` runs: each pass completes, the
    operator labels converge and the foreign labels stay."""

    def script(side, server, client):
        nodes = [NODE] + [f"race-node-{i}" for i in range(4)]
        for n in nodes[1:]:
            client.create(side.node(n))
        stop = threading.Event()
        ticks = [0]

        def storm():
            i = 0
            while not stop.is_set():
                i += 1

                def bump(node, i=i):
                    node["metadata"]["labels"]["chaos.example.com/tick"] = str(i)
                    return True

                try:
                    side.kclient.mutate_with_retry(client, "v1", "Node", nodes[i % len(nodes)], mutate=bump)
                    ticks[0] += 1
                except Exception:
                    pass

        t = threading.Thread(target=storm, daemon=True)
        t.start()
        try:
            with open(side.testing.sample_clusterpolicy_path()) as f:
                cp_obj = yaml.safe_load(f)
            ctrl = side.sm.ClusterPolicyController(client)
            for _ in range(15):
                ctrl.init(cp_obj)
            count = ctrl.tpu_node_count
        finally:
            stop.set()
            t.join(timeout=30)
        labels = [client.get("v1", "Node", n)["metadata"]["labels"] for n in nodes]
        return (count, ticks[0] > 0,
                [(lab.get(side.consts.TPU_PRESENT_LABEL),
                  lab.get(side.consts.DEPLOY_LABEL_PREFIX + "device-plugin"),
                  "chaos.example.com/tick" in lab) for lab in labels])

    assert both(script) == (5, True, [("true", "true", True)] * 5)


def test_steady_state_reconcile_is_cache_served():
    """Behind the warm informer cache a steady-state pass of both
    reconcilers makes no read and no write on the server."""

    def script(side, server, client):
        mgr, _, _ = side.main.build_manager(client, NS, metrics_port=0, probe_port=0)
        cached = mgr.client
        stop = threading.Event()
        try:
            synced = cached.start_informers(stop, timeout_s=60)
            res = None
            for _ in range(60):
                res = mgr._reconcilers["clusterpolicy"]("clusterpolicy")
                side.testing.simulate_kubelet_once(client, NS, node_name=NODE)
                if res.ready:
                    break
                time.sleep(0.1)
            ready = res is not None and res.ready
            time.sleep(1.5)
            mgr._reconcilers["clusterpolicy"]("clusterpolicy")
            mgr._reconcilers["upgrade"]("upgrade")
            time.sleep(0.5)
            before = dict(server.sim.request_counts)
            steady = []
            for _ in range(5):
                steady.append(mgr._reconcilers["clusterpolicy"]("clusterpolicy").ready)
                mgr._reconcilers["upgrade"]("upgrade")
            after = dict(server.sim.request_counts)
            reads = sum(after.get(v, 0) - before.get(v, 0) for v in ("GET", "LIST"))
            writes = sum(after.get(v, 0) - before.get(v, 0) for v in ("POST", "PUT", "DELETE"))
            return hasattr(cached, "start_informers"), synced, ready, steady, reads, writes
        finally:
            stop.set()
            mgr.stop()

    assert both(script) == (True, True, True, [True] * 5, 0, 0)
