"""The port's fault tolerance end to end against the JAX package's, on the 3
cases of ``tests/test_fault_matrix.py``: 429/500/503 and added latency on
every write verb (and LIST) absorbed by the ``RestClient``'s retry policy,
a full partition window that opens the circuit breaker which then recovers,
and a state whose control raises, isolated under a Degraded condition.

Each case runs one script on both packages (``both``): each side on its own
KubeSim seeded by its own ``seed_cluster`` (the reference's TPU node, the
port's H100 node, one name for both), its own ``RestClient`` tuned by
``_tune_client`` and its own whole operator (``running_operator``). The
script returns outcomes, not traces: states reached, faults consumed,
retries counted (as "some", never a number: thread timing differs between
the packages), and operand DaemonSets in the port's names
(``tests/test_torch_reconciler.py``'s ``ref_name``). Tolerance: exact
equality of those outcomes. Every wait on a condition has a limit of 60 s
or more (90 s for a convergence), no time is asserted, and every server and
operator stops in a ``finally``.

``SIDES`` is shared by the other wire suites of step 5c
(``test_torch_remediation_matrix.py``, ``test_torch_multihost_slice_loop.py``,
``test_torch_chaos_kubesim.py``).
"""

import os
import time
from types import SimpleNamespace

import pytest
import yaml

from tests import conftest
from tests.test_torch_reconciler import ref_name
from tpu_operator import consts as ref_consts
from tpu_operator.cfg import crdgen as ref_crdgen
from tpu_operator.controllers import clusterpolicy_controller as ref_cpc
from tpu_operator.controllers import object_controls as ref_oc
from tpu_operator.controllers import slice_status as ref_slice_status
from tpu_operator.discovery import tfd as ref_tfd
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import kubelet_sim as ref_kubelet_sim
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import rest as ref_rest
from tpu_operator.kube import testing as ref_testing
from tpu_operator.plugin import server as ref_plugin
from tpu_operator.upgrade import upgrade_state as ref_us
from tpu_operator.validator import components as ref_components
from tpu_operator_torch import consts, convert
from tpu_operator_torch.cfg import crdgen
from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
from tpu_operator_torch.controllers import object_controls as oc
from tpu_operator_torch.controllers import slice_status
from tpu_operator_torch.discovery import tfd
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import kubelet_sim, kubesim, rest, testing
from tpu_operator_torch.plugin import server as plugin
from tpu_operator_torch.upgrade import upgrade_state as us
from tpu_operator_torch.validator import components

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"
CPV = "tpu.k8s.io/v1"
NODE = "fm-node-1"

SIDES = {
    "reference": SimpleNamespace(
        name="reference", kubesim=ref_kubesim, testing=ref_testing, consts=ref_consts, kclient=ref_kclient,
        rest=ref_rest, crdgen=ref_crdgen, cpc=ref_cpc, oc=ref_oc, slice_status=ref_slice_status, tfd=ref_tfd,
        kubelet_sim=ref_kubelet_sim, plugin=ref_plugin, us=ref_us, components=ref_components,
        FakeClient=RefFakeClient, running_operator=conftest.running_operator, node=ref_testing.make_tpu_node,
        assets=os.path.join(REPO, "assets"), sample=ref_testing.sample_clusterpolicy_path(),
        resource=ref_consts.TPU_RESOURCE, card_label=ref_consts.GKE_TPU_ACCELERATOR_LABEL,
        driver_spec="libtpu", names=ref_name, app=lambda app: app),
    "port": SimpleNamespace(
        name="port", kubesim=kubesim, testing=testing, consts=consts, kclient=kclient, rest=rest, crdgen=crdgen,
        cpc=cpc, oc=oc, slice_status=slice_status, tfd=tfd, kubelet_sim=kubelet_sim, plugin=plugin, us=us,
        components=components, FakeClient=kclient.FakeClient, running_operator=testing.running_operator,
        node=testing.make_gpu_node, assets=os.path.join(REPO, "tpu_operator_torch", "assets"),
        sample=testing.sample_clusterpolicy_path(), resource=consts.GPU_RESOURCE,
        card_label=consts.GPU_PRODUCT_LABEL, driver_spec="driver", names=lambda n: n,
        app=convert.operand_app_from_reference),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def both(script, *args):
    """``script(side, *args)`` on each package; the outcomes (in the port's
    names) must agree. Returns the port's."""
    out = {name: script(side, *args) for name, side in SIDES.items()}
    assert out["reference"] == out["port"], out
    return out["port"]


def wait(pred, timeout_s=60.0):
    return testing.wait_until(pred, timeout_s, 0.1)


def start_server(side):
    return side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0)).start()


def _tune_client(client):
    """Test cadence for the same policy and breaker code paths."""
    client.retry_policy.backoff_s = 0.02
    client.retry_policy.cap_s = 0.2
    client.retry_policy.budget_s = 5.0
    client.breaker.cooldown_base_s = 0.2
    client.breaker.cooldown_cap_s = 0.5
    return client


def cp_state(client):
    cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
    return cp.get("status", {}).get("state")


def exporter_ds(side, client):
    return client.get_or_none("apps/v1", "DaemonSet", side.app("tpu-metrics-exporter"), NS)


def disable_exporter(side, client):
    side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"]["metricsExporter"].update(enabled=False))


def test_fault_matrix_write_verbs_converge():
    """With 429/500/503 and latency injected on every write verb (and on
    LIST), the operator still reaches READY: every fault is consumed by a
    retry, APPLY's retries are counted under its own name, a faulted DELETE
    converges, and the worker never wedges."""

    def script(side):
        server = start_server(side)
        sim = server.sim
        try:
            client = _tune_client(side.kubesim.make_client(server.port))
            side.testing.seed_cluster(client, NS, node_names=(NODE,))
            sim.inject_fault("POST", "*", code=500, count=2)
            sim.inject_fault("POST", "*", code=429, retry_after=0.05, count=2)
            sim.inject_fault("PUT", "*", code=503, count=2)
            sim.inject_fault("PUT", "*", code=429, retry_after=0.05, count=1)
            sim.inject_fault("PUT", "*", latency_s=0.15, count=2)
            sim.inject_fault("APPLY", "*", code=429, retry_after=0.05, count=2)
            sim.inject_fault("APPLY", "*", code=500, count=1)
            sim.inject_fault("APPLY", "*", code=503, count=1)
            sim.inject_fault("APPLY", "*", latency_s=0.15, count=2)
            sim.inject_fault("LIST", "*", code=500, count=2)
            out = {"injected": sim.faults_pending()}
            with side.running_operator(client, NS, [NODE]) as mgr:
                out["ready"] = wait(lambda: cp_state(client) == "ready", 90)
                out["consumed"] = wait(lambda: sim.faults_pending() == 0, 60)
                stats = client.fault_stats()["retry"]
                out["retried"] = stats["retries_total"] > 0
                out["retry-after honored"] = stats["retry_after_honored"] > 0
                out["APPLY retried"] = stats["retries_by_verb"].get("APPLY", 0) > 0
                sim.inject_fault("DELETE", "*", code=500, count=1)
                disable_exporter(side, client)
                out["faulted DELETE converged"] = wait(lambda: exporter_ds(side, client) is None, 60)
                out["DELETE fault consumed"] = sim.faults_pending() == 0
                out["healthy"] = mgr.healthy()
                mgr.enqueue("clusterpolicy")
                out["still reconciles"] = wait(lambda: mgr._last_reconcile_ok, 60)
            return out
        finally:
            server.stop()

    out = both(script)
    assert out.pop("injected") == 17
    assert all(out.values()), out


def test_fault_matrix_partition_window():
    """A full partition (every request 503, watch streams cut) trips the
    circuit breaker; when the window closes the watches reconnect, the
    breaker closes, a spec edit lands and the operator re-converges."""

    def script(side):
        server = start_server(side)
        sim = server.sim
        try:
            client = _tune_client(side.kubesim.make_client(server.port))
            side.testing.seed_cluster(client, NS, node_names=(NODE,))
            out = {}
            with side.running_operator(client, NS, [NODE]) as mgr:
                out["ready"] = wait(lambda: cp_state(client) == "ready", 90)
                trips = client.fault_stats()["breaker"]["trips_total"]
                sim.partition(1.0)
                time.sleep(1.2)
                out["partition exercised"] = sim.partition_rejects > 0
                out["breaker opened"] = client.fault_stats()["breaker"]["trips_total"] > trips

                def edit_lands():
                    try:
                        disable_exporter(side, client)
                        return True
                    except (side.rest.TransientAPIError, OSError):
                        return False

                out["edit landed"] = wait(edit_lands, 60)
                out["re-converged"] = wait(lambda: exporter_ds(side, client) is None and cp_state(client) == "ready",
                                           90)
                out["healthy"] = mgr.healthy()
                out["breaker closed"] = client.fault_stats()["breaker"]["state"] != "open"
            return out
        finally:
            server.stop()

    out = both(script)
    assert all(out.values()), out


def test_fault_matrix_state_error_isolation(monkeypatch):
    """With one state's control forced to raise, the other states still
    reconcile (their operands exist, before and after it in the order) and
    the CR names the state under Degraded; with the fault cleared, Degraded
    lifts on the next pass."""

    def script(side):
        client = side.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                                  side.node("tpu-node-1")])
        with open(side.sample) as f:
            client.create(yaml.safe_load(f))
        r = side.cpc.ClusterPolicyReconciler(client, assets_dir=side.assets)
        real = dict(side.oc.CONTROLS)

        def exploding(ctrl, state, obj):
            if state == "state-device-plugin":
                raise RuntimeError("injected control failure")
            return real["daemonset"](ctrl, state, obj)

        out = {}
        with monkeypatch.context() as m:
            m.setitem(side.oc.CONTROLS, "daemonset", exploding)
            out["requeued"] = r.reconcile().requeue_after is not None
        cr = client.get(CPV, "ClusterPolicy", "cluster-policy")
        out["errored"] = [e["state"] for e in cr["status"]["erroredStates"]]
        degraded = {c["type"]: c for c in cr["status"]["conditions"]}["Degraded"]
        out["degraded"] = (degraded["status"], "state-device-plugin" in degraded["message"])
        out["operands"] = sorted(side.names(d["metadata"]["name"]) for d in client.list("apps/v1", "DaemonSet", NS))
        r.reconcile()
        cr = client.get(CPV, "ClusterPolicy", "cluster-policy")
        out["errored after"] = "erroredStates" in cr["status"]
        out["degraded after"] = {c["type"]: c for c in cr["status"]["conditions"]}["Degraded"]["status"]
        return out

    out = both(script)
    assert out["requeued"]
    assert out["errored"] == ["state-device-plugin"]
    assert out["degraded"] == ("True", True)
    assert "gpu-feature-discovery" in out["operands"]  # runs after the error
    assert any(n.startswith(consts.DRIVER_APP) for n in out["operands"])  # runs before it
    assert consts.OPERAND_APPS["tpu-device-plugin-daemonset"] not in out["operands"]
    assert out["errored after"] is False and out["degraded after"] == "False"
