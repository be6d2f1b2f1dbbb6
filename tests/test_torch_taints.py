"""Node taints on the port against the JAX package's, on the 8 cases of
``tests/test_taints.py``: the one merge definition (``merge_taint``), the
read and write round trip through the fake, REST (over KubeSim) and cached
clients, the write-conflict retry, the simulated kubelet's NoSchedule
placement, toleration matching, and the repair-taint toleration on every
operand DaemonSet.

Each case runs on each package (``two_sided.hold``) with the same inputs
(the reference's TPU node, the port's H100 node, one name for both) and
the reference's assertions made on each side; the outcomes (taint lists,
whether each write moved the resourceVersion, pod placements, desired
counts, toleration verdicts, the DaemonSets' tolerations) must be equal.
The repair taint's key and value come from each side's ``consts``. The
rendered operand DaemonSets are named in the port's names
(``tests/test_torch_reconciler.py``'s ``ref_name``). Tolerance: exact
equality. Every server stops in a ``finally``.
"""

import copy
from types import SimpleNamespace

import pytest

from tests import test_torch_daemonset_common as dsc
from tests.test_torch_reconciler import ref_name
from tests.two_sided import BY_SIDE, hold
from tpu_operator import consts as ref_consts
from tpu_operator.api.v1 import clusterpolicy_types as ref_cpt
from tpu_operator.controllers import object_controls as ref_oc
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator_torch import consts
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt
from tpu_operator_torch.controllers import object_controls as oc
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import kubesim, testing
from tpu_operator_torch.kube.cache import CachedClient

NS = "tpu-operator"

SIDES = {
    "reference": SimpleNamespace(
        name="reference", consts=ref_consts, kclient=ref_kclient, FakeClient=RefFakeClient, kubesim=ref_kubesim,
        CachedClient=RefCachedClient, testing=ref_testing, node=ref_testing.make_tpu_node, oc=ref_oc, cpt=ref_cpt,
        dsc=dsc.SIDES["reference"], names=ref_name),
    "port": SimpleNamespace(
        name="port", consts=consts, kclient=kclient, FakeClient=kclient.FakeClient, kubesim=kubesim,
        CachedClient=CachedClient, testing=testing, node=testing.make_gpu_node, oc=oc, cpt=cpt,
        dsc=dsc.SIDES["port"], names=lambda n: n),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def repair(side):
    return side.consts.REPAIR_TAINT_KEY, side.consts.REPAIR_PENDING


# --- merge semantics ---------------------------------------------------------

@BY_SIDE
def test_merge_taint_appends_and_replaces(side):
    def script(side):
        merge = side.kclient.merge_taint
        taints = [{"key": "a", "value": "1", "effect": "NoSchedule"}]
        verdicts = [merge(taints, "b", "2", "NoSchedule")]  # a new key appends
        assert len(taints) == 2
        verdicts.append(merge(taints, "a", "9", "NoSchedule"))  # same key+effect replaces in place
        assert taints[0] == {"key": "a", "value": "9", "effect": "NoSchedule"}
        assert len(taints) == 2
        verdicts.append(merge(taints, "a", "9", "NoSchedule"))  # identical: no change
        verdicts.append(merge(taints, "a", "9", "NoExecute"))  # another effect: a distinct taint
        assert len(taints) == 3
        assert verdicts == [True, True, False, True]
        return verdicts, taints

    hold(SIDES, side, script)


# --- read and write through the client layers --------------------------------

def roundtrip(side, client, name):
    """The reference's ``_roundtrip``; returns each step's taints and
    whether the step wrote."""
    k = side.kclient
    key, pending = repair(side)
    steps = []

    def step(what):
        node = client.get("v1", "Node", name)
        steps.append((what, copy.deepcopy(k.node_taints(node)), "taints" in (node.get("spec") or {})))
        return node

    k.set_node_taint(client, name, key, pending)
    node = step("set")
    assert k.has_taint(node, key)
    assert k.has_taint(node, key, pending)
    assert not k.has_taint(node, key, "other")
    [taint] = [t for t in k.node_taints(node) if t["key"] == key]
    assert taint["effect"] == "NoSchedule"
    rv = node["metadata"]["resourceVersion"]
    k.set_node_taint(client, name, key, pending)  # idempotent: no write
    assert client.get("v1", "Node", name)["metadata"]["resourceVersion"] == rv
    k.set_node_taint(client, name, "user-taint", "x", "NoExecute")
    k.remove_node_taint(client, name, key)
    node = step("remove repair")
    assert not k.has_taint(node, key)
    assert k.has_taint(node, "user-taint")
    k.remove_node_taint(client, name, "user-taint")
    node = step("remove last")
    assert "taints" not in node.get("spec", {})  # the empty list is dropped
    rv = node["metadata"]["resourceVersion"]
    k.remove_node_taint(client, name, "never-there")  # absent: no write
    assert client.get("v1", "Node", name)["metadata"]["resourceVersion"] == rv
    return steps


@BY_SIDE
def test_taints_fake_client(side):
    def script(side):
        return roundtrip(side, side.FakeClient([side.node("t-node-1")]), "t-node-1")

    hold(SIDES, side, script)


@BY_SIDE
def test_taints_kubesim_rest_client(side):
    def script(side):
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim()).start()
        try:
            client = side.kubesim.make_client(server.port)
            client.create(side.node("t-node-1"))
            return roundtrip(side, client, "t-node-1")
        finally:
            server.stop()

    hold(SIDES, side, script)


@BY_SIDE
def test_taints_cached_client_write_through(side):
    def script(side):
        client = side.CachedClient(side.FakeClient([side.node("t-node-1")]), namespace=NS)
        assert client.start_informers() is True
        try:
            steps = roundtrip(side, client, "t-node-1")
            key, pending = repair(side)
            side.kclient.set_node_taint(client, "t-node-1", key, pending)
            cached = client.get("v1", "Node", "t-node-1")  # the cached view carries the write
            assert side.kclient.has_taint(cached, key)
            return steps, side.kclient.node_taints(cached)
        finally:
            client.stop()

    hold(SIDES, side, script)


@BY_SIDE
def test_taint_write_conflict_retries(side):
    """A writer that bumps the resourceVersion between the read and the
    write is absorbed by ``mutate_with_retry``; its label survives."""

    def script(side):
        client = side.FakeClient([side.node("t-node-1")])
        real_update = client.update
        raced = {"done": False}

        def racing_update(obj):
            if not raced["done"] and obj.get("kind") == "Node":
                raced["done"] = True
                other = client.get("v1", "Node", "t-node-1")
                other["metadata"]["labels"]["racer"] = "yes"
                real_update(other)
            return real_update(obj)

        client.update = racing_update
        key, pending = repair(side)
        side.kclient.set_node_taint(client, "t-node-1", key, pending)
        node = client.get("v1", "Node", "t-node-1")
        assert raced["done"]
        assert side.kclient.has_taint(node, key)
        assert node["metadata"]["labels"]["racer"] == "yes"  # nothing reverted
        return side.kclient.node_taints(node), node["metadata"]["labels"]["racer"]

    hold(SIDES, side, script)


# --- NoSchedule-aware placement ----------------------------------------------

def ds(side, name, tolerations=None):
    spec = {"nodeSelector": {}}
    if tolerations is not None:
        spec["tolerations"] = tolerations
    return {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": name, "namespace": NS},
            "spec": {"selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": {"annotations": {side.consts.LAST_APPLIED_HASH_ANNOTATION: "h1"}},
                                  "spec": spec},
                     "updateStrategy": {"type": "RollingUpdate"}}}


@BY_SIDE
def test_kubelet_sim_honors_noschedule_taints(side):
    def script(side):
        key, pending = repair(side)
        client = side.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                                  side.node("clean-node"), side.node("tainted-node")])
        side.kclient.set_node_taint(client, "tainted-node", key, pending)
        client.create(ds(side, "plain-ds"))
        client.create(ds(side, "tolerant-ds", [{"key": key, "operator": "Exists", "effect": "NoSchedule"}]))
        side.testing.simulate_kubelet_nodes(client, NS, ["clean-node", "tainted-node"])
        pods = {p["metadata"]["name"] for p in client.list("v1", "Pod", NS)}
        assert "plain-ds-clean-node" in pods
        assert "plain-ds-tainted-node" not in pods
        assert {"tolerant-ds-clean-node", "tolerant-ds-tainted-node"} <= pods
        desired = {n: client.get("apps/v1", "DaemonSet", n, NS)["status"]["desiredNumberScheduled"]
                   for n in ("plain-ds", "tolerant-ds")}
        assert desired == {"plain-ds": 1, "tolerant-ds": 2}
        return sorted(pods), desired

    hold(SIDES, side, script)


@BY_SIDE
def test_toleration_matching_semantics(side):
    def script(side):
        key, pending = repair(side)
        taint = {"key": key, "value": pending, "effect": "NoSchedule"}
        cases = [
            ({"operator": "Exists"}, True),  # empty key + Exists tolerates everything
            ({"key": key, "operator": "Exists"}, True),
            ({"key": key, "operator": "Equal", "value": pending}, True),
            ({"key": key, "operator": "Equal", "value": "x"}, False),
            ({"key": "other", "operator": "Exists"}, False),
            ({"key": key, "operator": "Exists", "effect": "NoExecute"}, False),
            ({"operator": "Equal", "value": "x"}, False),  # empty key without Exists tolerates nothing
        ]
        verdicts = [side.testing.toleration_matches(tol, taint) for tol, _ in cases]
        assert verdicts == [want for _, want in cases]
        return verdicts

    hold(SIDES, side, script)


@BY_SIDE
def test_rendered_operand_daemonsets_tolerate_repair_taint(side):
    """``_apply_common_daemonset_config`` adds the repair-taint toleration
    to any DaemonSet; and every operand DaemonSet a reconcile renders from
    the side's own assets carries it."""

    def script(side):
        key, _ = repair(side)
        want = {"key": key, "operator": "Exists", "effect": "NoSchedule"}

        class N:
            cp = side.cpt.ClusterPolicy()

        one = ds(side, "any-operand")
        side.oc._apply_common_daemonset_config(N, one)
        assert want in one["spec"]["template"]["spec"]["tolerations"]

        client = dsc.reconcile_with(side.dsc, dsc.load_cr())
        rendered = {side.names(d["metadata"]["name"]): want in (d["spec"]["template"]["spec"].get("tolerations") or [])
                    for d in client.list("apps/v1", "DaemonSet", NS)}
        assert len(rendered) >= 5 and all(rendered.values()), rendered
        return one["spec"]["template"]["spec"]["tolerations"], rendered

    hold(SIDES, side, script)
