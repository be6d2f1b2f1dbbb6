"""The port's ``FakeClient`` and ``mutate_with_retry`` (``kube/client.py``)
against the JAX package's, on the 12 cases of ``tests/test_fake_client.py``:
CRUD with resourceVersions, create conflicts, label-selector globs, the
status subresource, watch events, apply, field selectors, a node's
deletion taking its bound pods, and the conflict-retry discipline on a
scripted client (retries, the no-change short circuit, the attempt
budget).

Each case runs on each package (``two_sided.hold``) with the same objects
and the reference's assertions made on each side; the outcomes (stored
objects, resourceVersions, events, error class names, call counts) must be
equal. The node's capacity is each side's card resource. Tolerance: exact
equality. ``tests/test_torch_kube.py`` drives the same verbs as one script
of verbs; these cases keep the reference's names and assertions.
"""

from copy import deepcopy
from types import SimpleNamespace

import pytest

from tests.two_sided import BY_SIDE, hold
from tpu_operator.kube import client as ref_kclient
from tpu_operator_torch import consts, convert
from tpu_operator_torch.kube import client as kclient

SIDES = {
    "reference": SimpleNamespace(name="reference", k=ref_kclient, resource=convert.REF_TPU_RESOURCE,
                                 cp_api="tpu.k8s.io/v1"),
    "port": SimpleNamespace(name="port", k=kclient, resource=consts.GPU_RESOURCE,
                            cp_api=f"{consts.GROUP}/v1"),
}


def mk(kind, name, ns="", labels=None, api="v1"):
    meta = {"name": name}
    if ns:
        meta["namespace"] = ns
    if labels:
        meta["labels"] = labels
    return {"apiVersion": api, "kind": kind, "metadata": meta}


def raised(fn, *a, **kw):
    """The class name of what ``fn`` raised (it must raise)."""
    with pytest.raises(Exception) as err:
        fn(*a, **kw)
    return type(err.value).__name__


@BY_SIDE
def test_crud_and_rv(side):
    def script(side):
        c = side.k.FakeClient()
        c.create(mk("ConfigMap", "a", "ns1"))
        got = c.get("v1", "ConfigMap", "a", "ns1")
        assert got["metadata"]["resourceVersion"] == "1"
        got["data"] = {"k": "v"}
        updated = c.update(got)
        assert updated["metadata"]["resourceVersion"] == "2"
        with pytest.raises(side.k.ConflictError):
            c.update(got)  # stale rv
        c.delete("v1", "ConfigMap", "a", "ns1")
        with pytest.raises(side.k.NotFoundError):
            c.get("v1", "ConfigMap", "a", "ns1")
        return updated

    hold(SIDES, side, script)


@BY_SIDE
def test_create_conflict(side):
    def script(side):
        c = side.k.FakeClient()
        c.create(mk("ConfigMap", "a", "ns1"))
        with pytest.raises(side.k.ConflictError):
            c.create(mk("ConfigMap", "a", "ns1"))
        return raised(c.create, mk("ConfigMap", "a", "ns1"))

    hold(SIDES, side, script)


@BY_SIDE
def test_label_selector_globs(side):
    def script(side):
        c = side.k.FakeClient()
        c.create(mk("Pod", "p1", "ns", {"app": "tpu-libtpu-daemonset"}))
        c.create(mk("Pod", "p2", "ns", {"app": "other"}))
        counts = [len(c.list("v1", "Pod", "ns", label_selector={"app": "tpu-*"})),
                  len(c.list("v1", "Pod", "ns", label_selector={"app": None})),
                  len(c.list("v1", "Pod", label_selector={"app": "other"}))]
        assert counts == [1, 2, 1]
        return counts

    hold(SIDES, side, script)


@BY_SIDE
def test_status_subresource_preserved_on_update(side):
    def script(side):
        c = side.k.FakeClient()
        obj = mk("Node", "n1")
        obj["status"] = {"capacity": {side.resource: "4"}}
        c.create(obj)
        node = c.get("v1", "Node", "n1")
        del node["status"]
        node["metadata"]["labels"] = {"x": "y"}
        updated = c.update(node)
        assert updated["status"]["capacity"][side.resource] == "4"
        return updated["metadata"], updated["status"]["capacity"][side.resource]

    hold(SIDES, side, script)


@BY_SIDE
def test_update_status(side):
    def script(side):
        c = side.k.FakeClient()
        c.create(mk("ClusterPolicy", "cp", api=side.cp_api))
        obj = c.get(side.cp_api, "ClusterPolicy", "cp")
        obj["status"] = {"state": "ready"}
        c.update_status(obj)
        got = c.get(side.cp_api, "ClusterPolicy", "cp")
        assert got["status"]["state"] == "ready"
        return got["status"], got["metadata"]["resourceVersion"]

    hold(SIDES, side, script)


@BY_SIDE
def test_watch_events(side):
    def script(side):
        c = side.k.FakeClient()
        events = []
        c.add_watcher(lambda e, o: events.append((e, o["metadata"]["name"])))
        c.create(mk("ConfigMap", "a", "ns"))
        c.update(c.get("v1", "ConfigMap", "a", "ns"))
        c.delete("v1", "ConfigMap", "a", "ns")
        assert events == [("ADDED", "a"), ("MODIFIED", "a"), ("DELETED", "a")]
        return events

    hold(SIDES, side, script)


@BY_SIDE
def test_apply_create_or_update(side):
    def script(side):
        c = side.k.FakeClient()
        c.apply(mk("ConfigMap", "a", "ns"))
        obj = mk("ConfigMap", "a", "ns")
        obj["data"] = {"x": "1"}
        c.apply(obj)
        got = c.get("v1", "ConfigMap", "a", "ns")
        assert got["data"] == {"x": "1"}
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_field_selector(side):
    def script(side):
        c = side.k.FakeClient()
        p = mk("Pod", "p1", "ns")
        p["spec"] = {"nodeName": "node-a"}
        c.create(p)
        counts = [len(c.list("v1", "Pod", "ns", field_selector={"spec.nodeName": n})) for n in ("node-a", "node-b")]
        assert counts == [1, 0]
        return counts

    hold(SIDES, side, script)


@BY_SIDE
def test_node_deletion_gcs_bound_pods_fake(side):
    """Deleting a Node removes the pods bound to it, as KubeSim does."""

    def script(side):
        client = side.k.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "ns"}},
                                    {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "doomed"}}])
        for name, node in (("on-doomed", "doomed"), ("elsewhere", "other")):
            client.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": "ns"},
                           "spec": {"nodeName": node}})
        client.delete("v1", "Node", "doomed")
        left = [client.get_or_none("v1", "Pod", n, "ns") is not None for n in ("on-doomed", "elsewhere")]
        assert left == [False, True]
        return left

    hold(SIDES, side, script)


class ScriptedClient:
    """get/update stub whose ``update`` raises the side's ConflictError
    ``conflicts`` times."""

    def __init__(self, side, conflicts):
        self.side, self.conflicts = side, conflicts
        self.gets = self.updates = 0
        self.obj = {"metadata": {"name": "n", "labels": {}}}

    def get(self, av, kind, name, namespace="", copy=False):
        self.gets += 1
        return deepcopy(self.obj)

    def update(self, obj):
        self.updates += 1
        if self.conflicts > 0:
            self.conflicts -= 1
            raise self.side.k.ConflictError("stale")
        self.obj = obj


@BY_SIDE
def test_mutate_with_retry_retries_conflicts(side):
    def script(side):
        c = ScriptedClient(side, conflicts=2)

        def mutate(node):
            node["metadata"]["labels"]["k"] = "v"
            return True

        out = side.k.mutate_with_retry(c, "v1", "Node", "n", mutate=mutate, backoff_s=0)
        assert out["metadata"]["labels"]["k"] == "v"
        assert c.gets == 3 and c.updates == 3  # a fresh GET before every attempt
        return deepcopy(out), c.gets, c.updates

    hold(SIDES, side, script)


@BY_SIDE
def test_mutate_with_retry_no_change_short_circuits(side):
    def script(side):
        c = ScriptedClient(side, conflicts=0)
        side.k.mutate_with_retry(c, "v1", "Node", "n", mutate=lambda node: False)
        assert c.updates == 0
        return c.gets, c.updates

    hold(SIDES, side, script)


@BY_SIDE
def test_mutate_with_retry_raises_after_budget(side):
    def script(side):
        c = ScriptedClient(side, conflicts=99)
        with pytest.raises(side.k.ConflictError):
            side.k.mutate_with_retry(c, "v1", "Node", "n", mutate=lambda n: True, backoff_s=0)
        assert c.updates == 5  # the attempt budget
        return c.gets, c.updates

    hold(SIDES, side, script)
