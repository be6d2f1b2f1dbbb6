"""The port's labels-only merge patch against the JAX package's, on the 14
cases of ``tests/test_patch_labels.py``: ``FakeClient``'s native merge
(set and delete, the no-op that keeps the resourceVersion, the
unconditional last writer, the conditional 409, 404), the base
``Client``'s read-modify-write fallback, the HTTP PATCH against KubeSim
(merge, last writer, 409, 404, the MODIFIED watch event), the pause
override that survives the operator's stale label decision, and the
``CachedClient``'s write-through.

Each case runs on each package (``two_sided.hold``) with the same objects
(the reference's TPU node, the port's H100 node, one name for both) and
the reference's assertions made on each side; the labels, the
resourceVersion moves, the events and the error class names must be
equal. The race case reconciles the reference's sample CR, given to the
port through ``convert.clusterpolicy_from_reference``, over each side's
own assets; its deploy and presence labels are each side's ``consts``.
Tolerance: exact equality. Every wait has a limit of 60 s; every server
stops in a ``finally``.
"""

import os
import threading
from types import SimpleNamespace

import pytest
import yaml

from tests.two_sided import BY_SIDE, hold
from tpu_operator import consts as ref_consts
from tpu_operator.controllers import state_manager as ref_sm
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator_torch import consts, convert
from tpu_operator_torch.controllers import state_manager as sm
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import kubesim, testing
from tpu_operator_torch.kube.cache import CachedClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"

SIDES = {
    "reference": SimpleNamespace(
        name="reference", k=ref_kclient, kubesim=ref_kubesim, CachedClient=RefCachedClient, testing=ref_testing,
        consts=ref_consts, sm=ref_sm, node=ref_testing.make_tpu_node, driver=ref_consts.COMPONENT_LIBTPU,
        assets=os.path.join(REPO, "assets"), cr=lambda cr: cr),
    "port": SimpleNamespace(
        name="port", k=kclient, kubesim=kubesim, CachedClient=CachedClient, testing=testing, consts=consts,
        sm=sm, node=testing.make_gpu_node, driver=consts.COMPONENT_DRIVER,
        assets=os.path.join(REPO, "tpu_operator_torch", "assets"), cr=convert.clusterpolicy_from_reference),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def node(name, labels=None):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": dict(labels or {})}}


def rv(client, name="n1"):
    return client.get("v1", "Node", name)["metadata"]["resourceVersion"]


# --- FakeClient's native merge -----------------------------------------------

@BY_SIDE
def test_fake_client_patch_labels_sets_and_deletes(side):
    def script(side):
        client = side.k.FakeClient([node("n1", {"keep": "x", "drop": "y"})])
        labels = client.patch_labels("v1", "Node", "n1", labels={"added": "1", "drop": None})["metadata"]["labels"]
        assert labels == {"keep": "x", "added": "1"}
        assert client.get("v1", "Node", "n1")["metadata"]["labels"] == labels
        return labels

    hold(SIDES, side, script)


@BY_SIDE
def test_fake_client_patch_labels_noop_does_not_bump_rv(side):
    def script(side):
        client = side.k.FakeClient([node("n1", {"a": "1"})])
        before = rv(client)
        out = client.patch_labels("v1", "Node", "n1", labels={"a": "1"})
        assert out["metadata"]["resourceVersion"] == before
        return before

    hold(SIDES, side, script)


@BY_SIDE
def test_fake_client_unconditional_patch_is_last_writer_wins(side):
    def script(side):
        client = side.k.FakeClient([node("n1", {"a": "1"})])
        other = client.get("v1", "Node", "n1")
        other["metadata"]["labels"]["other-writer"] = "yes"
        client.update(other)  # the rv moved under us
        labels = client.patch_labels("v1", "Node", "n1", labels={"mine": "too"})["metadata"]["labels"]
        assert labels == {"a": "1", "other-writer": "yes", "mine": "too"}
        return labels

    hold(SIDES, side, script)


@BY_SIDE
def test_fake_client_conditional_patch_conflicts_on_stale_rv(side):
    def script(side):
        client = side.k.FakeClient([node("n1", {"a": "1"})])
        seen = rv(client)
        other = client.get("v1", "Node", "n1")
        other["metadata"]["labels"]["other-writer"] = "yes"
        client.update(other)
        with pytest.raises(side.k.ConflictError):
            client.patch_labels("v1", "Node", "n1", labels={"mine": "too"}, resource_version=seen)
        labels = client.patch_labels("v1", "Node", "n1", labels={"mine": "too"},
                                     resource_version=rv(client))["metadata"]["labels"]  # the fresh rv lands
        assert labels["mine"] == "too" and labels["other-writer"] == "yes"
        return labels

    hold(SIDES, side, script)


@BY_SIDE
def test_fake_client_patch_labels_not_found(side):
    def script(side):
        with pytest.raises(side.k.NotFoundError) as err:
            side.k.FakeClient().patch_labels("v1", "Node", "ghost", labels={"a": "1"})
        return type(err.value).__name__

    hold(SIDES, side, script)


# --- the base Client's fallback ----------------------------------------------

def minimal(side, inner):
    """A ``Client`` of the side with only get/update, so the base class's
    read-modify-write ``patch_labels`` is what runs."""

    class MinimalClient(side.k.Client):
        def get(self, api_version, kind, name, namespace="", copy=False):
            return inner.get(api_version, kind, name, namespace, copy=copy)

        def update(self, obj):
            return inner.update(obj)

    return MinimalClient()


@BY_SIDE
def test_base_client_fallback_applies_delta(side):
    def script(side):
        inner = side.k.FakeClient([node("n1", {"keep": "x", "drop": "y"})])
        updated = minimal(side, inner).patch_labels("v1", "Node", "n1", labels={"added": "1", "drop": None})
        assert updated["metadata"]["labels"] == {"keep": "x", "added": "1"}
        assert inner.get("v1", "Node", "n1")["metadata"]["labels"] == {"keep": "x", "added": "1"}
        return updated["metadata"]

    hold(SIDES, side, script)


@BY_SIDE
def test_base_client_fallback_noop_short_circuits(side):
    def script(side):
        inner = side.k.FakeClient([node("n1", {"a": "1"})])
        before = rv(inner)
        minimal(side, inner).patch_labels("v1", "Node", "n1", labels={"a": "1"})
        assert rv(inner) == before
        return before

    hold(SIDES, side, script)


# --- the HTTP PATCH against KubeSim ------------------------------------------

def over_the_wire(fn):
    """``fn(side, client, server)`` with a KubeSim of the side holding
    node ``n1``; the server stops in a ``finally``."""

    def script(side, *args):
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim()).start()
        try:
            client = side.kubesim.make_client(server.port)
            client.create(side.node("n1"))
            return fn(side, client, server, *args)
        finally:
            server.stop()

    script.__qualname__ = fn.__qualname__
    return script


@BY_SIDE
def test_kubesim_patch_labels_wire(side):
    @over_the_wire
    def script(side, client, server):
        before = rv(client)
        present = side.consts.TPU_PRESENT_LABEL
        labels = {present: "true", "kubernetes.io/hostname": None}
        updated = client.patch_labels("v1", "Node", "n1", labels=labels)
        got = updated["metadata"]["labels"]
        assert got[present] == "true"
        assert "kubernetes.io/hostname" not in got
        # only the labels changed; the rest of the node survived the merge
        assert updated["status"]["nodeInfo"]["containerRuntimeVersion"].startswith("containerd")
        assert updated["metadata"]["resourceVersion"] != before
        assert server.sim.requests_total() > 0  # a PATCH counts as a request
        return got[present], "kubernetes.io/hostname" in got

    hold(SIDES, side, script)


@BY_SIDE
def test_kubesim_unconditional_patch_is_last_writer_wins(side):
    @over_the_wire
    def script(side, client, server):
        other = client.get("v1", "Node", "n1")
        other["metadata"]["labels"]["other"] = "writer"
        client.update(other)
        labels = client.patch_labels("v1", "Node", "n1", labels={"mine": "too"})["metadata"]["labels"]
        assert labels["other"] == "writer" and labels["mine"] == "too"
        return labels["other"], labels["mine"]

    hold(SIDES, side, script)


@BY_SIDE
def test_kubesim_conditional_patch_conflicts_on_stale_rv(side):
    @over_the_wire
    def script(side, client, server):
        seen = rv(client)
        other = client.get("v1", "Node", "n1")
        other["metadata"]["labels"]["other"] = "writer"
        client.update(other)
        with pytest.raises(side.k.ConflictError) as err:
            client.patch_labels("v1", "Node", "n1", labels={"mine": "too"}, resource_version=seen)
        return type(err.value).__name__, "mine" in client.get("v1", "Node", "n1")["metadata"]["labels"]

    hold(SIDES, side, script)


@BY_SIDE
def test_kubesim_patch_missing_object_404(side):
    @over_the_wire
    def script(side, client, server):
        with pytest.raises(side.k.NotFoundError) as err:
            client.patch_labels("v1", "Node", "ghost", labels={"a": "1"})
        return type(err.value).__name__

    hold(SIDES, side, script)


@BY_SIDE
def test_kubesim_patch_emits_modified_watch_event(side):
    @over_the_wire
    def script(side, client, server):
        got = []
        stop = threading.Event()
        t = threading.Thread(target=client.watch,
                             args=("v1", "Node", lambda e, o: got.append((e, o["metadata"]["name"]))),
                             kwargs={"stop_event": stop}, daemon=True)
        t.start()
        try:
            assert testing.wait_until(lambda: ("ADDED", "n1") in got, 60)
            client.patch_labels("v1", "Node", "n1", labels={"patched": "true"})
            assert testing.wait_until(lambda: ("MODIFIED", "n1") in got, 60)
        finally:
            stop.set()
        return sorted(set(got))

    hold(SIDES, side, script)


# --- the race the conditional patch exists for ---------------------------------

@BY_SIDE
def test_concurrent_pause_override_survives_label_race(side):
    """An admin pauses an operand (its deploy label "false") between the
    operator's read and its label write. The operator's stale non-forced
    apply conflicts, the retry recomputes from the fresh node, and the
    pause is never reverted; the other labels still converge."""

    def script(side):
        c = side.consts
        paused_key = c.DEPLOY_LABEL_PREFIX + c.COMPONENT_DEVICE_PLUGIN

        class RacingClient:
            """The first batched label apply naming the deploy key loses
            the race to the admin's pause."""

            def __init__(self, inner):
                self._inner = inner
                self.raced = False

            def apply_ssa_batch(self, items, **kw):
                named = [obj for obj, _ in (i if isinstance(i, tuple) else (i, False) for i in items)
                         if paused_key in (obj.get("metadata", {}).get("labels") or {})]
                if not self.raced and named:
                    self.raced = True
                    self._inner.patch_labels("v1", "Node", named[0]["metadata"]["name"],
                                             labels={paused_key: "false"})
                return self._inner.apply_ssa_batch(items, **kw)

            def __getattr__(self, attr):
                return getattr(self._inner, attr)

        inner = side.k.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                                   side.node("race-node")])
        with open(os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")) as f:
            cr = yaml.safe_load(f)
        cr["metadata"]["uid"] = "race-uid"
        inner.create(side.cr(cr))
        client = RacingClient(inner)
        ctrl = side.sm.ClusterPolicyController(client, assets_dir=side.assets)
        ctrl.init(inner.get(f"{c.GROUP}/v1", "ClusterPolicy", "cluster-policy"))
        assert client.raced, "the race injection never fired"
        labels = inner.get("v1", "Node", "race-node")["metadata"]["labels"]
        got = (labels[paused_key], labels[c.TPU_PRESENT_LABEL], labels[c.DEPLOY_LABEL_PREFIX + side.driver])
        assert got == ("false", "true", "true"), "a stale delta reverted the pause"
        return got

    hold(SIDES, side, script)


# --- the CachedClient's write-through ------------------------------------------

@BY_SIDE
def test_cached_client_patch_labels_writes_through(side):
    def script(side):
        client = side.k.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
                                    node("n1", {"a": "1"})])
        cached = side.CachedClient(client, namespace=NS)
        assert cached.start_informers() is True
        try:
            updated = cached.patch_labels("v1", "Node", "n1", labels={"b": "2", "a": None})
            assert updated["metadata"]["labels"] == {"b": "2"}
            seen = cached.get("v1", "Node", "n1")["metadata"]["labels"]  # visible at once
            assert seen == {"b": "2"}
            return dict(seen)
        finally:
            cached.stop()

    hold(SIDES, side, script)
