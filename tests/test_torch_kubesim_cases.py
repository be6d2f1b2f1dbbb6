"""KubeSim's API-server semantics on the port against the JAX package's,
on the 12 cases of ``tests/test_kubesim.py`` that
``tests/test_torch_kubesim.py``'s cross-wire matrix does not drive: a
watch that resumes across expiries without a re-list, the validator's
workload pod over the wire, a node's deletion taking its pods, every asset
manifest admitted, evictions under budgets (``minAvailable``, a
percent ``maxUnavailable``, a malformed and a fractional budget failing
closed), set-based selectors, a status-less PUT that keeps status, Event
TTL expiry, and ``_scaled``'s fail-closed contract.

Each case runs on each package (``two_sided.hold``), on the side's own
KubeSim through the side's own ``RestClient``, with the same objects and
the reference's assertions made on each side; the outcomes (names, events,
statuses, error class names and their messages' key words) must be equal.
The workload pod is each side's own (the reference's JAX pod, the port's
CUDA pod) and owned by each side's validator DaemonSet; its card resource
and the asset directories are each side's. Tolerance: exact equality.
Every wait has a limit of 60 s; no time is asserted; every server stops in
a ``finally``.
"""

import os
import threading
import time
from types import SimpleNamespace

import pytest
import yaml

from tests.two_sided import BY_SIDE, hold
from tpu_operator import consts as ref_consts
from tpu_operator.controllers import resource_manager as ref_rm
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import disruption as ref_disruption
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import rest as ref_rest
from tpu_operator.validator import workload_pods as ref_wp
from tpu_operator_torch import consts, convert
from tpu_operator_torch.controllers import resource_manager as rm
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import disruption, kubesim, rest, testing
from tpu_operator_torch.validator import workload_pods as wp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"

SIDES = {
    "reference": SimpleNamespace(
        name="reference", kubesim=ref_kubesim, k=ref_kclient, rest=ref_rest, rm=ref_rm, d=ref_disruption,
        workload_pod=ref_wp.jax_workload_pod, run_to_completion=ref_wp.run_to_completion,
        validator_app="tpu-operator-validator", resource=convert.REF_TPU_RESOURCE,
        assets=os.path.join(REPO, "assets"), consts=ref_consts),
    "port": SimpleNamespace(
        name="port", kubesim=kubesim, k=kclient, rest=rest, rm=rm, d=disruption,
        workload_pod=wp.cuda_workload_pod, run_to_completion=wp.run_to_completion,
        validator_app=consts.VALIDATOR_APP, resource=consts.GPU_RESOURCE,
        assets=os.path.join(REPO, "tpu_operator_torch", "assets"), consts=consts),
}


def wait_until(pred, timeout_s=60.0):
    return testing.wait_until(pred, timeout_s, 0.05)


def on_cluster(fn):
    """``fn(side, server, client)`` on a fresh KubeSim of the side holding
    the namespace (the reference's ``cluster`` fixture)."""

    def script(side, *args):
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=0.3)).start()
        try:
            client = side.kubesim.make_client(server.port)
            client.GET_RETRY_BACKOFF_S = 0.01
            client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}})
            return fn(side, server, client, *args)
        finally:
            server.stop()

    script.__qualname__ = fn.__qualname__
    return script


def watching(client, kind, got, stop, **kw):
    t = threading.Thread(target=client.watch, args=("v1", kind, lambda e, o: got.append((e, o["metadata"]["name"]))),
                         kwargs=dict(namespace=NS, stop_event=stop, **kw), daemon=True)
    t.start()
    return t


@BY_SIDE
def test_watch_resumes_without_relist_on_expiry(side):
    """A stream that expires cleanly resumes from its last resourceVersion:
    no re-list, no second ADDED."""

    @on_cluster
    def script(side, server, client):
        client.create({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "r1", "namespace": NS}})
        events, stop = [], threading.Event()
        watching(client, "ConfigMap", events, stop, timeout_s=1)  # expires every second
        try:
            assert wait_until(lambda: ("ADDED", "r1") in events)
            time.sleep(3.2)  # ride across about three expiries with no change
            assert events.count(("ADDED", "r1")) == 1, events
            client.create({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "r2", "namespace": NS}})
            assert wait_until(lambda: ("ADDED", "r2") in events)
            assert events.count(("ADDED", "r1")) == 1, events
            return events.count(("ADDED", "r1")), ("ADDED", "r2") in events
        finally:
            stop.set()

    hold(SIDES, side, script)


@BY_SIDE
def test_validator_workload_pod_spawn_over_the_wire(side):
    """The validation's workload pod survives admission, is run to
    Succeeded, carries the card's toleration and limit and its owner
    reference to the validator DaemonSet, and goes with it."""

    @on_cluster
    def script(side, server, client):
        ds = client.create({"apiVersion": "apps/v1", "kind": "DaemonSet",
                            "metadata": {"name": side.validator_app, "namespace": NS},
                            "spec": {"selector": {"matchLabels": {"app": side.validator_app}}}})
        pod = side.workload_pod("card-node-1", NS)
        pod_name = pod["metadata"]["name"]

        def kubelet_runs_pod():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                live = client.get_or_none("v1", "Pod", pod_name, NS)
                if live is not None:
                    live["status"] = {"phase": "Succeeded"}
                    client.update_status(live)
                    return
                time.sleep(0.05)

        threading.Thread(target=kubelet_runs_pod, daemon=True).start()
        phase = side.run_to_completion(client, pod, retries=600, sleep_s=0.1)
        assert phase == "Succeeded"
        live = client.get("v1", "Pod", pod_name, NS)
        assert live["metadata"]["ownerReferences"][0]["uid"] == ds["metadata"]["uid"]
        assert live["spec"]["tolerations"][0]["key"] == side.resource
        assert live["spec"]["containers"][0]["resources"]["limits"][side.resource] == "1"
        client.delete("apps/v1", "DaemonSet", side.validator_app, NS)  # GC takes the pod
        gone = client.get_or_none("v1", "Pod", pod_name, NS) is None
        assert gone
        return phase, live["metadata"]["ownerReferences"][0]["kind"], gone

    hold(SIDES, side, script)


@BY_SIDE
def test_node_deletion_gcs_bound_pods(side):
    @on_cluster
    def script(side, server, client):
        client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "doomed"}})
        for name, node in (("on-doomed", "doomed"), ("elsewhere", "other")):
            client.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": NS},
                           "spec": {"nodeName": node}})
        client.delete("v1", "Node", "doomed")
        left = [client.get_or_none("v1", "Pod", n, NS) is not None for n in ("on-doomed", "elsewhere")]
        assert left == [False, True]
        return left

    hold(SIDES, side, script)


@BY_SIDE
def test_every_asset_manifest_is_server_admissible(side):
    """Every manifest of every state directory of the side's assets, the
    OpenShift ones too, is created on a KubeSim of the side."""

    def script(side):
        state_dirs = sorted(os.path.join(side.assets, d) for d in os.listdir(side.assets)
                            if os.path.isdir(os.path.join(side.assets, d)))
        assert len(state_dirs) >= 17, state_dirs
        kinds = {}
        for state_dir in state_dirs:
            server = side.kubesim.KubeSimServer(side.kubesim.KubeSim()).start()
            try:
                client = side.kubesim.make_client(server.port)
                client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}})
                for path in side.rm.get_assets_from(state_dir, openshift=True):
                    with open(path) as f:
                        docs = [d for d in yaml.safe_load_all(f) if d]
                    assert docs, f"{path}: no documents"
                    for obj in docs:
                        kind = obj.get("kind")
                        assert kind in side.rest.KIND_TABLE, f"{path}: unknown kind {kind!r}"
                        if side.rest.KIND_TABLE[kind][1]:
                            obj.setdefault("metadata", {})["namespace"] = NS
                        assert client.create(obj)["metadata"]["uid"], path
                        kinds[kind] = kinds.get(kind, 0) + 1
            finally:
                server.stop()
        assert sum(kinds.values()) >= 60, kinds
        return len(state_dirs), kinds

    hold(SIDES, side, script)


def workload_pod(name, labels=None, ready=True):
    return {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": NS, "labels": labels or {}},
            "spec": {"nodeName": "n1"},
            "status": {"phase": "Running" if ready else "Pending",
                       "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


def pdb(name, spec):
    return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": {"name": name, "namespace": NS}, "spec": spec}


def evicted(side, client, name):
    """``evict``'s outcome: "evicted", or the error's class and the key
    words of its message."""
    try:
        client.evict(name, NS)
    except side.k.EvictionBlockedError as e:
        return type(e).__name__, [w for w in ("disruption budget", "malformed") if w in str(e)]
    with pytest.raises(side.k.NotFoundError):
        client.get("v1", "Pod", name, NS)
    return "evicted"


@BY_SIDE
def test_eviction_respects_pdb_min_available(side):
    @on_cluster
    def script(side, server, client):
        for i in range(2):
            client.create(workload_pod(f"train-{i}", labels={"app": "train"}))
        client.create(pdb("train-pdb", {"minAvailable": 2, "selector": {"matchLabels": {"app": "train"}}}))
        trail = [evicted(side, client, "train-0")]
        assert trail[-1][0] == "EvictionBlockedError" and "disruption budget" in trail[-1][1]
        assert client.get("v1", "Pod", "train-0", NS) is not None
        client.create(workload_pod("other", labels={"app": "other"}))
        trail.append(evicted(side, client, "other"))  # outside the selector
        budget = client.get("policy/v1", "PodDisruptionBudget", "train-pdb", NS)
        budget["spec"]["minAvailable"] = 1
        client.update(budget)
        trail.append(evicted(side, client, "train-0"))  # the looser budget lets one go
        trail.append(evicted(side, client, "train-1"))  # at the floor again
        assert trail[1:3] == ["evicted", "evicted"] and trail[3][0] == "EvictionBlockedError"
        return trail

    hold(SIDES, side, script)


@BY_SIDE
def test_eviction_respects_pdb_max_unavailable_percent(side):
    @on_cluster
    def script(side, server, client):
        for i in range(4):
            client.create(workload_pod(f"w-{i}", labels={"app": "w"}, ready=(i != 3)))
        client.create(pdb("w-pdb", {"maxUnavailable": "25%", "selector": {
            "matchExpressions": [{"key": "app", "operator": "In", "values": ["w"]}]}}))
        # 25% of 4 is one disruption, taken by the unready pod
        trail = [evicted(side, client, "w-0")]
        assert trail[0][0] == "EvictionBlockedError"
        p = client.get("v1", "Pod", "w-3", NS)
        p["status"] = {"phase": "Running", "conditions": [{"type": "Ready", "status": "True"}]}
        client.update(p)
        trail.append(evicted(side, client, "w-0"))  # the unready pod recovered
        assert trail[1] == "evicted"
        return trail

    hold(SIDES, side, script)


@BY_SIDE
def test_set_based_label_selectors(side):
    @on_cluster
    def script(side, server, client):
        for name, labels in (("a", {"app": "train", "tier": "gpu"}), ("b", {"app": "batch"}),
                             ("c", {"app": "serve", "tier": "tpu"})):
            client.create({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": name, "namespace": NS, "labels": labels}, "spec": {}})

        def names(sel):
            return sorted(p["metadata"]["name"] for p in client.list("v1", "Pod", NS, label_selector=sel))

        cases = [("app in (train, batch)", ["a", "b"]), ("app notin (train)", ["b", "c"]), ("!tier", ["b"]),
                 ("tier", ["a", "c"]), ("app!=batch", ["a", "c"]), ("app in (train,serve), tier", ["a", "c"]),
                 ({"app": ["train", "serve"]}, ["a", "c"]), ({"!tier": None}, ["b"])]
        got = [names(sel) for sel, _ in cases]
        assert got == [want for _, want in cases]
        with pytest.raises(RuntimeError) as err:  # a malformed selector is a 400, not an empty list
            client.list("v1", "Pod", NS, label_selector="app in train)")
        return got, type(err.value).__name__

    hold(SIDES, side, script)


@BY_SIDE
def test_statusless_put_preserves_status(side):
    @on_cluster
    def script(side, server, client):
        client.create({"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": "op", "namespace": NS},
                       "spec": {"template": {"spec": {}}}})
        live = client.get("apps/v1", "DaemonSet", "op", NS)
        live["status"] = {"desiredNumberScheduled": 3, "numberUnavailable": 0}
        client.update_status(live)
        rv = client.get("apps/v1", "DaemonSet", "op", NS)["metadata"]["resourceVersion"]
        rendered = {"apiVersion": "apps/v1", "kind": "DaemonSet",
                    "metadata": {"name": "op", "namespace": NS, "resourceVersion": rv},
                    "spec": {"template": {"spec": {"x": "new"}}}}
        updated = client.update(rendered)
        kept = updated["status"]
        assert kept == {"desiredNumberScheduled": 3, "numberUnavailable": 0}, "a status-less PUT wiped status"
        updated["status"] = {"desiredNumberScheduled": 5}
        carried = client.update(updated)["status"]["desiredNumberScheduled"]  # a PUT with status writes it
        assert carried == 5
        return kept, carried

    hold(SIDES, side, script)


@BY_SIDE
def test_eviction_malformed_pdb_blocks_not_500(side):
    """A malformed percent fails closed: a veto naming it, never a 500."""

    @on_cluster
    def script(side, server, client):
        client.create(workload_pod("victim", labels={"app": "bad"}))
        client.create(pdb("bad-pdb", {"minAvailable": "10.5%", "selector": {"matchLabels": {"app": "bad"}}}))
        out = evicted(side, client, "victim")
        assert out[0] == "EvictionBlockedError" and "malformed" in out[1]
        assert client.get("v1", "Pod", "victim", NS) is not None
        return out

    hold(SIDES, side, script)


@BY_SIDE
def test_eviction_float_pdb_blocks_not_truncates(side):
    """``minAvailable: 1.5`` takes the malformed budget's fail-closed
    path; truncating it to 1 would weaken the budget."""

    @on_cluster
    def script(side, server, client):
        client.create(workload_pod("fvictim", labels={"app": "floaty"}))
        client.create(pdb("float-pdb", {"minAvailable": 1.5, "selector": {"matchLabels": {"app": "floaty"}}}))
        out = evicted(side, client, "fvictim")
        assert out[0] == "EvictionBlockedError" and "malformed" in out[1]
        assert client.get("v1", "Pod", "fvictim", NS) is not None
        return out

    hold(SIDES, side, script)


@BY_SIDE
def test_event_ttl_expiry(side):
    """An untouched Event expires; one whose count is bumped does not;
    expiry reaches watch streams as DELETED."""

    @on_cluster
    def script(side, server, client):
        server.sim.event_ttl_s = 0.4

        def ev(name):
            return {"apiVersion": "v1", "kind": "Event", "metadata": {"name": name, "namespace": NS},
                    "reason": "Test", "message": "m", "type": "Normal", "count": 1}

        client.create(ev("stale-ev"))
        client.create(ev("fresh-ev"))

        def names():
            return {e["metadata"]["name"] for e in client.list("v1", "Event", NS)}

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and "stale-ev" in names():
            cur = client.get("v1", "Event", "fresh-ev", NS)  # keep touching fresh-ev
            cur["count"] = int(cur.get("count", 1)) + 1
            try:
                client.update(cur)
            except side.k.ConflictError:
                pass
            time.sleep(0.1)
        left = sorted(names())
        assert "stale-ev" not in left, "an event outlived its TTL"
        assert "fresh-ev" in left, "a touched event must not expire"
        got, stop = [], threading.Event()
        watching(client, "Event", got, stop)
        try:
            assert wait_until(lambda: ("ADDED", "fresh-ev") in got)
            server.sim.event_ttl_s = 0.2
            assert wait_until(lambda: ("DELETED", "fresh-ev") in got), "TTL expiry must reach watches as DELETED"
        finally:
            stop.set()
        return left, ("DELETED", "fresh-ev") in got

    hold(SIDES, side, script)


@BY_SIDE
def test_scaled_budget_rejects_non_integral_and_inf(side):
    def script(side):
        cases = [(1.5, None), (float("inf"), None), (float("-inf"), None), (float("nan"), None),
                 (2.0, 2), ("50%", 2), (3, 3)]
        got = [side.d._scaled(v, 4) for v, _ in cases]
        assert got == [want for _, want in cases]
        return got

    hold(SIDES, side, script)
