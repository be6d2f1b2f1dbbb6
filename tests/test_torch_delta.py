"""The port's event-scoped delta reconciliation (``controllers/delta.py``)
against the JAX package's, on 7 of the 9 cases of
``tests/test_delta_reconcile.py`` and two of the port's own: a crash-looping
``gpu-*`` operand pod routes where the reference's ``tpu-*`` pod does, and
a user pod does not; and the keys the watch echo of a slice pass's own
verdict write routes, which are the reference's.

Each case runs one script on both sides over paired worlds, compared as
``tests/test_torch_reconciler.py`` sets out (``both``); the router's keys
(node names and slice ids cross ``convert`` unchanged) are compared
exactly. The router's manager is a stub that records ``enqueue`` calls.
The reference's generation flip (the GKE accelerator label to a v5p slice)
is the port's product label to an H100 PCIe card: each changes the node's
variant, a cluster fact.

Left out: ``test_resync_safety_net_converges_dropped_delta`` and
``test_worker_pool_env_knobs``, which need ``main.build_manager`` and
``manager.Manager``, modules this package has not ported yet.
"""

import copy

from tests.conftest import make_tpu_node
from tests.test_torch_reconciler import (  # noqa: F401  (autouse fixtures)
    CPV, NS, PRODUCTS, SIDES, both, paired_clocks, pinned_clock)
from tpu_operator import consts as ref_consts
from tpu_operator.kube.testing import make_validator_pod
from tpu_operator_torch import consts
from tpu_operator_torch.controllers import delta

NODE = "fake-tpu-node-1"


class MgrStub:
    def __init__(self):
        self.enqueued = []

    def enqueue(self, key, delay=0.0):
        self.enqueued.append(key)

    def take(self):
        out, self.enqueued = self.enqueued, []
        return out


def world(w, names=(NODE,), topology="2x2"):
    for name in names:
        w.create(make_tpu_node(name, topology=topology))
    w.create_cr()
    w.rec = w.reconciler()
    return w


def converge(w, rounds=30):
    res = None
    for _ in range(rounds):
        res = w.rec.reconcile()
        w.side.testing.simulate_kubelet_once(w.client, NS, NODE)
        if res.ready:
            break
    assert res is not None and res.ready, "fake cluster never converged"


def router(w):
    world(w)
    w.mgr = MgrStub()
    w.router = w.side.delta.EventRouter(w.mgr, w.rec.delta, "cp", "upgrade")
    w.router.enabled = True  # independent of the env knob
    return w


def pod(w, name, app, node=NODE, phase="Running", crash=False):
    """A reference-shaped pod in the side's names (``convert`` maps an
    operand's app)."""
    status = {"phase": phase}
    if crash:
        status["containerStatuses"] = [{"ready": False, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]
    return w.side.obj({"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": name, "namespace": NS, "labels": {"app": app}},
                       "spec": {"nodeName": node}, "status": status})


# ---------------------------------------------------------------------------
# router predicates
# ---------------------------------------------------------------------------


def test_router_drops_noop_and_status_only_deliveries():
    def script(w):
        router(w)
        seen = []
        cp = w.client.get(CPV, "ClusterPolicy", "cluster-policy", copy=True)
        w.router.on_event("MODIFIED", cp)
        seen.append(w.mgr.take())
        cp2 = w.client.get(CPV, "ClusterPolicy", "cluster-policy", copy=True)
        cp2.setdefault("status", {})["state"] = "ready"
        cp2["metadata"]["resourceVersion"] = "999999"
        w.router.on_event("MODIFIED", cp2)
        seen.append(w.mgr.take())
        cp3 = w.client.get(CPV, "ClusterPolicy", "cluster-policy", copy=True)
        cp3["spec"]["metricsExporter"] = {"enabled": False}
        w.router.on_event("MODIFIED", cp3)
        seen.append(w.mgr.take())
        node = w.client.get("v1", "Node", NODE, copy=True)
        w.router.on_event("MODIFIED", node)
        seen.append(w.mgr.take())
        w.router.on_event("MODIFIED", node)
        seen.append(w.mgr.take())
        return seen, w.router.stats()["dropped_total"] >= 2

    ref, port = both(script)
    assert ref == port == ([["cp", "upgrade"], [], ["cp", "upgrade"], ["cp"], []], True)


def test_router_maps_events_to_minimal_keys():
    def script(w):
        router(w)
        node = w.client.get("v1", "Node", NODE, copy=True)
        w.router.on_event("MODIFIED", node)
        w.mgr.take()
        seen = []
        souring = copy.deepcopy(node)
        souring["status"]["capacity"] = {w.side.resource: "4"}
        souring["status"]["allocatable"] = {w.side.resource: "0"}
        w.router.on_event("MODIFIED", souring)
        seen.append(w.mgr.take())
        relabel = copy.deepcopy(souring)
        relabel["metadata"]["labels"][w.c.TPU_PRESENT_LABEL] = "stale"
        w.router.on_event("MODIFIED", relabel)
        seen.append(w.mgr.take())
        regen = copy.deepcopy(relabel)
        if w.side.name == "reference":
            regen["metadata"]["labels"][ref_consts.GKE_TPU_ACCELERATOR_LABEL] = "tpu-v5p-slice"
        else:
            regen["metadata"]["labels"][consts.GPU_PRODUCT_LABEL] = PRODUCTS["h100-pcie"]
        w.router.on_event("MODIFIED", regen)
        seen.append("cp" in w.mgr.take())
        w.router.on_event("DELETED", regen)
        seen.append(w.mgr.take())
        return seen

    ref, port = both(script)
    assert ref == port
    souring, relabel, regen, deleted = port
    assert souring == [(delta.SLICE_KIND, NODE)] and relabel == [(delta.NODE_KIND, NODE)] and regen
    assert "upgrade" in deleted and (delta.NODE_KIND, NODE) in deleted and "cp" not in deleted
    assert any(isinstance(k, tuple) and k[0] == delta.SLICE_KIND for k in deleted)


def test_router_routes_validator_pod_flips_to_slice_key():
    def script(w):
        router(w)
        w.router.on_event("MODIFIED", w.client.get("v1", "Node", NODE, copy=True))
        w.mgr.take()
        seen = []
        val = pod(w, "tpu-operator-validator-x", "tpu-operator-validator")
        w.router.on_event("MODIFIED", val)
        seen.append(w.mgr.take())
        w.router.on_event("MODIFIED", val)
        seen.append(w.mgr.take())
        w.router.on_event("MODIFIED", dict(val, status={"phase": "Pending"}))
        seen.append(w.mgr.take())
        w.router.on_event("MODIFIED", {"apiVersion": "v1", "kind": "Pod",
                                       "metadata": {"name": "web", "labels": {"app": "web"}},
                                       "spec": {"nodeName": NODE}})
        seen.append(w.mgr.take())
        return seen

    ref, port = both(script)
    assert ref == port == [[(delta.SLICE_KIND, NODE)], [], [(delta.SLICE_KIND, NODE)], []]


def test_crashlooping_operand_pod_routes_by_the_ports_prefix():
    """With remediation off, an operand pod's crash-loop flip routes to its
    slice's key: the reference's ``tpu-*`` pod and the port's ``gpu-*`` pod
    alike (``convert`` maps the app); a user pod's crash loop routes
    nowhere, and on the port neither does a pod under the reference's
    prefix."""

    def script(w):
        router(w)
        w.router.on_event("MODIFIED", w.client.get("v1", "Node", NODE, copy=True))
        w.mgr.take()
        seen = []
        for name, app in (("plugin", "tpu-device-plugin-daemonset"), ("train", "train")):
            w.router.on_event("MODIFIED", pod(w, name, app, crash=True))
            seen.append(w.mgr.take())
        return seen

    ref, port = both(script)
    assert ref == port == [[(delta.SLICE_KIND, NODE)], []]

    def literal(w):
        router(w)
        w.router.on_event("MODIFIED", w.client.get("v1", "Node", NODE, copy=True))
        w.mgr.take()
        stray = {"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "stray", "namespace": NS, "labels": {"app": "tpu-device-plugin-daemonset"}},
                 "spec": {"nodeName": NODE},
                 "status": {"phase": "Running", "containerStatuses": [
                     {"ready": False, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]}}
        w.router.on_event("MODIFIED", stray)
        return w.mgr.take()

    from tests.test_torch_reconciler import World

    assert literal(World(SIDES["port"])) == []


# ---------------------------------------------------------------------------
# targeted sub-reconciles: converge the keyed unit, never the fleet
# ---------------------------------------------------------------------------


def test_delta_node_step_restores_labels_without_full_pass():
    def script(w):
        world(w)
        converge(w)
        before = w.label(NODE, w.c.TPU_PRESENT_LABEL)
        passes = w.rec.passes_total
        node = w.client.get("v1", "Node", NODE, copy=True)
        del node["metadata"]["labels"][w.c.TPU_PRESENT_LABEL]
        w.client.update(node)
        w.rec.delta.reconcile_node(NODE)
        return (before, w.label(NODE, w.c.TPU_PRESENT_LABEL), w.rec.passes_total == passes,
                w.rec.delta.stats()["node_passes"] >= 1)

    assert both(script) == (("true", "true", True, True),) * 2


def test_delta_slice_flip_updates_verdict_and_status():
    def script(w):
        world(w)
        converge(w)
        w.create(make_validator_pod(NODE, True, NS))
        w.rec.reconcile()
        seen = [w.label(NODE, w.c.SLICE_READY_LABEL), w.cp()["status"]["slices"]["ready"]]
        passes = w.rec.passes_total
        pods = w.client.list("v1", "Pod", NS, label_selector={"app": w.side.ss.VALIDATOR_APP})
        assert pods
        w.client.delete("v1", "Pod", pods[0]["metadata"]["name"], NS)
        w.rec.delta.reconcile_slice(NODE)
        seen += [w.label(NODE, w.c.SLICE_READY_LABEL), w.cp()["status"]["slices"]["ready"]]
        w.create(make_validator_pod(NODE, True, NS))
        w.rec.delta.reconcile_slice(NODE)
        seen += [w.label(NODE, w.c.SLICE_READY_LABEL), w.cp()["status"]["slices"]["ready"]]
        return seen, w.rec.passes_total == passes, w.rec.delta.stats()["slice_passes"] >= 2

    ref, port = both(script)
    assert ref == port
    seen, no_full, counted = port
    assert seen == ["true", seen[1], "false", seen[1] - 1, "true", seen[1]] and seen[1] >= 1
    assert no_full and counted


def test_node_delete_prunes_stale_verdicts_at_event_speed():
    def script(w):
        world(w, ("fleet-a", "fleet-b"))
        converge(w)
        total = w.cp()["status"]["slices"]["total"]
        passes = w.rec.passes_total
        logged = w.rec.remediation._logged
        for key in (("fleet-b", "interlock"), ("fleet-b", "budget"), ("fleet-a", "pdb")):
            logged.add(key)
        w.client.delete("v1", "Node", "fleet-b")
        w.rec.delta.reconcile_node("fleet-b")
        return (total, [k in logged for k in (("fleet-b", "interlock"), ("fleet-b", "budget"), ("fleet-a", "pdb"))],
                w.cp()["status"]["slices"]["total"], w.rec.passes_total == passes)

    assert both(script) == ((2, [False, False, True], 1, True),) * 2


def test_delta_without_context_escalates_to_full():
    def script(w):
        world(w)
        woken = []
        w.rec.delta.wake_full = lambda delay=0.0: woken.append(delay)
        w.rec.delta.reconcile_node(NODE)
        return bool(woken), w.rec.delta.stats()["escalations"] >= 1

    assert both(script) == ((True, True),) * 2


def test_router_switch_is_the_ports_name(monkeypatch):
    """``GPU_DELTA_RECONCILE=0`` turns the port's router off; the
    reference's ``TPU_DELTA_RECONCILE`` does not reach it."""
    assert delta.DELTA_RECONCILE_ENV == "GPU_DELTA_RECONCILE"
    monkeypatch.setenv("TPU_DELTA_RECONCILE", "0")
    assert delta.delta_enabled() is True
    monkeypatch.setenv("GPU_DELTA_RECONCILE", "0")
    assert delta.delta_enabled() is False


def test_slice_verdict_echo_keys_match_the_reference():
    """The router's keys for the watch echo of a ``reconcile_slice`` that
    flips the slice's verdict labels. The world's ``FakeClient`` delivers
    each write to the router as it lands (``add_watcher``), before
    ``reconcile_slice`` has folded the new verdict into its mirror: the
    ordering a fast watch gives. Both packages echo the same keys, so the
    keys that reach the queue after a slice pass are a cost the port shares
    with the reference, not a port fault (ROADMAP queue 3 item 2)."""

    def script(w):
        router(w)
        converge(w)
        w.create(make_validator_pod(NODE, True, NS))
        w.rec.reconcile()
        w.client.add_watcher(lambda event, obj: w.router.on_event(event, copy.deepcopy(obj)))
        w.router.on_event("MODIFIED", w.client.get("v1", "Node", NODE, copy=True))
        pods = w.client.list("v1", "Pod", NS, label_selector={"app": w.side.ss.VALIDATOR_APP})
        seen = []
        for flip in ("false", "true"):
            if flip == "false":
                w.client.delete("v1", "Pod", pods[0]["metadata"]["name"], NS)
            else:
                w.create(make_validator_pod(NODE, True, NS))
            w.mgr.take()
            w.rec.delta.reconcile_slice(NODE)
            seen.append((w.label(NODE, w.c.SLICE_READY_LABEL), sorted(map(str, w.mgr.take()))))
        w.router.on_event("MODIFIED", w.client.get("v1", "Node", NODE, copy=True))
        seen.append(w.mgr.take())
        return seen

    ref, port = both(script)
    assert ref == port
    for (verdict, keys), want in zip(port[:2], ("false", "true")):
        assert verdict == want
        assert {str((delta.NODE_KIND, NODE)), str((delta.SLICE_KIND, NODE))} <= set(keys)
    assert port[2] == []  # once the mirror holds the verdict, a repeat is dropped


class ForeignSliceOwner:
    """The shard view of a replica that holds the full pass and every
    slice but ``foreign``'s, which another replica owns."""

    def __init__(self, foreign):
        self.foreign = foreign

    def owns_full_pass(self):
        return True

    def confirm_full_pass_owner(self):
        return True

    def owns_slice(self, sid):
        return sid != self.foreign

    covers_slice = owns_slice
    owns_node_name = owns_slice


def test_full_pass_keeps_the_owners_ingested_verdict():
    """A full pass whose own view of another replica's slice lags the
    owner's verdict (no validator pod seen there yet) no longer drops the
    verdict it ingested: ``status.slices`` keeps the slice ready until
    the owner says otherwise. The reference's ``note_full_pass`` clears
    the ingested verdicts and its status write puts the slice back among
    the degraded, where it stays until the next full pass; the sharded
    leader-kill run then counts the new owner's correcting write."""
    from tests.test_torch_reconciler import World

    def script(w):
        world(w, ("fleet-a", "fleet-b"))
        converge(w)
        w.create(make_validator_pod("fleet-a", True, NS))
        w.rec.reconcile()
        w.rec.shard_state = ForeignSliceOwner("fleet-b")
        seen = [w.cp()["status"]["slices"]]
        w.rec.delta.ingest_foreign_verdict("fleet-b", True)
        seen.append(w.cp()["status"]["slices"])
        w.rec.reconcile()
        seen.append(w.cp()["status"]["slices"])
        w.rec.delta.ingest_foreign_verdict("fleet-b", False)
        seen.append(w.cp()["status"]["slices"])
        return seen

    degraded = {"total": 2, "ready": 1, "degraded": ["fleet-b"]}
    ready = {"total": 2, "ready": 2}
    assert script(World(SIDES["reference"])) == [degraded, ready, degraded, degraded]
    assert script(World(SIDES["port"])) == [degraded, ready, ready, degraded]
