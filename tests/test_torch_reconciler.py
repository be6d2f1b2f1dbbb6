"""The port's ClusterPolicy reconciler (``controllers/clusterpolicy_controller.py``)
against the JAX package's, on the 12 cases of ``tests/test_reconciler.py``,
``test_events_and_status.py::test_reconcile_emits_events_and_conditions``,
``test_slice_status.py::test_reconcile_status_includes_slices`` and
``test_render_cache.py::test_slice_memo_key_invalid_when_node_world_moved``,
and the port's own predicate cases.

Each case runs one script on both sides over paired worlds, as
``tests/test_torch_upgrade.py`` sets out: the reference's objects are built
with the reference's own fixtures and cross to the port through
``convert`` (a TPU node becomes an H100 node of the paired variant,
``VARIANTS``; the ClusterPolicy through ``clusterpolicy_from_reference``),
the reference reads its repo's ``assets/``, the port its package's. After
the script each side's world is compared through ``convert`` (``view``):
every node's labels (those no node factory writes), annotations, taints
and ``unschedulable``; the operand pods by app, node and phase; every
eviction and deletion (sorted: the two packages' operand names sort
differently); the Events (type, reason, object, message and
count); each ClusterPolicy's status and rollout ledger. Tolerance: exact
equality apart from the renames (``libtpu``→``driver`` as a word and as the
ledger's kind, ``google.com/tpu``→``nvidia.com/gpu``, ``TPU``→``GPU`` in a
message) and what comes from the clock or the card: condition
``lastTransitionTime``, the ledger's ``*At`` stamps and the nodes' ``*-since``
stamps are held to their properties (present alike, parseable, inside the
case's window); a validator-perf reading is held as its ratio to the side's
healthy reading (the port's simulated fleet publishes the card's datasheet
rates, the reference fixed rates of its own chip), and the numbers inside an
evidence string are masked; a flight dump's path is masked. Both sides'
Event correlators write every record through
(``EVENT_REFRESH_INTERVAL_S`` 0), both flight recorders dump without a rate
limit, and both rollout modules' ``_iso_now`` read one clock.
"""

import copy
import json
import os
import re
import time
from datetime import datetime, timezone
from types import SimpleNamespace

import pytest
import yaml

from tests import test_torch_state_machine as tsm
from tests import test_torch_upgrade as tu
from tests.conftest import make_cpu_node, make_tpu_node
from tests.test_torch_upgrade import pinned_clock  # noqa: F401  (autouse fixture)
from tpu_operator import consts as ref_consts
from tpu_operator.controllers import clusterpolicy_controller as ref_cpc
from tpu_operator.controllers import delta as ref_delta
from tpu_operator.controllers import rollout as ref_ro
from tpu_operator.controllers import state_manager as ref_sm
from tpu_operator.kube import events as ref_events
from tpu_operator.kube import testing as ref_testing
from tpu_operator.obs import flight as ref_flight
from tpu_operator.obs import trace as ref_trace
from tpu_operator.upgrade import upgrade_controller as ref_uc
from tpu_operator_torch import consts, convert
from tpu_operator_torch.api.v1.clusterpolicy_types import State
from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
from tpu_operator_torch.controllers import delta
from tpu_operator_torch.controllers import rollout as ro
from tpu_operator_torch.controllers import state_manager as sm
from tpu_operator_torch.kube import events
from tpu_operator_torch.kube import testing
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import trace
from tpu_operator_torch.upgrade import upgrade_controller as uc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ASSETS = os.path.join(REPO, "assets")
NS = tu.NS
CPV = consts.API_VERSION
# reference generation -> the port's card variant, and its product label
VARIANTS = {"v5e": "h100-sxm", "v5p": "h100-pcie"}
PRODUCTS = {"h100-sxm": testing.DEFAULT_PRODUCT, "h100-pcie": "NVIDIA-H100-PCIe"}
# the ledger's clock stamps
LEDGER_STAMPS = ("createdAt", "stageStartedAt", "stageRolledAt", "completedAt", "rolledBackAt", "pausedAt")


def ref_cr(name="cluster-policy", edit=None):
    """The reference's sample CR, optionally edited in the reference's
    terms (``spec.libtpu``)."""
    with open(ref_testing.sample_clusterpolicy_path()) as f:
        obj = yaml.safe_load(f)
    obj["metadata"]["name"] = name
    obj["metadata"]["uid"] = f"uid-{name}"
    if edit is not None:
        edit(obj)
    return obj


def port_node(ref):
    """A reference TPU node as an H100 node of the paired variant carrying
    the converted node's own labels, annotations, spec and capacity; a
    reference CPU node through ``convert`` alone."""
    if not ref_sm.has_tpu_labels(ref):
        return convert.object_from_reference(ref, VARIANTS)
    variant = VARIANTS[ref_sm.node_generation(ref)]
    conv = convert.object_from_reference(ref, VARIANTS)
    node = testing.make_gpu_node(ref["metadata"]["name"], variant=variant, product=PRODUCTS[variant])
    del node["metadata"]["labels"][consts.DRIVER_VERSION_LABEL]
    meta = conv["metadata"]
    node["metadata"]["labels"].update(
        {k: v for k, v in (meta.get("labels") or {}).items() if k not in tu.REF_IDENTITY})
    node["metadata"]["annotations"].update(meta.get("annotations") or {})
    if conv.get("spec"):
        node["spec"] = conv["spec"]
    for field in ("capacity", "allocatable"):
        node["status"][field].update((conv.get("status") or {}).get(field) or {})
    return node


def _side(base, **kw):
    return SimpleNamespace(**{**vars(base), **kw})


SIDES = {
    "reference": _side(
        tu.SIDES["reference"], cpc=ref_cpc, ro=ref_ro, delta=ref_delta, uc=ref_uc, events=ref_events,
        flight=ref_flight, trace=ref_trace, assets=REF_ASSETS, cr=lambda ref: ref, driver="libtpu",
        version_label=ref_consts.TFD_LIBTPU_VERSION_LABEL,
        perf_base=lambda labels: (ref_testing.PERF_BASE_TFLOPS, ref_testing.PERF_BASE_GBPS),
        to_port=lambda o: convert.object_from_reference(o, VARIANTS)),
    "port": _side(
        tu.SIDES["port"], cpc=cpc, ro=ro, delta=delta, uc=uc, events=events, flight=flight, trace=trace,
        assets=sm.PACKAGE_ASSETS_DIR, cr=convert.clusterpolicy_from_reference, driver="driver",
        version_label=consts.DRIVER_VERSION_LABEL, perf_base=testing.perf_base,
        obj=lambda o: port_node(o) if o.get("kind") == "Node" else convert.object_from_reference(o, VARIANTS)),
}


def pair_sides(monkeypatch, clock):
    """The operator namespace set, every Event written through, flight
    dumps unthrottled and one ledger clock, on both sides."""

    def iso_now():
        return datetime.fromtimestamp(clock(), timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")

    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    for side in SIDES.values():
        monkeypatch.setattr(side.events, "EVENT_REFRESH_INTERVAL_S", 0.0)
        monkeypatch.setattr(side.flight.RECORDER, "min_interval_s", 0.0)
        monkeypatch.setattr(side.ro, "_iso_now", iso_now)


@pytest.fixture(autouse=True)
def paired_clocks(monkeypatch, pinned_clock):  # noqa: F811
    pair_sides(monkeypatch, pinned_clock)
    yield
    for side in SIDES.values():
        side.testing.clear_bad_versions()


_NUMBER = re.compile(r"\d+(\.\d+)?")


def _evidence(text):
    """An evidence string with its readings masked (the verdict stays)."""
    return _NUMBER.sub("<n>", text) if ("TFLOPS" in text or "GB/s" in text or "alloc p99" in text) else text


def ref_name(name):
    """A reference object's name as the port's: its operand app and card
    variant renamed (a driver pod ``tpu-libtpu-daemonset-v5e-<node>`` is
    ``gpu-driver-daemonset-h100-sxm-<node>``)."""
    name = convert.operand_app_from_reference(name)
    for gen, variant in VARIANTS.items():
        name = re.sub(rf"-{gen}(?=-|$)", f"-{variant}", name)
    return name


def message(text, side):
    """An Event message in the port's words."""
    if text.startswith("flight recorder dumped ("):
        text = text.rsplit(" -> ", 1)[0] + " -> <path>"
    if side.name == "reference":
        text = re.sub(r"(?<![-\w])libtpu\b", "driver", text)
        text = text.replace(convert.REF_TPU_RESOURCE, consts.GPU_RESOURCE).replace("TPU", "GPU")
    return "; ".join(_evidence(part) for part in text.split("; "))


class World(tu.World):
    """One side's cluster (``tests/test_torch_upgrade.py``'s ``World``) with
    the reconcilers' objects: the ClusterPolicy, the reconcilers and the
    views of the CR."""

    def create_cr(self, name="cluster-policy", edit=None):
        return self.client.create(self.side.cr(ref_cr(name, edit)))

    def reconciler(self, client=None):
        return self.side.cpc.ClusterPolicyReconciler(client or self.client, assets_dir=self.side.assets)

    def upgrader(self, client=None):
        return self.side.uc.UpgradeReconciler(client or self.client, NS)

    def cp(self, name="cluster-policy"):
        return self.client.get(CPV, "ClusterPolicy", name)

    def ledger(self, name="cluster-policy"):
        return self.side.ro.load_record(self.cp(name))

    def set_version(self, version):
        self.side.testing.edit_clusterpolicy(self.client, lambda cp: cp["spec"][self.side.driver].update(
            version=version))

    def version(self, name):
        return self.label(name, self.side.version_label)

    def _node_view(self, node):
        out = super()._node_view(node)
        labels = node["metadata"].get("labels") or {}
        for key in (consts.VALIDATOR_PERF_ANNOTATION, consts.VALIDATOR_PERF_BASELINE_ANNOTATION):
            if key in out["annotations"]:
                perf = json.loads(out["annotations"][key])
                tflops, gbps = self.side.perf_base(labels)
                out["annotations"][key] = {"version": perf.get("version"), "tflops": round(perf["tflops"] / tflops, 3),
                                           "gbps": round(perf["gbps"] / gbps, 3)}
        return out

    def _stamp(self, value):
        return tu._stamp(value, self.t0)

    def cr_view(self, cp):
        status = copy.deepcopy(cp.get("status") or {})
        for cond in status.get("conditions") or []:
            cond["lastTransitionTime"] = self._stamp(cond["lastTransitionTime"])
        rollout = status.get("rollout")
        if rollout:
            rollout["kind"] = convert.ROLLOUT_KINDS.get(rollout["kind"], rollout["kind"])
            if "evidence" in rollout:
                rollout["evidence"] = [_evidence(e) for e in rollout["evidence"]]
        rec = ro.load_record(cp)
        if rec is not None:
            rec["kind"] = convert.ROLLOUT_KINDS.get(rec.get("kind"), rec.get("kind"))
            for key in LEDGER_STAMPS:
                if key in rec:
                    rec[key] = self._stamp(rec[key])
            if "evidence" in rec:
                rec["evidence"] = [_evidence(e) for e in rec["evidence"]]
        return {"status": status, "ledger": rec}

    def view(self):
        nodes = {n["metadata"]["name"]: self._node_view(n) for n in self.client.list("v1", "Node")}
        pods = sorted(
            (p["metadata"].get("namespace", ""), self.side.to_port(p)["metadata"].get("labels", {}).get("app"),
             p["spec"].get("nodeName"), p.get("status", {}).get("phase"))
            for p in self.client.list("v1", "Pod"))
        evs = sorted((e.get("type"), e.get("reason"), e.get("involvedObject", {}).get("kind"),
                      e.get("involvedObject", {}).get("name"), message(e.get("message", ""), self.side),
                      e.get("count")) for e in self.client.list("v1", "Event"))
        crs = {cp["metadata"]["name"]: self.cr_view(cp) for cp in self.client.list(CPV, "ClusterPolicy")}
        calls = self.calls
        if self.side.name == "reference":
            # (verb, apiVersion, kind, name, namespace): an asset by the
            # pairing of the two asset trees, a pod by its app and variant
            calls = [call[:3] + (tsm.ASSET_NAMES.get((call[2], call[3]), ref_name(call[3])),) + call[4:]
                     for call in calls]
        # sorted: a restart deletes a node's operand pods in name order,
        # and the two packages' operand names sort differently
        return {"nodes": nodes, "pods": pods, "events": evs, "calls": sorted(calls), "crs": crs}


def both(script, *args):
    """``script(world, *args)`` on each side; the worlds must agree.
    Returns the two results."""
    worlds, out = [], []
    for name in ("reference", "port"):
        w = World(SIDES[name])
        out.append(script(w, *args))
        worlds.append(w)
    ref, port = (w.view() for w in worlds)
    for key in ("nodes", "pods", "calls", "crs", "events"):
        assert ref[key] == port[key], key
    return out[0], out[1]


def result(res):
    return res.requeue_after, res.ready


def tpu_world(w, *names):
    for name in names:
        w.create(make_tpu_node(name))
    return w


def simulate_kubelet(w):
    """``tests/test_reconciler.py::simulate_kubelet`` in the side's names:
    every DaemonSet scheduled, one Running pod at the template hash for an
    OnDelete DaemonSet."""
    c = w.client
    for ds in c.list("apps/v1", "DaemonSet", NS):
        ds["status"] = {"desiredNumberScheduled": 1, "numberUnavailable": 0, "updatedNumberScheduled": 1}
        c.update_status(ds)
        if ds["spec"].get("updateStrategy", {}).get("type") == "OnDelete":
            app = ds["spec"]["selector"]["matchLabels"]["app"]
            h = ds["spec"]["template"]["metadata"].get("annotations", {}).get(w.c.LAST_APPLIED_HASH_ANNOTATION)
            pod = {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": f"{app}-0", "namespace": NS, "labels": {"app": app},
                                "annotations": {w.c.LAST_APPLIED_HASH_ANNOTATION: h}},
                   "spec": {"nodeName": "tpu-node-1"}, "status": {"phase": "Running"}}
            if c.get_or_none("v1", "Pod", pod["metadata"]["name"], NS) is None:
                c.create(pod)


def cached(w, client=None):
    c = w.side.CachedClient(client or w.client, namespace=NS)
    assert c.start_informers() is True
    return c


# ---------------------------------------------------------------------------
# tests/test_reconciler.py
# ---------------------------------------------------------------------------


def test_reconcile_to_ready():
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        r = w.reconciler()
        first = result(r.reconcile())
        status = w.cp()["status"]
        assert (status["state"], status["namespace"]) == (State.NOT_READY, NS)
        simulate_kubelet(w)
        return first, result(r.reconcile()), w.cp()["status"]["state"]

    ref, port = both(script)
    assert ref == port == ((cpc.REQUEUE_NOT_READY_S, False), (None, True), State.READY)


def test_singleton_stable_across_reconciles():
    def script(w):
        tpu_world(w, "tpu-node-1")
        w.create_cr("a-policy")
        w.create_cr("b-policy")
        r = w.reconciler()
        seen = []
        for _ in range(3):
            r.reconcile()
            seen.append((w.cp("a-policy")["status"]["state"], w.cp("b-policy")["status"]["state"]))
        return seen

    ref, port = both(script)
    assert ref == port
    assert all(a != State.IGNORED and b == State.IGNORED for a, b in port)


def test_singleton_extra_cr_ignored():
    def script(w):
        tpu_world(w, "tpu-node-1")
        w.create_cr("cluster-policy")
        w.create_cr("cluster-policy-2")
        w.reconciler().reconcile()
        return w.cp("cluster-policy-2")["status"]["state"], w.cp()["status"]["state"]

    ref, port = both(script)
    assert ref == port and port[0] == State.IGNORED and port[1] != State.IGNORED


def test_no_tpu_labels_polls_45s():
    def script(w):
        w.create(make_cpu_node("cpu-1"))
        w.create_cr()
        return result(w.reconciler().reconcile())

    assert both(script) == ((cpc.REQUEUE_NO_LABELS_S, False),) * 2
    assert cpc.REQUEUE_NO_LABELS_S == ref_cpc.REQUEUE_NO_LABELS_S


def test_no_cr_is_noop():
    assert both(lambda w: result(w.reconciler().reconcile())) == ((None, False),) * 2


def test_node_event_predicates():
    def script(w):
        gpu, cpu = w.side.obj(make_tpu_node("n1")), w.side.obj(make_cpu_node("n2"))
        pred = w.side.cpc.node_event_needs_reconcile
        unrelated = copy.deepcopy(gpu)
        unrelated["metadata"]["labels"]["unrelated"] = "x"
        tamper = copy.deepcopy(gpu)
        tamper["metadata"]["labels"][w.c.DEPLOY_LABEL_PREFIX + w.side.driver] = "false"
        return [pred("ADDED", None, gpu), pred("ADDED", None, cpu), pred("DELETED", gpu, gpu),
                pred("MODIFIED", gpu, unrelated), pred("MODIFIED", gpu, tamper)]

    assert both(script) == ([True, False, True, False, True],) * 2


def test_step_exception_is_isolated_and_records_failure_metric(monkeypatch):
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        r = w.reconciler()
        recorded = []
        monkeypatch.setattr(r.metrics, "observe_reconcile", lambda v: recorded.append(v))
        real_run = r.ctrl.run_state

        def boom(state):
            if state == "state-metricsd":
                raise RuntimeError("control exploded")
            return real_run(state)

        monkeypatch.setattr(r.ctrl, "run_state", boom)
        res = result(r.reconcile())
        status = w.cp()["status"]
        degraded = {c["type"]: c for c in status["conditions"]}["Degraded"]
        tfd = w.client.get_or_none("apps/v1", "DaemonSet", w.c.OPERAND_APPS["tpu-feature-discovery"]
                                   if w.side.name == "port" else "tpu-feature-discovery", NS)
        first = (res, recorded[-1], status["erroredStates"], degraded["status"], degraded["reason"],
                 "state-metricsd" in degraded.get("message", ""), tfd is not None)
        monkeypatch.setattr(r.ctrl, "run_state", real_run)
        r.reconcile()
        status = w.cp()["status"]
        return first, "erroredStates" in status, {c["type"]: c for c in status["conditions"]}["Degraded"]["status"]

    ref, port = both(script)
    assert ref == port
    first, errored_left, degraded = port
    assert first == ((cpc.REQUEUE_NOT_READY_S, False), -1,
                     [{"state": "state-metricsd", "error": "RuntimeError: control exploded"}], "True",
                     "StatesErrored", True, True)
    assert (errored_left, degraded) == (False, "False")


def test_reconcile_converges_behind_frozen_cache():
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        r = w.reconciler(cached(w))
        r.reconcile()
        simulate_kubelet(w)
        ready = r.reconcile().ready
        stats = r.ctrl.snapshot_stats()
        return ready, w.label("tpu-node-1", w.c.TPU_PRESENT_LABEL), stats["hits_total"] > 0, stats[
            "last_pass"]["hit_rate"] > 0

    assert both(script) == ((True, "true", True, True),) * 2


def test_label_tpu_nodes_thaws_only_dirty_nodes():
    def script(w):
        tpu_world(w, "tpu-node-1", "tpu-node-2").create_cr()
        c = cached(w)
        r = w.reconciler(c)
        r.reconcile()
        writes = []
        orig_update = c.update

        def counting_update(obj, **kw):
            writes.append(obj["metadata"]["name"])
            return orig_update(obj, **kw)

        c.update = counting_update
        before = c.read_stats()["copied_reads"]
        r.reconcile()
        return [x for x in writes if x.startswith("tpu-node")], c.read_stats()["copied_reads"] - before

    ref, port = both(script)
    assert ref == port and port[0] == [] and port[1] <= 4


def test_get_runtime_serves_listed_empty_cluster():
    def script(w):
        w.create_cr()
        r = w.reconciler()
        r.reconcile()
        listed = r.ctrl._nodes_cache
        calls = []
        orig_list = w.client.list

        def counting_list(av, kind, *a, **kw):
            calls.append(kind)
            return orig_list(av, kind, *a, **kw)

        w.client.list = counting_list
        runtimes = [r.ctrl.get_runtime(), r.ctrl.get_runtime()]
        w.client.list = orig_list
        return listed, runtimes, "Node" in calls

    assert both(script) == (([], ["containerd", "containerd"], False),) * 2


def test_snapshot_shares_node_scans_across_states():
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        c = cached(w)
        r = w.reconciler(c)
        r.reconcile()
        simulate_kubelet(w)
        node_inf = c._informers[("v1", "Node")]
        before = node_inf.read_stats()["lists"]
        ready = r.reconcile().ready
        return ready, node_inf.read_stats()["lists"] - before, r.ctrl.last_snapshot_stats["hits"] >= 1

    ref, port = both(script)
    assert ref == port and port[0] is True and port[1] <= 3 and port[2]


def test_snapshot_lifecycle_scoped_to_pass():
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        r = w.reconciler()
        outside = [r.ctrl.snapshot is None]
        r.reconcile()
        outside.append(r.ctrl.snapshot is None)
        first = r.ctrl.last_snapshot_stats
        r.reconcile()
        outside.append(r.ctrl.snapshot is None)
        return outside, r.ctrl.snapshot_hits_total >= first["hits"]

    assert both(script) == (([True, True, True], True),) * 2


# ---------------------------------------------------------------------------
# the reconcile cases of test_events_and_status.py, test_slice_status.py and
# test_render_cache.py
# ---------------------------------------------------------------------------


def test_reconcile_emits_events_and_conditions():
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        r = w.reconciler()
        r.reconcile()
        out = [{e["reason"] for e in w.events()}, w.cp()["status"]["conditions"][0]]
        simulate_kubelet(w)
        r.reconcile()
        out += [{e["reason"] for e in w.events()}, w.cp()["status"]["conditions"][0]]
        return [sorted(o) if isinstance(o, set) else (o["type"], o["status"], o["reason"]) for o in out]

    ref, port = both(script)
    assert ref == port
    assert "OperandsNotReady" in port[0] and port[1] == ("Ready", "False", "OperandsNotReady")
    assert "Ready" in port[2] and port[3] == ("Ready", "True", "OperandsReady")


def test_reconcile_status_includes_slices():
    def multihost_node(name, worker):
        return make_tpu_node(name, accelerator="tpu-v5p-slice", topology="4x4x4", extra_labels={
            ref_consts.GKE_NODEPOOL_LABEL: "pool-a", ref_consts.TFD_SLICE_HOSTS_LABEL: "2",
            ref_consts.TFD_WORKER_ID_LABEL: str(worker)})

    def script(w):
        w.create_cr()
        for i in range(2):
            w.create(multihost_node(f"n{i}", i))
            w.create(ref_testing.make_validator_pod(f"n{i}", True, NS))
        w.reconciler().reconcile()
        slices = w.client.list(CPV, consts.CLUSTER_POLICY_KIND)[0]["status"]["slices"]
        return slices, [w.label(f"n{i}", w.c.SLICE_READY_LABEL) for i in range(2)]

    assert both(script) == (({"total": 1, "ready": 1}, ["true", "true"]),) * 2


def test_slice_memo_key_invalid_when_node_world_moved():
    def script(w):
        tpu_world(w, "tpu-node-1").create_cr()
        r = w.reconciler(cached(w))
        r.reconcile()
        r.reconcile()
        keys = [r._store_versions() is not None]
        node = w.node("tpu-node-1")
        node["metadata"]["labels"]["tpu.k8s.io/chip.failed"] = "true"
        w.client.update(node)
        keys.append(r._store_versions() is not None)
        r.reconcile()
        keys.append(r._store_versions() is not None)
        return keys

    assert both(script) == ([True, False, True],) * 2


# ---------------------------------------------------------------------------
# the port's predicate: feature discovery's labels and the card's resources
# ---------------------------------------------------------------------------


def _edit_product(node):
    node["metadata"]["labels"][consts.GPU_PRODUCT_LABEL] = "NVIDIA-A100-SXM4-80GB"


def _edit_allocatable(node):
    node["status"]["allocatable"][consts.GPU_RESOURCE] = "0"


def _edit_tpu_resource(node):
    node["status"]["allocatable"][convert.REF_TPU_RESOURCE] = "0"


def _edit_mig(node):
    node["status"]["allocatable"][consts.MIG_RESOURCE_PREFIX + "1g.10gb"] = "7"


@pytest.mark.parametrize("edit, wakes", [(_edit_product, True), (_edit_allocatable, True), (_edit_mig, True),
                                         (_edit_tpu_resource, False)],
                         ids=["product-label", "gpu-allocatable", "mig-allocatable", "tpu-resource"])
def test_port_predicate_watches_the_card(edit, wakes):
    """An edit of feature discovery's product label alone (it decides
    ``has_gpu_labels``) and a change of the card's allocatable wake a
    reconcile; the reference's ``google.com/tpu`` is no resource of the
    port's."""
    old = testing.make_gpu_node("g1")
    old["status"]["capacity"][consts.GPU_RESOURCE] = "8"
    old["status"]["allocatable"][consts.GPU_RESOURCE] = "8"
    new = copy.deepcopy(old)
    edit(new)
    assert cpc.node_event_needs_reconcile("MODIFIED", old, new) is wakes
    assert (cpc._tpu_resource_view(old) != cpc._tpu_resource_view(new)) is (edit is not _edit_product and wakes)
