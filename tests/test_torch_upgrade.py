"""The port's rolling driver upgrade (``upgrade/upgrade_state.py``, and its
reconciler ``upgrade/upgrade_controller.py``) against the JAX package's, on
the cases of ``tests/test_upgrade.py`` and ``tests/test_upgrade_slices.py``
that need no manager.

Each case runs one script on both sides over paired worlds built from one
table. The script builds the reference's objects with the reference's own
fixtures (``tests/test_upgrade.py``'s driver, validator and workload pods
and driver DaemonSet, ``make_tpu_node``); the port's world gets each of
them through ``convert.object_from_reference`` (``VARIANTS``), a node as an
H100 node of ``make_gpu_node`` carrying the converted node's labels,
annotations, spec and capacity (``port_obj``). So the port's FSM finds
its driver pods by ``consts.DRIVER_APP`` and its validator pods by
``consts.VALIDATOR_APP`` because ``convert`` renamed them, not because a
fixture wrote the port's literal.

After the script, each side's world is compared through ``convert``
(``World.view``). Tolerance: exact equality of every node's labels (those
no node factory writes), annotations, taints and ``unschedulable``, of the
pods left, of every eviction and deletion issued, and of the Events (type,
reason, object, message and count), apart from the renames
(``libtpu``→``driver``, ``google.com/tpu``→``nvidia.com/gpu``, ``TPU``→``GPU``
in a message) and the clock-derived annotations. Those (the ``*-since``
stamps, the retry record's ``lastRetryAt``, the remediation attempts
record's ``retryAt``/``updatedAt``) are held to their property instead:
present on both sides alike, parseable, and inside the case's window (no
later than now, no earlier than the oldest backdating a case writes).
``random.uniform`` is pinned to its upper bound and both remediation
modules' ``_utc_now`` read one clock (``pinned_clock``).

The 30 cases of ``tests/test_upgrade.py`` and the 8 of
``tests/test_upgrade_slices.py`` without the wire case keep their names; the rest hold the port's own
names: the per-variant driver DaemonSets, the validator app and the
previous-version annotation read from ``DRIVER_VERSION_LABEL``.
"""

import copy
import json
import random
import time
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import pytest

from tests import test_upgrade as ref_t
from tests.conftest import make_tpu_node
from tpu_operator import consts as ref_consts
from tpu_operator.api.v1 import clusterpolicy_types as ref_cpt
from tpu_operator.controllers import remediation as ref_rem
from tpu_operator.controllers import repartition as ref_rp
from tpu_operator.controllers import slice_status as ref_ss
from tpu_operator.controllers.state_manager import has_tpu_labels
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator.sliceman import slice_manager as ref_sliceman
from tpu_operator.upgrade import upgrade_state as ref_us
from tpu_operator_torch import consts, convert
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt
from tpu_operator_torch.controllers import remediation as rem
from tpu_operator_torch.controllers import repartition as rp
from tpu_operator_torch.controllers import slice_status as ss
from tpu_operator_torch.controllers.state_manager import has_gpu_labels
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import testing
from tpu_operator_torch.kube.cache import CachedClient
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.kube.testing import make_gpu_node
from tpu_operator_torch.sliceman import slice_manager as sliceman
from tpu_operator_torch.upgrade import upgrade_state as us

NS = "tpu-operator"
DESIRED_HASH = ref_t.DESIRED_HASH
# reference generation -> the port's card variant
VARIANTS = {"v5e": "h100-sxm"}
# the label keys each side's node factory writes: the nodes' identity, not
# FSM state (the driver version is the FSM's rollback fact: it crosses from
# the reference's node, as its libtpu version, or not at all)
REF_IDENTITY = set(make_tpu_node("x")["metadata"]["labels"])
IDENTITY = REF_IDENTITY | set(make_gpu_node("x")["metadata"]["labels"]) - {consts.DRIVER_VERSION_LABEL}
# the oldest stamp a case writes (``age`` backdates by at most this)
MAX_BACKDATE_S = ref_us.FAILED_RETRY_CAP_S + 3600


def port_obj(obj):
    """A reference object as the port's: through ``convert``; a node as an
    H100 node with the converted node's own labels, annotations, spec and
    capacity."""
    conv = convert.object_from_reference(obj, VARIANTS)
    if obj.get("kind") != "Node":
        return conv
    node = make_gpu_node(obj["metadata"]["name"])
    del node["metadata"]["labels"][consts.DRIVER_VERSION_LABEL]
    meta = conv["metadata"]
    node["metadata"]["labels"].update({k: v for k, v in (meta.get("labels") or {}).items() if k not in REF_IDENTITY})
    node["metadata"]["annotations"].update(meta.get("annotations") or {})
    if conv.get("spec"):
        node["spec"] = conv["spec"]
    for field in ("capacity", "allocatable"):
        node["status"][field].update((conv.get("status") or {}).get(field) or {})
    return node


def _message(text: str) -> str:
    """A reference Event message in the port's words."""
    for old, new in (("libtpu", "driver"), (convert.REF_TPU_RESOURCE, consts.GPU_RESOURCE), ("TPU", "GPU")):
        text = text.replace(old, new)
    return text


SIDES = {
    "reference": SimpleNamespace(
        name="reference", consts=ref_consts, us=ref_us, rem=ref_rem, rp=ref_rp, ss=ref_ss, cpt=ref_cpt,
        FakeClient=RefFakeClient, CachedClient=RefCachedClient, kclient=ref_kclient, testing=ref_testing,
        sliceman=ref_sliceman, has_labels=has_tpu_labels, resource=convert.REF_TPU_RESOURCE,
        obj=copy.deepcopy, to_port=lambda o: convert.object_from_reference(o, VARIANTS), message=_message,
        logger="tpu-operator"),
    "port": SimpleNamespace(
        name="port", consts=consts, us=us, rem=rem, rp=rp, ss=ss, cpt=cpt, FakeClient=FakeClient,
        CachedClient=CachedClient, kclient=kclient, testing=testing, sliceman=sliceman, has_labels=has_gpu_labels,
        resource=consts.GPU_RESOURCE, obj=port_obj, to_port=copy.deepcopy, message=lambda t: t,
        logger="gpu-operator"),
}


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """Jitter at its upper bound; both remediation modules on one clock
    (one function, so neither side's deadlines can run ahead of the
    other's)."""

    def clock():
        return time.time()

    monkeypatch.setattr(random, "uniform", lambda a, b: b)
    for mod in (ref_rem, rem):
        monkeypatch.setattr(mod, "_utc_now", clock)
    return clock


def _stamp(value, t0) -> str:
    """``<stamp>`` for a parseable time inside the case's window."""
    try:
        then = datetime.fromisoformat(value.replace("Z", "+00:00")).timestamp()
    except (AttributeError, ValueError) as e:
        raise AssertionError(f"unparseable stamp {value!r}") from e
    assert t0 - MAX_BACKDATE_S <= then <= time.time() + 1, value
    return "<stamp>"


class World:
    """One side's cluster: a ``FakeClient`` whose evictions and deletions
    are recorded, built from reference objects through the side's
    converter."""

    def __init__(self, side):
        self.side, self.c, self.t0 = side, side.consts, time.time()
        self.client = side.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}])
        self.calls = []
        for verb in ("evict", "delete", "delete_if_exists"):
            real = getattr(self.client, verb)

            def record(*args, _verb=verb, _real=real, **kw):
                self.calls.append((_verb,) + tuple(a for a in args if isinstance(a, str)))
                return _real(*args, **kw)

            setattr(self.client, verb, record)

    def create(self, ref_obj):
        return self.client.create(self.side.obj(ref_obj))

    def node(self, name):
        return self.client.get("v1", "Node", name)

    def label(self, name, key):
        return (self.node(name)["metadata"].get("labels") or {}).get(key)

    def state(self, name):
        return self.label(name, self.c.UPGRADE_STATE_LABEL)

    def relabel(self, name, **changes):
        """Set (or, with ``None``, drop) labels named by ``consts`` attribute."""
        node = self.node(name)
        labels = node["metadata"].setdefault("labels", {})
        for attr, value in changes.items():
            if value is None:
                labels.pop(getattr(self.c, attr), None)
            else:
                labels[getattr(self.c, attr)] = value
        self.client.update(node)

    def set_unschedulable(self, name, value=True):
        node = self.node(name)
        node.setdefault("spec", {})["unschedulable"] = value
        self.client.update(node)

    def unschedulable(self, name):
        return bool((self.node(name).get("spec") or {}).get("unschedulable", False))

    def pod(self, name, namespace=NS):
        return self.client.get_or_none("v1", "Pod", name, namespace)

    def events(self, reason=None):
        return [e for e in self.client.list("v1", "Event", NS) if reason is None or e.get("reason") == reason]

    def age(self, name, seconds, key="UPGRADE_STATE_SINCE_ANNOTATION"):
        """Backdate a state-entry stamp (``tests/test_upgrade.py::_age_node_state``)."""
        node = self.node(name)
        then = datetime.now(timezone.utc) - timedelta(seconds=seconds)
        node["metadata"].setdefault("annotations", {})[getattr(self.c, key)] = then.strftime("%Y-%m-%dT%H:%M:%SZ")
        self.client.update(node)

    def _node_view(self, node):
        node = self.side.to_port(node)
        meta = node["metadata"]
        ann = dict(meta.get("annotations") or {})
        for key in (consts.UPGRADE_STATE_SINCE_ANNOTATION, consts.REMEDIATION_STATE_SINCE_ANNOTATION):
            if key in ann:
                ann[key] = _stamp(ann[key], self.t0)
        if consts.UPGRADE_RETRY_ANNOTATION in ann:
            rec = json.loads(ann[consts.UPGRADE_RETRY_ANNOTATION])
            ann[consts.UPGRADE_RETRY_ANNOTATION] = {
                k: (_stamp(v, self.t0) if k == "lastRetryAt" else v) for k, v in rec.items()}
        if consts.REMEDIATION_ATTEMPTS_ANNOTATION in ann:
            rec = json.loads(ann[consts.REMEDIATION_ATTEMPTS_ANNOTATION])
            ann[consts.REMEDIATION_ATTEMPTS_ANNOTATION] = {
                k: (_stamp(v, self.t0) if k in ("retryAt", "updatedAt") else v) for k, v in rec.items()}
        spec = node.get("spec") or {}
        return {"labels": {k: v for k, v in (meta.get("labels") or {}).items() if k not in IDENTITY},
                "annotations": ann, "taints": spec.get("taints") or [],
                "unschedulable": bool(spec.get("unschedulable", False))}

    def view(self):
        """What this side's FSMs wrote, in the port's names."""
        nodes = {n["metadata"]["name"]: self._node_view(n) for n in self.client.list("v1", "Node")}
        pods = sorted((p["metadata"].get("namespace", ""), p["metadata"]["name"], p["metadata"].get("labels", {}).get(
            "app") and self.side.to_port(p)["metadata"]["labels"]["app"]) for p in self.client.list("v1", "Pod"))
        events = sorted((e.get("type"), e.get("reason"), e.get("involvedObject", {}).get("kind"),
                         e.get("involvedObject", {}).get("name"), self.side.message(e.get("message", "")),
                         e.get("count")) for e in self.client.list("v1", "Event"))
        return {"nodes": nodes, "pods": pods, "events": events, "calls": self.calls}


def both(script, *args, sides=SIDES):
    """``script(world, *args)`` on each side; the worlds must agree.
    Returns the two results."""
    worlds, out = [], []
    for name in ("reference", "port"):
        w = World(sides[name])
        out.append(script(w, *args))
        worlds.append(w)
    ref, port = (w.view() for w in worlds)
    for key in ("nodes", "pods", "calls", "events"):
        assert ref[key] == port[key], key
    return out[0], out[1]


# --- the worlds of tests/test_upgrade.py and tests/test_upgrade_slices.py ---

def managed(w, name, extra=None):
    """A reference node the driver DaemonSet selects."""
    node = make_tpu_node(name, extra_labels=extra)
    node["metadata"]["labels"][ref_consts.DEPLOY_LABEL_PREFIX + ref_consts.COMPONENT_LIBTPU] = "true"
    return node


def per_variant(obj):
    """A reference driver DaemonSet or pod of the v5e generation's own
    DaemonSet (``tpu-libtpu-daemonset-v5e``)."""
    obj = copy.deepcopy(obj)
    app = f"{ref_t.APP}-v5e"
    if obj["kind"] == "DaemonSet":
        obj["metadata"]["name"] = app
        obj["spec"]["selector"]["matchLabels"]["app"] = app
    else:
        obj["metadata"]["labels"]["app"] = app
    return obj


def cluster(w, per_variant_ds=False):
    """``tests/test_upgrade.py``'s fixture: four single-host nodes, each
    driver pod stale."""
    wrap = per_variant if per_variant_ds else (lambda o: o)
    for i in (1, 2, 3, 4):
        w.create(managed(w, f"node-{i}"))
        w.create(wrap(ref_t.driver_pod(f"node-{i}", "stale-hash")))
    w.create(wrap(ref_t.driver_ds()))
    w.wrap = wrap
    return w


def manager(w, client=None):
    return w.side.us.ClusterUpgradeStateManager(client or w.client, NS)


def policy(w, **kw):
    if "drain" in kw and isinstance(kw["drain"], dict):
        kw["drain"] = w.side.cpt.DrainSpec(**kw["drain"])
    return w.side.cpt.UpgradePolicySpec(auto_upgrade=True, **kw)


def pump(mgr, pol, times=1):
    for _ in range(times):
        mgr.apply_state(mgr.build_state(), pol)


def kubelet(w, names, validators=True):
    """The DaemonSet controller's role: recreate a deleted driver pod at
    the desired hash (and the validator pod beside it)."""
    for n in names:
        if w.pod(f"libtpu-{n}") is None:
            w.create(getattr(w, "wrap", lambda o: o)(ref_t.driver_pod(n, DESIRED_HASH)))
            if validators:
                w.create(ref_t.validator_pod(n))


def naked_pod(name, node):
    """An unmanaged workload pod (no owner): a drain without force cannot
    clear it."""
    return {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": "default"},
            "spec": {"nodeName": node, "containers": [{"resources": {"limits": {"google.com/tpu": "4"}}}]}}


def job_pod(name, node, labels, containers=None):
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": "default", "labels": labels,
                        "ownerReferences": [{"kind": "Job", "name": "j", "uid": "u"}]},
           "spec": {"nodeName": node}, "status": {"phase": "Running"}}
    if containers is not None:
        pod["spec"]["containers"] = containers
    return pod


NODES = [f"node-{i}" for i in (1, 2, 3, 4)]


def states(w, names=NODES):
    return {n: w.state(n) for n in names}


# --- tests/test_upgrade.py ---------------------------------------------------

def test_detects_stale_nodes():
    ref, port = both(lambda w: manager(cluster(w)).build_state().count(w.side.us.STATE_UPGRADE_REQUIRED))
    assert ref == port == 4


def test_fresh_nodes_marked_done():
    def script(w):
        cluster(w)
        pod = w.pod("libtpu-node-1")
        pod["metadata"]["annotations"][w.c.LAST_APPLIED_HASH_ANNOTATION] = DESIRED_HASH
        w.client.update(pod)
        state = manager(w).build_state()
        return state.count(w.side.us.STATE_UPGRADE_REQUIRED), state.count(w.side.us.STATE_DONE)

    assert both(script) == ((3, 1), (3, 1))


@pytest.mark.parametrize("ds", ["one", "per-variant"])
def test_full_fsm_walk_single_node(ds):
    """With a per-variant driver DaemonSet the port's FSM finds it as
    ``gpu-driver-daemonset-h100-sxm`` by the prefix of ``consts.DRIVER_APP``."""

    def script(w):
        cluster(w, per_variant_ds=ds == "per-variant")
        mgr = manager(w)
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="25%")
        w.create(ref_t.workload_pod("train-1", "node-1"))
        for _ in range(36):
            pump(mgr, pol)
            kubelet(w, NODES)
        assert states(w) == {n: w.side.us.STATE_DONE for n in NODES}
        assert w.pod("train-1", "default") is None
        assert not any(w.unschedulable(n) for n in NODES)
        return sorted(mgr._desired_hashes())

    ref, port = both(script)
    assert ref == [ref_t.APP + ("-v5e" if ds == "per-variant" else "")]
    assert port == [consts.DRIVER_APP + ("-h100-sxm" if ds == "per-variant" else "")]


def test_max_parallel_throttling():
    def script(w):
        mgr = manager(cluster(w))
        pump(mgr, policy(w, max_parallel_upgrades=2, max_unavailable="100%"))
        return sum(1 for s in states(w).values() if s not in (w.side.us.STATE_UPGRADE_REQUIRED, None))

    assert both(script) == (2, 2)


def test_skip_label():
    def script(w):
        cluster(w).relabel("node-1", UPGRADE_SKIP_LABEL="true")
        mgr = manager(w)
        count = mgr.build_state().count(w.side.us.STATE_UPGRADE_REQUIRED)
        pump(mgr, policy(w, max_unavailable="100%"), 2)
        return count, w.state("node-1")

    assert both(script) == ((3, None), (3, None))


def test_skip_drain_label():
    def script(w):
        cluster(w).relabel("node-2", UPGRADE_SKIP_DRAIN_LABEL="true")
        w.create(ref_t.workload_pod("train-2", "node-2"))
        pump(manager(w), policy(w, max_parallel_upgrades=4, max_unavailable="100%", drain={"enable": True}), 4)
        return w.pod("train-2", "default") is not None

    assert both(script) == (True, True)


def test_uncordon_defers_during_host_maintenance():
    def script(w):
        cluster(w)
        mgr = manager(w)
        for n in NODES:
            w.create(ref_t.validator_pod(n))
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="100%")
        pump(mgr, pol, 6)
        w.relabel("node-1", MAINTENANCE_STATE_LABEL="pending")
        pump(mgr, pol, 6)
        us_ = w.side.us
        assert states(w, NODES[1:]) == {n: us_.STATE_DONE for n in NODES[1:]}
        held = (w.state("node-1"), w.unschedulable("node-1"))
        w.relabel("node-1", MAINTENANCE_STATE_LABEL=None)
        pump(mgr, pol)
        return held, w.state("node-1"), w.unschedulable("node-1")

    ref, port = both(script)
    assert ref == port == ((us.STATE_UNCORDON_REQUIRED, True), us.STATE_DONE, False)


def test_parse_max_unavailable():
    cases = [("25%", 4), ("50%", 4), (2, 4), ("3", 4), (None, 4), ("0%", 4), ("200%", 4), ("x", 4), (-1, 4), ("7", 0)]
    ref = [ref_us.parse_max_unavailable(v, n) for v, n in cases]
    assert [us.parse_max_unavailable(v, n) for v, n in cases] == ref
    assert ref[:6] == [1, 2, 2, 3, 4, 0]


def test_pod_requests_tpu():
    """The reference's ``pod_requests_tpu`` is the port's re-exported
    ``selector.pod_requests_gpu``, on the same pods through ``convert``."""
    from tpu_operator_torch.kube.selector import pod_requests_gpu

    assert us.pod_requests_gpu is pod_requests_gpu
    sub = ref_t.workload_pod("y", "n")
    sub["spec"]["containers"][0]["resources"]["limits"] = {"google.com/tpu-2x2": "1"}
    cpu = {"spec": {"containers": [{"resources": {"limits": {"cpu": "1"}}}]}}
    pods = [ref_t.workload_pod("x", "n"), cpu, sub, ref_t.validator_pod("n")]
    ref = [ref_us.pod_requests_tpu(p) for p in pods]
    assert [us.pod_requests_gpu(convert.pod_from_reference(p)) for p in pods] == ref == [True, False, True, False]
    assert not us.pod_requests_gpu(ref_t.workload_pod("x", "n"))  # google.com/tpu is no card


def test_drain_timeout_marks_failed():
    def script(w):
        mgr = manager(cluster(w))
        w.create(naked_pod("naked", "node-1"))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%", drain={"enable": True, "timeout_seconds": 300})
        pump(mgr, pol, 6)
        drain = w.state("node-1")
        w.age("node-1", 301)
        pump(mgr, pol)
        failed = (w.state("node-1"), w.unschedulable("node-1"))
        events = [(e["type"], e["involvedObject"]["name"]) for e in w.events("UpgradeDrainTimeout")]
        pump(mgr, pol, 3)
        return drain, failed, events, w.state("node-1")

    ref, port = both(script)
    assert ref == port == (us.STATE_DRAIN_REQUIRED, (us.STATE_FAILED, True), [("Warning", "node-1")],
                           us.STATE_FAILED)


def test_validation_timeout_marks_failed():
    def script(w):
        mgr = manager(cluster(w))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%")
        pump(mgr, pol, 8)
        held = w.state("node-1")
        w.age("node-1", w.side.us.VALIDATION_TIMEOUT_S + 1)
        pump(mgr, pol)
        return held, w.state("node-1")

    assert both(script) == ((us.STATE_VALIDATION_REQUIRED, us.STATE_FAILED),) * 2


def test_wait_for_jobs_timeout_proceeds():
    def script(w):
        mgr = manager(cluster(w))
        w.create(job_pod("long-job", "node-1", {"job-class": "batch"}))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%",
                     wait_for_completion={"podSelector": "job-class=batch", "timeoutSeconds": 600})
        pump(mgr, pol, 4)
        held = w.state("node-1")
        w.age("node-1", 601)
        pump(mgr, pol)
        return held, w.state("node-1")

    ref, port = both(script)
    assert ref == port
    assert ref[0] == us.STATE_WAIT_FOR_JOBS_REQUIRED
    assert ref[1] in (us.STATE_POD_DELETION_REQUIRED, us.STATE_DRAIN_REQUIRED, us.STATE_POD_RESTART_REQUIRED)


def test_failed_node_reenters_after_label_clear():
    def script(w):
        mgr = manager(cluster(w))
        mgr.provider.set_state(w.node("node-1"), w.side.us.STATE_FAILED)
        mgr.provider.clear_state(w.node("node-1"))
        meta = w.node("node-1")["metadata"]
        cleared = (w.c.UPGRADE_STATE_LABEL in meta["labels"],
                   w.c.UPGRADE_STATE_SINCE_ANNOTATION in meta.get("annotations", {}))
        pump(mgr, policy(w, max_unavailable="100%"))
        return cleared, w.state("node-1") is not None

    assert both(script) == (((False, False), True),) * 2


def test_drain_timeout_applies_with_default_policy():
    def script(w):
        mgr = manager(cluster(w))
        w.create(naked_pod("naked2", "node-1"))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%")
        pump(mgr, pol, 6)
        held = w.state("node-1")
        w.age("node-1", 301)
        pump(mgr, pol)
        return held, w.state("node-1")

    assert both(script) == ((us.STATE_DRAIN_REQUIRED, us.STATE_FAILED),) * 2


def test_unstamped_timed_state_gets_stamped_then_times_out():
    def script(w):
        mgr = manager(cluster(w))
        w.create(naked_pod("naked3", "node-1"))
        w.relabel("node-1", UPGRADE_STATE_LABEL=w.side.us.STATE_DRAIN_REQUIRED)
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%", drain={"enable": True, "timeout_seconds": 300})
        pump(mgr, pol)
        stamped = w.c.UPGRADE_STATE_SINCE_ANNOTATION in w.node("node-1")["metadata"].get("annotations", {})
        held = w.state("node-1")
        w.age("node-1", 301)
        pump(mgr, pol)
        return stamped, held, w.state("node-1")

    assert both(script) == ((True, us.STATE_DRAIN_REQUIRED, us.STATE_FAILED),) * 2


def test_precordoned_node_stays_cordoned_after_upgrade():
    def script(w):
        cluster(w).set_unschedulable("node-2")
        mgr = manager(w)
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="100%")
        for _ in range(12):
            pump(mgr, pol)
            kubelet(w, NODES)
        assert states(w) == {n: w.side.us.STATE_DONE for n in NODES}
        return ([w.unschedulable(n) for n in NODES],
                w.c.UPGRADE_INITIAL_STATE_ANNOTATION in w.node("node-2")["metadata"].get("annotations", {}))

    assert both(script) == (([False, True, False, False], False),) * 2


def test_cleanup_strips_initial_state_annotation():
    def script(w):
        cluster(w)
        node = w.node("node-1")
        node["metadata"]["labels"][w.c.UPGRADE_STATE_LABEL] = w.side.us.STATE_DONE
        node["metadata"].setdefault("annotations", {})[w.c.UPGRADE_INITIAL_STATE_ANNOTATION] = "true"
        w.client.update(node)
        manager(w).cleanup_state_labels()
        meta = w.node("node-1")["metadata"]
        return w.c.UPGRADE_STATE_LABEL in meta["labels"], w.c.UPGRADE_INITIAL_STATE_ANNOTATION in meta.get(
            "annotations", {})

    assert both(script) == ((False, False),) * 2


def test_stale_initial_state_annotation_cleared_on_reentry():
    def script(w):
        cluster(w)
        node = w.node("node-3")
        node["metadata"].setdefault("annotations", {})[w.c.UPGRADE_INITIAL_STATE_ANNOTATION] = "true"
        w.client.update(node)
        mgr = manager(w)
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="100%")
        for _ in range(12):
            pump(mgr, pol)
            kubelet(w, NODES)
        return (w.state("node-3"), w.unschedulable("node-3"),
                w.c.UPGRADE_INITIAL_STATE_ANNOTATION in w.node("node-3")["metadata"].get("annotations", {}))

    assert both(script) == ((us.STATE_DONE, False, False),) * 2


def test_wait_for_jobs_set_based_selector():
    def script(w):
        mgr = manager(cluster(w))
        w.create(job_pod("setsel-job", "node-1", {"job-class": "train"}))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%",
                     wait_for_completion={"podSelector": "job-class in (batch, train)", "timeoutSeconds": 600})
        pump(mgr, pol, 4)
        held = w.state("node-1")
        w.client.delete("v1", "Pod", "setsel-job", "default")
        pump(mgr, pol)
        return held, w.state("node-1") != w.side.us.STATE_WAIT_FOR_JOBS_REQUIRED

    assert both(script) == ((us.STATE_WAIT_FOR_JOBS_REQUIRED, True),) * 2


def test_wait_for_jobs_malformed_selector_fails_closed():
    def script(w):
        mgr = manager(cluster(w))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%",
                     wait_for_completion={"podSelector": "job-class in (batch", "timeoutSeconds": 600})
        pump(mgr, pol, 5)
        held = w.state("node-1")
        w.age("node-1", 601)
        pump(mgr, pol)
        return held, w.state("node-1") != w.side.us.STATE_WAIT_FOR_JOBS_REQUIRED

    assert both(script) == ((us.STATE_WAIT_FOR_JOBS_REQUIRED, True),) * 2


def test_vanished_node_does_not_abort_pass():
    def script(w):
        mgr = manager(cluster(w))
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="100%")
        state = mgr.build_state()
        entered = len(state.node_states.get(w.side.us.STATE_UPGRADE_REQUIRED, []))
        w.client.delete("v1", "Node", "node-2")
        mgr.apply_state(state, pol)
        survivors = ["node-1", "node-3", "node-4"]
        first = states(w, survivors)
        for _ in range(12):
            pump(mgr, pol)
            kubelet(w, survivors)
        return entered, first, states(w, survivors)

    ref, port = both(script)
    survivors = ["node-1", "node-3", "node-4"]
    assert ref == port == (4, dict.fromkeys(survivors, us.STATE_CORDON_REQUIRED), dict.fromkeys(survivors, us.STATE_DONE))


def test_persistently_conflicting_node_does_not_abort_pass():
    def script(w):
        cluster(w)
        real_update = w.client.update

        def update(obj):
            if obj.get("kind") == "Node" and obj["metadata"]["name"] == "node-2":
                raise w.side.kclient.ConflictError("scripted persistent 409")
            return real_update(obj)

        mgr = manager(w)
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="100%")
        state = mgr.build_state()
        w.client.update = update
        mgr.apply_state(state, pol)
        first = states(w)
        w.client.update = real_update
        pump(mgr, pol)
        second = w.state("node-2")
        for n in NODES:
            node = w.node(n)
            node["metadata"]["labels"].pop(w.c.UPGRADE_STATE_LABEL, None)
            node["metadata"].get("annotations", {}).pop(w.c.UPGRADE_INITIAL_STATE_ANNOTATION, None)
            node.setdefault("spec", {})["unschedulable"] = False
            w.client.update(node)
        w.client.update = update
        try:
            state2 = manager(w).build_state()
        finally:
            w.client.update = real_update
        return first, second, sorted(ns.node["metadata"]["name"]
                                     for ns in state2.node_states.get(w.side.us.STATE_UPGRADE_REQUIRED, []))

    ref, port = both(script)
    assert ref == port
    assert ref[0] == {"node-1": us.STATE_CORDON_REQUIRED, "node-2": us.STATE_UPGRADE_REQUIRED,
                      "node-3": us.STATE_CORDON_REQUIRED, "node-4": us.STATE_CORDON_REQUIRED}
    assert ref[1] == us.STATE_CORDON_REQUIRED and ref[2] == ["node-1", "node-3", "node-4"]


def test_wait_for_jobs_sees_pods_outside_scoped_cache():
    def script(w):
        cluster(w)
        cached = w.side.CachedClient(w.client, namespace=NS)
        assert cached.start_informers() is True
        try:
            mgr = manager(w, cached)
            w.create(job_pod("coordinator", "node-1", {"app": "train-coordinator"},
                             containers=[{"name": "c", "resources": {}}]))
            scoped = any(o["metadata"]["name"] == "coordinator" for o in cached._informers[("v1", "Pod")].list())
            pol = policy(w, max_parallel_upgrades=1, max_unavailable="100%",
                         wait_for_completion={"podSelector": "app=train-coordinator", "timeoutSeconds": 600})
            pump(mgr, pol, 4)
            held = w.state("node-1")
            w.client.delete("v1", "Pod", "coordinator", "default")
            pump(mgr, pol)
            return scoped, held, w.state("node-1") != w.side.us.STATE_WAIT_FOR_JOBS_REQUIRED
        finally:
            cached.stop()

    assert both(script) == ((False, us.STATE_WAIT_FOR_JOBS_REQUIRED, True),) * 2


def _fail_node_via_drain_timeout(w, mgr, pol, name="node-1"):
    w.create(naked_pod(f"naked-{name}", name))
    pump(mgr, pol, 6)
    assert w.state(name) == w.side.us.STATE_DRAIN_REQUIRED
    w.age(name, pol.drain.timeout_seconds + 1)
    pump(mgr, pol)
    assert w.state(name) == w.side.us.STATE_FAILED


def test_failed_node_auto_retries_after_backoff():
    def script(w):
        mgr = manager(cluster(w))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="25%", drain={"enable": True, "timeout_seconds": 300})
        _fail_node_via_drain_timeout(w, mgr, pol)
        pump(mgr, pol, 2)
        held = w.state("node-1")
        w.age("node-1", w.side.us.FAILED_RETRY_BASE_S + 1)
        pump(mgr, pol)
        ann = w.node("node-1")["metadata"]["annotations"]
        return held, w.state("node-1") != w.side.us.STATE_FAILED, json.loads(ann[w.c.UPGRADE_RETRY_ANNOTATION])[
            "count"]

    assert both(script) == ((us.STATE_FAILED, True, 1),) * 2


def test_failed_retry_capped():
    def script(w):
        mgr = manager(cluster(w))
        node = w.node("node-1")
        node["metadata"].setdefault("annotations", {})[w.c.UPGRADE_RETRY_ANNOTATION] = json.dumps(
            {"count": w.side.us.FAILED_RETRY_MAX})
        w.client.update(node)
        mgr.provider.set_state(w.node("node-1"), w.side.us.STATE_FAILED)
        w.age("node-1", w.side.us.FAILED_RETRY_CAP_S + 1)
        pump(mgr, policy(w, max_unavailable="100%"), 3)
        return w.state("node-1"), w.side.us.failed_retries_exhausted(w.node("node-1"))

    assert both(script) == ((us.STATE_FAILED, True),) * 2


def test_failed_node_no_longer_starves_pending_slices():
    def script(w):
        mgr = manager(cluster(w))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="25%", drain={"enable": True, "timeout_seconds": 300})
        _fail_node_via_drain_timeout(w, mgr, pol)
        budget = w.side.us.slice_budget(mgr.build_state(), pol)
        pinned = (budget.failed_sids, budget.admit, states(w, NODES[1:]))
        w.client.delete("v1", "Pod", "naked-node-1", "default")
        w.age("node-1", w.side.us.FAILED_RETRY_BASE_S + 1)
        pump(mgr, pol)
        budget = w.side.us.slice_budget(mgr.build_state(), pol)
        freed = (budget.failed_sids, budget.admit)
        pump(mgr, pol)
        active = sum(1 for s in states(w).values() if s not in (w.side.us.STATE_UPGRADE_REQUIRED, None))
        return pinned, freed, active >= 1

    ref, port = both(script)
    assert ref == port == (({"node-1"}, 0, dict.fromkeys(NODES[1:], us.STATE_UPGRADE_REQUIRED)), (set(), 1), True)


def test_skip_label_drops_failed_node_and_frees_budget():
    def script(w):
        mgr = manager(cluster(w))
        pol = policy(w, max_parallel_upgrades=1, max_unavailable="25%", drain={"enable": True, "timeout_seconds": 300})
        _fail_node_via_drain_timeout(w, mgr, pol)
        before = w.side.us.slice_budget(mgr.build_state(), pol).admit
        w.relabel("node-1", UPGRADE_SKIP_LABEL="true")
        pump(mgr, pol)
        meta = w.node("node-1")["metadata"]
        budget = w.side.us.slice_budget(mgr.build_state(), pol)
        return (before, w.c.UPGRADE_STATE_LABEL in meta["labels"], w.c.UPGRADE_RETRY_ANNOTATION in meta.get(
            "annotations", {}), w.unschedulable("node-1"), budget.failed_sids, budget.admit)

    assert both(script) == ((0, False, False, True, set(), 1),) * 2


def test_slice_budget_counts_remediation_quarantine():
    def script(w):
        cluster(w).relabel("node-2", REMEDIATION_STATE_LABEL=w.c.REMEDIATION_STATE_QUARANTINED)
        mgr = manager(w)
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="25%")
        budget = w.side.us.slice_budget(mgr.build_state(), pol)
        pump(mgr, pol)
        held = states(w, ["node-1", "node-3", "node-4"])
        w.relabel("node-2", REMEDIATION_STATE_LABEL=None)
        return budget.repair_sids, budget.admit, held, w.side.us.slice_budget(mgr.build_state(), pol).admit

    ref, port = both(script)
    assert ref == port == ({"node-2"}, 0, dict.fromkeys(["node-1", "node-3", "node-4"], us.STATE_UPGRADE_REQUIRED), 1)


def test_upgrade_never_admits_a_quarantined_slice():
    def script(w):
        cluster(w).relabel("node-1", REMEDIATION_STATE_LABEL=w.c.REMEDIATION_STATE_QUARANTINED)
        mgr = manager(w)
        pol = policy(w, max_parallel_upgrades=4, max_unavailable="50%")
        budget = w.side.us.slice_budget(mgr.build_state(), pol)
        pump(mgr, pol, 3)
        return budget.admit, "node-1" in budget.pending_sids, w.state("node-1") in (
            None, w.side.us.STATE_UPGRADE_REQUIRED), w.unschedulable("node-1")

    assert both(script) == ((1, False, True, False),) * 2


# --- the port's own names ----------------------------------------------------

def test_validation_reads_the_ports_validator_app():
    """The port's FSM validates against ``gpu-operator-validator`` pods:
    a pod still carrying the reference's app never releases the node,
    the port's app does."""
    assert us.ValidationManager.APP == consts.VALIDATOR_APP == "gpu-operator-validator"
    assert us.ClusterUpgradeStateManager.DRIVER_APP == consts.DRIVER_APP == "gpu-driver-daemonset"
    w = cluster(World(SIDES["port"]))
    mgr = manager(w)
    pol = policy(w, max_parallel_upgrades=4, max_unavailable="100%")
    for _ in range(8):
        pump(mgr, pol)
        for n in NODES:
            if w.pod(f"libtpu-{n}") is None:
                w.create(ref_t.driver_pod(n, DESIRED_HASH))
                w.client.create(ref_t.validator_pod(n))  # the reference's app, not converted
    assert states(w) == dict.fromkeys(NODES, us.STATE_VALIDATION_REQUIRED)
    assert mgr.validation.running_nodes() == set()
    for n in NODES:
        pod = ref_t.validator_pod(n)
        pod["metadata"]["name"] = f"val-{n}"
        w.create(pod)
    assert mgr.validation.running_nodes() == set(NODES)
    pump(mgr, pol, 2)
    assert states(w) == dict.fromkeys(NODES, us.STATE_DONE)


def test_admission_records_the_driver_version_feature_discovery_published():
    """The rollback target recorded at admission is the node's
    ``DRIVER_VERSION_LABEL`` (the reference's libtpu-version label)."""

    def script(w):
        for i, version in ((1, "2026.1.0"), (2, "2026.1.1")):
            w.create(managed(w, f"node-{i}", {convert.REF_LIBTPU_VERSION_LABEL: version}))
            w.create(ref_t.driver_pod(f"node-{i}", "stale-hash"))
        w.create(ref_t.driver_ds())
        pump(manager(w), policy(w, max_parallel_upgrades=2, max_unavailable="100%"))
        return [w.node(f"node-{i}")["metadata"]["annotations"].get(w.c.UPGRADE_PREVIOUS_VERSION_ANNOTATION)
                for i in (1, 2)]

    assert both(script) == (["2026.1.0", "2026.1.1"],) * 2
    assert convert.LABEL_KEYS[convert.REF_LIBTPU_VERSION_LABEL] == consts.DRIVER_VERSION_LABEL


# --- tests/test_upgrade_slices.py ---------------------------------------------

MEMBERS = {"slice-a": [f"a-host-{i}" for i in range(1, 5)], "slice-b": [f"b-host-{i}" for i in range(1, 5)]}


def two_slices(w):
    """2 slices × 4 hosts, every driver pod stale, every validator up."""
    for sid, names in MEMBERS.items():
        for n in names:
            w.create(managed(w, n, {ref_consts.TFD_SLICE_ID_LABEL: sid, ref_consts.TFD_SLICE_HOSTS_LABEL: "4"}))
            w.create(ref_t.driver_pod(n, "stale-hash"))
            w.create(ref_t.validator_pod(n))
    w.create(ref_t.driver_ds())
    return w


def slice_policy(w, **kw):
    return policy(w, max_parallel_upgrades=2, max_unavailable="50%", **kw)


def recreate(w, names):
    for n in names:
        if w.pod(f"libtpu-{n}") is None:
            w.create(ref_t.driver_pod(n, "new-hash"))


def test_build_state_groups_by_slice():
    def script(w):
        state = manager(two_slices(w)).build_state()
        return (set(state.slices), state.is_multihost("slice-a"), sorted(state.member_hosts("slice-a")),
                state.slice_of["b-host-2"], {sid: len(es) for sid, es in state.fsm_by_slice().items()})

    ref, port = both(script)
    assert ref == port == ({"slice-a", "slice-b"}, True, MEMBERS["slice-a"], "slice-b", {"slice-a": 4, "slice-b": 4})


def test_slice_batch_admission_within_slice_budget():
    def script(w):
        mgr = manager(two_slices(w))
        pol = slice_policy(w)
        pump(mgr, pol)
        first = (set(states(w, MEMBERS["slice-a"]).values()), set(states(w, MEMBERS["slice-b"]).values()))
        started = [e["message"] for e in w.events("SliceUpgradeStarted")]
        pump(mgr, pol, 3)
        return first, len(started), "slice-a" in started[0], set(states(w, MEMBERS["slice-b"]).values())

    ref, port = both(script)
    assert ref == port == (({us.STATE_CORDON_REQUIRED}, {us.STATE_UPGRADE_REQUIRED}), 1, True,
                           {us.STATE_UPGRADE_REQUIRED})


def test_full_slice_roll_completes_and_b_follows_a():
    def script(w):
        mgr = manager(two_slices(w))
        pol = slice_policy(w)
        b_started_at = a_done_at = None
        us_ = w.side.us
        for i in range(40):
            pump(mgr, pol)
            recreate(w, MEMBERS["slice-a"] + MEMBERS["slice-b"])
            a_states = set(states(w, MEMBERS["slice-a"]).values())
            b_states = set(states(w, MEMBERS["slice-b"]).values())
            assert len(a_states) <= 2, a_states
            if a_done_at is None and a_states == {us_.STATE_DONE}:
                a_done_at = i
            if b_started_at is None and b_states & set(us_.ACTIVE_STATES):
                b_started_at = i
            if a_states == b_states == {us_.STATE_DONE}:
                break
        completed = {e["message"].split(":")[0].replace("slice ", "") for e in w.events("SliceUpgradeCompleted")}
        return (a_done_at, b_started_at, set(states(w, MEMBERS["slice-a"] + MEMBERS["slice-b"]).values()),
                any(w.unschedulable(n) for n in MEMBERS["slice-a"] + MEMBERS["slice-b"]), completed)

    ref, port = both(script)
    assert ref == port
    a_done_at, b_started_at, final, cordoned, completed = ref
    assert b_started_at >= a_done_at and final == {us.STATE_DONE} and not cordoned
    assert completed == {"slice-a", "slice-b"}


def test_pdb_veto_on_one_member_pins_whole_slice():
    def script(w):
        two_slices(w)
        pod = ref_t.workload_pod("gang-0", "a-host-1")
        pod["metadata"]["labels"] = {"app": "gang"}
        w.create(pod)
        w.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                  "metadata": {"name": "gang-pdb", "namespace": "default"},
                  "spec": {"minAvailable": 1, "selector": {"matchLabels": {"app": "gang"}}}})
        mgr = manager(w)
        pol = slice_policy(w)
        pump(mgr, pol, 8)
        held = (set(states(w, MEMBERS["slice-a"]).values()), set(mgr.pinned_slices), w.pod("gang-0", "default") is not None)
        msg = w.events("SliceUpgradePinned")[0]["message"]
        w.client.delete("policy/v1", "PodDisruptionBudget", "gang-pdb", "default")
        pump(mgr, pol, 2)
        return held, all(s in msg for s in ("slice-a", "a-host-1", "gang-pdb")), set(
            states(w, MEMBERS["slice-a"]).values()), set(mgr.pinned_slices)

    ref, port = both(script)
    assert ref == port
    assert ref[0] == ({us.STATE_DRAIN_REQUIRED}, {"slice-a"}, True) and ref[1] is True
    assert ref[2] <= {us.STATE_POD_RESTART_REQUIRED, us.STATE_VALIDATION_REQUIRED} and ref[3] == set()


def test_slice_validation_gate_holds_until_every_member_validates():
    def script(w):
        two_slices(w)
        val3 = w.pod("validator-a-host-3")
        val3["status"]["phase"] = "Pending"
        w.client.update(val3)
        mgr = manager(w)
        pol = slice_policy(w)
        for _ in range(8):
            pump(mgr, pol)
            recreate(w, MEMBERS["slice-a"])
        held = (set(states(w, MEMBERS["slice-a"]).values()), all(w.unschedulable(n) for n in MEMBERS["slice-a"]))
        val3 = w.pod("validator-a-host-3")
        val3["status"]["phase"] = "Running"
        w.client.update(val3)
        pump(mgr, pol, 2)
        return held, set(states(w, MEMBERS["slice-a"]).values()), any(w.unschedulable(n) for n in MEMBERS["slice-a"])

    assert both(script) == ((({us.STATE_VALIDATION_REQUIRED}, True), {us.STATE_DONE}, False),) * 2


def test_wait_for_jobs_barrier_holds_whole_slice():
    def script(w):
        two_slices(w)
        w.create({"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": "coord-0", "namespace": "default", "labels": {"app": "train"}},
                  "spec": {"nodeName": "a-host-2", "containers": [{"name": "c"}]}, "status": {"phase": "Running"}})
        mgr = manager(w)
        pol = slice_policy(w, wait_for_completion={"podSelector": "app=train"})
        pump(mgr, pol, 6)
        seen = [set(states(w, MEMBERS["slice-a"]).values())]
        w.client.delete("v1", "Pod", "coord-0", "default")
        for _ in range(2):
            pump(mgr, pol)
            seen.append(set(states(w, MEMBERS["slice-a"]).values()))
        return seen

    ref, port = both(script)
    assert ref == port == [{us.STATE_WAIT_FOR_JOBS_REQUIRED}, {us.STATE_POD_DELETION_REQUIRED},
                           {us.STATE_DRAIN_REQUIRED}]


def test_single_host_fleet_keeps_reference_arithmetic():
    def script(w):
        for i in range(1, 5):
            w.create(managed(w, f"solo-{i}"))
            w.create(ref_t.driver_pod(f"solo-{i}", "stale-hash"))
            w.create(ref_t.validator_pod(f"solo-{i}"))
        w.create(ref_t.driver_ds())
        mgr = manager(w)
        state = mgr.build_state()
        shape = (len(state.slices), any(state.is_multihost(sid) for sid in state.slices))
        mgr.apply_state(state, policy(w, max_parallel_upgrades=4, max_unavailable="50%"))
        return shape, sum(1 for i in range(1, 5) if w.state(f"solo-{i}") == w.side.us.STATE_CORDON_REQUIRED)

    assert both(script) == (((4, False), 2),) * 2


def test_maintenance_on_one_member_holds_whole_slice_cordoned():
    def script(w):
        mgr = manager(two_slices(w))
        pol = slice_policy(w)
        for _ in range(7):
            pump(mgr, pol)
            recreate(w, MEMBERS["slice-a"])
            if set(states(w, MEMBERS["slice-a"]).values()) == {w.side.us.STATE_UNCORDON_REQUIRED}:
                break
        at = set(states(w, MEMBERS["slice-a"]).values())
        w.relabel("a-host-3", MAINTENANCE_STATE_LABEL="pending")
        pump(mgr, pol, 2)
        held = (set(states(w, MEMBERS["slice-a"]).values()), all(w.unschedulable(n) for n in MEMBERS["slice-a"]))
        w.relabel("a-host-3", MAINTENANCE_STATE_LABEL=None)
        pump(mgr, pol)
        return at, held, set(states(w, MEMBERS["slice-a"]).values()), any(
            w.unschedulable(n) for n in MEMBERS["slice-a"])

    assert both(script) == (({us.STATE_UNCORDON_REQUIRED}, ({us.STATE_UNCORDON_REQUIRED}, True), {us.STATE_DONE},
                             False),) * 2


def test_upgrade_reconciler_gates(monkeypatch):
    """``tests/test_upgrade.py::test_upgrade_reconciler_gates``: with
    ``autoUpgrade`` off the upgrade reconciler clears the FSM's state labels
    and asks for no requeue; on, it requeues at ``REQUEUE_S``. The port reads
    ``spec.driver.upgradePolicy`` (the reference's ``spec.libtpu``)."""
    from tests.test_torch_reconciler import ref_cr
    from tpu_operator.upgrade import upgrade_controller as ref_uc
    from tpu_operator_torch.upgrade import upgrade_controller as uc

    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)

    def script(w):
        ref = w.side.name == "reference"
        cluster(w)
        cr = ref_cr(edit=lambda cr: cr["spec"]["libtpu"].update(upgradePolicy={"autoUpgrade": False}))
        w.client.create(cr if ref else convert.clusterpolicy_from_reference(cr))
        w.relabel("node-1", UPGRADE_STATE_LABEL=w.side.us.STATE_DONE)
        r = (ref_uc if ref else uc).UpgradeReconciler(w.client, NS)
        first = r.reconcile().requeue_after, w.state("node-1")
        cp = w.client.get(consts.API_VERSION, "ClusterPolicy", "cluster-policy")
        cp["spec"]["libtpu" if ref else "driver"]["upgradePolicy"] = {"autoUpgrade": True}
        w.client.update(cp)
        return first, r.reconcile().requeue_after

    assert both(script) == (((None, None), uc.REQUEUE_S),) * 2
    assert uc.REQUEUE_S == 120.0
