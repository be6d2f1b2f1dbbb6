"""The port's client layer (``kube/client.py``, ``apply.py``, ``frozen.py``,
``retry.py``, ``disruption.py``, ``selector.py``) against the JAX
package's, module by module on the same inputs.

Each script of verbs drives the reference's ``FakeClient`` and the port's
from the same objects; every step's result (the stored object, its
resourceVersion and managed fields, or the error's class name), the watch
events and the final store must be equal. uids and timestamps are the
stores' own deterministic counters, so nothing needs normalising. The
retry and breaker schedules are compared under one seed and one clock."""

import copy
import random

import pytest

from tpu_operator.kube import apply as ref_apply
from tpu_operator.kube import client as ref_client
from tpu_operator.kube import disruption as ref_disruption
from tpu_operator.kube import frozen as ref_frozen
from tpu_operator.kube import retry as ref_retry
from tpu_operator.kube import selector as ref_selector
from tpu_operator_torch import consts
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt
from tpu_operator_torch.kube import apply, client, disruption, frozen, retry, selector

SIDES = {"reference": (ref_client, ref_apply), "port": (client, apply)}
NS = "default"


def node(name, **labels):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": dict(labels)},
            "status": {"capacity": {"cpu": "8"}}}


def pod(name, node_name="n1", owner_uid=None, ready=True, **labels):
    meta = {"name": name, "namespace": NS, "labels": dict(labels)}
    if owner_uid:
        meta["ownerReferences"] = [{"kind": "ConfigMap", "name": "owner", "uid": owner_uid}]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": {"nodeName": node_name},
            "status": {"phase": "Running",
                       "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


def run(script, side):
    """Drive one side's FakeClient through ``script(c, mod, do)``; returns
    the step log, the watch events and the final store."""
    mod, ssa = SIDES[side]
    c = mod.FakeClient()
    events = []
    c.add_watcher(lambda etype, obj: events.append((etype, obj["kind"], obj["metadata"]["name"],
                                                    obj["metadata"]["resourceVersion"])))
    log = []

    def do(fn, *a, **kw):
        try:
            log.append(("ok", fn(*a, **kw)))
        except Exception as e:  # noqa: BLE001 - the class name is the result
            log.append(("err", type(e).__name__))
        return log[-1]

    script(c, mod, ssa, do)
    return log, events, sorted(c.all_objects(), key=lambda o: (o["kind"], o["metadata"]["name"]))


def script_crud(c, mod, ssa, do):
    do(c.create, node("n1", zone="a", tier="gpu"))
    do(c.create, node("n2", zone="b"))
    do(c.create, node("n1"))  # AlreadyExists
    do(c.create, {"apiVersion": "v1", "kind": "Node", "metadata": {}})  # no name
    do(c.get, "v1", "Node", "n1")
    do(c.get, "v1", "Node", "missing")
    do(c.list, "v1", "Node", label_selector={"zone": "a"})
    do(c.list, "v1", "Node", label_selector={"zone": "*"})
    do(c.list, "v1", "Node", label_selector={"!tier": None})
    do(c.list, "v1", "Node", label_selector="zone in (a,b),tier notin (cpu)")
    do(c.list, "v1", "Node", field_selector={"metadata.name": "n2"})
    stale = c.get("v1", "Node", "n1")
    fresh = c.get("v1", "Node", "n1")
    fresh["metadata"]["labels"]["x"] = "1"
    del fresh["status"]
    do(c.update, fresh)  # status preserved
    do(c.update, stale)  # stale rv: Conflict
    st = c.get("v1", "Node", "n2")
    st["status"] = {"capacity": {"cpu": "16"}}
    st["metadata"]["labels"]["ignored"] = "by-status"
    do(c.update_status, st)
    do(c.apply, node("n3", zone="c"))
    do(c.apply, node("n3", zone="d"))
    do(c.get_or_none, "v1", "Node", "nope")
    do(c.delete_if_exists, "v1", "Node", "n3")
    do(c.delete_if_exists, "v1", "Node", "n3")
    do(c.update, node("ghost"))


def script_labels(c, mod, ssa, do):
    do(c.create, node("n1", a="1"))
    do(c.patch_labels, "v1", "Node", "n1", labels={"b": "2", "a": None})
    rv = c.get("v1", "Node", "n1")["metadata"]["resourceVersion"]
    do(c.patch_labels, "v1", "Node", "n1", labels={"b": "2"})  # no-op: same rv
    do(c.patch_labels, "v1", "Node", "n1", labels={"c": "3"}, resource_version=rv)
    do(c.patch_labels, "v1", "Node", "n1", labels={"d": "4"}, resource_version=rv)  # stale
    do(c.patch_labels, "v1", "Node", "gone", labels={"a": "1"})
    do(mod.Client.patch_labels, c, "v1", "Node", "n1", labels={"e": "5", "b": None})  # the fallback
    labels = {"k": "v"}
    do(mod.apply_label_delta, labels, {"k": None, "j": "w"})
    do(lambda: labels)

    def bump(n):
        n["metadata"]["labels"]["m"] = "x"
        return True

    do(mod.mutate_with_retry, c, "v1", "Node", "n1", mutate=bump)
    do(mod.mutate_with_retry, c, "v1", "Node", "n1", mutate=lambda n: False)
    do(mod.set_node_taint, c, "n1", "tpu.k8s.io/repair", "pending")
    do(mod.set_node_taint, c, "n1", "tpu.k8s.io/repair", "pending")
    do(mod.set_node_taint, c, "n1", "tpu.k8s.io/repair", "again", "NoExecute")
    do(lambda: mod.has_taint(c.get("v1", "Node", "n1"), "tpu.k8s.io/repair", "again"))
    do(mod.remove_node_taint, c, "n1", "tpu.k8s.io/repair")
    do(mod.remove_node_taint, c, "n1", "tpu.k8s.io/repair")


def script_ssa(c, mod, ssa, do):
    cm = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm", "namespace": NS,
                                                               "labels": {"app": "x"}},
          "data": {"a": "1", "b": "2"}}
    do(c.apply_ssa, cm, field_manager="m1")
    do(c.apply_ssa, cm, field_manager="m1")  # no-op: no rv bump
    other = copy.deepcopy(cm)
    other["data"] = {"a": "9"}
    do(c.apply_ssa, other, field_manager="m2", force=False)  # FieldConflict
    do(c.apply_ssa, other, field_manager="m2", force=True)
    shrunk = copy.deepcopy(cm)
    shrunk["data"] = {"b": "2"}
    do(c.apply_ssa, shrunk, field_manager="m1", force=False, prune=True)
    delta = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm", "namespace": NS,
                                                                  "labels": {"app": None, "new": "y"}}}
    do(c.apply_ssa, delta, field_manager="m3", prune=False)
    do(c.apply_ssa, cm, field_manager="m1", create_only=True)  # exists
    ghost = copy.deepcopy(cm)
    ghost["metadata"]["name"] = "ghost"
    do(c.apply_ssa, ghost, field_manager="m1", update_only=True)  # NotFound
    got = c.get("v1", "ConfigMap", "cm", NS)
    got["data"]["b"] = "human"
    do(c.update, got)  # re-owns b as unmanaged
    do(c.apply_ssa, cm, field_manager="m1", force=False)  # conflicts with unmanaged
    batch = [copy.deepcopy(cm), (ghost, True), (copy.deepcopy(cm), True)]
    do(lambda: [(o, type(e).__name__ if e else None)
                for o, e in c.apply_ssa_batch(batch, field_manager="m4", force=True)])
    do(mod.Client.apply_ssa, c, dict(ghost, data={"z": "1"}), field_manager="m5")  # the fallback
    stored = c.get("v1", "ConfigMap", "cm", NS)
    do(lambda: {m: sorted(ssa.encode_path(p) for p in paths)
                for m, paths in ssa.decode_managed(stored).items()})
    do(ssa.apply_merge, stored, {"apiVersion": "v1", "kind": "ConfigMap",
                                 "metadata": {"name": "cm", "namespace": NS}, "data": {"a": "0"}},
       manager="m9", force=False)
    do(lambda: ssa.conflict_message("ConfigMap", "cm", [("/data/a", "m1")]))


def script_eviction_and_gc(c, mod, ssa, do):
    owner = do(c.create, {"apiVersion": "v1", "kind": "ConfigMap",
                          "metadata": {"name": "owner", "namespace": NS}})[1]
    uid = owner["metadata"]["uid"]
    for i, ready in enumerate((True, True, False)):
        do(c.create, pod(f"p{i}", owner_uid=uid, ready=ready, app="train"))
    do(c.create, pod("solo", node_name="n2", app="serve"))
    do(c.create, node("n2"))
    do(c.create, {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                  "metadata": {"name": "pdb", "namespace": NS},
                  "spec": {"minAvailable": 2, "selector": {"matchLabels": {"app": "train"}}}})
    do(c.evict, "p0", NS)  # 2 healthy of 3, minAvailable 2: blocked
    do(c.evict, "p2", NS)  # the unready pod: still blocked (the budget counts healthy)
    do(c.evict, "solo", NS)  # no matching budget
    do(c.evict, "solo", NS)  # gone
    do(c.delete, "v1", "ConfigMap", "owner", NS)  # cascades to p0..p2
    do(c.create, pod("bound", node_name="n2"))
    do(c.delete, "v1", "Node", "n2")  # node GC takes its pods
    do(c.list, "v1", "Pod", NS)
    do(c.list_with_rv, "v1", "Pod", NS)


SCRIPTS = {"crud": script_crud, "labels": script_labels, "ssa": script_ssa,
           "eviction-and-gc": script_eviction_and_gc}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_fake_clients_agree_on_a_script_of_verbs(name):
    ref_log, ref_events, ref_store = run(SCRIPTS[name], "reference")
    log, events, store = run(SCRIPTS[name], "port")
    assert log == ref_log
    assert events == ref_events
    assert store == ref_store
    assert any(r[0] == "err" for r in log) and any(r[0] == "ok" for r in log)


def test_errors_are_the_port_s_own_objects():
    """The port's FakeClient raises the classes ``incluster.py``,
    ``eviction.py`` and the validator already catch."""
    from tpu_operator_torch.kube import eviction, incluster

    assert incluster.NotFoundError is client.NotFoundError
    assert eviction.EvictionBlockedError is client.EvictionBlockedError
    assert issubclass(apply.ApplyConflictError, client.ConflictError)
    c = client.FakeClient([node("n1")])
    with pytest.raises(client.NotFoundError):
        c.get("v1", "Node", "n2")
    with pytest.raises(client.ConflictError):
        c.create(node("n1"))


def test_default_field_manager_is_the_port_s():
    assert apply.DEFAULT_FIELD_MANAGER == "gpu-operator"
    c = client.FakeClient()
    obj = c.apply_ssa({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "x", "namespace": NS},
                       "data": {"k": "v"}})
    assert [m["manager"] for m in obj["metadata"]["managedFields"]] == ["gpu-operator"]


MUTATIONS = [
    ("dict", lambda d: d.__setitem__("a", 1)), ("dict", lambda d: d.__delitem__("k")),
    ("dict", lambda d: d.update(a=1)), ("dict", lambda d: d.pop("k")), ("dict", lambda d: d.clear()),
    ("dict", lambda d: d.popitem()), ("dict", lambda d: d.setdefault("new", 1)),
    ("list", lambda v: v.append(1)), ("list", lambda v: v.extend([1])), ("list", lambda v: v.insert(0, 1)),
    ("list", lambda v: v.pop()), ("list", lambda v: v.remove(1)), ("list", lambda v: v.sort()),
    ("list", lambda v: v.__setitem__(0, 2)), ("list", lambda v: v.reverse()),
]


@pytest.mark.parametrize("mod", [ref_frozen, frozen], ids=["reference", "port"])
@pytest.mark.parametrize("i", range(len(MUTATIONS)))
def test_frozen_views_raise_on_mutation(mod, i):
    view = mod.freeze({"k": "v", "items": [1, 2], "nested": {"x": [1]}})
    kind, mutate = MUTATIONS[i]
    target = view if kind == "dict" else view["items"]
    with pytest.raises(mod.FrozenObjectError):
        mutate(target)
    assert view.setdefault("k") == "v"  # reading through setdefault is allowed
    thawed = mod.thaw(view)
    assert thawed == view and not mod.is_frozen(thawed) and mod.is_frozen(view["nested"]["x"])
    assert type(copy.deepcopy(view)) is dict and type(view.copy()) is dict


def schedules(mod, seed):
    rng = random.Random(seed)
    p = mod.RetryPolicy(backoff_s=0.5, cap_s=8.0, rng=rng)
    backoffs = [p.backoff(a) for a in range(1, 9)] + [p.backoff(3, retry_after=x) for x in (0.2, 99, -1)]
    w = mod.WatchBackoff(base_s=1.0, cap_s=30.0, rng=random.Random(seed))
    watch = [w.next_delay() for _ in range(8)]
    w.reset()
    watch.append(w.next_delay())
    return backoffs, watch, [p.attempts_for(v) for v in ("GET", "POST", "APPLY")]


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_retry_and_watch_backoff_schedules_match_under_one_seed(seed):
    assert schedules(retry, seed) == schedules(ref_retry, seed)


def breaker_trace(mod, monkeypatch, events):
    now = [100.0]
    monkeypatch.setattr(mod, "_monotonic", lambda: now[0])
    b = mod.CircuitBreaker(threshold=3, cooldown_base_s=1.0, cooldown_cap_s=4.0)
    out = []
    for e in events:
        if e == "f":
            b.record_failure()
        elif e == "s":
            b.record_success()
        elif e == "a":
            out.append(b.allow())
        else:
            now[0] += float(e)
        out.append(b.stats())
    return out


@pytest.mark.parametrize("events", [
    "f f a f a",  # trips after the threshold, fast-fails while open
    "f f f a 1.5 a f a a 3 a",  # half-open probe failure re-trips with a doubled window
    "f f s f f a",  # success resets the streak
    "f f f a 1.1 a f a 2.1 a f a 4.1 a f s a",  # the doubling cooldown is capped
])
def test_breaker_states_match(events, monkeypatch):
    steps = events.split()
    assert breaker_trace(retry, monkeypatch, steps) == breaker_trace(ref_retry, monkeypatch, steps)


def test_breaker_trip_is_recorded_in_the_flight_recorder():
    from tpu_operator_torch.obs import flight

    before = flight.RECORDER.events_total
    b = retry.CircuitBreaker(threshold=1)
    b.record_failure()
    events = flight.RECORDER.snapshot()["events"]
    assert flight.RECORDER.events_total == before + 1 and events[-1]["kind"] == "breaker.trip"


def _ref_labels(labels):
    """A port node's labels as the reference writes them."""
    return {{v: k for k, v in cpt.VALUE_RENAMES.items()}.get(k, k): v for k, v in labels.items()}


DISRUPTION_NODES = [
    node("a", **{consts.UPGRADE_STATE_LABEL: consts.UPGRADE_STATE_DRAIN_REQUIRED}),
    node("b", **{consts.UPGRADE_STATE_LABEL: consts.UPGRADE_STATE_FAILED}),
    node("c", **{consts.UPGRADE_STATE_LABEL: consts.UPGRADE_STATE_DONE,
                 consts.REMEDIATION_STATE_LABEL: consts.REMEDIATION_STATE_QUARANTINED}),
    node("d", **{consts.REPARTITION_STATE_LABEL: consts.REPARTITION_STATE_ROLLING}),
    node("e", **{consts.REMEDIATION_STATE_LABEL: consts.REMEDIATION_STATE_OBSERVED}),
    node("f"),
]


@pytest.mark.parametrize("i", range(len(DISRUPTION_NODES)))
def test_disruption_owner_matches(i):
    port = DISRUPTION_NODES[i]
    ref = copy.deepcopy(port)
    ref["metadata"]["labels"] = _ref_labels(port["metadata"]["labels"])
    assert disruption.disruption_owner(port) == ref_disruption.disruption_owner(ref)


def test_joint_disrupted_slices_match():
    refs = []
    for n in DISRUPTION_NODES:
        r = copy.deepcopy(n)
        r["metadata"]["labels"] = _ref_labels(n["metadata"]["labels"])
        refs.append(r)
    slice_of = {"a": "s1", "b": "s1", "c": "s2"}
    got = disruption.joint_disrupted_slices(DISRUPTION_NODES, slice_of)
    assert got == ref_disruption.joint_disrupted_slices(refs, slice_of)
    assert got["all"] == {"s1", "s2", "d"}


PDB_CASES = [
    {"minAvailable": 2}, {"minAvailable": "50%"}, {"maxUnavailable": 1}, {"maxUnavailable": "10%"},
    {"minAvailable": "10.5%"}, {"minAvailable": 1.5}, {"minAvailable": float("inf")}, {},
    {"maxUnavailable": 0, "selector": {"matchExpressions": [{"key": "app", "operator": "Exists"}]}},
    {"maxUnavailable": 0, "selector": {"matchExpressions": [{"key": "app", "operator": "DoesNotExist"}]}},
    {"maxUnavailable": 0, "selector": {"matchExpressions": [{"key": "app", "operator": "Bogus"}]}},
    {"maxUnavailable": 0, "selector": {"matchExpressions": [{"key": "app", "operator": "In",
                                                             "values": ["train"]}]}},
]


@pytest.mark.parametrize("i", range(len(PDB_CASES)))
def test_eviction_blocked_by_matches(i):
    pods = [pod("p0", app="train"), pod("p1", app="train"), pod("p2", ready=False, app="train")]
    spec = dict(PDB_CASES[i])
    spec.setdefault("selector", {"matchLabels": {"app": "train"}})
    pdbs = [{"metadata": {"name": "pdb", "namespace": NS}, "spec": spec}]
    for p in pods:
        assert disruption.eviction_blocked_by(p, pods, pdbs) == ref_disruption.eviction_blocked_by(p, pods, pdbs)


SELECTORS = ["a=1", "a==1,b!=2", "a in (1, 2),!c", "a notin (3)", "b", "!b", "a in (1,2),b notin (x,y),c",
             "bad term (", "!", "a!=", ""]
LABELS = [{}, {"a": "1"}, {"a": "2", "b": "2"}, {"a": "3", "c": "x"}, {"b": "x"}]


@pytest.mark.parametrize("sel", SELECTORS)
def test_selectors_parse_and_match_alike(sel):
    def outcome(mod):
        try:
            reqs = mod.parse_selector(sel)
        except ValueError:
            return "ValueError"
        return reqs, [mod.matches(lbl, sel) for lbl in LABELS]

    assert outcome(selector) == outcome(ref_selector)


@pytest.mark.parametrize("sel", [{"k": "v"}, {"k": ["a", "b"]}, {"k": ""}, {"k": None}, {"!k": None},
                                 {"k": "v*"}, {}, {"a": "1", "b": ["x"], "!c": None}])
def test_dict_selectors_encode_alike(sel):
    assert selector.encode_dict_selector(sel) == ref_selector.encode_dict_selector(sel)
    labels = {"k": "va", "a": "1", "b": "x"}
    obj = {"metadata": {"labels": labels}}
    assert client.match_labels(obj, sel) == ref_client.match_labels(obj, sel)


def test_pod_requests_gpu_is_pod_requests_tpu_through_the_table():
    for resources, want in (({"limits": {"nvidia.com/gpu": "1"}}, True),
                            ({"requests": {"nvidia.com/mig-1x2": "1"}}, True),
                            ({"limits": {"cpu": "1"}}, False), ({}, False)):
        p = {"spec": {"containers": [{"resources": resources}]}}
        ref = {"spec": {"containers": [{"resources": {
            b: {k.replace("nvidia.com/gpu", "google.com/tpu").replace("nvidia.com/mig-", "google.com/tpu-"): v
                for k, v in m.items()} for b, m in resources.items()}}]}}
        assert selector.pod_requests_gpu(p) == ref_selector.pod_requests_tpu(ref) == want
