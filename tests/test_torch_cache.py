"""The port's informer cache (``kube/cache.py``) against the JAX package's.

Each script drives one side's ``CachedClient`` (or a bare ``Informer``)
over that side's ``FakeClient`` from the same objects, and logs what the
cache answers: names, labels, data, resourceVersions, repair events, read
counters and the class names of the errors raised. The port's log must
equal the reference's exactly; a pod's ``google.com/tpu`` request reaches
the port as ``nvidia.com/gpu`` through ``convert.pod_from_reference``, and
that rename is the only difference between the two worlds. Every script
also asserts the behaviour it exercises, so a defect both sides shared
would still fail. The seeded cases (list order, the indexed lists against
an unindexed scan) draw from one ``random.Random`` seed per side.

The wire cases run a {reference, port} cache stack (``CachedClient`` over
``RestClient``) × {reference, port} ``KubeSim`` matrix over loopback
HTTP, one module-scoped run of four cells seeded with the port's CRD,
sample and nodes; every cell's log must equal the reference × reference
cell's. Caches run with ``resync_interval_s=0`` (resync is called
explicitly), every wait is on a condition with a limit, every server is
stopped in a ``finally`` and every cache's threads are joined and
asserted dead."""

import copy
import http.server
import json
import random
import threading
import time
from http.client import HTTPConnection
from types import SimpleNamespace

import pytest

from tpu_operator.kube import cache as ref_cache
from tpu_operator.kube import client as ref_client
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import rest as ref_rest
from tpu_operator_torch import consts, convert
from tpu_operator_torch.kube import cache, client, kubesim, rest
from tpu_operator_torch.kube.testing import make_gpu_node, seed_cluster

NS = "tpu-operator"
WAIT_S = 30  # a limit on every wait, never what decides a result

SIDES = {
    "reference": SimpleNamespace(client=ref_client, cache=ref_cache, rest=ref_rest, kubesim=ref_kubesim,
                                 pod=lambda p: p),
    "port": SimpleNamespace(client=client, cache=cache, rest=rest, kubesim=kubesim,
                            pod=convert.pod_from_reference),
}


def wait_until(pred, timeout_s=WAIT_S, poll_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


def cm(name, ns=NS, **data):
    return {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": name, "namespace": ns},
            "data": data or {"k": "v"}}


def node(name, labels=None):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": labels or {}}}


def names(objs):
    return [o["metadata"]["name"] for o in objs]


def err(fn, *a, **kw):
    """The class name of what ``fn`` raised, or its result."""
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return ("err", type(e).__name__)


class PoisonedReads:
    """Wraps a client; any get/list explodes, so an answer proves the
    informer store served it."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name in ("get", "list"):
            raise AssertionError(f"live {name}() called: the cache was bypassed")
        return getattr(self._inner, name)


def started(side):
    c = side.client.FakeClient([
        {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
        node("n1", {"a": "1"}),
        node("n2", {"a": "2"}),
        cm("cm1"),
    ])
    cached = side.cache.CachedClient(c, namespace=NS, resync_interval_s=0)
    assert cached.start_informers() is True
    return c, cached


# ---------------------------------------------------------------------------
# scripts over the FakeClient; each returns its log
# ---------------------------------------------------------------------------


def s_reads_from_store(side):
    c, cached = started(side)
    cached.live = PoisonedReads(c)
    out = [dict(cached.get("v1", "Node", "n1")["metadata"]["labels"]), names(cached.list("v1", "Node")),
           dict(cached.get("v1", "ConfigMap", "cm1", NS)["data"])]
    assert out == [{"a": "1"}, ["n1", "n2"], {"k": "v"}]
    return out


def s_foreign_writes(side):
    c, cached = started(side)
    c.create(node("n3"))
    n2 = c.get("v1", "Node", "n2")
    n2["metadata"]["labels"]["a"] = "changed"
    c.update(n2)
    c.delete("v1", "Node", "n1")
    cached.live = PoisonedReads(c)
    out = [names(cached.list("v1", "Node")), cached.get("v1", "Node", "n2")["metadata"]["labels"]["a"],
           err(cached.get, "v1", "Node", "n1")]
    assert out == [["n2", "n3"], "changed", ("err", "NotFoundError")]
    return out


def s_write_through(side):
    c, cached = started(side)
    created = cached.create(cm("cm2", x="y"))
    out = [created["metadata"]["resourceVersion"], dict(cached.get("v1", "ConfigMap", "cm2", NS)["data"])]
    got = cached.get("v1", "ConfigMap", "cm2", NS, copy=True)
    got["data"]["x"] = "z"
    cached.update(got)
    out.append(cached.get("v1", "ConfigMap", "cm2", NS)["data"]["x"])
    cached.delete("v1", "ConfigMap", "cm2", NS)
    out.append(cached.get_or_none("v1", "ConfigMap", "cm2", NS))
    assert out[1:] == [{"x": "y"}, "z", None]
    return out


def s_selectors(side):
    _, cached = started(side)
    out = [names(cached.list("v1", "Node", label_selector={"a": "1"})),
           names(cached.list("v1", "Node", label_selector={"a": "*"})),
           names(cached.list("v1", "Node", field_selector={"metadata.name": "n2"}))]
    assert out == [["n1"], ["n1", "n2"], ["n2"]]
    return out


def s_passthrough_and_scoping(side):
    c, cached = started(side)
    c.create({"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
              "metadata": {"name": "leader", "namespace": NS}, "spec": {"holderIdentity": "x"}})
    c.create(cm("other-cm", ns="other"))
    out = [cached.get("coordination.k8s.io/v1", "Lease", "leader", NS)["spec"]["holderIdentity"],
           dict(cached.get("v1", "ConfigMap", "other-cm", "other")["data"]),
           sorted(names(cached.list("v1", "ConfigMap")))]
    assert out == ["x", {"k": "v"}, ["cm1", "other-cm"]]
    unstarted = side.cache.CachedClient(side.client.FakeClient([node("n1")]), namespace=NS)
    out.append([unstarted.get("v1", "Node", "n1")["metadata"]["name"], len(unstarted.list("v1", "Node"))])
    assert out[-1] == ["n1", 1]
    return out


def s_stale_event_guard(side):
    _, cached = started(side)
    fresh = cached.get("v1", "Node", "n1", copy=True)
    fresh["metadata"]["labels"]["a"] = "new"
    updated = cached.update(fresh)
    inf = cached._informers[("v1", "Node")]
    inf.on_event("MODIFIED", dict(fresh, metadata=dict(fresh["metadata"], resourceVersion="1")))
    out = [cached.get("v1", "Node", "n1")["metadata"]["resourceVersion"], updated["metadata"]["resourceVersion"]]
    assert out[0] == out[1]
    return out


def s_mutate_with_retry_reads_live(side):
    c, cached = started(side)
    inf = cached._informers[("v1", "Node")]
    stale = c.get("v1", "Node", "n1")
    n1 = c.get("v1", "Node", "n1")
    n1["metadata"]["labels"]["foreign"] = "write"
    c.update(n1)
    with inf._lock:
        inf._store[("", "n1")] = stale

    def mutate(obj):
        obj["metadata"]["labels"]["mine"] = "yes"
        return True

    got = side.client.mutate_with_retry(cached, "v1", "Node", "n1", mutate=mutate)
    out = [dict(got["metadata"]["labels"]), dict(c.get("v1", "Node", "n1")["metadata"]["labels"])]
    assert out[1] == {"a": "1", "foreign": "write", "mine": "yes"}
    return out


def s_apply_after_stale_miss(side):
    c, cached = started(side)
    c.create(cm("ghost", v="live"))
    inf = cached._informers[("v1", "ConfigMap")]
    with inf._lock:
        inf._store.pop((NS, "ghost"), None)
    out = [dict(cached.apply(cm("ghost", v="applied"))["data"]), dict(c.get("v1", "ConfigMap", "ghost", NS)["data"])]
    assert out == [{"v": "applied"}] * 2
    return out


def s_pod_scope(side):
    c, cached = started(side)

    def pod(name, ns, accelerator=False):
        res = {"limits": {"google.com/tpu": "4"}} if accelerator else {}
        return side.pod({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": ns},
                         "spec": {"containers": [{"name": "c", "resources": res}]}})

    c.create(pod("operand", NS))
    c.create(pod("train", "user-ns", accelerator=True))
    c.create(pod("web", "user-ns"))
    inf = cached._informers[("v1", "Pod")]
    out = [names(inf.list()), names(cached.list_scoped("v1", "Pod")), names(cached.list("v1", "Pod")),
           names(cached.list("v1", "Pod", NS)), cached.get("v1", "Pod", "web", "user-ns")["metadata"]["name"]]
    p = c.get("v1", "Pod", "train", "user-ns")
    p["spec"]["containers"][0]["resources"] = {}
    c.update(p)
    out += [names(inf.list()), cached.resync_once()]
    assert out == [["operand", "train"], ["operand", "train"], ["operand", "train", "web"], ["operand"], "web",
                   ["operand"], 0]
    return out


def s_transient_notfound(side):
    c, cached = started(side)
    NotFound = side.client.NotFoundError

    class Flaky:
        def __init__(self, inner):
            self._inner = inner
            self.fail_kinds = set()

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def list_with_rv(self, av, kind, ns=""):
            if kind in self.fail_kinds:
                raise NotFound(f"{kind} not served")
            return self._inner.list_with_rv(av, kind, ns)

        def list(self, av, kind, ns="", label_selector=None, field_selector=None):
            if kind in self.fail_kinds:
                raise NotFound(f"{kind} not served")
            return self._inner.list(av, kind, ns, label_selector, field_selector)

    flaky = Flaky(c)
    cached.live = flaky
    deleted = []
    cached.add_event_hook(lambda t, o: deleted.append(o["metadata"]["name"]) if t == "DELETED" else None)
    out = []
    flaky.fail_kinds = {"ConfigMap"}
    cached.resync_once()
    out.append((err(cached.get, "v1", "ConfigMap", "cm1", NS)[0], list(deleted)))
    flaky.fail_kinds = set()
    cached.resync_once()
    flaky.fail_kinds = {"ConfigMap"}
    cached.resync_once()
    out.append(err(cached.get, "v1", "ConfigMap", "cm1", NS)[0])
    cached.resync_once()
    out.append((err(cached.get, "v1", "ConfigMap", "cm1", NS), list(deleted)))
    assert out == [("ok", []), "ok", (("err", "NotFoundError"), ["cm1"])]
    return out


def s_frozen_views(side):
    _, cached = started(side)
    n1 = cached.get("v1", "Node", "n1")

    def mutations():
        yield lambda: n1["metadata"]["labels"].__setitem__("a", "mutated")
        yield lambda: n1.__setitem__("status", {})
        yield lambda: n1.__delitem__("metadata")
        yield lambda: n1["metadata"].setdefault("annotations", {})
        for obj in cached.list("v1", "Node"):
            yield lambda obj=obj: obj["metadata"]["labels"].update({"x": "y"})

    out = [err(m) for m in mutations()]
    assert all(o == ("err", "FrozenObjectError") for o in out)
    out.append(n1["metadata"].setdefault("name"))
    private = cached.get("v1", "Node", "n1", copy=True)
    out.append([type(private) is dict, type(private["metadata"]) is dict])
    private["metadata"]["labels"]["a"] = "private"
    for obj in cached.list("v1", "Node", copy=True):
        obj["metadata"]["labels"]["scratch"] = "ok"
    dup = copy.deepcopy(cached.get("v1", "Node", "n2"))
    dup["metadata"]["labels"]["b"] = "2"
    nodes = cached.list("v1", "Node")
    out += [dict(cached.get("v1", "Node", "n1")["metadata"]["labels"]),
            dict(cached.get("v1", "Node", "n2")["metadata"]["labels"]),
            all(isinstance(n, dict) and isinstance(n["metadata"], dict) for n in nodes),
            json.dumps(nodes, sort_keys=True) == json.dumps([dict(n) for n in nodes], sort_keys=True),
            nodes[0] == dict(nodes[0])]
    created = cached.create(cm("wt-cm", x="1"))
    created["data"]["x"] = "2"
    out.append(err(cached.get("v1", "ConfigMap", "wt-cm", NS)["data"].__setitem__, "x", "3"))
    assert out[6:] == ["n1", [True, True], {"a": "1"}, {"a": "2"}, True, True, True, ("err", "FrozenObjectError")]
    return out


def s_index_miss_counts(side):
    _, cached = started(side)
    inf = cached._informers[("v1", "Node")]
    base = inf.read_stats()
    got = cached.list("v1", "Node", label_selector={consts.TPU_PRESENT_LABEL: "true"})
    stats = inf.read_stats()
    agg = cached.read_stats()
    out = [got, stats["indexed_lists"] - base["indexed_lists"], stats["lists"] - base["lists"],
           stats["copied_reads"] - base["copied_reads"], agg["lists"] >= stats["lists"], agg["list_seconds"] >= 0]
    assert out == [[], 1, 1, 0, True, True]
    return out


# ---------------------------------------------------------------------------
# scripts over a bare Informer
# ---------------------------------------------------------------------------


def mk(kind, name, rv, ns=NS, **extra):
    obj = {"apiVersion": "v1", "kind": kind, "metadata": {"name": name, "namespace": ns, "resourceVersion": str(rv)}}
    obj.update(extra)
    return obj


def repairs_log(repairs):
    return sorted((t, o["metadata"]["name"]) for t, o in repairs)


def s_resync_semantics(side):
    inf = side.cache.Informer("v1", "ConfigMap", "")
    inf.replace([mk("ConfigMap", "a", 1, data={"k": "v"}), mk("ConfigMap", "b", 2), mk("ConfigMap", "ghost", 3)])
    inf.on_event("ADDED", mk("ConfigMap", "raced", 9))
    out = [repairs_log(inf.resync([mk("ConfigMap", "a", 5, data={"k": "v2"}), mk("ConfigMap", "b", 2),
                                   mk("ConfigMap", "c", 4)], list_rv=6))]
    out += [inf.get("a", NS)["data"]["k"], inf.get("raced", NS)["metadata"]["name"], err(inf.get, "ghost", NS),
            inf.drift_repairs]
    out.append(inf.resync([mk("ConfigMap", "a", 5, data={"k": "v2"}), mk("ConfigMap", "b", 2),
                           mk("ConfigMap", "c", 4), mk("ConfigMap", "raced", 9)], list_rv=9))
    out.append(inf.drift_repairs)
    assert out == [[("ADDED", "c"), ("DELETED", "ghost"), ("MODIFIED", "a")], "v2", "raced",
                   ("err", "NotFoundError"), 3, [], 3]
    return out


def s_no_resurrection(side):
    inf = side.cache.Informer("v1", "ConfigMap", "")
    inf.replace([mk("ConfigMap", "doomed", 5)])
    inf.on_event("DELETED", mk("ConfigMap", "doomed", 7))
    out = [inf.resync([mk("ConfigMap", "doomed", 5)], list_rv=6), err(inf.get, "doomed", NS)]
    out.append(repairs_log(inf.resync([mk("ConfigMap", "doomed", 9)], list_rv=10)))
    out.append(inf.get("doomed", NS)["metadata"]["resourceVersion"])
    assert out == [[], ("err", "NotFoundError"), [("ADDED", "doomed")], "9"]
    return out


def s_graveyard_pruned_on_delete(side):
    inf = side.cache.Informer("v1", "Event", "")
    inf.replace([])
    for i in range(50):
        inf.on_event("DELETED", mk("Event", f"e{i}", i + 1))
    out = [len(inf._graveyard)]
    with inf._lock:
        inf._graveyard = {k: (rv, t - side.cache.GRAVEYARD_TTL_S - 1) for k, (rv, t) in inf._graveyard.items()}
        inf._graveyard_next_prune = 0.0
    inf.on_event("DELETED", mk("Event", "fresh", 999))
    out.append(sorted(inf._graveyard))
    assert out == [50, [(NS, "fresh")]]
    return out


def s_list_order_stable(side):
    rng = random.Random(42)
    inf = side.cache.Informer("v1", "ConfigMap", "")
    all_names = [f"cm-{i:03d}" for i in range(60)]
    shuffled = all_names[:]
    rng.shuffle(shuffled)
    inf.replace([mk("ConfigMap", n, 1) for n in shuffled[:30]])
    for i, n in enumerate(shuffled[30:]):
        inf.on_event("ADDED", mk("ConfigMap", n, 2 + i))
    out = [names(inf.list())]
    doomed = rng.sample(all_names, 20)
    for i, n in enumerate(doomed):
        inf.on_event("DELETED", mk("ConfigMap", n, 100 + i))
    out.append(names(inf.list()))
    inf.resync([mk("ConfigMap", n, 200) for n in out[-1] + ["aaa-first"]], list_rv=300)
    out.append(names(inf.list()))
    assert out[0] == sorted(all_names) and out[1] == sorted(set(all_names) - set(doomed))
    assert out[2] == sorted(out[1] + ["aaa-first"])
    return out


def index_health(inf):
    with inf._lock:
        for (k, v), keys in inf._label_index.items():
            for key in keys:
                obj = inf._store.get(key)
                assert obj is not None and str((obj["metadata"].get("labels") or {}).get(k)) == v
        for (path, v), keys in inf._field_index.items():
            assert all(inf._store.get(key) is not None for key in keys)
        for key, obj in inf._store.items():
            lab, flds = inf._index_entries(obj)
            assert all(key in inf._label_index.get(e, set()) for e in lab)
            assert all(key in inf._field_index.get(e, set()) for e in flds)


def s_indexed_lists_match_scan(side):
    rng = random.Random(1337)
    inf = side.cache.Informer("v1", "Pod", "", index_label_keys=("app",), index_fields=("spec.nodeName",))
    apps = ["web", "db", "cache", "batch", None]
    nodes = [f"node-{i}" for i in range(5)] + [None]

    def pod(i, rv):
        labels = {}
        app = rng.choice(apps)
        if app:
            labels["app"] = app
        if rng.random() < 0.5:
            labels["tier"] = rng.choice(["a", "b"])
        spec = {}
        where = rng.choice(nodes)
        if where:
            spec["nodeName"] = where
        return {"apiVersion": "v1", "kind": "Pod", "spec": spec,
                "metadata": {"name": f"p-{i:03d}", "namespace": rng.choice([NS, "user-ns"]),
                             "resourceVersion": str(rv), "labels": labels}}

    selectors = [({"app": "web"}, None), ({"app": "db", "tier": "a"}, None), ({"app": "missing-app"}, None),
                 ({"app": "web"}, {"spec.nodeName": "node-2"}), (None, {"spec.nodeName": "node-0"}),
                 ({"app": "*"}, None), ({"!app": ""}, None), ({"app": ["web", "db"]}, None)]
    out = []

    def check():
        index_health(inf)
        for ns in ("", NS):
            for lsel, fsel in selectors:
                got = inf.list(ns, lsel, fsel)
                with inf._lock:
                    want = [obj for key, obj in sorted(inf._store.items())
                            if (not ns or key[0] == ns) and side.client.match_labels(obj, lsel)
                            and (not fsel or side.client.match_fields(obj, fsel))]
                assert got == want, (ns, lsel, fsel)
                out.append(names(got))

    rv = 1
    inf.replace([pod(i, rv) for i in range(80)])
    check()
    for _ in range(3):
        for _ in range(60):
            rv += 1
            op = rng.random()
            i = rng.randrange(120)
            if op < 0.5:
                inf.on_event("ADDED", pod(i, rv))
            elif op < 0.8:
                inf.on_event("MODIFIED", pod(i, rv))
            else:
                with inf._lock:
                    existing = list(inf._store.values())
                if existing:
                    victim = rng.choice(existing)
                    rv += 1
                    inf.on_event("DELETED", {"apiVersion": "v1", "kind": "Pod",
                                             "metadata": dict(victim["metadata"], resourceVersion=str(rv))})
        check()
    rv += 1
    inf.resync([pod(i, rv) for i in range(0, 120, 2)], list_rv=rv + 1)
    check()
    return out


FAKE_SCRIPTS = {f.__name__[2:]: f for f in [
    s_reads_from_store, s_foreign_writes, s_write_through, s_selectors, s_passthrough_and_scoping,
    s_stale_event_guard, s_mutate_with_retry_reads_live, s_apply_after_stale_miss, s_pod_scope,
    s_transient_notfound, s_frozen_views, s_index_miss_counts, s_resync_semantics, s_no_resurrection,
    s_graveyard_pruned_on_delete, s_list_order_stable, s_indexed_lists_match_scan,
]}


@pytest.mark.parametrize("name", list(FAKE_SCRIPTS))
def test_cache_script_matches_reference(name):
    script = FAKE_SCRIPTS[name]
    assert script(SIDES["port"]) == script(SIDES["reference"])


def test_default_specs_and_indexes_match_reference():
    assert cache.default_cache_specs(consts.API_VERSION, NS) == ref_cache.default_cache_specs(consts.API_VERSION, NS)
    for kind in ("Pod", "Node", "ConfigMap"):
        assert cache.default_index_spec(kind) == ref_cache.default_index_spec(kind)
    obj = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n", "managedFields": [{"manager": "m"}]}}
    assert cache._slim(obj) == ref_cache._slim(obj) == {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n"}}


# ---------------------------------------------------------------------------
# the wire: {reference, port} cache stack × {reference, port} KubeSim
# ---------------------------------------------------------------------------

CELLS = [(c, s) for c in SIDES for s in SIDES]
WIRE_GROUPS = ["sync_read", "foreign_write", "hook_after_store", "compaction", "dropped_delete",
               "dropped_add", "stop_joins"]


def has(c, name):
    return c.get_or_none("v1", "ConfigMap", name, NS) is not None


def wire_script(side, server, log):
    raw = side.kubesim.make_client(server.port)
    raw.GET_RETRY_BACKOFF_S = 0.05
    seed_cluster(raw, NS, node_names=("w-node-1", "w-node-2"))
    stop = threading.Event()
    cached = side.cache.CachedClient(side.kubesim.make_client(server.port), namespace=NS, resync_interval_s=0)
    try:
        log["sync_read"] = [cached.start_informers(stop, timeout_s=WAIT_S), names(cached.list("v1", "Node")),
                            cached.get(consts.API_VERSION, "ClusterPolicy", "cluster-policy")["spec"] is not None]
        node_inf = cached._informers[("v1", "Node")]

        raw.create(make_gpu_node("w-node-3"))
        added = wait_until(lambda: len(node_inf.list()) == 3)
        raw.delete("v1", "Node", "w-node-3")
        log["foreign_write"] = [added, wait_until(lambda: len(node_inf.list()) == 2), names(node_inf.list())]

        seen = threading.Event()
        in_store = []

        def hook(etype, obj):
            if obj.get("kind") == "Node" and obj["metadata"]["name"] == "hook-node":
                in_store.append(node_inf.get("hook-node")["metadata"]["name"])
                seen.set()

        cached.add_event_hook(hook)
        raw.create(make_gpu_node("hook-node"))
        log["hook_after_store"] = [seen.wait(WAIT_S), in_store[:1]]

        server.sim.compact_now()
        for i in range(20):
            raw.create(make_gpu_node(f"c-node-{i}"))
        server.sim.compact_now()
        log["compaction"] = [wait_until(lambda: len(node_inf.list()) == 23), len(node_inf.list())]

        repairs = []
        cached.add_event_hook(lambda t, o: repairs.append((t, o["metadata"]["name"])) if o.get("kind") == "ConfigMap"
                              else None)
        raw.create(cm("drift-cm", k="v1"))
        synced = wait_until(lambda: has(cached, "drift-cm"))
        server.sim.inject_watch_drop("configmaps", 1)
        raw.delete("v1", "ConfigMap", "drift-cm", NS)
        dropped = wait_until(lambda: server.sim.watch_drops_injected >= 1)
        cached.resync_once()
        log["dropped_delete"] = [synced, dropped, has(cached, "drift-cm"), ("DELETED", "drift-cm") in repairs]

        server.sim.inject_watch_drop("configmaps", 1)
        raw.create(cm("drift-add-cm"))
        dropped = wait_until(lambda: server.sim.watch_drops_injected >= 2)
        cached.resync_once()
        log["dropped_add"] = [dropped, has(cached, "drift-add-cm"), ("ADDED", "drift-add-cm") in repairs]
    finally:
        stop.set()
        cached.stop(timeout_s=WAIT_S)
    log["stop_joins"] = [cached._threads, cached.resync_once()]


@pytest.fixture(scope="module")
def wire_logs():
    logs = {}
    for client_side, server_side in CELLS:
        server = SIDES[server_side].kubesim.KubeSimServer(
            SIDES[server_side].kubesim.KubeSim(compact_keep=64, bookmark_interval_s=0.5)).start()
        log = logs[(client_side, server_side)] = {}
        try:
            wire_script(SIDES[client_side], server, log)
        finally:
            server.stop()
    return logs


@pytest.mark.parametrize("group", WIRE_GROUPS)
def test_wire_matches_reference(wire_logs, group):
    want = wire_logs[("reference", "reference")][group]
    expect = {"sync_read": [True, ["w-node-1", "w-node-2"], True],
              "foreign_write": [True, True, ["w-node-1", "w-node-2"]],
              "hook_after_store": [True, ["hook-node"]], "compaction": [True, 23],
              "dropped_delete": [True, True, False, True], "dropped_add": [True, True, True],
              "stop_joins": [[], 0]}
    assert want == expect[group]
    for cell in CELLS:
        assert wire_logs[cell][group] == want, cell


def absent_kind(side):
    """A kind the server does not serve syncs as empty instead of
    stalling the start."""

    class NotFound(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b'{"kind":"Status","code":404,"reason":"NotFound"}'
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), NotFound)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()

    class Plain(side.rest.RestClient):
        def __init__(self):
            super().__init__(host="127.0.0.1", port=str(srv.server_address[1]), token="t", insecure=True)

        def _make_conn(self, timeout: float = 30):
            return HTTPConnection(self.host, self.port, timeout=timeout)

    stop = threading.Event()
    cached = side.cache.CachedClient(Plain(), namespace=NS, specs=[("monitoring.coreos.com/v1", "ServiceMonitor", NS)],
                                     resync_interval_s=0)
    try:
        return [cached.start_informers(stop, timeout_s=10), cached.list("monitoring.coreos.com/v1", "ServiceMonitor", NS)]
    finally:
        stop.set()
        cached.stop(timeout_s=WAIT_S)
        srv.shutdown()
        srv.server_close()
        t.join(WAIT_S)


def test_absent_kind_syncs_empty_like_reference():
    assert absent_kind(SIDES["port"]) == absent_kind(SIDES["reference"]) == [True, []]
