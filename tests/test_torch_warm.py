"""The port's warm-restart journal (``kube/warm.py``) against the JAX
package's.

The journal's file format, its invalidation rules (schema, age,
namespace, a corrupt or missing file) and the shard slicing are driven on
both sides with the same payloads and must give equal results; a journal's
age is set by rewriting its ``saved_at``, never by sleeping. A journal
either side writes must seed the other's informers: the reference's
journal over a world of TPU nodes, pods and a ClusterPolicy, mapped by
``convert.warm_journal_from_reference``, seeds a port ``CachedClient``
whose stores then equal, object for object, those a cold port cache
lists from the converted world; and the other way round. A stand-in
reconciler holding a ``RenderCache`` and an ``ApplySet`` carries the
render and apply-set halves across.

Over HTTP, for each {reference, port} ``KubeSim``, a journal written by
either side's cache warm-starts either side's cache with no LIST request,
and the warm cache sees a node changed while it was down. Exact equality
throughout, apart from the renames ``convert`` applies. Every server is
stopped and every cache's threads joined in a ``finally``."""

import copy
import json
import os
import time
from types import SimpleNamespace

import pytest
import yaml

from tpu_operator.controllers import render_cache as ref_render_cache
from tpu_operator.kube import apply as ref_apply
from tpu_operator.kube import cache as ref_cache
from tpu_operator.kube import client as ref_client
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube import warm as ref_warm
from tpu_operator_torch import consts, convert
from tpu_operator_torch.controllers import render_cache
from tpu_operator_torch.kube import apply, cache, client, kubesim, testing, warm
from tpu_operator_torch.kube.frozen import thaw

NS = "tpu-operator"
WAIT_S = 30
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SAMPLE = os.path.join(REPO, "config", "samples", "v1_clusterpolicy.yaml")
SIDES = {
    "reference": SimpleNamespace(warm=ref_warm, cache=ref_cache, client=ref_client, apply=ref_apply,
                                 render_cache=ref_render_cache, kubesim=ref_kubesim, testing=ref_testing),
    "port": SimpleNamespace(warm=warm, cache=cache, client=client, apply=apply, render_cache=render_cache,
                            kubesim=kubesim, testing=testing),
}


def journal(side, tmp_path, **kw):
    return side.warm.WarmJournal(str(tmp_path / "warm.json"), **kw)


def j_rules(side, tmp_path):
    out = []
    j = journal(side, tmp_path)
    out.append(j.save({"namespace": NS, "applyset": [["v1", "Node", "", "n"]]}))
    payload = j.load(NS)
    out.append([payload["applyset"], payload["schema"], j.saves_total, j.last_save_bytes > 0])

    def rewrite(**fields):
        with open(j.path) as f:
            blob = json.load(f)
        blob.update(fields)
        with open(j.path, "w") as f:
            json.dump(blob, f)

    rewrite(schema=999)
    out.append(j.load(NS))
    j.save({"namespace": NS})
    rewrite(saved_at=time.time() - 10)
    out.append([journal(side, tmp_path, max_age_s=5).load(NS), journal(side, tmp_path, max_age_s=60).load(NS) is not None])
    rewrite(saved_at=time.time() + 3600)  # from the future: not trusted
    out.append(journal(side, tmp_path, max_age_s=60).load(NS))
    j.save({"namespace": "other"})
    out.append([j.load(NS), j.load("other") is not None, j.load("") is not None])
    with open(j.path, "w") as f:
        f.write("{not json")
    out.append(j.load(NS))
    os.unlink(j.path)
    out.append(j.load(NS))
    out.append(journal(side, tmp_path).save({"bad": object()}))
    return out


def test_journal_rules_match_reference(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = j_rules(SIDES["reference"], tmp_path / "r")
    assert j_rules(SIDES["port"], tmp_path / "p") == ref
    assert ref == [True, [[["v1", "Node", "", "n"]], 1, 1, True], None, [None, True], None, [None, True, True],
                   None, None, False]
    assert warm.SCHEMA == ref_warm.SCHEMA == 1


def test_env_names(monkeypatch):
    assert consts.WARM_STATE_ENV == "GPU_OPERATOR_WARM_STATE"
    for value, want in ((None, 15.0), ("2.5", 2.5), ("junk", 15.0)):
        if value is None:
            monkeypatch.delenv("WARM_STATE_SAVE_INTERVAL_S", raising=False)
        else:
            monkeypatch.setenv("WARM_STATE_SAVE_INTERVAL_S", value)
        assert warm.save_interval_s() == ref_warm.save_interval_s() == want
    monkeypatch.setenv("WARM_STATE_MAX_AGE_S", "7")
    assert warm.WarmJournal("x").max_age_s == ref_warm.WarmJournal("x").max_age_s == 7.0


def test_shard_slice_matches_reference():
    informers = {
        "v1|Node": {"namespace": "", "rv": 42, "objects": [{"metadata": {"name": "keep-1"}},
                                                         {"metadata": {"name": "drop-1"}}]},
        "v1|Pod": {"namespace": "", "rv": 42, "objects": [
            {"metadata": {"name": "p1"}, "spec": {"nodeName": "keep-1"}},
            {"metadata": {"name": "p2"}, "spec": {"nodeName": "drop-1"}},
            {"metadata": {"name": "p3"}, "spec": {}}]},
        "apps/v1|DaemonSet": {"namespace": NS, "rv": 42, "objects": [{"metadata": {"name": "ds"}}]},
    }
    keep = lambda name, node: name.startswith("keep")  # noqa: E731
    out = warm.journal_shard_slice(copy.deepcopy(informers), keep)
    assert out == ref_warm.journal_shard_slice(copy.deepcopy(informers), keep)
    assert [o["metadata"]["name"] for o in out["v1|Pod"]["objects"]] == ["p1", "p3"]
    assert out["v1|Node"]["rv"] == 42 and len(out["apps/v1|DaemonSet"]["objects"]) == 1
    assert warm.journal_shard_slice(None, keep) == {}


# ---------------------------------------------------------------------------
# one world, journalled by one side and seeded into the other
# ---------------------------------------------------------------------------


def reference_world():
    with open(REF_SAMPLE) as f:
        cp = yaml.safe_load(f)
    nodes = []
    for i in range(3):
        n = ref_testing.make_tpu_node(f"w-node-{i}", extra_labels={"tpu.k8s.io/tpu.libtpu-version": "1.2"})
        n["status"]["capacity"] = {"google.com/tpu": "4", "cpu": "8"}
        n["status"]["allocatable"] = {"google.com/tpu": str(4 - i), "cpu": "8"}
        nodes.append(n)
    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"tpu-libtpu-daemonset-w-node-{i}", "namespace": NS,
                          "labels": {"app": "tpu-libtpu-daemonset"}},
             "spec": {"nodeName": f"w-node-{i}"}} for i in range(3)]
    pods.append({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "train", "namespace": "user-ns"},
                 "spec": {"nodeName": "w-node-0",
                          "containers": [{"name": "c", "resources": {"limits": {"google.com/tpu": "4"}}}]}})
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "tpu-libtpu-daemonset", "namespace": NS, "labels": {"app": "tpu-libtpu-daemonset"}},
          "spec": {"selector": {"matchLabels": {"app": "tpu-libtpu-daemonset"}},
                   "template": {"metadata": {"labels": {"app": "tpu-libtpu-daemonset"}}, "spec": {}}}}
    return ([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}, cp] + nodes + pods + [ds]
            + [{"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm", "namespace": NS}, "data": {"k": "v"}}])


def world_for(side_name):
    objs = reference_world()
    return objs if side_name == "reference" else [convert.object_from_reference(o) for o in objs]


def standin(side):
    rc = side.render_cache.RenderCache()
    rc.begin_pass(side.render_cache.render_fingerprint({"spec": {"a": 1}, "metadata": {"uid": "u"}}, NS, "containerd",
                                                        False), ["g1"])
    from_ref = {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": "ds", "namespace": NS}}
    rc.store(("state-driver", "DaemonSet", "ds", "g1"), from_ref, "h1", "state-driver", 0.001, "g1")
    aps = side.apply.ApplySet([("apps/v1", "DaemonSet", NS, "ds"), ("v1", "ConfigMap", NS, "cm")])
    return SimpleNamespace(ctrl=SimpleNamespace(render_cache=rc, applyset=aps))


def stores(cached):
    return {f"{av}|{kind}": [thaw(o) for o in inf.list()] for (av, kind), inf in cached._informers.items()
            if inf.synced.is_set()}


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_journal_seeds_the_other_side(tmp_path, writer, reader):
    w, r = SIDES[writer], SIDES[reader]
    live = w.cache.CachedClient(w.client.FakeClient(world_for(writer)), namespace=NS, resync_interval_s=0)
    assert live.start_informers()
    j = w.warm.WarmJournal(str(tmp_path / "warm.json"))
    assert j.save(w.warm.export_state(live, standin(w), NS))
    payload = r.warm.WarmJournal(j.path).load(NS)
    payload = (convert.warm_journal_from_reference if reader == "port" else convert.warm_journal_to_reference)(payload)

    cold = r.cache.CachedClient(r.client.FakeClient(world_for(reader)), namespace=NS, resync_interval_s=0)
    assert cold.start_informers()
    seeded = r.cache.CachedClient(r.client.FakeClient(), namespace=NS, resync_interval_s=0)
    target = SimpleNamespace(ctrl=SimpleNamespace(render_cache=r.render_cache.RenderCache(), applyset=None))
    counts = r.warm.seed_state(seeded, target, payload)
    assert counts == {"informer_kinds": len(payload["informers"]), "render_entries": 1, "applyset_members": 2}
    assert stores(seeded) == stores(cold)
    assert target.ctrl.applyset.members() == standin(r).ctrl.applyset.members()
    assert target.ctrl.render_cache.export() == standin(r).ctrl.render_cache.export()
    # the accelerator surfaces arrived renamed
    nodes = stores(seeded)["v1|Node"]
    want = "nvidia.com/gpu" if reader == "port" else "google.com/tpu"
    assert [n["status"]["allocatable"][want] for n in nodes] == ["4", "3", "2"]


def test_export_and_seed_match_reference(tmp_path):
    outs = {}
    for name, side in SIDES.items():
        live = side.cache.CachedClient(side.client.FakeClient(world_for(name)), namespace=NS, resync_interval_s=0)
        assert live.start_informers()
        payload = side.warm.export_state(live, standin(side), NS)
        bare = side.warm.export_state(side.client.FakeClient(), None, NS)
        empty = side.warm.seed_state(live, None, {})
        outs[name] = [sorted(payload), sorted(payload["informers"]), payload["applyset"], payload["render_cache"],
                      bare, empty, side.warm.seed_state(side.cache.CachedClient(side.client.FakeClient()), None,
                                                         {"informers": {}})]
        outs[name][1] = [(k, len(payload["informers"][k]["objects"])) for k in outs[name][1]]
    assert outs["port"] == outs["reference"]
    assert outs["reference"][4] == {"namespace": NS}


# ---------------------------------------------------------------------------
# warm start over HTTP: no LIST, and the change made while down is seen
# ---------------------------------------------------------------------------


def warm_start(writer, reader, server, tmp_path):
    w, r = SIDES[writer], SIDES[reader]
    live = w.cache.CachedClient(w.kubesim.make_client(server.port), namespace=NS, resync_interval_s=0)
    try:
        assert live.start_informers(timeout_s=WAIT_S)
        path = str(tmp_path / f"{writer}-{reader}.json")
        assert w.warm.WarmJournal(path).save(w.warm.export_state(live, None, NS))
    finally:
        live.stop(timeout_s=WAIT_S)
    assert live._threads == []
    raw = r.kubesim.make_client(server.port)
    stamp = f"{writer}-{reader}"
    got = raw.get("v1", "Node", "fake-gpu-node-1")
    got["metadata"]["labels"]["changed-while-down"] = stamp
    raw.update(got)

    payload = r.warm.WarmJournal(path).load(NS)
    if writer != reader:
        payload = (convert.warm_journal_from_reference if reader == "port" else convert.warm_journal_to_reference)(
            payload)
    warm_cache = r.cache.CachedClient(r.kubesim.make_client(server.port), namespace=NS, resync_interval_s=0)
    try:
        seeded = r.warm.seed_state(warm_cache, None, payload)["informer_kinds"]
        lists = server.sim.request_counts.get("LIST", 0)
        synced = warm_cache.start_informers(timeout_s=WAIT_S)
        listed = server.sim.request_counts.get("LIST", 0) - lists
        deadline = time.monotonic() + WAIT_S
        seen = False
        while time.monotonic() < deadline and not seen:
            labels = warm_cache.get("v1", "Node", "fake-gpu-node-1")["metadata"].get("labels", {})
            seen = labels.get("changed-while-down") == stamp
            time.sleep(0.02)
    finally:
        warm_cache.stop(timeout_s=WAIT_S)
    return [seeded, synced, listed, seen, warm_cache._threads]


@pytest.mark.parametrize("server_side", list(SIDES))
def test_warm_start_lists_nothing_and_sees_changes(tmp_path, server_side):
    kube = SIDES[server_side].kubesim
    server = kube.KubeSimServer(kube.KubeSim(bookmark_interval_s=0.5)).start()
    try:
        testing.seed_cluster(kubesim.make_client(server.port), NS)
        kinds = len(cache.default_cache_specs(consts.API_VERSION, NS))
        for writer in SIDES:
            for reader in SIDES:
                assert warm_start(writer, reader, server, tmp_path) == [kinds, True, 0, True, []], (writer, reader)
    finally:
        server.stop()
