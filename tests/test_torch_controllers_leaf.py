"""The port's leaf modules of the state machine against the JAX package's:
the render cache (``controllers/render_cache.py``), the per-pass cluster
snapshot (``controllers/cluster_snapshot.py``), the asset loader
(``controllers/resource_manager.py``) and the operator's metrics
(``controllers/operator_metrics.py``).

The render cache and the snapshot are driven with one script per case on
each side (the snapshot over each side's ``FakeClient`` and
``CachedClient``); their logs, digests and stats must be equal. The asset
loader reads every directory of the reference's own ``assets/`` as data,
with and without OpenShift, and must give the same ``Resources`` by kind
and the same ordered control names. Both ``OperatorMetrics`` singletons
live in this process: each must install its hooks into its own package's
kube layer, and the port's series carry the ``gpu_operator`` namespace
(the reference's ``tpu_operator``), so one registry holds both. Without
``prometheus_client`` (blocked in a child process) every series is the
no-op. Exact equality throughout."""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

from tpu_operator.controllers import cluster_snapshot as ref_snapshot
from tpu_operator.controllers import operator_metrics as ref_metrics
from tpu_operator.controllers import render_cache as ref_render_cache
from tpu_operator.controllers import resource_manager as ref_rm
from tpu_operator.kube import cache as ref_cache
from tpu_operator.kube import client as ref_client
from tpu_operator.kube import rest as ref_rest
from tpu_operator.kube import write_pipeline as ref_wp
from tpu_operator_torch.controllers import cluster_snapshot, operator_metrics, render_cache, resource_manager
from tpu_operator_torch.kube import cache, client, rest, write_pipeline
from tpu_operator_torch.kube.frozen import thaw

NS = "tpu-operator"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
SIDES = {
    "reference": SimpleNamespace(rc=ref_render_cache, snap=ref_snapshot, rm=ref_rm, client=ref_client,
                                 cache=ref_cache),
    "port": SimpleNamespace(rc=render_cache, snap=cluster_snapshot, rm=resource_manager, client=client, cache=cache),
}


def both(script, *a):
    return script(SIDES["reference"], *a), script(SIDES["port"], *a)


# ---------------------------------------------------------------------------
# render cache
# ---------------------------------------------------------------------------

CR = {"spec": {"operator": {"defaultRuntime": "containerd"}, "driver": {"version": "550"}},
      "metadata": {"generation": 3, "uid": "u-1"}}


def manifest(name, gen=None):
    return {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": name, "namespace": NS,
                                                                        "labels": {"gen": gen or ""}}}


def r_script(side):
    rc = side.rc.RenderCache()
    fp = side.rc.render_fingerprint(CR, NS, "containerd", False)
    out = [fp, side.rc.render_fingerprint(CR, NS, "crio", False), side.rc.render_fingerprint(CR, NS, "containerd", True),
           side.rc.render_fingerprint(dict(CR, metadata={"generation": 3, "uid": "u-2"}), NS, "containerd", False),
           side.rc._digest({"b": 1, "a": [1, 2]})]
    rc.begin_pass(fp, ["h100-sxm"])
    out.append(rc.lookup(("state-driver", "DaemonSet", "d", "h100-sxm")))
    rc.store(("state-driver", "DaemonSet", "d", "h100-sxm"), manifest("d", "h100-sxm"), "h1", "state-driver", 0.002,
             "h100-sxm")
    rc.store(("state-plugin", "DaemonSet", "p", ""), manifest("p"), "h2", "state-plugin", 0.001)
    got = rc.lookup(("state-driver", "DaemonSet", "d", "h100-sxm"))
    out.append([thaw(got[0]), got[1], len(rc)])
    rc.begin_pass(fp, ["h100-sxm", "h100-pcie"])  # a variant appears: nothing dropped
    out.append([len(rc), rc.fingerprint])
    rc.begin_pass(fp, ["h100-pcie"])  # a variant goes: exactly its entry drops
    out.append([len(rc), rc.lookup(("state-driver", "DaemonSet", "d", "h100-sxm")),
                rc.lookup(("state-plugin", "DaemonSet", "p", ""))[1]])
    exported = rc.export()
    stats = rc.stats()
    out.append([exported, {k: v for k, v in stats.items()}])
    rc.begin_pass(side.rc.render_fingerprint(CR, NS, "crio", False), ["h100-pcie"])  # base change: all cleared
    out.append([len(rc), rc.invalidations])
    seeded = side.rc.RenderCache()
    out.append([seeded.seed(exported), len(seeded), seeded.fingerprint, seeded.seed(exported),
                side.rc.RenderCache().seed({"base_fp": "x", "entries": [{"key": ["a"], "obj": {}, "hash": "h"}]}),
                side.rc.RenderCache().seed({})])
    seeded.begin_pass(fp, ["h100-pcie"])
    out.append([len(seeded), seeded.lookup(("state-plugin", "DaemonSet", "p", ""))[1]])
    return out


def test_render_cache_matches_reference():
    ref, port = both(r_script)
    assert port == ref
    assert ref[5] is None and ref[6][2] == 2 and ref[8][:2] == [1, None] and ref[10] == [0, 1]


def test_render_cache_views_are_frozen():
    for side in SIDES.values():
        rc = side.rc.RenderCache()
        seeded = rc.seed({"base_fp": "b", "entries": [{"key": ["s", "k", "n", ""], "obj": manifest("n"), "hash": "h"}]})
        assert seeded == 1
        view, _ = rc.lookup(("s", "k", "n", ""))
        with pytest.raises(Exception) as e:
            view["metadata"]["name"] = "x"
        assert type(e.value).__name__ == "FrozenObjectError"


# ---------------------------------------------------------------------------
# cluster snapshot
# ---------------------------------------------------------------------------


def world(side):
    objs = [{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}]
    for i in range(6):
        objs.append({"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": f"n{i}", "labels": {"pool": "a" if i % 2 else "b",
                                                              "tpu.k8s.io/tpu.deploy.driver": "true" if i < 4 else "false"}}})
    for app in ("gpu-driver-daemonset", "gpu-operator-validator"):
        for i in range(3):
            objs.append({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": f"{app}-n{i}", "namespace": NS,
                                                                         "labels": {"app": app}},
                         "spec": {"nodeName": f"n{i}"}})
        objs.append({"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": app, "namespace": NS}})
    return side.client.FakeClient(objs)


def s_script(side, cached):
    c = world(side)
    if cached:
        c = side.cache.CachedClient(c, namespace=NS, resync_interval_s=0)
        assert c.start_informers()
    ns = {"value": ""}
    snap = side.snap.ClusterSnapshot(c, lambda: ns["value"] or NS)
    out = [[n["metadata"]["name"] for n in snap.nodes()], snap.nodes_version,
           snap.count_nodes_matching({"tpu.k8s.io/tpu.deploy.driver": "true"}),
           snap.count_nodes_matching({"tpu.k8s.io/tpu.deploy.driver": "true", "pool": "a"}),
           snap.count_nodes_matching({"tpu.k8s.io/tpu.deploy.driver": "true"}),
           [p["metadata"]["name"] for p in snap.pods_by_app("gpu-driver-daemonset")],
           [p["metadata"]["name"] for p in snap.pods_by_app("gpu-driver-daemonset")],
           [p["metadata"]["name"] for p in snap.pods_by_app("missing")],
           [d["metadata"]["name"] for d in snap.daemonsets()], len(snap.daemonsets())]
    try:
        snap.nodes().append({})
        out.append("mutable")
    except Exception as e:  # noqa: BLE001 - the class name is the result
        out.append(type(e).__name__)
    snap.set_nodes([n for n in snap.nodes() if n["metadata"]["name"] != "n0"])
    out += [snap.count_nodes_matching({"tpu.k8s.io/tpu.deploy.driver": "true"}), snap.nodes_version, snap.stats()]
    return out


@pytest.mark.parametrize("cached", [False, True])
def test_cluster_snapshot_matches_reference(cached):
    ref, port = both(s_script, cached)
    assert port == ref
    assert ref[2:5] == [4, 2, 4] and ref[5] == ref[6] == ["gpu-driver-daemonset-n0", "gpu-driver-daemonset-n1",
                                                          "gpu-driver-daemonset-n2"]
    assert ref[10] == "FrozenObjectError" and ref[11] == 3
    assert (ref[1] is None) is (not cached)


# ---------------------------------------------------------------------------
# resource manager, on the reference's own assets
# ---------------------------------------------------------------------------

ASSET_DIRS = sorted(d for d in os.listdir(ASSETS) if os.path.isdir(os.path.join(ASSETS, d)))


@pytest.mark.parametrize("state", ASSET_DIRS)
def test_resource_manager_on_reference_assets(state):
    path = os.path.join(ASSETS, state)
    for openshift in (False, True):
        ref_res, ref_controls = ref_rm.add_resources_controls(path, openshift)
        res, controls = resource_manager.add_resources_controls(path, openshift)
        assert res.by_kind == ref_res.by_kind
        assert [name for name, _ in controls] == [name for name, _ in ref_controls]
        assert [obj for _, obj in controls] == [obj for _, obj in ref_controls]
        assert resource_manager.get_assets_from(path, openshift) == ref_rm.get_assets_from(path, openshift)
    assert resource_manager.KIND_TO_CONTROL == ref_rm.KIND_TO_CONTROL


def test_resource_manager_errors_match_reference(tmp_path):
    (tmp_path / "b.yaml").write_text("kind: ConfigMap\nmetadata: {name: b}\n---\n---\nkind: Service\nmetadata: {name: s}\n")
    (tmp_path / "a.yaml").write_text("kind: ServiceAccount\nmetadata: {name: a}\n")
    (tmp_path / "c-openshift.yaml").write_text("kind: SecurityContextConstraints\nmetadata: {name: scc}\n")
    (tmp_path / "notes.txt").write_text("not yaml")
    bad_kind, no_kind = tmp_path / "bad", tmp_path / "nokind"
    bad_kind.mkdir()
    no_kind.mkdir()
    (bad_kind / "x.yaml").write_text("kind: Widget\n")
    (no_kind / "x.yaml").write_text("metadata: {name: x}\n")
    out = {}
    for name, side in SIDES.items():
        res, controls = side.rm.add_resources_controls(str(tmp_path))
        log = [[c for c, _ in controls], [c for c, _ in side.rm.add_resources_controls(str(tmp_path), True)[1]],
               res.first("ConfigMap")["metadata"]["name"], res.of("Pod")]
        try:
            res.first("Pod")
        except KeyError as e:
            log.append(str(e))
        for d in (bad_kind, no_kind):
            try:
                side.rm.add_resources_controls(str(d))
            except ValueError as e:
                log.append(str(e).replace(str(d), "<dir>"))
        out[name] = log
    assert out["port"] == out["reference"]
    assert out["reference"][:2] == [["service_account", "config_map", "service"],
                                    ["service_account", "config_map", "service", "security_context_constraints"]]


# ---------------------------------------------------------------------------
# operator metrics
# ---------------------------------------------------------------------------


def test_metrics_hooks_point_at_their_own_package():
    from prometheus_client import REGISTRY, generate_latest

    port_m, ref_m = operator_metrics.OperatorMetrics(), ref_metrics.OperatorMetrics()
    assert port_m is operator_metrics.OperatorMetrics() and port_m is not ref_m
    assert write_pipeline.on_queue_wait_ms == port_m.write_pipeline_queue_wait_hist.observe
    assert rest.on_write_rtt_ms == port_m._observe_write_rtt
    assert client.on_conflict_retry == port_m.conflict_retries.inc
    assert ref_wp.on_queue_wait_ms == ref_m.write_pipeline_queue_wait_hist.observe
    assert ref_rest.on_write_rtt_ms == ref_m._observe_write_rtt
    assert ref_client.on_conflict_retry == ref_m.conflict_retries.inc

    def count(name, **labels):
        return REGISTRY.get_sample_value(name, labels) or 0.0

    before = [count("gpu_operator_write_pipeline_queue_wait_duration_ms_count"),
              count("tpu_operator_write_pipeline_queue_wait_duration_ms_count"),
              count("gpu_operator_apiserver_write_rtt_ms_count", verb="APPLY")]
    pipe = write_pipeline.WritePipeline(depth=2)
    for i in range(5):
        pipe.submit(i, lambda: None)
    pipe.drain(timeout=30)
    rest.on_write_rtt_ms("APPLY", 2.0)
    after = [count("gpu_operator_write_pipeline_queue_wait_duration_ms_count"),
             count("tpu_operator_write_pipeline_queue_wait_duration_ms_count"),
             count("gpu_operator_apiserver_write_rtt_ms_count", verb="APPLY")]
    assert [a - b for a, b in zip(after, before)] == [5, 0, 1]
    text = generate_latest(REGISTRY).decode()
    assert "gpu_operator_write_pipeline_queue_wait_duration_ms_bucket" in text
    assert "tpu_operator_write_pipeline_queue_wait_duration_ms_bucket" in text


def test_metrics_series_match_reference_under_their_namespace():
    port_m, ref_m = operator_metrics.OperatorMetrics(), ref_metrics.OperatorMetrics()

    def series(m, ns):
        out = {}
        for attr, v in sorted(vars(m).items()):
            name = getattr(v, "_name", None)
            if name is not None:
                out[attr] = (type(v).__name__, name[len(ns) + 1:], tuple(getattr(v, "_labelnames", ())),
                             tuple(getattr(v, "_upper_bounds", ())))
        return out

    port_series = series(port_m, "gpu_operator")
    assert port_series == series(ref_m, "tpu_operator") and len(port_series) > 40
    port_m.observe_reconcile(1)
    port_m.observe_reconcile(-1)
    port_m.set_state("state-driver", 1)
    from prometheus_client import REGISTRY

    assert REGISTRY.get_sample_value("gpu_operator_operand_state", {"state": "state-driver"}) == 1.0
    assert REGISTRY.get_sample_value("gpu_operator_reconciliation_status") == -1.0


NOPROM = textwrap.dedent("""
    import sys
    sys.path.insert(0, {block!r})
    sys.path.insert(0, {repo!r})
    from tpu_operator_torch.controllers.operator_metrics import HAVE_PROM, OperatorMetrics, _NoopMetric
    assert not HAVE_PROM
    m = OperatorMetrics()
    stubs = 0
    for name in vars(m):
        attr = getattr(m, name)
        if isinstance(attr, _NoopMetric):
            attr.labels(state="x").set(1)
            attr.inc()
            attr.dec()
            attr.observe(1.0)
            attr.remove("x")
            stubs += 1
    m.observe_reconcile(1)
    m.observe_reconcile(-1)
    m.set_state("state-driver", 1)
    from tpu_operator_torch.kube import client, rest, write_pipeline
    write_pipeline.on_queue_wait_ms(1.0)
    rest.on_write_rtt_ms("APPLY", 2.0)
    client.on_conflict_retry()
    pipe = write_pipeline.WritePipeline(depth=2)
    pipe.submit("k", lambda: None)
    assert pipe.drain(timeout=30) == []
    assert "tpu_operator." not in " ".join(sys.modules) and "prometheus_client" not in sys.modules
    print("NOOP", stubs)
""")


def test_metrics_without_prometheus_are_noops(tmp_path):
    block = tmp_path / "block"
    block.mkdir()
    (block / "prometheus_client.py").write_text('raise ImportError("prometheus_client blocked")\n')
    proc = subprocess.run([sys.executable, "-c", NOPROM.format(block=str(block), repo=REPO)], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[0] == "NOOP" and int(proc.stdout.split()[1]) > 40
