"""Tracing and the flight recorder on the port (``obs/trace.py``,
``obs/flight.py``) against the JAX package's, on 13 of the 14 cases of
``tests/test_obs.py``: the disabled fast path, span nesting and self time,
errors and attributes on a span, the chrome export, the tracer's and the
flight recorder's bounded rings, the dump and its rate limit and sink,
spans flowing into the flight ring, the latency histograms and the
queue-wait hook, a traced reconcile pass over the whole layer stack, and
the degraded-state dump once per transition.

Each case runs on each package (``two_sided.hold``) with the same spans,
records and cluster (the reference's TPU nodes and sample CR, the port's
H100 nodes and sample CR, one name for both), and the reference's
assertions made on each side. The outcomes compared are structural: span
names, layers and counts, parent links, ring sizes, dump reasons and
details, the histograms present, the degraded state named. A duration is
never compared and no time is asserted; the nesting case holds only that
a parent's self time excludes its child's, which its spans' containment
decides. ``test_tracing_overhead_smoke`` is a wall-clock ratio check and
is not held here (``tests/test_torch_parity.py``).
"""

import json
import os
from types import SimpleNamespace

import pytest
import yaml

from tests.two_sided import BY_SIDE, hold
from tpu_operator.controllers import clusterpolicy_controller as ref_cpc
from tpu_operator.controllers import object_controls as ref_oc
from tpu_operator.controllers import operator_metrics as ref_om
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube import write_pipeline as ref_wp
from tpu_operator.obs import flight as ref_flight
from tpu_operator.obs import trace as ref_trace
from tpu_operator_torch import consts
from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
from tpu_operator_torch.controllers import object_controls as oc
from tpu_operator_torch.controllers import operator_metrics as om
from tpu_operator_torch.kube import testing, write_pipeline as wp
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.obs import flight, trace

NS = "tpu-operator"

SIDES = {
    "reference": SimpleNamespace(
        name="reference", trace=ref_trace, flight=ref_flight, om=ref_om, wp=ref_wp, cpc=ref_cpc, oc=ref_oc,
        testing=ref_testing, FakeClient=RefFakeClient, node=ref_testing.make_tpu_node, metrics_ns="tpu_operator"),
    "port": SimpleNamespace(
        name="port", trace=trace, flight=flight, om=om, wp=wp, cpc=cpc, oc=oc, testing=testing,
        FakeClient=FakeClient, node=testing.make_gpu_node, metrics_ns=consts.METRICS_NAMESPACE),
}

HISTOGRAMS = ("reconcile_pass_ms_hist", "state_render_ms_hist", "write_pipeline_queue_wait_hist",
              "apply_rtt_ms_hist", "alloc_latency_ms_hist")


def _reset():
    for side in SIDES.values():
        side.trace.disable()
        side.trace.TRACER.reset()
        side.flight.RECORDER.clear()


@pytest.fixture(autouse=True)
def clean_tracer(monkeypatch):
    """Both packages' tracers off and empty around each case, as the
    reference's fixture leaves its own."""
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")
    _reset()
    yield
    _reset()


# --- the tracer --------------------------------------------------------------

@BY_SIDE
def test_span_disabled_is_shared_noop(side):
    def script(side):
        t = side.trace
        assert not t.TRACER.enabled
        a = t.span("pass.x", k=1)
        b = t.span("state.y")
        assert a is b is t.NOOP  # the disabled path allocates nothing
        with a as sp:
            sp.set("ignored", True)
        counts = [t.TRACER.spans_total]
        t.instant("pass.marker")
        counts.append(t.TRACER.spans_total)
        assert counts == [0, 0]
        return counts

    hold(SIDES, side, script)


@BY_SIDE
def test_span_nesting_parents_and_self_time(side):
    def script(side):
        t = side.trace
        t.enable()
        with t.span("pass.outer"):
            with t.span("state.inner", state="s1"):
                pass
        summary = t.TRACER.mark_pass()
        assert set(summary) == {"pass", "state"}
        # the child's time is inside the parent's total and outside its self time
        assert summary["pass"]["total_ms"] >= summary["state"]["total_ms"]
        assert summary["pass"]["self_ms"] <= summary["pass"]["total_ms"]
        assert summary["state"]["spans"] == 1
        again = t.TRACER.mark_pass()
        assert again == {}
        return {layer: (sorted(v), v["spans"]) for layer, v in summary.items()}, again

    hold(SIDES, side, script)


@BY_SIDE
def test_span_records_error_and_attrs(side):
    def script(side):
        t = side.trace
        t.enable()
        with pytest.raises(ValueError):
            with t.span("rest.request", verb="PUT") as sp:
                sp.set("retries", 2)
                raise ValueError("boom")
        assert t.TRACER.stats()["spans_total"] == 1
        args = list(t.TRACER._spans)[0]["args"]
        picked = {k: args[k] for k in ("verb", "retries", "error")}
        assert picked == {"verb": "PUT", "retries": 2, "error": "ValueError"}
        return picked, sorted(args), sorted(t.TRACER.stats())

    hold(SIDES, side, script)


@BY_SIDE
def test_chrome_export_is_perfetto_loadable_json(side, tmp_path):
    def script(side):
        t = side.trace
        t.enable()
        with t.span("pass.reconcile"):
            with t.span("apply.object", kind="DaemonSet", name="d"):
                pass
        t.instant("render.cache_hit", state="s")
        out = tmp_path / f"trace-{side.name}.json"
        n = t.TRACER.export_chrome(str(out))
        assert n == 3
        events = json.loads(out.read_text())["traceEvents"]
        assert len(events) == 3
        durations = [e for e in events if e["ph"] == "X"]
        instants = [e for e in events if e["ph"] == "i"]
        assert len(durations) == 2 and len(instants) == 1
        for e in durations:
            assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
        child = next(e for e in durations if e["name"] == "apply.object")
        parent = next(e for e in durations if e["name"] == "pass.reconcile")
        assert child["args"]["parent"] == parent["id"]
        return n, sorted((e["ph"], e["name"], e["cat"], sorted(e)) for e in events), child["args"]["kind"]

    hold(SIDES, side, script)


@BY_SIDE
def test_tracer_ring_is_bounded(side):
    def script(side):
        t = side.trace.Tracer(capacity=64)
        t.enable()
        for _ in range(200):
            with side.trace._SpanHandle(t, "pass.x", {}):
                pass
        assert t.spans_total == 200
        assert len(t._spans) == 64
        return t.spans_total, len(t._spans)

    hold(SIDES, side, script)


# --- the flight recorder -----------------------------------------------------

def recorder(side, tmp_path, **kw):
    rec = side.flight.FlightRecorder(**kw)
    rec.dir = str(tmp_path / side.name)
    return rec


@BY_SIDE
def test_flight_ring_bounded_and_dump(side, tmp_path):
    def script(side):
        rec = recorder(side, tmp_path, event_capacity=32)
        rec.min_interval_s = 0.0
        for i in range(100):
            rec.record("labels.write", nodes=i)
        assert rec.events_total == 100
        snap = rec.snapshot()
        assert len(snap["events"]) == 32
        assert snap["events"][-1]["nodes"] == 99
        sink_calls = []
        rec.event_sink = lambda reason, detail, path: sink_calls.append((reason, detail, path))
        path = rec.dump("unit-test", detail="forced")
        assert path and os.path.exists(path)
        data = json.loads(open(path).read())
        assert (data["reason"], data["detail"], len(data["events"])) == ("unit-test", "forced", 32)
        assert sink_calls == [("unit-test", "forced", path)]
        assert rec.stats()["dumps_total"] == 1
        return (rec.events_total, [e["nodes"] for e in snap["events"]], sorted(data),
                [(r, d) for r, d, _ in sink_calls], sorted(rec.stats()))

    hold(SIDES, side, script)


@BY_SIDE
def test_flight_dump_rate_limited(side, tmp_path):
    def script(side):
        rec = recorder(side, tmp_path)
        rec.min_interval_s = 60.0
        got = [rec.dump("same-reason") is not None, rec.dump("same-reason") is not None,
               rec.dump("other-reason") is not None]
        assert got == [True, False, True]  # per-reason limiter
        assert rec.dumps_total == 2
        return got, rec.dumps_total

    hold(SIDES, side, script)


@BY_SIDE
def test_spans_flow_into_flight_ring(side):
    def script(side):
        side.trace.enable()
        with side.trace.span("fsm.remediation"):
            pass
        names = [s["name"] for s in side.flight.RECORDER.snapshot()["spans"]]
        assert "fsm.remediation" in names
        return names

    hold(SIDES, side, script)


@BY_SIDE
def test_flight_broken_sink_never_breaks_dump(side, tmp_path):
    def script(side):
        rec = recorder(side, tmp_path)
        rec.min_interval_s = 0.0

        def broken(*a):
            raise RuntimeError("sink down")

        rec.event_sink = broken
        path = rec.dump("x")
        assert path is not None
        return json.loads(open(path).read())["reason"], rec.dumps_total

    hold(SIDES, side, script)


# --- the latency histograms ----------------------------------------------------

@BY_SIDE
def test_latency_histograms_registered_and_observable(side):
    def script(side):
        m = side.om.OperatorMetrics()
        present = [hasattr(m, attr) for attr in HISTOGRAMS]
        assert all(present)
        m.reconcile_pass_ms_hist.observe(12.0)
        m.state_render_ms_hist.labels(state="state-libtpu").observe(0.8)
        m.write_pipeline_queue_wait_hist.observe(0.2)
        m.apply_rtt_ms_hist.labels(verb="APPLY").observe(1.5)
        m.alloc_latency_ms_hist.observe(40.0)
        exported = None
        if side.om.HAVE_PROM:
            from prometheus_client import generate_latest

            text = generate_latest().decode()
            exported = (f"{side.metrics_ns}_reconcile_pass_duration_ms_bucket" in text, 'verb="APPLY"' in text)
            assert exported == (True, True)
        return present, side.om.HAVE_PROM, exported

    hold(SIDES, side, script)


@BY_SIDE
def test_queue_wait_hook_feeds_histogram(side):
    def script(side):
        side.om.OperatorMetrics()  # installs the hook
        assert side.wp.on_queue_wait_ms is not None
        observed = []
        orig = side.wp.on_queue_wait_ms
        side.wp.on_queue_wait_ms = observed.append
        try:
            pipe = side.wp.WritePipeline(depth=2, name="obs-test")
            value = pipe.submit("k", lambda: "v").result()
            pipe.drain()
        finally:
            side.wp.on_queue_wait_ms = orig
        assert len(observed) == 1 and observed[0] >= 0.0
        return value, len(observed)

    hold(SIDES, side, script)


# --- a traced pass over the layer stack ----------------------------------------

def mini_reconciler(side, n_nodes=4):
    objs = [{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}]
    client = side.FakeClient(objs + [side.node(f"obs-{i}") for i in range(n_nodes)])
    with open(side.testing.sample_clusterpolicy_path()) as f:
        cr = yaml.safe_load(f)
    cr["metadata"]["uid"] = "obs-uid"
    client.create(cr)
    return side.cpc.ClusterPolicyReconciler(client), client


@BY_SIDE
def test_traced_pass_covers_the_layer_stack(side):
    def script(side):
        r, client = mini_reconciler(side)
        side.trace.enable()
        for _ in range(3):
            r.reconcile()
            side.testing.simulate_kubelet_once(client, NS)
        layers = set(side.trace.TRACER.stats()["layers"])
        for expected in ("pass", "state", "render", "apply", "fsm"):
            assert expected in layers, (expected, layers)
        assert r.last_trace_summary, "reconciler did not seal a pass summary"
        return sorted(layers), sorted(r.last_trace_summary)

    hold(SIDES, side, script)


@BY_SIDE
def test_degraded_state_dumps_flight_once_per_transition(side, tmp_path, monkeypatch):
    def script(side):
        rec = side.flight.RECORDER
        r, client = mini_reconciler(side, n_nodes=1)
        monkeypatch.setattr(rec, "dir", str(tmp_path / side.name))
        monkeypatch.setattr(rec, "min_interval_s", 0.0)
        rec.clear()
        before = rec.dumps_total
        orig = side.oc.CONTROLS["daemonset"]

        def boom(n, state_name, obj):
            if state_name == "state-libtpu":
                raise RuntimeError("forced operand failure")
            return orig(n, state_name, obj)

        monkeypatch.setitem(side.oc.CONTROLS, "daemonset", boom)
        r.reconcile()
        assert rec.dumps_total == before + 1
        data = json.loads(open(rec.last_dump_path).read())
        assert data["reason"] == "state-degraded"
        assert "state-libtpu" in data["detail"]
        degraded = [e["state"] for e in data["events"] if e["kind"] == "state.degraded"]
        assert "state-libtpu" in degraded
        r.reconcile()  # the same degraded picture does not dump again
        assert rec.dumps_total == before + 1
        return data["reason"], data["detail"], degraded, rec.dumps_total - before

    hold(SIDES, side, script)
