"""The port's write pipeline, batch lane, Events and log-once registry
(``kube/write_pipeline.py``, ``kube/events.py``, ``obs/logonce.py``)
against the JAX package's.

Each script drives one side's module with the same submissions, records
and keys, and logs what comes out: the order each key's revisions
applied in, futures' values and the class names of their errors, drain
results, stats, batch cuts, the stored Events and the log lines. The
port's log must equal the reference's exactly, apart from the one rename:
an Event's ``source.component`` is ``gpu-operator`` in the port and
``tpu-operator`` in the reference. Timestamps are replaced before the
comparison; the correlator's window is pinned through each module's
``EVENT_REFRESH_INTERVAL_S`` so both sides see one schedule, and both
correlators are reset. Every wait has a limit, and no assertion reads a
wall-clock ratio."""

import logging
import threading
import time
from types import SimpleNamespace

import pytest

from tpu_operator.kube import client as ref_client
from tpu_operator.kube import events as ref_events
from tpu_operator.kube import write_pipeline as ref_wp
from tpu_operator.obs import logonce as ref_logonce
from tpu_operator_torch import consts
from tpu_operator_torch.kube import client, events, write_pipeline
from tpu_operator_torch.obs import LogOnce
from tpu_operator_torch.obs import logonce

NS = "tpu-operator"
WAIT_S = 30
SIDES = {
    "reference": SimpleNamespace(wp=ref_wp, events=ref_events, client=ref_client, logonce=ref_logonce),
    "port": SimpleNamespace(wp=write_pipeline, events=events, client=client, logonce=logonce),
}


def both(script, *a):
    return script(SIDES["reference"], *a), script(SIDES["port"], *a)


# ---------------------------------------------------------------------------
# WritePipeline
# ---------------------------------------------------------------------------


def p_ordering(side, depth):
    pipe = side.wp.WritePipeline(depth=depth)
    applied = {}
    lock = threading.Lock()

    def apply(key, rev):
        # a task's length varies with key and revision, so a later
        # submission would overtake an earlier one if order rode on timing
        time.sleep(0.0003 * ((rev * 7 + key) % 5))
        with lock:
            applied.setdefault(key, []).append(rev)

    for rev in range(20):
        for key in range(32):
            pipe.submit(("Node", "", f"n{key}"), apply, key, rev)
    out = [pipe.drain(timeout=60), [applied[k] for k in range(32)]]
    assert out == [[], [list(range(20))] * 32]
    return out


@pytest.mark.parametrize("depth", [1, 2, 4, 16, 64])
def test_per_key_order_at_every_depth_matches_reference(depth):
    ref, port = both(p_ordering, depth)
    assert port == ref


def p_overlap(side):
    pipe = side.wp.WritePipeline(depth=4)
    barrier = threading.Barrier(2, timeout=10)

    def task():
        barrier.wait()  # only both tasks at once release it
        return "ok"

    f1 = pipe.submit(("Node", "", "a"), task)
    f2 = pipe.submit(("Node", "", "b"), task)
    return [f1.result(timeout=WAIT_S), f2.result(timeout=WAIT_S), pipe.stats()["inflight_peak"] >= 2]


def p_same_key_serial(side):
    pipe = side.wp.WritePipeline(depth=8)
    active, overlap = [], []
    lock = threading.Lock()

    def task(i):
        with lock:
            active.append(i)
            if len(active) > 1:
                overlap.append(tuple(active))
        time.sleep(0.002)
        with lock:
            active.remove(i)

    for i in range(25):
        pipe.submit(("Node", "", "same"), task, i)
    return [pipe.drain(timeout=WAIT_S), overlap]


def p_errors(side):
    pipe = side.wp.WritePipeline(depth=4)

    def boom():
        raise ConnectionResetError("socket died")

    fut = pipe.submit("k", boom)
    try:
        fut.result(timeout=WAIT_S)
        raised = None
    except ConnectionResetError as e:
        raised = str(e)
    errors = pipe.drain()
    out = [raised, [type(e).__name__ for e in errors], pipe.drain()]
    pipe.submit("a", lambda: 1)
    pipe.submit("b", lambda: (_ for _ in ()).throw(ValueError("bad")))
    try:
        pipe.drain(timeout=WAIT_S, raise_errors=True)
        out.append(None)
    except side.wp.PipelineError as e:
        out.append([type(e.errors[0]).__name__, type(e.__cause__).__name__, str(e)])
    return out


def p_inline(side):
    before = threading.active_count()
    pipe = side.wp.WritePipeline(depth=1)
    order = []
    for i in range(5):
        pipe.submit("k", order.append, i)
    return [order, pipe.drain(), threading.active_count() == before, pipe._executor is None,
            pipe.stats()["inline_total"]]


def p_drain_barrier(side):
    pipe = side.wp.WritePipeline(depth=2)
    done = []

    def slow(i):
        time.sleep(0.01)
        done.append(i)

    for i in range(6):
        pipe.submit(f"k{i % 3}", slow, i)
    pipe.drain(timeout=WAIT_S)
    return [len(done), sorted(done)]


def p_stats(side):
    pipe = side.wp.WritePipeline(depth=3)
    pipe.submit("a", lambda: None)
    pipe.drain(timeout=WAIT_S)
    stats = pipe.stats()
    return [sorted(stats), {k: stats[k] for k in ("depth", "inflight", "outstanding", "submitted_total",
                                                  "completed_total", "errors_total", "inline_total")},
            0.0 <= pipe.utilization(wall_s=1.0) <= 1.0, pipe.utilization(0)]


def p_queue_wait_hook(side):
    seen = []
    installed, side.wp.on_queue_wait_ms = side.wp.on_queue_wait_ms, seen.append
    try:
        for depth in (1, 4):
            pipe = side.wp.WritePipeline(depth=depth)
            for i in range(10):
                pipe.submit(("k", i % 3), lambda: None)
            pipe.drain(timeout=WAIT_S)
    finally:
        side.wp.on_queue_wait_ms = installed
    return [len(seen), all(ms >= 0 for ms in seen)]


def p_defaults(side, monkeypatch):
    out = []
    for value in (None, "4", "junk"):
        for var in ("WRITE_PIPELINE_DEPTH", "APPLY_BATCH_MAX"):
            if value is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, value)
        out.append([side.wp.default_depth(), side.wp.default_batch_max(), side.wp.WritePipeline().depth])
    return out


def p_executor_reaped(side):
    pipe = side.wp.WritePipeline(depth=4, name="reaped")
    pipe.submit("a", lambda: None)
    pipe.drain(timeout=WAIT_S)
    executor = pipe._executor
    del pipe
    import gc

    gc.collect()
    return [executor._shutdown]


PIPE_SCRIPTS = {f.__name__[2:]: f for f in [p_overlap, p_same_key_serial, p_errors, p_inline, p_drain_barrier,
                                             p_stats, p_queue_wait_hook, p_executor_reaped]}


@pytest.mark.parametrize("name", list(PIPE_SCRIPTS))
def test_pipeline_script_matches_reference(name):
    ref, port = both(PIPE_SCRIPTS[name])
    assert port == ref
    expect = {"overlap": ["ok", "ok", True], "same_key_serial": [[], []], "inline": [[0, 1, 2, 3, 4], [], True, True, 5],
              "drain_barrier": [6, list(range(6))], "queue_wait_hook": [20, True], "executor_reaped": [True]}
    if name in expect:
        assert ref == expect[name]


def test_defaults_match_reference(monkeypatch):
    ref = p_defaults(SIDES["reference"], monkeypatch)
    assert p_defaults(SIDES["port"], monkeypatch) == ref == [[16, 64, 16], [4, 4, 4], [16, 64, 16]]


# ---------------------------------------------------------------------------
# BatchLane
# ---------------------------------------------------------------------------


def l_batches(side, depth, shards):
    pipe = side.wp.WritePipeline(depth=depth)
    flushed = []
    lock = threading.Lock()

    def flush(payloads):
        with lock:
            flushed.append(list(payloads))
        return [(p, ValueError(f"bad {p}") if p.endswith("-bad") else None) for p in payloads]

    lane = side.wp.BatchLane(pipe, flush, name="t", max_batch=4, shards=shards)
    futs = [lane.submit(("Node", "", f"n{i % 6}"), f"n{i % 6}-r{i}" + ("-bad" if i == 7 else ""))
            for i in range(10)]
    out_errors = pipe.drain(timeout=WAIT_S)
    results = []
    for f in futs:
        try:
            results.append(("ok", f.result(timeout=WAIT_S)))
        except ValueError as e:
            results.append(("err", str(e)))
    per_key = {}
    for batch in flushed:
        assert len(batch) <= 4 and len({p.split("-")[0] for p in batch}) == len(batch)
        for p in batch:
            per_key.setdefault(p.split("-")[0], []).append(p)
    stats = lane.stats()
    return [out_errors, results, per_key, stats["items_total"], stats["items_failed_total"], stats["queued"]]


@pytest.mark.parametrize("depth,shards", [(1, 1), (4, 1), (4, 3), (16, 4)])
def test_batch_lane_matches_reference(depth, shards):
    ref, port = both(l_batches, depth, shards)
    assert port == ref
    assert ref[1][7] == ("err", "bad n1-r7-bad") and ref[4] == 1 and ref[5] == 0
    assert ref[2]["n0"] == ["n0-r0", "n0-r6"]  # two revisions of one key, in order


def l_flush_raises(side):
    pipe = side.wp.WritePipeline(depth=2)

    def flush(payloads):
        raise RuntimeError("wire down")

    lane = side.wp.BatchLane(pipe, flush, max_batch=2)
    futs = [lane.submit(i, i) for i in range(5)]
    errors = pipe.drain(timeout=WAIT_S)
    out = []
    for f in futs:
        try:
            f.result(timeout=WAIT_S)
        except RuntimeError as e:
            out.append(str(e))
    return [[type(e).__name__ for e in errors], out, lane.stats()["queued"]]


def test_batch_lane_flush_failure_matches_reference():
    ref, port = both(l_flush_raises)
    assert port == ref
    assert ref[1] == ["wire down"] * 5 and ref[2] == 0


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


def stored_events(c):
    out = []
    for e in c.list("v1", "Event", NS):
        e = {k: v for k, v in e.items() if k not in ("firstTimestamp", "lastTimestamp")}
        e["metadata"] = {k: e["metadata"][k] for k in ("name", "namespace", "resourceVersion")}
        if e.get("source", {}).get("component") == consts.EVENT_COMPONENT:
            e["source"] = {"component": "tpu-operator"}
        out.append(e)
    return out


def e_record(side, monkeypatch, involved, k):
    c = side.client.FakeClient()
    side.events.reset_correlator(c)
    monkeypatch.setattr(side.events, "EVENT_REFRESH_INTERVAL_S", 1e9)
    out = []
    for _ in range(k):  # inside the window: coalesced, nothing written
        side.events.record_event(c, NS, involved, "Normal", "CapacityChanged", "8 cards")
    out.append(stored_events(c))
    monkeypatch.setattr(side.events, "EVENT_REFRESH_INTERVAL_S", 0.0)
    side.events.record_event(c, NS, involved, "Normal", "CapacityChanged", "8 cards")
    out.append(stored_events(c))
    monkeypatch.setattr(side.events, "EVENT_REFRESH_INTERVAL_S", 1e9)
    side.events.record_event(c, NS, involved, "Warning", "CapacityChanged", "7 cards")  # a new message writes through
    side.events.record_event(c, NS, involved, "Normal", "SliceDegraded", "s1", dedup_extra="s1")
    side.events.record_event(c, NS, involved, "Normal", "SliceDegraded", "s2", dedup_extra="s2")
    side.events.record_event(c, NS, involved, "Normal", "Other", "x")
    out.append(stored_events(c))
    side.events.reset_correlator(c)
    return out


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("on", ["clusterpolicy", "node"])
def test_events_match_reference(monkeypatch, k, on):
    involved = ({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n1", "uid": "u1"}} if on == "node"
                else events.cluster_policy_ref())
    ref = e_record(SIDES["reference"], monkeypatch, ref_events.cluster_policy_ref() if on != "node" else involved, k)
    port = e_record(SIDES["port"], monkeypatch, involved, k)
    assert port == ref
    assert [e["count"] for e in ref[0]] == [1]  # the first record; its repeats coalesced
    assert [e["count"] for e in ref[1]] == [k + 1]  # one Event, the true count
    assert sorted((e["reason"], e["count"], e["message"]) for e in ref[2]) == [
        ("CapacityChanged", k + 2, "7 cards"), ("Other", 1, "x"), ("SliceDegraded", 1, "s1"),
        ("SliceDegraded", 1, "s2")]


def test_event_names_and_component():
    assert events.cluster_policy_ref() == ref_events.cluster_policy_ref()
    assert (events.TYPE_NORMAL, events.TYPE_WARNING) == (ref_events.TYPE_NORMAL, ref_events.TYPE_WARNING)
    assert (events.COMPONENT, ref_events.COMPONENT) == ("gpu-operator", "tpu-operator")
    c = client.FakeClient()
    events.record_event(c, NS, events.cluster_policy_ref(), "Normal", "R", "m")
    assert c.list("v1", "Event", NS)[0]["source"] == {"component": "gpu-operator"}
    events.reset_correlator(c)


# ---------------------------------------------------------------------------
# LogOnce
# ---------------------------------------------------------------------------


def o_script(side, caplog):
    logger = logging.getLogger(f"logonce-{id(side)}")
    reg = side.logonce.LogOnce()
    caplog.clear()
    with caplog.at_level(logging.DEBUG, logger=logger.name):
        firsts = [reg.log(logger, ("n1", "budget"), "deferred %s", "n1"),
                  reg.log(logger, ("n1", "budget"), "deferred %s", "n1"),
                  reg.log(logger, ("n2", "budget"), "deferred %s", "n2")]
        reg.clear(("n1", "budget"))
        firsts.append(reg.log(logger, ("n1", "budget"), "deferred %s", "n1", level=logging.WARNING))
    lines = [(r.levelname, r.getMessage()) for r in caplog.records if r.name == logger.name]
    reg.add(("alive", "budget"))
    reg.add(("dead", "budget"))
    reg.add(("dead", "interlock"))
    reg.add("plain-alive")
    reg.add("plain-dead")
    pruned = reg.prune({"alive", "plain-alive", "n1", "n2"})
    after = sorted(map(str, reg._seen))
    dropped = reg.discard_subject("n1")
    reg.discard("plain-alive")
    members = ["plain-alive" in reg, ("alive", "budget") in reg, len(reg)]
    reg.clear()
    return [firsts, lines, pruned, after, dropped, members, len(reg)]


def test_logonce_matches_reference(caplog):
    ref = o_script(SIDES["reference"], caplog)
    assert o_script(SIDES["port"], caplog) == ref
    assert ref[0] == [True, False, True, True]
    assert [lvl for lvl, _ in ref[1]] == ["INFO", "DEBUG", "INFO", "WARNING"]
    assert ref[2] == 3 and ref[4] == 1 and ref[5] == [False, True, 2]
    assert LogOnce is logonce.LogOnce
