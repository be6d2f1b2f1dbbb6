"""The port's runtime lock-order watchdog
(``tpu_operator_torch/analysis/lockwatch.py``) against the JAX package's.

The 8 cases of ``tests/test_lockwatch.py`` run on the port's watchdog and
its write pipeline: an inverted two-lock acquisition is a cycle (and is
flight-recorded), a consistent order is not, RLock re-entry and
``Condition.wait`` keep the held set consistent, held-across-blocking
calls (``time.sleep``, ``WriteFuture.result``) are caught, and enable and
disable restore the process. The cases of ``tests/test_concurrent_writers.py``
that run under its module-wide watchdog run here on the port's clients,
under the port's watchdog, and fail on any cycle it saw.

Both watchdogs patch the same process-wide globals (``threading.Lock``,
``threading.RLock``, ``time.sleep``) and each its own write pipeline, so
one case enables and disables each side in turn, and nested, and checks
that every global comes back exactly.
"""

import os
import threading
import time

import pytest

os.environ.setdefault("OPERATOR_NAMESPACE", "tpu-operator")
os.environ.setdefault("UNIT_TEST", "true")

from tpu_operator.analysis import lockwatch as ref_lockwatch  # noqa: E402
from tpu_operator.kube import write_pipeline as ref_wp  # noqa: E402
from tpu_operator_torch.analysis import lockwatch  # noqa: E402
from tpu_operator_torch.kube import client as kube_client  # noqa: E402
from tpu_operator_torch.kube import write_pipeline as wp  # noqa: E402
from tpu_operator_torch.kube.client import FakeClient, mutate_with_retry  # noqa: E402
from tpu_operator_torch.kube.kubesim import KubeSim, KubeSimServer, make_client  # noqa: E402
from tpu_operator_torch.kube.testing import make_gpu_node  # noqa: E402
from tpu_operator_torch.obs import flight  # noqa: E402


@pytest.fixture()
def watch():
    """A fresh graph around every test; disable only if this fixture did
    the enabling, and reset at teardown so a seeded cycle cannot leak into
    a module-wide watchdog's verdict."""
    was_enabled = lockwatch.enabled()
    lockwatch.reset()
    lockwatch.enable()
    yield lockwatch.WATCH
    if not was_enabled:
        lockwatch.disable()
    lockwatch.reset()


def _run_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


def test_inverted_two_lock_acquisition_detected(watch, tmp_path):
    flight.RECORDER.clear()
    flight.RECORDER.dir = str(tmp_path)
    # separate lines: the graph keys locks by CREATION SITE
    a = threading.Lock()
    b = threading.Lock()

    def forward():
        with a:
            with b:
                pass

    def inverted():
        with b:
            with a:
                pass

    _run_thread(forward)
    assert lockwatch.cycles() == []
    _run_thread(inverted)
    cycles = lockwatch.cycles()
    assert len(cycles) == 1
    assert len(set(cycles[0]["cycle"])) == 2
    # the sites are this file's own lines, not lockwatch.py's
    assert all(site.startswith("tests/test_torch_lockwatch.py:") for site in cycles[0]["cycle"]), cycles
    events = flight.RECORDER.snapshot()["events"]
    assert any(e["kind"] == "lockwatch.cycle" for e in events)
    assert flight.RECORDER.last_dump_path


def test_consistent_order_is_clean(watch):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):

        def ordered():
            with a:
                with b:
                    pass

        _run_thread(ordered)
    assert lockwatch.cycles() == []
    assert lockwatch.stats()["edges"] >= 1


def test_rlock_reentrancy_no_false_edges(watch):
    rl = threading.RLock()

    def reenter():
        with rl:
            with rl:
                with rl:
                    pass

    _run_thread(reenter)
    assert lockwatch.cycles() == []
    assert all(k.split("->")[0] != k.split("->")[1] for k in watch.edges())


def test_condition_wait_keeps_held_set_consistent(watch):
    """``cond.wait()`` releases the watched lock; another thread taking
    more locks meanwhile must not fabricate edges from the waiter's stale
    state, for Lock- and RLock-backed conditions alike."""
    for factory in (threading.Lock, threading.RLock):
        lk = factory()
        cond = threading.Condition(lk)
        other = threading.Lock()
        released = threading.Event()

        def waiter():
            with cond:
                released.set()
                cond.wait(0.5)

        def nudger():
            released.wait(5)
            with lk if factory is threading.Lock else cond:
                with other:
                    pass
            with cond:
                cond.notify_all()

        t1 = threading.Thread(target=waiter)
        t2 = threading.Thread(target=nudger)
        t1.start()
        t2.start()
        t1.join(10)
        t2.join(10)
        assert not t1.is_alive() and not t2.is_alive()
    assert lockwatch.cycles() == []


def _blocking():
    return [v for v in lockwatch.violations() if v["type"] == "held-across-blocking"]


def test_held_across_blocking_detected(watch):
    lk = threading.Lock()

    def sleepy():
        with lk:
            time.sleep(0.01)

    _run_thread(sleepy)
    blocking = _blocking()
    assert len(blocking) == 1
    assert "time.sleep" in blocking[0]["call"]
    assert blocking[0]["locks"]
    time.sleep(0.01)  # unlocked: no violation
    assert len(_blocking()) == 1


def test_write_future_result_under_lock_detected(watch):
    pipe = wp.WritePipeline(depth=2)
    lk = threading.Lock()

    def bad():
        fut = pipe.submit("k", lambda: 42)
        with lk:
            assert fut.result(5) == 42

    _run_thread(bad)
    calls = [v["call"] for v in _blocking()]
    assert "WriteFuture.result()" in calls
    before = len(calls)
    fut = pipe.submit("k2", lambda: 1)
    assert fut.result(5) == 1
    assert len(_blocking()) == before


def test_enable_disable_restores_factories():
    assert not lockwatch.enabled(), "a module-wide watchdog would be disarmed here"
    lockwatch.reset()
    real_lock, real_rlock, real_sleep = threading.Lock, threading.RLock, time.sleep
    lockwatch.enable()
    assert threading.Lock is not real_lock
    lockwatch.enable()  # idempotent
    lockwatch.disable()
    assert threading.Lock is real_lock
    assert threading.RLock is real_rlock
    assert time.sleep is real_sleep
    lockwatch.disable()  # idempotent
    # locks created while enabled keep working after disable
    lockwatch.enable()
    lk = threading.Lock()
    lockwatch.disable()
    with lk:
        pass
    assert not lk.locked()


def test_pipeline_under_watch_end_to_end(watch):
    """The port's write pipeline (pool, per-key chains, drain, a batch
    lane) runs correctly under instrumentation with no cycle."""
    pipe = wp.WritePipeline(depth=4)
    futs = [pipe.submit(i % 5, lambda x=i: x * 2) for i in range(50)]
    lane = wp.BatchLane(pipe, lambda items: [(i, None) for i in items], shards=2)
    lane_futs = [lane.submit(f"k{i}", i) for i in range(30)]
    pipe.drain(timeout=30)
    assert [f.result(5) for f in futs] == [i * 2 for i in range(50)]
    for f in lane_futs:
        f.result(5)
    assert lockwatch.cycles() == []
    assert lockwatch.stats()["acquires"] > 0


def _globals():
    return (
        threading.Lock,
        threading.RLock,
        time.sleep,
        wp.WriteFuture.__dict__["result"],
        wp.WritePipeline.__dict__["drain"],
        ref_wp.WriteFuture.__dict__["result"],
        ref_wp.WritePipeline.__dict__["drain"],
    )


@pytest.mark.parametrize("order", ["port-then-reference", "reference-then-port", "nested"])
def test_both_watchdogs_restore_every_global(order):
    """Each side's watchdog enabled and disabled in turn (and the port's
    nested inside the reference's) in one process: every patched global
    comes back as the very object it was, and a lock made under each side
    still works after both are off."""
    assert not lockwatch.enabled() and not ref_lockwatch.enabled()
    before = _globals()
    made = []
    if order == "nested":
        ref_lockwatch.enable()
        mid = _globals()
        lockwatch.enable()
        made.append(threading.Lock())
        assert _globals() != mid
        lockwatch.disable()
        assert all(x is y for x, y in zip(_globals(), mid))
        made.append(threading.RLock())
        ref_lockwatch.disable()
    else:
        sides = [lockwatch, ref_lockwatch]
        if order == "reference-then-port":
            sides.reverse()
        for side in sides:
            side.enable()
            made.append(threading.Lock())
            assert threading.Lock is not before[0] and time.sleep is not before[2]
            side.disable()
            assert all(x is y for x, y in zip(_globals(), before)), side.__name__
    assert all(x is y for x, y in zip(_globals(), before))
    for lk in made:
        with lk:
            pass
    lockwatch.reset()
    ref_lockwatch.reset()


def test_watching_fails_on_a_cycle():
    """``watching()`` — the session watchdog ``GPU_LOCKWATCH=1`` asks for —
    raises on a cycle seen inside it and leaves the process unpatched."""
    real_lock = threading.Lock
    lockwatch.reset()
    with pytest.raises(lockwatch.LockOrderError, match="cycle"):
        with lockwatch.watching(strict=False):
            a = threading.Lock()
            b = threading.Lock()
            for first, second in ((a, b), (b, a)):

                def nest(x=first, y=second):
                    with x:
                        with y:
                            pass

                _run_thread(nest)
    assert threading.Lock is real_lock and not lockwatch.enabled()
    lockwatch.reset()


# -- the concurrent-writer matrix under the port's watchdog -----------------


@pytest.fixture(scope="module")
def _writers_watched():
    """The port's concurrent-writer cases always run under its watchdog
    and fail on any observed cycle."""
    lockwatch.reset()
    was_enabled = lockwatch.enabled()
    lockwatch.enable()
    yield
    found = lockwatch.cycles()
    if not was_enabled:
        lockwatch.disable()
    lockwatch.reset()
    assert not found, "; ".join(" -> ".join(c["cycle"]) for c in found)


@pytest.fixture()
def sim(_writers_watched):
    server = KubeSimServer(KubeSim()).start()
    try:
        yield server
    finally:
        server.stop()


def _count_conflicts():
    counts = {"n": 0}
    prev = kube_client.on_conflict_retry

    def bump():
        counts["n"] += 1

    kube_client.on_conflict_retry = bump
    return counts, lambda: setattr(kube_client, "on_conflict_retry", prev)


def test_two_threads_racing_mutate_with_retry_on_kubesim(sim):
    """Six threads each add their own labels through ``mutate_with_retry``
    on one node; the node ends with every delta."""
    client = make_client(sim.port)
    client.create(make_gpu_node("race-node"))
    counts, restore = _count_conflicts()
    threads_n, writes_each = 6, 5
    errors = []
    barrier = threading.Barrier(threads_n, timeout=30)

    def writer(tid):
        try:
            barrier.wait()
            for i in range(writes_each):

                def mutate(node, tid=tid, i=i):
                    node["metadata"].setdefault("labels", {})[f"race.test/writer-{tid}-{i}"] = "yes"
                    return True

                mutate_with_retry(client, "v1", "Node", "race-node", mutate=mutate, attempts=20)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(threads_n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        restore()
    assert errors == []
    labels = client.get("v1", "Node", "race-node")["metadata"]["labels"]
    for tid in range(threads_n):
        for i in range(writes_each):
            assert labels.get(f"race.test/writer-{tid}-{i}") == "yes", (tid, i)
    assert counts["n"] >= 1, "the race never actually conflicted"


@pytest.mark.parametrize("backend", ["kubesim", "fake"])
def test_patch_labels_race_recomputes_not_reverts(sim, backend):
    """Two threads race conditional label patches on one node; the loser
    409s and recomputes, so both labels survive on every client."""
    client = make_client(sim.port) if backend == "kubesim" else FakeClient()
    client.create(make_gpu_node("patch-race"))
    errors = []
    barrier = threading.Barrier(2, timeout=30)

    def patcher(label):
        try:
            barrier.wait()
            for _attempt in range(10):
                node = client.get("v1", "Node", "patch-race", copy=True)
                try:
                    client.patch_labels(
                        "v1",
                        "Node",
                        "patch-race",
                        labels={label: "true"},
                        resource_version=node["metadata"]["resourceVersion"],
                    )
                    return
                except kube_client.ConflictError:
                    continue
            raise AssertionError(f"{label}: never won the race")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t1 = threading.Thread(target=patcher, args=("race.test/alpha",))
    t2 = threading.Thread(target=patcher, args=("race.test/beta",))
    t1.start(), t2.start()
    t1.join(timeout=60), t2.join(timeout=60)
    assert errors == []
    labels = client.get("v1", "Node", "patch-race")["metadata"]["labels"]
    assert labels.get("race.test/alpha") == "true"
    assert labels.get("race.test/beta") == "true"


def test_pooled_rest_client_many_threads_no_response_mixup(sim):
    """16 threads share one pooled client, each creating and re-reading its
    own ConfigMap; each reads back its own data, over reused connections."""
    client = make_client(sim.port)
    client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "pool-ns"}})
    n, rounds = 16, 10
    errors = []
    barrier = threading.Barrier(n, timeout=30)

    def worker(tid):
        try:
            barrier.wait()
            client.create(
                {
                    "apiVersion": "v1",
                    "kind": "ConfigMap",
                    "metadata": {"name": f"cm-{tid}", "namespace": "pool-ns"},
                    "data": {"owner": str(tid)},
                }
            )
            for _ in range(rounds):
                got = client.get("v1", "ConfigMap", f"cm-{tid}", "pool-ns")
                assert got["data"]["owner"] == str(tid), got
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    assert client.pool_stats()["reuses"] > 0


def test_pool_survives_server_side_connection_close(sim):
    """A pooled keep-alive connection the server closed while idle is
    replaced silently and never trips the breaker."""
    client = make_client(sim.port)
    client.create(make_gpu_node("pool-node"))
    assert client.get("v1", "Node", "pool-node")["metadata"]["name"] == "pool-node"
    with client._pool_lock:
        for conn in client._pool:
            sock = getattr(conn, "sock", None)
            if sock is not None:
                sock.close()
    before_trips = client.breaker.stats()["trips_total"]
    assert client.get("v1", "Node", "pool-node")["metadata"]["name"] == "pool-node"
    assert client.breaker.stats()["trips_total"] == before_trips
