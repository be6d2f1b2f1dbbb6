"""The port's workqueue and rate limiter (``manager.WorkQueue``,
``manager.RateLimiter``) against the JAX package's, on the 17 cases of
``tests/test_workqueue.py``, the queue and limiter cases of
``tests/test_manager.py`` (``:12-66``),
``tests/test_sharding.py::test_workqueue_remove_if_and_wait_idle`` and one
case of the port's own: a seeded replay.

Each case runs one script on both packages (``both``) and compares what it
returns: the items each ``get`` handed out, the items ``remove_if``
dropped, the limiter's delays. Tolerance: exact equality. The reference's
wall-clock bounds on a call that must not wait out a long delay are kept
as bounds far below that delay (a 30 s timer against a 5 s bound), so a
loaded machine cannot fail them; no ratio of two times is asserted.

The replay (``test_seeded_replay_dispatches_alike``) drives one seeded
sequence of ``add``, ``add(delay)``, ``mark_barrier``, ``get``,
``task_done`` and ``remove_if`` through both queues on one pinned clock
(each module's ``time`` replaced by a clock the script advances), and the
two dispatch orders must be equal.
"""

import random
import threading
import time
from types import SimpleNamespace

import pytest

from tpu_operator import manager as ref_manager
from tpu_operator_torch import manager

MODULES = {"reference": ref_manager, "port": manager}


def both(script, *args):
    """``script(module, *args)`` on each package; the results must agree.
    Returns the port's."""
    ref, port = (script(mod, *args) for mod in MODULES.values())
    assert ref == port
    return port


# ---------------------------------------------------------------------------
# tests/test_workqueue.py: WorkQueue
# ---------------------------------------------------------------------------


def test_add_supersedes_later_addafter():
    def script(m):
        q = m.WorkQueue()
        q.add("a", delay=30.0)
        q.add("a")  # now
        t0 = time.monotonic()
        got = q.get(timeout=10.0)
        return got, time.monotonic() - t0 < 5.0

    assert both(script) == ("a", True)


def test_later_addafter_does_not_delay_pending_item():
    def script(m):
        q = m.WorkQueue()
        q.add("a")
        q.add("a", delay=30.0)  # must not supersede the immediate one
        t0 = time.monotonic()
        got = q.get(timeout=10.0)
        return got, time.monotonic() - t0 < 5.0

    assert both(script) == ("a", True)


def test_pending_items_coalesce_to_one_execution():
    def script(m):
        q = m.WorkQueue()
        for _ in range(5):
            q.add("a")
        return len(q), q.get(timeout=0.5), q.get(timeout=0)

    assert both(script) == (1, "a", None)


def test_get_zero_timeout_polls_without_blocking():
    def script(m):
        q = m.WorkQueue()
        t0 = time.monotonic()
        out = [q.get(timeout=0), time.monotonic() - t0 < 5.0]
        q.add("due")
        q.add("future", delay=30.0)
        out += [q.get(timeout=0), q.get(timeout=0)]  # the future item is not served early
        return out

    assert both(script) == [None, True, "due", None]


def test_earliest_due_item_first():
    def script(m):
        q = m.WorkQueue()
        q.add("late", delay=0.2)
        q.add("early", delay=0.05)
        return q.get(timeout=10.0), q.get(timeout=10.0)

    assert both(script) == ("early", "late")


def test_delayed_item_becomes_due_while_waiting():
    """A blocking get wakes for an item whose delay expires during the
    wait (not only for notify)."""

    def script(m):
        q = m.WorkQueue()
        q.add("a", delay=0.15)
        t0 = time.monotonic()
        got = q.get(timeout=20.0)
        return got, time.monotonic() - t0 >= 0.1

    assert both(script) == ("a", True)


def test_add_wakes_blocked_getter():
    def script(m):
        q = m.WorkQueue()
        got = []
        t = threading.Thread(target=lambda: got.append(q.get(timeout=30.0)))
        t.start()
        time.sleep(0.05)
        q.add("a")
        t.join(timeout=30.0)
        return got

    assert both(script) == ["a"]


# ---------------------------------------------------------------------------
# multi-worker semantics: processing set, barrier keys, same-key coalescing
# ---------------------------------------------------------------------------


def test_readd_while_processing_coalesces_to_one_rerun():
    def script(m):
        q = m.WorkQueue()
        q.add("a")
        out = [q.get(timeout=0)]  # in flight now
        for _ in range(5):
            q.add("a")
        out.append(q.get(timeout=0))  # processing: nothing dispatchable
        q.task_done("a")
        out.append(q.get(timeout=0))  # exactly one coalesced re-run
        q.task_done("a")
        out.append(q.get(timeout=0))
        return out

    assert both(script) == ["a", None, "a", None]


def test_same_key_never_concurrent_under_workers():
    """N workers hammering a small key set: one key on one worker at a
    time while different keys overlap."""

    def script(m):
        q = m.WorkQueue()
        active, overlaps, concurrency = {}, [], []
        lock = threading.Lock()
        done = threading.Event()
        executed = [0]

        def worker():
            while not done.is_set():
                item = q.get(timeout=0.05)
                if item is None:
                    continue
                with lock:
                    if active.get(item):
                        overlaps.append(item)
                    active[item] = True
                    concurrency.append(sum(1 for v in active.values() if v))
                time.sleep(0.002)
                with lock:
                    active[item] = False
                    executed[0] += 1
                q.task_done(item)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for i in range(120):
            q.add(f"k{i % 3}")
            time.sleep(0.001)
        deadline = time.monotonic() + 60
        while executed[0] < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
        done.set()
        for t in threads:
            t.join(timeout=30)
        return overlaps, executed[0] >= 30, max(concurrency) >= 2

    assert both(script) == ([], True, True)


def test_barrier_key_gets_exclusive_occupancy():
    def script(m):
        q = m.WorkQueue()
        q.mark_barrier("full")
        q.add("n1")
        q.add("n2")
        a, b = q.get(timeout=0), q.get(timeout=0)
        out = [{a, b} == {"n1", "n2"}]
        q.add("full")
        q.add("n3")
        out.append(q.get(timeout=0))  # the barrier is due: n3 waits
        q.task_done(a)
        out.append(q.get(timeout=0))  # one still in flight
        q.task_done(b)
        out.append(q.get(timeout=0))
        out.append(q.get(timeout=0))  # barrier running: exclusive
        q.task_done("full")
        out.append(q.get(timeout=0))
        q.task_done("n3")
        return out

    assert both(script) == [True, None, None, "full", None, "n3"]


def test_mixed_key_types_with_identical_due_times_dispatch():
    """Two due entries tying on the clock must not fall through to
    comparing a str key with a tuple key."""

    def script(m):
        q = m.WorkQueue()
        q.add("clusterpolicy")
        q.add(("node", "n1"))
        q.add(("slice", "s1"))
        with q._cond:
            due = q._ready[0][0]
            q._ready = [(due, item) for _, item in q._ready]
        got = [q.get(timeout=0) for _ in range(3)]
        for item in got:
            q.task_done(item)
        return got

    assert set(both(script)) == {"clusterpolicy", ("node", "n1"), ("slice", "s1")}


def test_barrier_blocked_getter_wakes_on_task_done():
    def script(m):
        q = m.WorkQueue()
        q.mark_barrier("full")
        q.add("n1")
        first = q.get(timeout=0)
        q.add("full")
        got = []
        t = threading.Thread(target=lambda: got.append(q.get(timeout=30.0)))
        t.start()
        time.sleep(0.05)
        q.task_done("n1")
        t.join(timeout=30.0)
        q.task_done("full")
        return first, got

    assert both(script) == ("n1", ["full"])


# ---------------------------------------------------------------------------
# shard-handoff drain primitives: remove_if / wait_idle
# ---------------------------------------------------------------------------


def test_remove_if_spares_barriers_and_coalesced_dirty_readds():
    def script(m):
        q = m.WorkQueue()
        q.mark_barrier("clusterpolicy")
        q.add("clusterpolicy")
        q.add(("node", "a"))
        q.add(("node", "b"), delay=5.0)  # a future-dated requeue drains too
        q.add(("slice", "s1"))
        inflight = q.get(timeout=0)
        barriers = 0
        while inflight == "clusterpolicy":
            barriers += 1
            q.task_done(inflight)
            inflight = q.get(timeout=0)
        q.add(inflight)  # coalesces into the dirty slot while processing
        removed = q.remove_if(lambda k: isinstance(k, tuple))
        out = [barriers, inflight, inflight in removed, sorted(removed)]
        q.task_done(inflight)
        out.append(q.wait_idle(lambda k: isinstance(k, tuple), timeout=30.0))
        left = []
        item = q.get(timeout=0)
        while item is not None:
            left.append(item)
            q.task_done(item)
            item = q.get(timeout=0)
        return out + [left]

    out = both(script)
    assert out[2] is True and out[4] is True
    assert out[1] in (("node", "a"), ("slice", "s1"))
    assert all(not isinstance(k, tuple) for k in out[5])


def test_wait_idle_blocks_until_matching_inflight_completes():
    def script(m):
        q = m.WorkQueue()
        q.add(("node", "x"))
        item = q.get(timeout=0)
        done = []

        def finisher():
            time.sleep(0.15)
            q.task_done(item)
            done.append(True)

        threading.Thread(target=finisher, daemon=True).start()
        t0 = time.monotonic()
        idle = q.wait_idle(lambda k: isinstance(k, tuple), timeout=30.0)
        return idle, time.monotonic() - t0 >= 0.1, done

    assert both(script) == (True, True, [True])


# ---------------------------------------------------------------------------
# tests/test_workqueue.py: RateLimiter
# ---------------------------------------------------------------------------


def test_rate_limiter_items_are_independent():
    def script(m):
        rl = m.RateLimiter(base=0.1, cap=3.0)
        for _ in range(10):
            rl.when("noisy")
        return rl.when("noisy"), rl.when("quiet")

    assert both(script) == (3.0, 0.1)


def test_rate_limiter_forget_only_named_item():
    def script(m):
        rl = m.RateLimiter(base=0.1, cap=3.0)
        rl.when("a")
        rl.when("a")
        rl.when("b")
        rl.forget("a")
        return rl.when("a"), rl.when("b")

    assert both(script) == (0.1, 0.2)


def test_rate_limiter_caps_and_never_overflows():
    def script(m):
        rl = m.RateLimiter(base=0.1, cap=3.0)
        delays = [rl.when("x") for _ in range(2000)]
        rl.forget("x")
        return delays, rl.when("x")

    delays, after = both(script)
    assert max(delays) == delays[-1] == 3.0 and after == 0.1


# ---------------------------------------------------------------------------
# tests/test_manager.py:12-66
# ---------------------------------------------------------------------------


def test_workqueue_dedup_and_delay():
    """The add without delay supersedes the later due time: the item is
    due at once, which a zero-timeout poll shows without timing."""

    def script(m):
        q = m.WorkQueue()
        q.add("a", delay=0.2)
        q.add("a", delay=0.0)
        return len(q), q.get(timeout=0), q.get(timeout=0.05)

    assert both(script) == (1, "a", None)


def test_workqueue_get_zero_timeout_is_nonblocking_poll():
    def script(m):
        q = m.WorkQueue()
        t0 = time.monotonic()
        out = [q.get(timeout=0), time.monotonic() - t0 < 5.0]
        q.add("a")
        out.append(q.get(timeout=0))
        q.add("b", delay=30.0)
        t0 = time.monotonic()
        out += [q.get(timeout=0), time.monotonic() - t0 < 5.0]
        return out

    assert both(script) == [None, True, "a", None, True]


def test_rate_limiter_backoff_and_forget():
    def script(m):
        rl = m.RateLimiter(base=0.1, cap=3.0)
        out = [rl.when("x"), rl.when("x"), rl.when("x")]
        rl.forget("x")
        out.append(rl.when("x"))
        for _ in range(10):
            rl.when("x")
        return out + [rl.when("x")]

    assert both(script) == [0.1, 0.2, 0.4, 0.1, 3.0]


def test_rate_limiter_survives_unbounded_failure_streak():
    def script(m):
        rl = m.RateLimiter(base=0.1, cap=3.0)
        for _ in range(5000):
            delay = rl.when("x")
        rl.forget("x")
        return delay, rl.when("x")

    assert both(script) == (3.0, 0.1)


# ---------------------------------------------------------------------------
# tests/test_sharding.py::test_workqueue_remove_if_and_wait_idle
# ---------------------------------------------------------------------------


def test_workqueue_remove_if_and_wait_idle():
    def script(m):
        q = m.WorkQueue()
        q.add(("node", "a"))
        q.add(("node", "b"))
        q.add(("slice", "s1"))
        first = q.get(timeout=0)
        removed = q.remove_if(lambda k: k[0] == "node")
        q.task_done(first)
        idle = q.wait_idle(lambda k: k[0] == "node", timeout=30.0)
        return first, sorted(removed), idle, q.get(timeout=0)

    first, removed, idle, left = both(script)
    assert idle and first not in removed
    assert sorted(removed + [first, left], key=str) == sorted(
        [("node", "a"), ("node", "b"), ("slice", "s1")], key=str)


# ---------------------------------------------------------------------------
# the port's own: a seeded replay on one pinned clock
# ---------------------------------------------------------------------------


KEYS = ["clusterpolicy", "upgrade", ("node", "n1"), ("node", "n2"), ("node", "n3"), ("slice", "s1"),
        ("slice", "s2"), ("status", "slices")]


def replay(m, seed, steps=600):
    """One seeded sequence of queue operations on ``m``'s ``WorkQueue``
    with the module's clock pinned to ``now``; returns what each ``get``
    and ``remove_if`` gave."""
    rng = random.Random(seed)
    now = [1000.0]
    m.time = SimpleNamespace(monotonic=lambda: now[0], sleep=time.sleep)
    q = m.WorkQueue()
    inflight, trace = [], []
    for step in range(steps):
        op = rng.random()
        key = rng.choice(KEYS)
        if op < 0.05:
            q.mark_barrier(key)
            trace.append(("barrier", key))
        elif op < 0.30:
            q.add(key)
        elif op < 0.45:
            q.add(key, delay=rng.choice([0.1, 0.5, 2.0, 30.0]))
        elif op < 0.70:
            item = q.get(timeout=0)
            if item is not None:
                inflight.append(item)
            trace.append(("get", step, item))
        elif op < 0.85 and inflight:
            item = inflight.pop(rng.randrange(len(inflight)))
            q.task_done(item)
        elif op < 0.90:
            kind = rng.choice(["node", "slice"])
            trace.append(("removed", step, q.remove_if(lambda k: isinstance(k, tuple) and k[0] == kind)))
        else:
            now[0] += rng.choice([0.05, 0.3, 1.0, 5.0])
        trace.append(("len", len(q), q.due_len(), q.busy_len()))
    return trace


@pytest.mark.parametrize("seed", [0, 7, 19])
def test_seeded_replay_dispatches_alike(monkeypatch, seed):
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "time", mod.time)  # restored after the case
    trace = both(replay, seed)
    gets = [t for t in trace if t[0] == "get" and t[2] is not None]
    assert len(gets) >= 30  # the replay dispatched, not only polled
