"""The port's fault-tolerance policy objects (``kube/retry.py``) against
the JAX package's, on the 14 cases of ``tests/test_retry.py``: attempts
per verb, the jittered exponential backoff with its cap, Retry-After, the
counters, the circuit breaker's trip, cooldown, half-open probe, doubling
window and closed fast path, the watch reconnect backoff, the policy
surface every client carries, and the breaker and counters hammered from
many threads.

Each case runs on each package (``two_sided.hold``) with the same calls
and seeds and the reference's assertions made on each side; the delays
drawn under one seed, the states, the counters and the stats must be
equal. Both breakers read one pinned monotonic clock (``_monotonic``), so
a window (``open_for_s``) is exactly its cooldown and is compared like
any other field; a window lapses by clearing ``_open_until``, as the
reference's half-open cases do. The reference's thread case waits out a
0.2 s cooldown; here nothing sleeps on a window and no time is asserted.
Tolerance: exact equality.
"""

import random
import threading
import time
from types import SimpleNamespace

import pytest

from tests.two_sided import BY_SIDE, hold
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import retry as ref_retry
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator_torch.kube import retry
from tpu_operator_torch.kube.cache import CachedClient
from tpu_operator_torch.kube.client import FakeClient

SIDES = {
    "reference": SimpleNamespace(name="reference", r=ref_retry, FakeClient=RefFakeClient,
                                 CachedClient=RefCachedClient),
    "port": SimpleNamespace(name="port", r=retry, FakeClient=FakeClient, CachedClient=CachedClient),
}


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    for mod in (ref_retry, retry):
        monkeypatch.setattr(mod, "_monotonic", lambda: 1000.0)


def stats(breaker):
    return breaker.stats()


@BY_SIDE
def test_retry_policy_per_verb_attempts(side):
    def script(side):
        p = side.r.RetryPolicy(read_attempts=3, write_attempts=4)
        got = {verb: p.attempts_for(verb) for verb in ("GET", "POST", "PUT", "PATCH", "DELETE")}
        assert got == {"GET": 3, "POST": 4, "PUT": 4, "PATCH": 4, "DELETE": 4}
        return got

    hold(SIDES, side, script)


@BY_SIDE
def test_backoff_is_jittered_exponential_with_cap(side):
    def script(side):
        p = side.r.RetryPolicy(backoff_s=1.0, cap_s=4.0, rng=random.Random(7))
        delays = []
        for attempt, d in ((1, 1.0), (2, 2.0), (3, 4.0), (4, 4.0), (10, 4.0)):
            for _ in range(20):  # attempt n draws from [d/2, d], d = min(cap, base * 2**(n-1))
                delays.append(p.backoff(attempt))
                assert d / 2 <= delays[-1] <= d
        jitter = {round(p.backoff(2), 6) for _ in range(10)}
        assert len(jitter) > 1  # the jitter varies
        return delays, sorted(jitter)

    hold(SIDES, side, script)


@BY_SIDE
def test_backoff_honors_retry_after_capped(side):
    def script(side):
        p = side.r.RetryPolicy(backoff_s=0.01, cap_s=2.0)
        got = [p.backoff(1, retry_after=v) for v in (0.5, 3600, -5)]
        assert got == [0.5, 2.0, 0.0]  # a huge header capped, a negative one floored
        assert p.stats()["retry_after_honored"] == 0  # counted only by count_retry
        return got, p.stats()

    hold(SIDES, side, script)


@BY_SIDE
def test_retry_counters(side):
    def script(side):
        p = side.r.RetryPolicy()
        p.count_retry("POST")
        p.count_retry("POST", honored_retry_after=True)
        p.count_retry("GET")
        p.count_giveup()
        s = p.stats()
        assert s["retries_total"] == 3
        assert s["retries_by_verb"] == {"POST": 2, "GET": 1}
        assert s["giveups_total"] == 1
        assert s["retry_after_honored"] == 1
        return s

    hold(SIDES, side, script)


@BY_SIDE
def test_breaker_trips_after_threshold_and_cools_down(side):
    def script(side):
        b = side.r.CircuitBreaker(threshold=3, cooldown_base_s=30.0)
        for _ in range(2):
            b.record_failure()
        trail = [b.allow(), stats(b)]
        assert trail[1]["state"] == "half-open"  # failures seen, not open
        b.record_failure()  # the third in a row trips
        trail += [stats(b), b.allow(), stats(b)]
        assert trail[2]["state"] == "open" and trail[3] is False
        assert trail[4]["fast_fails_total"] == 1 and trail[4]["trips_total"] == 1
        b.record_success()  # a success closes it fully
        trail += [b.allow(), stats(b)]
        assert trail[5] is True and trail[6]["state"] == "closed"
        return trail

    hold(SIDES, side, script)


@BY_SIDE
def test_breaker_success_resets_streak(side):
    def script(side):
        b = side.r.CircuitBreaker(threshold=3)
        for ok in (False, False, True, False, False):
            b.record_success() if ok else b.record_failure()
        assert b.stats()["state"] != "open"  # never three in a row
        return stats(b)

    hold(SIDES, side, script)


@BY_SIDE
def test_breaker_half_open_single_probe_failure_retrips(side):
    """After a trip, one failure past the cooldown re-trips at once."""

    def script(side):
        b = side.r.CircuitBreaker(threshold=3, cooldown_base_s=1.0, cooldown_cap_s=8.0)
        for _ in range(3):
            b.record_failure()
        trail = [stats(b)]
        assert trail[0]["state"] == "open"
        b._open_until = 0.0  # the cooldown lapses: half-open
        b.record_failure()  # one probe fails
        trail.append(stats(b))
        assert trail[1]["state"] == "open" and trail[1]["trips_total"] == 2
        b._open_until = 0.0
        b.record_success()  # a half-open success forgets the streak
        b.record_failure()
        b.record_failure()
        trail.append(stats(b))
        assert trail[2]["state"] != "open"
        return trail

    hold(SIDES, side, script)


@BY_SIDE
def test_breaker_cooldown_doubles_per_consecutive_trip(side):
    def script(side):
        b = side.r.CircuitBreaker(threshold=1, cooldown_base_s=1.0, cooldown_cap_s=8.0)
        b.record_failure()  # trip 1: a 1 s window
        first = b.stats()["open_for_s"]
        b._open_until = 0.0
        b.record_failure()  # trip 2: the window doubles
        second = b.stats()["open_for_s"]
        assert second > first
        assert second <= 8.0
        assert (first, second) == (1.0, 2.0)
        return stats(b)

    hold(SIDES, side, script)


@BY_SIDE
def test_breaker_closed_fast_path_is_lock_free_compare(side):
    def script(side):
        b = side.r.CircuitBreaker()
        allowed = sum(b.allow() for _ in range(1000))
        assert allowed == 1000 and b.stats()["fast_fails_total"] == 0
        return allowed, stats(b)

    hold(SIDES, side, script)


@BY_SIDE
def test_watch_backoff_grows_jittered_and_resets(side):
    def script(side):
        wb = side.r.WatchBackoff(base_s=1.0, cap_s=8.0, rng=random.Random(3))
        d = [wb.next_delay() for _ in range(3)]
        assert 0.5 <= d[0] <= 1.0 and 1.0 <= d[1] <= 2.0 and 2.0 <= d[2] <= 4.0
        more = [wb.next_delay() for _ in range(10)]
        assert max(more) <= 8.0  # capped
        wb.reset()
        again = wb.next_delay()
        assert 0.5 <= again <= 1.0
        return d, more, again

    hold(SIDES, side, script)


@BY_SIDE
def test_clients_share_the_policy_surface(side):
    """Every client carries ``retry_policy``, ``breaker`` and
    ``fault_stats()``; the cached client delegates to its live one."""

    def script(side):
        fake = side.FakeClient()
        assert fake.fault_stats()["breaker"]["state"] == "closed"
        assert fake.fault_stats()["retry"]["retries_total"] == 0
        cached = side.CachedClient(fake, namespace="ns")
        assert cached.retry_policy is fake.retry_policy
        assert cached.breaker is fake.breaker
        assert cached.fault_stats() == fake.fault_stats()
        return cached.fault_stats()

    hold(SIDES, side, script)


def run_threads(n, target, *args):
    threads = [threading.Thread(target=target, args=args + (i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


@BY_SIDE
def test_breaker_hammered_from_many_threads_trips_exactly_once(side):
    """Eight threads record 50 failures each at once: one trip, one base
    window (not doubled by racing trippers); a success after the window
    closes it exactly once."""

    def script(side):
        breaker = side.r.CircuitBreaker(threshold=5, cooldown_base_s=10.0)
        barrier = threading.Barrier(8, timeout=60)

        def hammer(_):
            barrier.wait()
            for _ in range(50):
                breaker.record_failure()

        run_threads(8, hammer)
        tripped = stats(breaker)
        assert tripped["trips_total"] == 1, tripped
        assert tripped["state"] == "open"
        assert tripped["open_for_s"] == 10.0  # the base window, not doubled (20) by racing trippers
        breaker._open_until = 0.0  # the window lapses: half-open
        assert breaker.allow() is True
        breaker.record_success()
        closed = stats(breaker)
        assert closed["state"] == "closed" and closed["consecutive_failures"] == 0
        return tripped, closed

    hold(SIDES, side, script)


@BY_SIDE
def test_breaker_allow_and_failure_race_counts_are_consistent(side):
    """allow() spinning in four threads while the breaker trips: one trip,
    and every denial the readers saw is counted."""

    def script(side):
        breaker = side.r.CircuitBreaker(threshold=3, cooldown_base_s=30.0)
        stop = threading.Event()
        denied = []
        started = threading.Barrier(5, timeout=60)

        def spin_allow(_):
            count = 0
            started.wait()
            while not stop.is_set():
                if not breaker.allow():
                    count += 1
            denied.append(count)

        readers = [threading.Thread(target=spin_allow, args=(i,)) for i in range(4)]
        for t in readers:
            t.start()
        started.wait()
        for _ in range(3):
            breaker.record_failure()  # trips: a 30 s window on the pinned clock, every allow denied
        time.sleep(0.05)
        stop.set()
        for t in readers:
            t.join(timeout=60)
        s = breaker.stats()
        assert s["trips_total"] == 1
        assert s["fast_fails_total"] == sum(denied)
        return s["trips_total"], s["state"], len(denied)

    hold(SIDES, side, script)


@BY_SIDE
def test_retry_policy_counters_hammered_from_many_threads_are_exact(side):
    def script(side):
        policy = side.r.RetryPolicy()
        n_threads, per_thread = 8, 200
        barrier = threading.Barrier(n_threads, timeout=60)

        def hammer(_):
            barrier.wait()
            for i in range(per_thread):
                policy.count_retry("PATCH" if i % 2 else "PUT", honored_retry_after=(i % 4 == 0))
            policy.count_giveup()

        run_threads(n_threads, hammer)
        s = policy.stats()
        assert s["retries_total"] == n_threads * per_thread
        assert s["giveups_total"] == n_threads
        assert s["retries_by_verb"] == {"PUT": n_threads * per_thread // 2, "PATCH": n_threads * per_thread // 2}
        assert s["retry_after_honored"] == n_threads * (per_thread // 4)
        return s

    hold(SIDES, side, script)
