"""The port's manager runtime (``manager.py``) and operator wiring
(``main.build_manager``, ``main.main``) against the JAX package's, on the
cases of ``tests/test_manager.py`` past its queue and limiter ones,
``tests/test_manager_http.py``'s 2, ``tests/test_debug_vars_schema.py``'s 2,
``tests/test_metrics_noprom.py``'s 1, the two cases of
``tests/test_delta_reconcile.py`` that need the manager, and the port's
own: what ``build_manager`` wires, with and without ``GPU_SHARDS``.

Each case runs one script on both packages (``both``), each side with its
own ``FakeClient``, and compares what the script returns: leases'
holders, the probe's answers, the ``/debug/vars`` keys, the exit codes of
``main``. Tolerance: exact equality, apart from the names decision 2 of
ROADMAP queue 3 item 3 renames (the leader Lease ``gpu-operator-leader``,
the metric families under ``gpu_operator_``) and what comes from the card
(the render cache's variant set). The ``/debug/vars`` key set is the
reference's ``build_manager``'s, computed live on a ``FakeClient``, never
a copied list. Every wait on a condition has a limit of 30 s or more;
every manager and server stops in a ``finally``.
"""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator import main as ref_main
from tpu_operator import manager as ref_manager
from tpu_operator import shard as ref_shard
from tpu_operator.controllers import operator_metrics as ref_om
from tpu_operator.controllers.render_cache import RenderCache as RefRenderCache
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import frozen as ref_frozen
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube.cache import CachedClient as RefCachedClient
from tpu_operator.obs import flight as ref_flight
from tpu_operator_torch import consts, main, manager, shard
from tpu_operator_torch.controllers import operator_metrics as om
from tpu_operator_torch.controllers.render_cache import RenderCache
from tpu_operator_torch.kube import frozen, testing
from tpu_operator_torch.kube.cache import CachedClient
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.obs import flight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"
CPV = consts.API_VERSION
LEASE = ("coordination.k8s.io/v1", "Lease")
WAIT_S = 60.0

SIDES = {
    "reference": SimpleNamespace(
        name="reference", manager=ref_manager, main=ref_main, shard=ref_shard, consts=ref_consts, om=ref_om,
        FakeClient=RefFakeClient, CachedClient=RefCachedClient, frozen=ref_frozen, testing=ref_testing,
        flight=ref_flight, RenderCache=RefRenderCache, variants={"v5e"}, node="fake-tpu-node-1",
        lease="tpu-operator-leader", metrics="tpu_operator", shards_env="TPU_SHARDS", package="tpu_operator"),
    "port": SimpleNamespace(
        name="port", manager=manager, main=main, shard=shard, consts=consts, om=om, FakeClient=FakeClient,
        CachedClient=CachedClient, frozen=frozen, testing=testing, flight=flight, RenderCache=RenderCache,
        variants={"h100-sxm"}, node="fake-gpu-node-1", lease="gpu-operator-leader", metrics="gpu_operator",
        shards_env="GPU_SHARDS", package="tpu_operator_torch"),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def both(script, *args):
    """``script(side, *args)`` on each package; the results must agree.
    Returns the port's."""
    ref, port = (script(side, *args) for side in SIDES.values())
    assert ref == port
    return port


def _now():
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def wait(pred, timeout_s=WAIT_S):
    return testing.wait_until(pred, timeout_s, 0.02)


class probe_server:
    """A probe server over ``mgr`` on an ephemeral port (``probe_port=0``
    disables the manager's own), stopped on exit."""

    def __init__(self, side, mgr):
        handler = type("H", (side.manager._HealthHandler,), {"manager": mgr})
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def get(self, path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.srv.server_port}{path}", timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


# ---------------------------------------------------------------------------
# tests/test_manager.py
# ---------------------------------------------------------------------------


def test_worker_survives_queue_machinery_error(monkeypatch):
    """An error outside the reconciler call (the limiter) neither kills
    the worker nor drops the in-flight key: the containment path re-adds
    it."""

    def script(side):
        mgr = side.manager.Manager(side.FakeClient(), "ns", metrics_port=0, probe_port=0)
        blown, calls, fails = threading.Event(), [], [0]
        real_when = mgr.rate_limiter.when

        def exploding_when(item):
            if not blown.is_set():
                blown.set()
                raise OverflowError("boom")
            return real_when(item)

        monkeypatch.setattr(mgr.rate_limiter, "when", exploding_when)

        def flaky(_k):
            if fails[0] == 0:
                fails[0] += 1
                raise RuntimeError("reconcile fails once")
            calls.append(1)

        mgr.add_reconciler("k", flaky)
        mgr.start()
        try:
            mgr.enqueue("k")
            return blown.wait(WAIT_S), wait(lambda: calls)
        finally:
            mgr.stop()

    assert both(script) == (True, True)


def test_leader_election_single_holder():
    """One holder; the other candidate is refused while the lease is
    live; the holder renews. The Lease is each package's own."""

    def script(side):
        client = side.FakeClient()
        a = side.manager.LeaderElector(client, NS, identity="pod-a")
        b = side.manager.LeaderElector(client, NS, identity="pod-b")
        out = [a.name == side.lease, a.try_acquire(), b.try_acquire(), a.try_acquire()]
        return out, client.get(*LEASE, a.name, NS)["spec"]["holderIdentity"]

    assert both(script) == ([True, True, False, True], "pod-a")


def test_leader_election_takeover_on_expiry():
    def script(side):
        client = side.FakeClient()
        a = side.manager.LeaderElector(client, NS, identity="pod-a", lease_seconds=30)
        first = a.try_acquire()
        lease = client.get(*LEASE, a.name, NS, copy=True)
        lease["spec"]["renewTime"] = "2020-01-01T00:00:00.000000Z"
        client.update(lease)
        b = side.manager.LeaderElector(client, NS, identity="pod-b")
        return first, b.try_acquire(), client.get(*LEASE, a.name, NS)["spec"]["holderIdentity"]

    assert both(script) == (True, True, "pod-b")


def test_leader_election_renews_a_frozen_lease_view():
    """``try_acquire`` thaws a frozen (informer) view before its
    read-modify-write."""

    def script(side):
        client = side.FakeClient()
        a = side.manager.LeaderElector(client, NS, identity="pod-a", lease_seconds=30)
        first = a.try_acquire()

        class FrozenReadClient:
            def __init__(self, inner):
                self._inner, self.updated = inner, None

            def get_or_none(self, api_version, kind, name, namespace=""):
                obj = self._inner.get_or_none(api_version, kind, name, namespace)
                return side.frozen.freeze(obj) if obj is not None else None

            def create(self, obj):
                return self._inner.create(obj)

            def update(self, obj):
                self.updated = obj
                return self._inner.update(obj)

        frozen_client = FrozenReadClient(client)
        renewed = side.manager.LeaderElector(frozen_client, NS, identity="pod-a").try_acquire()
        return first, renewed, frozen_client.updated["spec"]["holderIdentity"], type(frozen_client.updated) is dict

    assert both(script) == (True, True, "pod-a", True)


def test_manager_stops_on_lost_leadership(monkeypatch):
    def script(side):
        client = side.FakeClient()
        mgr = side.manager.Manager(client, NS, metrics_port=0, probe_port=0, leader_election=True)
        holder = {}
        orig_init = side.manager.LeaderElector.__init__

        def fast_init(self, *a, **kw):
            orig_init(self, *a, **kw)
            self.lease_seconds = 3  # renew every ~1 s
            holder["elector"] = self

        monkeypatch.setattr(side.manager.LeaderElector, "__init__", fast_init)
        try:
            mgr.start()
            assert wait(lambda: "elector" in holder)
            name = holder["elector"].name
            stopped = False
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline:
                # the usurper keeps the lease fresh, so expiry cannot hand it back
                lease = client.get(*LEASE, name, NS, copy=True)
                lease["spec"].update(holderIdentity="usurper", renewTime=_now())
                client.update(lease)
                if not mgr.healthy():
                    stopped = True
                    break
                time.sleep(0.3)
            return name == side.lease, stopped
        finally:
            monkeypatch.setattr(side.manager.LeaderElector, "__init__", orig_init)
            mgr.stop()

    assert both(script) == (True, True)


def test_probe_debug_endpoints():
    def script(side):
        mgr = side.manager.Manager(side.FakeClient(), NS, metrics_port=0, probe_port=0, debug_endpoints=True)
        out = {}
        try:
            with probe_server(side, mgr) as srv:
                out["healthz"] = srv.get("/healthz")
                code, stacks = srv.get("/debug/stacks")
                out["stacks"] = (code, "--- thread" in stacks and "MainThread" in stacks)
                mgr.add_reconciler("cp", lambda k: None)
                v = json.loads(srv.get("/debug/vars")[1])
                out["plain"] = (v["reconcilers"], v["threads"] >= 1, "informer_cache" in v)
                cached = side.CachedClient(mgr.client, namespace=NS)
                cached.start_informers()
                mgr.client = cached
                v = json.loads(srv.get("/debug/vars")[1])
                out["cached"] = [v["informer_cache"].get("Node"), v["informer_drift_repairs"]]
                cached._informers[("v1", "Node")].drift_repairs = 3
                out["cached"].append(json.loads(srv.get("/debug/vars")[1])["informer_drift_repairs"])
                cached.list("v1", "Node")
                reads = json.loads(srv.get("/debug/vars")[1])["informer_reads"]
                out["reads"] = (reads["lists"] >= 1, reads["copied_reads"])
                mgr.register_debug_vars("reconcile_snapshot", lambda: {"hits": 7})
                mgr.register_debug_vars("broken", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
                v = json.loads(srv.get("/debug/vars")[1])
                out["providers"] = (v["reconcile_snapshot"], v["broken"])
                rc = side.RenderCache()
                rc.begin_pass("base-fp", side.variants)
                mgr.register_debug_vars("render_cache", rc.stats)
                v = json.loads(srv.get("/debug/vars")[1])["render_cache"]
                out["render"] = (bool(v["fingerprint"]), v["entries"], v["last_pass"]["hit_rate"])
                cached.stop()
        finally:
            mgr.stop()
        return out

    assert both(script) == {
        "healthz": (200, "ok"), "stacks": (200, True), "plain": (["cp"], True, False), "cached": [0, 0, 3],
        "reads": (True, 0), "providers": ({"hits": 7}, {"error": "boom"}), "render": (True, 0, 0.0)}


def test_debug_endpoints_default_off():
    def script(side):
        mgr = side.manager.Manager(side.FakeClient(), NS, metrics_port=0, probe_port=0)
        try:
            with probe_server(side, mgr) as srv:
                return srv.get("/debug/stacks")[0], srv.get("/debug/vars")[0], srv.get("/healthz")
        finally:
            mgr.stop()

    assert both(script) == (404, 404, (200, "ok"))


def test_main_once_mode():
    """``--once`` exits 0 when the fake cluster reaches READY with the
    kubelet simulated and 2 without it, on both sides."""

    def script(side):
        return (side.main.main(["--fake", "--simulate-kubelet", "--once"]),
                side.main.main(["--fake", "--once"]))

    assert both(script) == (0, 2)


def test_leader_election_accepts_rfc3339_without_fraction():
    def script(side):
        client = side.FakeClient()
        a = side.manager.LeaderElector(client, NS, identity="pod-a", lease_seconds=30)
        out = [a.try_acquire()]
        b = side.manager.LeaderElector(client, NS, identity="pod-b")
        for stamp in (datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
                      datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S") + "+00:00",
                      "2020-01-01T00:00:00Z"):
            lease = client.get(*LEASE, a.name, NS, copy=True)
            lease["spec"]["renewTime"] = stamp
            client.update(lease)
            out.append(b.try_acquire())
        return out, client.get(*LEASE, a.name, NS)["spec"]["holderIdentity"]

    # a fresh lease without a fraction or with an offset stays pod-a's;
    # an expired one is taken over
    assert both(script) == ([True, False, False, True], "pod-b")


def test_watchdog_flips_healthz_on_wedged_pass():
    def script(side):
        release, entered = threading.Event(), threading.Event()

        def wedge(_key):
            entered.set()
            release.wait(WAIT_S)

        mgr = side.manager.Manager(side.FakeClient(), NS, metrics_port=0, probe_port=0, pass_deadline_s=0.2)
        mgr.add_reconciler("k", wedge)
        mgr.start()
        try:
            out = [mgr.healthy()]
            mgr.enqueue("k")
            out.append(entered.wait(WAIT_S))
            out.append(wait(lambda: not mgr.healthy()))
            stats = mgr.watchdog_stats()
            out += [stats["stalled"], stats["inflight"]]
            release.set()
            out.append(wait(mgr.healthy))
            out.append(mgr.watchdog_stats()["stalled"])
            return out
        finally:
            release.set()
            mgr.stop()

    assert both(script) == [True, True, True, True, "k", True, False]


def test_debug_vars_watchdog_and_fault_tolerance():
    def script(side):
        mgr = side.manager.Manager(side.FakeClient(), NS, metrics_port=0, probe_port=0, debug_endpoints=True)
        try:
            with probe_server(side, mgr) as srv:
                v = json.loads(srv.get("/debug/vars")[1])
            return (v["watchdog"]["stalled"], v["watchdog"]["pass_deadline_s"] == mgr.pass_deadline_s,
                    v["fault_tolerance"]["retry"]["retries_total"], v["fault_tolerance"]["breaker"]["state"])
        finally:
            mgr.stop()

    assert both(script) == (False, True, 0, "closed")


def test_leader_identity_from_pod_env(monkeypatch):
    def script(side):
        monkeypatch.setenv("POD_NAME", "gpu-operator-abc")
        monkeypatch.setenv("POD_UID", "uid-123")
        on_cluster = side.manager.default_leader_identity()
        monkeypatch.delenv("POD_NAME")
        monkeypatch.delenv("POD_UID")
        return on_cluster, side.manager.default_leader_identity() != side.manager.default_leader_identity()

    assert both(script) == ("gpu-operator-abc_uid-123", True)


# ---------------------------------------------------------------------------
# tests/test_manager_http.py
# ---------------------------------------------------------------------------


_SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+]?[0-9.eE+-]+( [0-9.eE+-]+)?$")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class served_manager:
    """``tests/test_manager_http.py``'s fixture on one side: a started
    manager with its metrics and probe servers on free ports, the flight
    recorder writing into ``tmp``."""

    def __init__(self, side, tmp):
        self.side, self.tmp = side, tmp

    def __enter__(self):
        rec = self.side.flight.RECORDER
        self.saved = (rec.dir, rec.min_interval_s)
        rec.dir, rec.min_interval_s = str(self.tmp / self.side.name), 0.0
        rec.clear()
        self.mgr = self.side.manager.Manager(self.side.FakeClient(), NS, metrics_port=_free_port(),
                                             probe_port=_free_port(), debug_endpoints=True, pass_deadline_s=0.6)
        self.mgr.start()
        assert wait(lambda: self._up())
        return self.mgr

    def _up(self):
        try:
            _http_get(f"http://127.0.0.1:{self.mgr.probe_port}/healthz")
            return True
        except OSError:
            return False

    def __exit__(self, *exc):
        self.mgr.stop()
        self.side.flight.RECORDER.dir, self.side.flight.RECORDER.min_interval_s = self.saved


def test_metrics_scrape_parses_and_has_histograms(tmp_path):
    """The scrape parses as Prometheus text with the histogram families
    present, the port's under ``gpu_operator_``."""
    pytest.importorskip("prometheus_client")

    def script(side):
        with served_manager(side, tmp_path) as mgr:
            m = side.om.OperatorMetrics()
            m.reconcile_pass_ms_hist.observe(12.5)
            m.apply_rtt_ms_hist.labels(verb="APPLY").observe(1.25)
            m.observe_reconcile(1)
            status, text = _http_get(f"http://127.0.0.1:{mgr.metrics_port}/metrics")
        samples = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
        p = side.metrics
        count = next(ln for ln in samples if ln.startswith(f"{p}_reconcile_pass_duration_ms_count"))
        return (status, bool(samples), [ln for ln in samples if not _SAMPLE_RE.match(ln)],
                f"{p}_reconcile_pass_duration_ms_bucket" in text, 'le="50.0"' in text,
                f"{p}_apiserver_write_rtt_ms_bucket" in text, 'verb="APPLY"' in text,
                float(count.split()[-1]) >= 1)

    assert both(script) == (200, True, [], True, True, True, True, True)


def test_healthz_flip_and_flight_dump_on_stall(tmp_path):
    def script(side):
        with served_manager(side, tmp_path) as mgr:
            rec = side.flight.RECORDER
            probe = f"http://127.0.0.1:{mgr.probe_port}"
            out = [_http_get(f"{probe}/healthz")]
            before = rec.dumps_total
            mgr._inflight_item = "clusterpolicy"
            mgr._inflight_since = time.monotonic() - 5.0
            try:
                out.append(_http_get(f"{probe}/healthz")[0])
                out.append(json.loads(_http_get(f"{probe}/debug/vars")[1])["watchdog"]["stalled"])
                out.append(wait(lambda: rec.dumps_total > before))
                out.append(rec.dumps_total - before)
                with open(rec.last_dump_path) as f:
                    dump = json.load(f)
                out += [dump["reason"], "clusterpolicy" in dump["detail"], dump["extra"]["stalled"],
                        any(e["kind"] == "watchdog.stall" for e in dump["events"])]
            finally:
                mgr._inflight_since = None
                mgr._inflight_item = None
            out.append(_http_get(f"{probe}/healthz"))
            return out

    assert both(script) == [(200, "ok"), 500, True, True, 1, "watchdog-stall", True, True, True, (200, "ok")]


# ---------------------------------------------------------------------------
# tests/test_debug_vars_schema.py: the reference's key set, computed live
# ---------------------------------------------------------------------------


def _shipped_payload(side):
    mgr, _, _ = side.main.build_manager(side.FakeClient(), NS, metrics_port=0, probe_port=0, informer_cache=False)
    try:
        return mgr.debug_vars_payload()
    finally:
        mgr.stop()


def test_debug_vars_keyset_is_stable():
    """The port's shipped payload holds every key of the reference's."""
    ref, port = (_shipped_payload(side) for side in SIDES.values())
    assert set(ref) - set(port) == set(), sorted(set(ref) - set(port))
    assert {"queue_len", "watchdog", "delta_reconcile", "shards", "trace", "flight", "allocation"} <= set(port)
    assert ref["shards"] == port["shards"] == {"enabled": False}


def test_debug_vars_payload_is_json_and_providers_healthy():
    def script(side):
        payload = _shipped_payload(side)
        json.dumps(payload)
        errors = sorted(k for k, v in payload.items() if isinstance(v, dict) and "error" in v)
        return (errors, "stalled" in payload["watchdog"], "pass_deadline_s" in payload["watchdog"],
                payload["trace"]["enabled"] in (True, False), "dumps_total" in payload["flight"])

    assert both(script) == ([], True, True, True, True)


# ---------------------------------------------------------------------------
# tests/test_metrics_noprom.py
# ---------------------------------------------------------------------------


_NOPROM = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {block!r})   # masks prometheus_client
    sys.path.insert(0, {repo!r})
    os.environ["OPERATOR_NAMESPACE"] = "tpu-operator"
    os.environ["UNIT_TEST"] = "true"
    pkg = {package!r}
    om = __import__(pkg + ".controllers.operator_metrics", fromlist=["x"])
    assert not om.HAVE_PROM, "mask failed: prometheus_client imported"
    m = om.OperatorMetrics()
    for name in vars(m):
        attr = getattr(m, name)
        if isinstance(attr, om._NoopMetric):
            attr.labels(state="x").set(1)
            attr.inc()
            attr.observe(1.0)
            attr.remove("x")
    m.observe_reconcile(1)
    m.observe_reconcile(-1)
    m.set_state("state-libtpu", 1)
    rest = __import__(pkg + ".kube.rest", fromlist=["x"])
    wp = __import__(pkg + ".kube.write_pipeline", fromlist=["x"])
    wp.on_queue_wait_ms(1.0)
    rest.on_write_rtt_ms("APPLY", 2.0)
    main = __import__(pkg + ".main", fromlist=["x"])
    cpc = __import__(pkg + ".controllers.clusterpolicy_controller", fromlist=["x"])
    testing = __import__(pkg + ".kube.testing", fromlist=["x"])
    client = main.make_fake_client()
    r = cpc.ClusterPolicyReconciler(client)
    res = None
    for _ in range(30):
        res = r.reconcile()
        testing.simulate_kubelet_once(client, "tpu-operator")
        if res.ready:
            break
    assert res is not None and res.ready, "never converged metric-less"
    assert main.main(["--fake", "--simulate-kubelet", "--once", "--metrics-port", "0", "--probe-port", "0"]) == 0
    print("METRICLESS_OK")
    """
)


def test_operator_converges_without_prometheus(tmp_path):
    block = tmp_path / "block"
    block.mkdir()
    (block / "prometheus_client.py").write_text('raise ImportError("prometheus_client masked")\n')

    def script(side):
        code = _NOPROM.format(block=str(block), repo=REPO, package=side.package)
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout.split()[-1]

    assert both(script) == "METRICLESS_OK"


# ---------------------------------------------------------------------------
# tests/test_delta_reconcile.py: the two cases that need the manager
# ---------------------------------------------------------------------------


def test_resync_safety_net_converges_dropped_delta(monkeypatch):
    """With no event wiring at all, the full pass's resync alone converges
    an external label strip."""
    monkeypatch.setenv("RECONCILE_RESYNC_S", "0.3")

    def script(side):
        client = side.main.make_fake_client()
        mgr, _, _ = side.main.build_manager(client, NS, metrics_port=0, probe_port=0)
        halt = threading.Event()

        def kubelet():
            while not halt.is_set():
                try:
                    side.testing.simulate_kubelet_once(client, NS, side.node)
                except Exception:
                    pass
                halt.wait(0.05)

        threading.Thread(target=kubelet, daemon=True).start()
        mgr.start()
        try:
            mgr.enqueue("clusterpolicy")
            ready = wait(lambda: ((client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}).get(
                "status", {}).get("state")) == "ready")
            node = client.get("v1", "Node", side.node, copy=True)
            del node["metadata"]["labels"][side.consts.TPU_PRESENT_LABEL]
            client.update(node)
            restored = wait(lambda: (client.get("v1", "Node", side.node)["metadata"].get("labels") or {}).get(
                side.consts.TPU_PRESENT_LABEL) == "true")
            return ready, restored
        finally:
            halt.set()
            mgr.stop()

    assert both(script) == (True, True)


def test_worker_pool_env_knobs(monkeypatch):
    def script(side):
        out = [side.manager.default_workers() >= 1]
        for n in ("1", "6", "x"):
            monkeypatch.setenv("RECONCILE_WORKERS", n)
            out.append(side.manager.Manager(side.FakeClient(), NS, metrics_port=0, probe_port=0).workers)
        return out

    assert both(script) == [True, 1, 6, 4]


# ---------------------------------------------------------------------------
# the port's own: what build_manager wires
# ---------------------------------------------------------------------------


def test_build_manager_wires_the_delta_reconciler():
    """``wake_full``, ``enqueue_slice`` and ``enqueue_status`` (``None`` in
    a bare reconciler) reach the manager's queue as the reference's do:
    the full pass, a slice key, the coalesced status key."""

    def script(side):
        mgr, rec, _ = side.main.build_manager(side.FakeClient(), NS, metrics_port=0, probe_port=0,
                                              informer_cache=False)
        try:
            delta = rec.delta
            delta.wake_full()
            delta.enqueue_slice("slice-a")
            delta.enqueue_status()
            keys = []
            with mgr.queue._cond:
                keys = [(item, round(due - time.monotonic(), 1)) for due, item in mgr.queue._ready]
            return (sorted(keys, key=str), sorted(mgr._reconcilers), sorted(mgr._keyed_reconcilers),
                    mgr.delta is delta, mgr.shard_state, rec.shard_state)
        finally:
            mgr.stop()

    assert both(script) == (
        [("clusterpolicy", 0.0), (("slice", "slice-a"), 0.0), (("status", "slices"), 0.2)],
        ["clusterpolicy", "upgrade"], ["node", "slice", "status"], True, None, None)


def test_sharded_build_manager_sets_shard_state_everywhere(monkeypatch):
    """With ``GPU_SHARDS=2`` (the reference's ``TPU_SHARDS``) the shard
    lease manager is the manager's, the reconciler's and its controller's
    ``shard_state``, leader election yields to it, and the shard Leases
    are the port's ``gpu-operator-shard-<i>``."""

    def script(side):
        monkeypatch.setenv(side.shards_env, "2")
        client = side.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}])
        mgr, rec, _ = side.main.build_manager(client, NS, metrics_port=0, probe_port=0, leader_election=True,
                                              informer_cache=False)
        try:
            sm = mgr.shard_lease_manager
            wired = (sm is not None and mgr.shard_state is sm and rec.shard_state is sm
                     and rec.ctrl.shard_state is sm, mgr.leader_election)
            sm.tick()
            leases = sorted(lease["metadata"]["name"] for lease in client.list(*LEASE, NS))
            return wired, sm.owned(), sm.confirm_full_pass_owner(), mgr.debug_vars_payload()["shards"]["owned"], \
                [name.replace(side.shard.SHARD_LEASE_PREFIX, "<prefix>") for name in leases], \
                side.shard.SHARD_LEASE_PREFIX
        finally:
            mgr.stop()
            monkeypatch.delenv(side.shards_env)

    ref, port = (script(side) for side in SIDES.values())
    assert ref[:5] == port[:5] == ((True, False), {0, 1}, True, [0, 1], ["<prefix>0", "<prefix>1"])
    assert (ref[5], port[5]) == ("tpu-operator-shard-", "gpu-operator-shard-")
