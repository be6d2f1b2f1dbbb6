"""The port's sharded scale-out (``shard.py``, and its wiring in
``main.build_manager``) against the JAX package's, on the cases of
``tests/test_sharding.py`` (its queue case is in
``tests/test_torch_workqueue.py``), ``tests/test_shard_splitbrain.py`` and
one case of the port's own: one fleet, built through ``convert``, gets the
same shards on both sides.

Each case runs one script on both packages (``both``) and compares what it
returns: owned shard sets, fencing, routed keys, shards of nodes and
slices. The reference's nodes are built with its own ``make_tpu_node``;
the port gets each through ``convert`` (``test_torch_upgrade.port_obj``: an
H100 node carrying the converted labels), so slice ids and node names,
which cross unchanged, are the ring's keys on both sides. Tolerance:
exact equality, apart from the Lease names (``gpu-operator-shard-<i>``;
the reference's ``tpu-operator-shard-<i>``) and the shard variables
(``GPU_SHARDS``, ``GPU_SHARD_MAX``, ``GPU_SHARD_LEASE_S``). The wire cases
(the journal-seeded failover and the split brain) run each side on its
own KubeSim; every wait has a limit of 30 s or more, and every manager and
server stops in a ``finally``.
"""

import os
import random
import threading
import time
from types import SimpleNamespace

import pytest
import yaml

from tests import test_torch_upgrade as tu
from tpu_operator import consts as ref_consts
from tpu_operator import main as ref_main
from tpu_operator import manager as ref_manager
from tpu_operator import shard as ref_shard
from tpu_operator.cfg import crdgen as ref_crdgen
from tpu_operator.controllers import delta as ref_delta
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import rest as ref_rest
from tpu_operator.kube import testing as ref_testing
from tpu_operator.kube import warm as ref_warm
from tpu_operator_torch import consts, main, manager, shard
from tpu_operator_torch.cfg import crdgen
from tpu_operator_torch.controllers import delta
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import kubesim, rest, testing, warm
from tpu_operator_torch.kube.client import FakeClient

NS = "tpu-operator"
WAIT_S = 60.0

SIDES = {
    "reference": SimpleNamespace(
        name="reference", shard=ref_shard, manager=ref_manager, main=ref_main, consts=ref_consts,
        delta=ref_delta, FakeClient=RefFakeClient, kclient=ref_kclient, kubesim=ref_kubesim, rest=ref_rest,
        testing=ref_testing, warm=ref_warm, crdgen=ref_crdgen, node=lambda o: o, env="TPU_SHARD",
        prefix="tpu-operator-shard-"),
    "port": SimpleNamespace(
        name="port", shard=shard, manager=manager, main=main, consts=consts, delta=delta, FakeClient=FakeClient,
        kclient=kclient, kubesim=kubesim, rest=rest, testing=testing, warm=warm, crdgen=crdgen,
        node=tu.port_obj, env="GPU_SHARD", prefix="gpu-operator-shard-"),
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


def wait(pred, timeout_s=WAIT_S):
    return testing.wait_until(pred, timeout_s, 0.05)


def ref_node(name, sid=None, hosts=None, pool=None, topology="2x2"):
    """A reference TPU node; ``sid``/``hosts``/``pool`` set its slice
    labels (keys both packages share)."""
    extra = {}
    if sid:
        extra[ref_consts.TFD_SLICE_ID_LABEL] = sid
    if hosts:
        extra[ref_consts.TFD_SLICE_HOSTS_LABEL] = str(hosts)
    if pool:
        extra[ref_consts.GKE_NODEPOOL_LABEL] = pool
    return ref_testing.make_tpu_node(name, topology=topology, extra_labels=extra)


def _ns_obj():
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}


def _mk_sm(side, client, shards=4, max_shards=None, identity=None, lease_s=2):
    return side.shard.ShardLeaseManager(client, NS, shards, identity=identity, lease_seconds=lease_s,
                                        max_shards=max_shards)


# ---------------------------------------------------------------------------
# hash ring
# ---------------------------------------------------------------------------


def test_ring_is_deterministic_and_balanced():
    def script(side):
        ring = side.shard.HashRing(8)
        keys = [f"node-{i}" for i in range(4000)]
        first = [ring.shard_of(k) for k in keys]
        return first, first == [ring.shard_of(k) for k in keys]

    first, stable = both(script)
    counts = [first.count(s) for s in range(8)]
    assert stable and max(counts) <= 2 * min(counts), counts


def test_multi_host_slice_members_land_on_the_slice_shard():
    def script(side):
        ring = side.shard.HashRing(16)
        members = [side.node(ref_node(f"host-{i}", sid="slice-alpha", hosts=4)) for i in range(4)]
        return {ring.shard_of(side.shard.node_slice_identity(n)) for n in members}, ring.shard_of("slice-alpha")

    shards, sid_shard = both(script)
    assert shards == {sid_shard}


def test_one_fleet_gets_one_assignment_on_both_sides():
    """The port's own: a fleet of explicit-id slices, node-pool slices
    (slice-hosts > 1, no id) and single hosts, built through ``convert``,
    gets equal ``shard_of_node_obj`` and ``shard_of_slice`` on both
    sides, and each multi-host slice's members share their slice's
    shard."""
    fleet = [ref_node(f"a-{s}-{h}", sid=f"slice-{s}", hosts=4) for s in range(6) for h in range(4)]
    fleet += [ref_node(f"p-{s}-{h}", hosts=4, pool=f"pool-{s}", topology="4x4") for s in range(4) for h in range(4)]
    fleet += [ref_node(f"solo-{i}") for i in range(40)]

    def script(side):
        sm = _mk_sm(side, side.FakeClient([_ns_obj()]), shards=8, identity="rep")
        nodes = {n["metadata"]["name"]: sm.shard_of_node_obj(side.node(n)) for n in fleet}
        sids = [f"slice-{s}" for s in range(6)] + [f"pool-{s}" for s in range(4)]
        return nodes, {sid: sm.shard_of_slice(sid) for sid in sids}, {
            name: sm.shard_of_node_name(name) for name in nodes}

    nodes, slices, by_name = both(script)
    assert by_name == nodes
    for s in range(6):
        assert {nodes[f"a-{s}-{h}"] for h in range(4)} == {slices[f"slice-{s}"]}
    for s in range(4):
        assert {nodes[f"p-{s}-{h}"] for h in range(4)} == {slices[f"pool-{s}"]}
    assert len(set(nodes.values())) == 8


# ---------------------------------------------------------------------------
# per-shard leases
# ---------------------------------------------------------------------------


def test_two_replicas_split_the_ring_and_leases_cas():
    def script(side):
        client = side.FakeClient([_ns_obj()])
        a = _mk_sm(side, client, shards=4, max_shards=2, identity="rep-a_1")
        a.tick()
        b = _mk_sm(side, client, shards=4, max_shards=2, identity="rep-b_1")
        b.tick()
        out = [sorted(a.owned()), sorted(b.owned())]
        a.tick()
        b.tick()
        leases = sorted(lease["metadata"]["name"] for lease in client.list("coordination.k8s.io/v1", "Lease", NS))
        return out + [sorted(a.owned()), sorted(b.owned()), [n.replace(side.prefix, "") for n in leases]]

    a0, b0, a1, b1, leases = both(script)
    assert len(a0) == len(b0) == 2 and not set(a0) & set(b0) and set(a0) | set(b0) == {0, 1, 2, 3}
    assert (a1, b1) == (a0, b0) and leases == ["0", "1", "2", "3"]


def test_expired_lease_fails_over_and_full_shard_exceeds_max():
    def script(side):
        client = side.FakeClient([_ns_obj()])
        a = _mk_sm(side, client, shards=4, max_shards=3, identity="rep-a_1", lease_s=1)
        a.tick()
        out = [a.owns_full_pass(), len(a.owned())]
        b = _mk_sm(side, client, shards=4, max_shards=1, identity="rep-b_1", lease_s=30)
        b.tick()
        out += [len(b.owned()), b.owns_full_pass()]
        time.sleep(1.2)  # a's leases expire
        b.tick()
        return out + [b.owns_full_pass(), len(b.owned())]

    assert both(script) == [True, 3, 1, False, True, 2]


def test_renewal_loss_drops_shard_and_fires_callbacks():
    def script(side):
        client = side.FakeClient([_ns_obj()])
        a = _mk_sm(side, client, shards=2, max_shards=2, identity="rep-a_1", lease_s=1)
        a.tick()
        lost = []
        a.on_lose.append(lost.append)
        time.sleep(1.2)
        b = _mk_sm(side, client, shards=2, max_shards=1, identity="rep-b_1", lease_s=30)
        b._electors.pop(0)
        elector = b._electors[1]
        if b._vacant(elector) and elector.try_acquire():
            b._gain(1)
        out = [b.owns(1)]
        a.tick()
        return out + [a.owns(1), lost, a.handoffs_total]

    assert both(script) == [True, False, [1], 1]


def test_confirm_full_pass_owner_fences_a_stale_holder():
    def script(side):
        client = side.FakeClient([_ns_obj()])
        a = _mk_sm(side, client, shards=2, max_shards=2, identity="rep-a_1", lease_s=1)
        a.tick()
        out = [a.confirm_full_pass_owner()]
        time.sleep(1.2)
        b = _mk_sm(side, client, shards=2, max_shards=2, identity="rep-b_1", lease_s=30)
        b.tick()
        out += [b.owns_full_pass(), a.owns_full_pass(), a.confirm_full_pass_owner(), a.owns_full_pass(),
                a.fenced_passes]
        return out

    assert both(script) == [True, True, True, False, False, 1]


def test_covers_node_falls_back_for_orphaned_shards_only():
    def script(side):
        a = _mk_sm(side, side.FakeClient([_ns_obj()]), shards=3, max_shards=3, identity="rep-a_1", lease_s=30)
        a.tick()
        node = side.node(ref_node("n-1"))
        out = [a.covers_node_obj(node)]
        foreign = next(s for s in range(1, 3) if s != a.shard_of_node_obj(node))
        a._owned.discard(foreign)
        a._held_by_other[foreign] = True
        i = 0
        n2 = side.node(ref_node("x-0"))
        while a.shard_of_node_obj(n2) != foreign:
            i += 1
            n2 = side.node(ref_node(f"x-{i}"))
        out += [n2["metadata"]["name"], a.covers_node_obj(n2)]
        a._held_by_other[foreign] = False
        return out + [a.covers_node_obj(n2)]

    out = both(script)
    assert out[0] is True and out[2:] == [False, True]


# ---------------------------------------------------------------------------
# queue drain / handoff property
# ---------------------------------------------------------------------------


def _handoff(side, seed):
    """``tests/test_sharding.py``'s hand-off on one side: 2 workers × 2
    simulated replicas over the real ``WorkQueue``; returns each moved
    key's violations (an old-owner run past the drain or overlapping a
    new-owner run) and whether the drain settled."""
    rng = random.Random(seed)
    ring = side.shard.HashRing(2)
    queues = {"A": side.manager.WorkQueue(), "B": side.manager.WorkQueue()}
    for q in queues.values():
        q.mark_barrier("clusterpolicy")
    ownership = {0: "A", 1: "A"}
    own_lock, runs_lock = threading.Lock(), threading.Lock()
    runs = []
    stop = threading.Event()

    def owner_of(key):
        if key == "clusterpolicy":
            return None
        with own_lock:
            return ownership[ring.shard_of(key[1])]

    def worker(replica, q):
        while not stop.is_set():
            item = q.get(timeout=0.05)
            if item is None:
                continue
            try:
                if owner_of(item) in (replica, None):
                    t0 = time.monotonic()
                    time.sleep(rng.random() * 0.003)
                    with runs_lock:
                        runs.append((item, replica, t0, time.monotonic()))
            finally:
                q.task_done(item)

    threads = [threading.Thread(target=worker, args=(rep, queues[rep]), daemon=True) for rep in ("A", "B")
               for _ in range(2)]
    for t in threads:
        t.start()
    keys = [("node", f"n-{i}") for i in range(12)] + [("slice", f"s-{i}") for i in range(6)]
    try:
        for k in rng.sample(keys, len(keys)):
            queues["A"].add(k)
        queues["A"].add("clusterpolicy")
        time.sleep(0.05)
        moved = 1
        with own_lock:
            ownership[moved] = "B"

        def pred(k):
            return isinstance(k, tuple) and ring.shard_of(k[1]) == moved

        queues["A"].remove_if(pred)
        settled = queues["A"].wait_idle(pred, timeout=30.0)
        handoff_done = time.monotonic()
        for k in keys:
            if pred(k):
                queues["B"].add(k)
        queues["B"].add("clusterpolicy")
        time.sleep(0.15)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    violations = []
    for key in keys:
        if not pred(key):
            continue
        a_runs = [(t0, t1) for k, rep, t0, t1 in runs if k == key and rep == "A"]
        b_runs = [t0 for k, rep, t0, _ in runs if k == key and rep == "B"]
        for _, a1 in a_runs:
            if a1 > handoff_done or any(a1 > b0 for b0 in b_runs):
                violations.append(key)
    return violations, settled, sorted(k for k in keys if pred(k))


@pytest.mark.parametrize("seed", [3, 11])
def test_handoff_drain_never_overlaps_old_and_new_owner(seed):
    violations, settled, moved = both(_handoff, seed)
    assert violations == [] and settled and moved


# ---------------------------------------------------------------------------
# journal shard slicing
# ---------------------------------------------------------------------------


def test_journal_shard_slice_filters_nodes_and_their_pods():
    informers = {
        "v1|Node": {"namespace": "", "rv": 42, "objects": [{"metadata": {"name": "keep-1"}},
                                                           {"metadata": {"name": "drop-1"}}]},
        "v1|Pod": {"namespace": "", "rv": 42, "objects": [
            {"metadata": {"name": "p1"}, "spec": {"nodeName": "keep-1"}},
            {"metadata": {"name": "p2"}, "spec": {"nodeName": "drop-1"}},
            {"metadata": {"name": "p3"}, "spec": {}}]},
        "apps/v1|DaemonSet": {"namespace": NS, "rv": 42, "objects": [{"metadata": {"name": "ds"}}]},
    }

    def script(side):
        # the sharding API re-exports the journal's slicer, as the reference's does
        assert side.shard.journal_shard_slice is side.warm.journal_shard_slice
        out = side.shard.journal_shard_slice(informers, lambda name, node: name.startswith("keep"))
        return ([o["metadata"]["name"] for o in out["v1|Node"]["objects"]],
                [o["metadata"]["name"] for o in out["v1|Pod"]["objects"]],
                len(out["apps/v1|DaemonSet"]["objects"]), out["v1|Node"]["rv"])

    assert both(script) == (["keep-1"], ["p1", "p3"], 1, 42)


# ---------------------------------------------------------------------------
# shard-aware event router
# ---------------------------------------------------------------------------


class _FakeMgr:
    def __init__(self, shard_state):
        self.shard_state = shard_state
        self.enqueued = []

    def enqueue(self, key, delay=0.0):
        self.enqueued.append(key)


def test_router_drops_foreign_shard_keys_and_counts():
    def script(side):
        sm = _mk_sm(side, side.FakeClient([_ns_obj()]), shards=2, max_shards=2, identity="rep-a_1")
        sm.tick()
        mgr = _FakeMgr(sm)
        router = side.delta.EventRouter(mgr, None, "clusterpolicy", "upgrade")
        router.enabled = True
        sm._owned.discard(1)
        owned = foreign = None
        i = 0
        while owned is None or foreign is None:
            n = side.node(ref_node(f"n-{i}"))
            if sm.shard_of_node_obj(n) == 0:
                owned = owned or n["metadata"]["name"]
            else:
                foreign = foreign or n["metadata"]["name"]
            i += 1
        dropped0 = sm.events_dropped_total
        router._fire("node", ("node", owned))
        router._fire("node", ("node", foreign))
        out = [list(mgr.enqueued), sm.events_dropped_total - dropped0]
        mgr.enqueued.clear()
        router._fire("node", "upgrade")
        out.append(list(mgr.enqueued))
        sm._owned.discard(0)
        router._fire("node", "upgrade")
        out.append(list(mgr.enqueued))
        router._fire("clusterpolicy", "clusterpolicy")
        return out + [mgr.enqueued[-1], sm.events_routed.get(0, 0) >= 1, owned, foreign]

    out = both(script)
    assert out[:6] == [[("node", out[6])], 1, ["upgrade"], ["upgrade"], "clusterpolicy", True]


def test_router_keeps_node_shard_map_current():
    def script(side):
        sm = _mk_sm(side, side.FakeClient([_ns_obj()]), shards=4, max_shards=4, identity="rep-a_1")
        sm.tick()
        router = side.delta.EventRouter(_FakeMgr(sm), None, "clusterpolicy", "upgrade")
        router.on_event("ADDED", side.node(ref_node("member-1", sid="slice-zzz", hosts=4)))
        return sm.shard_of_node_name("member-1"), sm.shard_of_slice("slice-zzz")

    mapped, sid = both(script)
    assert mapped == sid


# ---------------------------------------------------------------------------
# the wire cases: each side on its own KubeSim
# ---------------------------------------------------------------------------


def _seed(side, server, client, names, chips=8):
    client.create(_ns_obj())
    client.create(side.crdgen.build_crd())
    for name in names:
        client.create(side.node(ref_testing.make_tpu_node(name)))
        server.sim.set_node_chips(name, chips)
    with open(side.testing.sample_clusterpolicy_path()) as f:
        client.create(yaml.safe_load(f))


def _client(side, server):
    client = side.kubesim.make_client(server.port)
    client.GET_RETRY_BACKOFF_S = 0.05
    return client


def _kubelet(side, client, names, halt):
    def loop():
        while not halt.is_set():
            try:
                side.testing.simulate_kubelet_nodes(client, NS, list(names))
            except (side.kclient.ConflictError, side.kclient.NotFoundError, side.rest.TransientAPIError, OSError):
                pass
            halt.wait(0.15)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def test_journal_seeded_failover_avoids_the_cold_relist(monkeypatch, tmp_path):
    """Stop the shard-0 owner: the survivor takes the lease and seeds its
    mirror from the shared warm journal — no LIST on the server — then
    reads the whole fleet. A scoped replica never writes the journal."""
    nodes = tuple(f"fo-node-{i}" for i in range(6))

    def script(side):
        for key, value in (("S", "4"), ("_MAX", "4"), ("_LEASE_S", "2")):
            monkeypatch.setenv(side.env + key, value)
        warm_path = str(tmp_path / f"{side.name}-warm.json")
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0, compact_keep=8192))
        server.start()
        halt = threading.Event()
        mgr_a = mgr_b = None
        stops = []
        try:
            seed = _client(side, server)
            _seed(side, server, seed, nodes)
            _kubelet(side, seed, nodes, halt)
            client_a = _client(side, server)
            mgr_a, rec_a, _ = side.main.build_manager(client_a, NS, metrics_port=0, probe_port=0,
                                                      warm_state=warm_path)
            stops.append(threading.Event())
            side.main.wire_event_sources(mgr_a, client_a, NS, stop_event=stops[-1])
            mgr_a.start()
            mgr_a.enqueue(side.main.CP_KEY)
            out = [wait(lambda: mgr_a.shard_state.owns_full_pass()),
                   wait(lambda: rec_a.passes_total >= 1 and rec_a.ctrl.tpu_node_count == len(nodes))]
            rec_a.save_warm_state()
            client_b = _client(side, server)
            mgr_b, rec_b, _ = side.main.build_manager(client_b, NS, metrics_port=0, probe_port=0,
                                                      warm_state=warm_path)
            stops.append(threading.Event())
            side.main.wire_event_sources(mgr_b, client_b, NS, stop_event=stops[-1])
            mgr_b.start()
            sm_b = mgr_b.shard_state
            out.append(sorted(sm_b.owned()))
            before = os.stat(warm_path).st_mtime_ns
            rec_b.save_warm_state()
            out.append(os.stat(warm_path).st_mtime_ns == before)
            halt.set()
            time.sleep(0.4)
            mgr_a.stop()
            lists_before = server.sim.request_counts.get("LIST", 0)
            out += [wait(lambda: sm_b.owns_full_pass()),
                    wait(lambda: rec_b.ctrl.tpu_node_count == len(nodes)),
                    server.sim.request_counts.get("LIST", 0) - lists_before,
                    sm_b.failover.get("seeded_from_journal"), sm_b.failover.get("adopted", 0) >= len(nodes)]
            return out
        finally:
            halt.set()
            for stop in stops:
                stop.set()
            for mgr in (mgr_a, mgr_b):
                if mgr is not None:
                    mgr.stop()
            server.stop()

    assert both(script) == [True, True, [], True, True, True, 0, True, True]


def _disrupted_count(side, client):
    return sum(1 for node in client.list("v1", "Node")
               if (node["metadata"].get("labels") or {}).get(side.consts.REMEDIATION_STATE_LABEL)
               in side.consts.REMEDIATION_DISRUPTED_STATES)


def test_split_brain_never_double_drains(monkeypatch):
    """``tests/test_shard_splitbrain.py``: replica A's lease loop freezes
    while it keeps reconciling; replica B takes every lease over. With
    the cards of two hosts dead under ``maxUnavailable: 1`` remediation,
    the disrupted nodes never exceed the cap, A's budgeted pass is fenced
    and B remediates."""
    names = tuple(f"sb-node-{i}" for i in range(6))
    cap = 1

    def script(side):
        for key, value in (("S", "4"), ("_MAX", "4"), ("_LEASE_S", "2")):
            monkeypatch.setenv(side.env + key, value)
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0)).start()
        halt = threading.Event()
        mgr_a = mgr_b = None
        stops = [threading.Event(), threading.Event()]
        try:
            seed = _client(side, server)
            _seed(side, server, seed, names)
            side.testing.edit_clusterpolicy(seed, lambda cp: cp["spec"].update(remediation={
                "enabled": True, "maxAttempts": 3, "backoffSeconds": 0, "maxUnavailable": cap,
                "systemicThreshold": "90%"}))
            _kubelet(side, seed, names, halt)
            client_a = _client(side, server)
            mgr_a, rec_a, _ = side.main.build_manager(client_a, NS, metrics_port=0, probe_port=0)
            side.main.wire_event_sources(mgr_a, client_a, NS, stop_event=stops[0])
            mgr_a.start()
            mgr_a.enqueue(side.main.CP_KEY)
            sm_a = mgr_a.shard_state
            out = [wait(lambda: sm_a.owns_full_pass()),
                   wait(lambda: rec_a.passes_total >= 1 and rec_a.ctrl.has_tpu_nodes)]
            sm_a._stop.set()  # the stale holder: its renew loop frozen
            if sm_a._thread is not None:
                sm_a._thread.join(timeout=30)
            client_b = _client(side, server)
            mgr_b, _, _ = side.main.build_manager(client_b, NS, metrics_port=0, probe_port=0)
            side.main.wire_event_sources(mgr_b, client_b, NS, stop_event=stops[1])
            time.sleep(2.5)  # A's leases expire
            mgr_b.start()
            mgr_b.enqueue(side.main.CP_KEY)
            sm_b = mgr_b.shard_state
            out += [wait(lambda: sm_b.owns_full_pass()), sm_a.owns_full_pass() and sm_b.owns_full_pass()]
            for victim in names[:2]:
                server.sim.kill_node_chips(victim)
            over_cap, saw = [], False
            deadline = time.monotonic() + 40
            while time.monotonic() < deadline:
                mgr_a.enqueue(side.main.CP_KEY)  # the stale holder keeps trying
                n = _disrupted_count(side, seed)
                saw = saw or n > 0
                if n > cap:
                    over_cap.append(n)
                if saw and sm_a.fenced_passes > 0 and n <= cap and time.monotonic() > deadline - 36:
                    break
                time.sleep(0.1)
            return out + [over_cap, saw, sm_a.fenced_passes > 0, sm_a.owns_full_pass()]
        finally:
            halt.set()
            for stop in stops:
                stop.set()
            for mgr in (mgr_a, mgr_b):
                if mgr is not None:
                    mgr.stop()
            server.stop()

    assert both(script) == [True, True, True, True, [], True, True, False]
