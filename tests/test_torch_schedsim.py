"""The port's scheduling-churn engine (``tpu_operator_torch/schedsim``)
against the JAX package's (``tpu_operator/schedsim``).

The 14 cases of ``tests/test_schedsim.py`` run on the port: the ledger,
the gang coordinator, the in-process churn engine's invariants over the
real plugin admission path, and the simulated kubelet's ledger over real
gRPC. The three that depend on geometry are restated over chip tables of
more than one NVLink domain (on one HGX board fragmentation reads 0 by
construction). ``tests/test_lifecycle.py``'s engine-detach case runs too.

Two cases hold the port against the reference directly: one seeded
sequence of holds, releases and gang holds driven through both ledgers and
both coordinators (equal results, equal ``stats()``, a
``DoubleAllocationError`` at the same steps), and a property over free
sets of a reference ``2x4`` host: the port's table whose domains are the
reference's ICI components of that set gives the same largest block and
fragmentation, strays included. Tolerance: exact equality.
"""

import os
import random
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

os.environ.setdefault("OPERATOR_NAMESPACE", "tpu-operator")
os.environ.setdefault("UNIT_TEST", "true")

from tpu_operator.schedsim import gang as ref_gang  # noqa: E402
from tpu_operator.schedsim import registry as ref_registry  # noqa: E402
from tpu_operator.workloads import topology as ref_topo  # noqa: E402
from tpu_operator_torch import consts  # noqa: E402
from tpu_operator_torch.kube.client import FakeClient  # noqa: E402
from tpu_operator_torch.kube.kubelet_sim import (  # noqa: E402
    KubeletDeviceManager,
    PodGoneError,
    StaleGenerationError,
)
from tpu_operator_torch.kube.kubesim import KubeSim, KubeSimServer, make_client  # noqa: E402
from tpu_operator_torch.kube.testing import seed_cluster  # noqa: E402
from tpu_operator_torch.plugin.server import DevicePluginServer  # noqa: E402
from tpu_operator_torch.schedsim.engine import (  # noqa: E402
    ChurnEngine,
    InsufficientChipsError,
    SyntheticChipServicer,
)
from tpu_operator_torch.schedsim.gang import GangCoordinator  # noqa: E402
from tpu_operator_torch.schedsim.registry import (  # noqa: E402
    AllocationRegistry,
    DoubleAllocationError,
    fragmentation_pct,
    largest_contiguous_block,
)

NS = "tpu-operator"
CHURN_NS = "alloc-churn"
RES = consts.GPU_RESOURCE
# two NVLink domains of four cards, and four of two (NVLink-bridged pairs)
TWO_DOMAINS = {i: {"index": i, "nvlink_domain": i // 4} for i in range(8)}
PAIRS = {i: {"index": i, "nvlink_domain": i // 2} for i in range(8)}
BOARD = {i: {"index": i, "nvlink_domain": 0} for i in range(8)}


def wait_until(pred, timeout_s=30.0, poll_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


# -- AllocationRegistry ------------------------------------------------------


def test_registry_hold_release_and_double_allocation():
    reg = AllocationRegistry()
    reg.hold("n1", RES, "pod-a", ["0", "1"])
    reg.hold("n1", RES, "pod-b", ["2"])
    reg.hold("n2", RES, "pod-a", ["0"])  # other node: fine
    assert reg.total_held() == 4
    assert reg.held_ids("n1", RES) == {"0", "1", "2"}
    assert reg.holder_of("n1", RES, "1") == "pod-a"
    with pytest.raises(DoubleAllocationError, match="already held"):
        reg.hold("n1", RES, "pod-c", ["1", "3"])
    assert reg.double_allocation_attempts == 1
    # the refused hold must not have landed card 3
    assert "3" not in reg.held_ids("n1", RES)
    # a self-overlapping hold is refused too
    with pytest.raises(DoubleAllocationError):
        reg.hold("n1", RES, "pod-d", ["4", "4"])
    assert reg.release_pod("pod-a") == 3  # both nodes freed
    assert reg.release_pod("pod-a") == 0  # idempotent
    assert reg.total_held() == 1
    reg.release_pod("pod-b")
    assert reg.total_held() == 0 and reg.pods_holding() == 0
    s = reg.stats()
    assert s["holds_total"] == 3 and s["chips_held_peak"] == 4


def test_registry_gang_tracking():
    reg = AllocationRegistry()
    reg.hold("n1", RES, "g1-m0", ["0"], gang_id="g1")
    reg.hold("n2", RES, "g1-m1", ["0"], gang_id="g1")
    reg.hold("n3", RES, "solo", ["0"])
    assert reg.pods_of_gang("g1") == ["g1-m0", "g1-m1"]
    reg.release_pod("g1-m0")
    assert reg.pods_of_gang("g1") == ["g1-m1"]


# -- fragmentation math, restated over NVLink domains -----------------------


def test_largest_contiguous_block_2x4():
    """The reference's 2x4 case over a host of two NVLink domains of four
    cards (0-3 and 4-7): a block is the free cards inside one domain."""
    assert largest_contiguous_block(range(8), TWO_DOMAINS) == 4
    assert largest_contiguous_block(range(8), BOARD) == 8
    # {0,1,2} in one domain, {7} alone in the other
    assert largest_contiguous_block([0, 1, 2, 7], TWO_DOMAINS) == 3
    # one card in each domain
    assert largest_contiguous_block([0, 7], TWO_DOMAINS) == 1
    assert largest_contiguous_block([], TWO_DOMAINS) == 0
    # stray/non-numeric ids and ids outside the table count as singleton
    # blocks, never crash
    assert largest_contiguous_block(["0", "1", "weird"], TWO_DOMAINS) == 2
    assert largest_contiguous_block([9, "x"], TWO_DOMAINS) == 1


def test_fragmentation_pct():
    # every host fully free on one board -> 0
    assert fragmentation_pct([set(range(8))] * 4, BOARD) == 0.0
    # nothing free anywhere -> 0 (nothing to fragment)
    assert fragmentation_pct([set(), set()], TWO_DOMAINS) == 0.0
    # one host with one free card in each domain: block 1 of 2 -> 50%
    assert fragmentation_pct([{0, 4}], TWO_DOMAINS) == 50.0
    # a fully free host of two domains holds half its cards in one block
    assert fragmentation_pct([set(range(8))], TWO_DOMAINS) == 50.0
    # mixed fleet: (4 in one domain) + (2 free, 1 contiguous) = 5/6
    assert fragmentation_pct([set(range(4)), {0, 4}], TWO_DOMAINS) == 16.67


# -- GangCoordinator ---------------------------------------------------------


def test_gang_holds_block_and_release():
    c = GangCoordinator(hold_ttl_s=5.0)
    assert c.acquire("g1", ["n1", "n2"])
    assert c.holder("n1") == "g1"
    assert not c.acquire("g2", ["n2", "n3"], timeout_s=0.05)
    assert c.holder("n3") is None, "failed admission must hold nothing"
    c.release("g1", ["n1", "n2"])
    assert c.acquire("g2", ["n2", "n3"], timeout_s=0.5)
    c.release("g2", ["n2", "n3"])
    assert c.active_holds() == 0


def test_gang_hold_ttl_reclaims_wedged_admitter():
    c = GangCoordinator(hold_ttl_s=0.1)
    assert c.acquire("wedged", ["n1"])
    time.sleep(0.15)
    assert c.acquire("fresh", ["n1"], timeout_s=0.5)
    assert c.expired_reclaims_total == 1
    c.release("fresh", ["n1"])


def test_gang_contention_no_deadlock():
    """Two gangs over overlapping hosts, acquired from worker threads in
    OPPOSITE naming orders, many rounds: both must always make progress,
    with no admission timing out."""
    c = GangCoordinator(hold_ttl_s=5.0, backoff_s=0.0005)
    rounds = 60
    done = [0, 0]
    errs = []

    def gang(idx, nodes):
        try:
            for r in range(rounds):
                gid = f"g{idx}-{r}"
                assert c.acquire(gid, nodes, timeout_s=10.0), gid
                time.sleep(0.0005)
                c.release(gid, nodes)
                done[idx] += 1
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    t1 = threading.Thread(target=gang, args=(0, ["a", "b", "c"]))
    t2 = threading.Thread(target=gang, args=(1, ["c", "b", "a"]))
    t1.start()
    t2.start()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not errs, errs
    assert done == [rounds, rounds]
    assert c.active_holds() == 0
    assert c.timeouts_total == 0


# -- ChurnEngine (in-process, FakeClient) -----------------------------------


def _fake_cluster_client():
    return FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}])


def test_engine_fast_churn_invariants():
    """A short unlimited-rate churn on a small fleet sustains allocations
    through the real plugin admission path with zero double allocations,
    zero partially placed gangs and a clean drain."""
    client = _fake_cluster_client()
    nodes = [f"churn-node-{i}" for i in range(24)]
    eng = ChurnEngine(
        client,
        nodes,
        workers=6,
        gang_fraction=0.2,
        gang_hosts=2,
        sizes=(1, 2, 4),
        lifetime_s=(0.05, 0.2),
        cancel_prob=0.05,
        seed=7,
    )
    eng.start()
    try:
        deadline = time.monotonic() + 6.0
        while time.monotonic() < deadline and eng.allocations_total < 150:
            time.sleep(0.05)
    finally:
        eng.stop()
    stats = eng.stats()
    assert eng.allocations_total >= 150, stats
    assert eng.invariant_violations == 0, stats
    assert eng.errors_total == 0, stats
    assert eng.registry.double_allocation_attempts == 0, stats
    verdict = eng.drain_check()
    assert verdict["chips_held"] == 0, verdict
    assert verdict["pods_holding"] == 0, verdict
    assert client.list("v1", "Pod", CHURN_NS) == [], "leftover churn pods"
    assert stats["latency_ms"]["p50_ms"] is not None
    assert stats["latency_ms"]["p99_ms"] is not None
    assert eng.gangs_admitted > 0, stats
    assert stats["coordinator"]["acquires_total"] > 0


def test_engine_cancellation_releases_reservations():
    """Pods deleted mid-allocation (every pod, ``cancel_prob=1``) release
    their cards."""
    client = _fake_cluster_client()
    eng = ChurnEngine(
        client,
        [f"c-{i}" for i in range(4)],
        workers=2,
        gang_fraction=0.0,
        cancel_prob=1.0,
        lifetime_s=(0.05, 0.1),
        seed=3,
    )
    eng.start()
    try:
        assert wait_until(lambda: eng.cancelled_total >= 20, timeout_s=10)
    finally:
        eng.stop()
    assert eng.allocations_total == 0
    assert eng.registry.total_held() == 0
    assert eng.invariant_violations == 0


def test_engine_gang_all_or_nothing_rollback():
    """A gang whose second member fails mid-admission, after the first
    member placed its pod and holds its cards, rolls back completely."""
    client = _fake_cluster_client()
    eng = ChurnEngine(client, ["ga", "gb"], workers=1, gang_fraction=1.0, gang_hosts=2, seed=1)
    eng.ensure_namespace()
    rng = random.Random(0)
    orig_allocate = eng.agents["gb"].allocate

    def fail_mid_admission(*a, **kw):
        assert eng.registry.total_held() == eng.chips_per_host
        raise InsufficientChipsError("injected mid-admission failure")

    eng.agents["gb"].allocate = fail_mid_admission
    eng._run_gang(rng)
    assert eng.pods_created == 2, "both member pods must have been placed"
    assert eng.gangs_admitted == 0
    assert eng.gangs_failed == 1
    assert eng.invariant_violations == 0
    assert eng.partial_gang_violations == 0
    assert eng.registry.total_held() == 0, "rollback leaked cards"
    assert client.list("v1", "Pod", CHURN_NS) == [], "rollback leaked pods"
    eng.agents["gb"].allocate = orig_allocate
    eng._run_gang(rng)
    assert eng.gangs_admitted == 1
    assert eng.registry.total_held() == 2 * eng.chips_per_host


def test_engine_gang_evicted_mid_admission_rolls_back_without_a_violation():
    """A lifecycle eviction that takes a placed member's host (a
    re-partition's ``evict_host``) before the next member admits: the
    port's admission rolls the gang back as failed, nothing held, no
    invariant violation. The reference's engine places the second member
    and counts a partial gang, the violation its soak reports under load;
    both runs here hold the same eviction at the same step."""
    from tpu_operator.kube import FakeClient as RefFakeClient
    from tpu_operator.schedsim.engine import ChurnEngine as RefChurnEngine

    def run(engine):
        engine.ensure_namespace()
        orig = engine.agents["gb"].allocate

        def evict_first_then_admit(*a, **kw):
            engine.evict_host("ga")  # ga's member is placed and holds its cards
            return orig(*a, **kw)

        engine.agents["gb"].allocate = evict_first_then_admit
        try:
            engine._run_gang(random.Random(0))
        except AssertionError as e:
            return str(e)
        return None

    port = ChurnEngine(_fake_cluster_client(), ["ga", "gb"], workers=1, gang_fraction=1.0, gang_hosts=2, seed=1)
    assert run(port) is None
    assert port.partial_gang_violations == 0 and port.invariant_violations == 0
    assert port.gangs_failed == 1 and port.gangs_admitted == 0
    assert port.pods_evicted_lifecycle == 1 and port.gangs_rescheduled == 1
    assert port.registry.total_held() == 0
    assert port.client.list("v1", "Pod", CHURN_NS) == []

    ref = RefChurnEngine(
        RefFakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}]),
        ["ga", "gb"],
        workers=1,
        gang_fraction=1.0,
        gang_hosts=2,
        seed=1,
    )
    assert "1/2 members hold chips after admission" in run(ref)
    assert ref.partial_gang_violations == 1
    assert ref.registry.total_held() == 0


def test_engine_scoring_prefers_contiguous_fit():
    """A host whose free cards hold an NVLink-contiguous block for the
    request beats a fragmented host with more free cards (hosts of four
    NVLink-bridged pairs)."""
    client = _fake_cluster_client()
    eng = ChurnEngine(client, ["frag", "tight"], workers=1, seed=5, cards=PAIRS)
    # frag: 3 free cards, one in each of three pairs ({0, 2, 4});
    # tight: 2 free cards forming one pair ({6, 7})
    eng.registry.hold("frag", eng.resource, "x1", ["1", "3", "5", "6", "7"])
    eng.registry.hold("tight", eng.resource, "x2", ["0", "1", "2", "3", "4", "5"])
    assert eng._score("frag", 2)[0] == 1  # no contiguous pair
    assert eng._score("tight", 2)[0] == 0
    assert eng._pick_hosts(2, 1, random.Random(0)) == ["tight"]


def test_engine_detach_releases_chips_and_terminates_gangs_whole():
    """``tests/test_lifecycle.py``'s case: a detached host takes its gang
    down whole, frees its cards and leaves the placement pool."""
    client = FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": CHURN_NS}}])
    engine = ChurnEngine(client, ["h-1", "h-2", "h-3"], workers=0, seed=3)
    engine.ensure_namespace()
    single = engine._make_pod("h-3", 2, "job-s")
    engine.agents["h-3"].allocate(2, single)
    for node in ("h-1", "h-2"):
        pod = engine._make_pod(node, 8, "gang-x")
        engine.agents[node].allocate(8, pod, gang_id="gang-x")
    assert engine.registry.pods_holding() == 3
    assert engine.registry.nodes_holding() == {"h-1", "h-2", "h-3"}
    freed = engine.detach_host("h-1")
    assert freed >= 0
    assert engine.registry.pods_of_gang("gang-x") == []
    assert engine.registry.nodes_holding() == {"h-3"}
    assert engine.registry.total_held() == 2
    assert "h-1" not in engine.agents and "h-1" not in engine.node_names
    assert engine.detach_host("h-1") == 0  # idempotent
    assert engine._pick_hosts(8, 3, random.Random(1)) != []
    assert "h-1" not in engine._pick_hosts(8, 3, random.Random(1))


def test_synthetic_hosts_name_cards_without_a_device_node():
    """A synthetic host's cards lie under a root that does not exist (an
    open probe fails, never opening a real card), carry their domain and a
    UUID, and ``Allocate`` names them by CDI and UUID."""
    servicer = SyntheticChipServicer(chips=8, cards=PAIRS, host="h-9", cdi_enabled=True)
    table = servicer.discover()
    assert [c["nvlink_domain"] for c in table] == [i // 2 for i in range(8)]
    assert all(not os.path.exists(c["path"]) for c in table)
    assert not servicer.device_probe("0")
    content = servicer.allocate_container(["2", "3"])
    assert content["cdi_devices"] == ["nvidia.com/gpu=2", "nvidia.com/gpu=3"]
    uuids = content["envs"]["NVIDIA_VISIBLE_DEVICES"].split(",")
    assert uuids == [table[2]["uuid"], table[3]["uuid"]] and all(u.startswith("GPU-") for u in uuids)
    assert servicer.preferred(["0", "2", "3", "4"], [], 2) == ["2", "3"]


# -- kubelet sim registry integration (real gRPC) ---------------------------


NODE = "sched-node-1"


@pytest.fixture()
def rig(tmp_path):
    """KubeSim + the simulated kubelet's device manager (with ledger) + the
    real plugin over a synthetic host of 4 cards."""
    server = KubeSimServer(KubeSim(bookmark_interval_s=1.0)).start()
    kubelet = plugin = None
    try:
        client = make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05
        seed_cluster(client, NS, node_names=(NODE,))
        registry = AllocationRegistry()
        socket_dir = str(tmp_path / "kubelet")
        kubelet = KubeletDeviceManager(client, NODE, socket_dir, registry=registry)
        kubelet.start()
        servicer = SyntheticChipServicer(
            chips=4, cdi_enabled=True, poll_interval_s=0.2, health_probe_interval_s=3600
        )
        plugin = DevicePluginServer(servicer, socket_dir=socket_dir)
        plugin.start()
        plugin.register_with_kubelet(kubelet.kubelet_socket)
        assert wait_until(
            lambda: client.get("v1", "Node", NODE).get("status", {}).get("allocatable", {}).get(RES) == "4"
        )
        yield client, kubelet, servicer, plugin, registry, socket_dir
    finally:
        if plugin is not None:
            plugin.stop()
        if kubelet is not None:
            kubelet.stop()
        server.stop()


def _mk_pod(client, name, ns=NS):
    client.create(
        {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": ns}, "spec": {"nodeName": NODE}}
    )
    return {"uid": f"{ns}/{name}", "namespace": ns, "name": name}


def test_kubelet_allocate_records_and_releases(rig):
    client, kubelet, servicer, plugin, registry, _ = rig
    pod = _mk_pod(client, "alloc-a")
    kubelet.allocate(RES, 2, pod=pod)
    assert registry.total_held() == 2
    pod_b = _mk_pod(client, "alloc-b")
    with pytest.raises(RuntimeError, match="only 2 allocatable"):
        kubelet.allocate(RES, 3, pod=pod_b)
    kubelet.allocate(RES, 2, pod=pod_b)
    assert registry.total_held() == 4
    with pytest.raises(RuntimeError, match="only 0 allocatable"):
        kubelet.allocate(RES, 1, pod=_mk_pod(client, "alloc-c"))
    assert kubelet.release_pod(pod["uid"]) == 2
    assert kubelet.release_pod(pod_b["uid"]) == 2
    assert registry.total_held() == 0


def test_kubelet_allocate_releases_pod_deleted_mid_allocation(rig):
    """A pod deleted while its allocation is in flight leaks no
    reservation: the kubelet releases on detection and fails cleanly."""
    client, kubelet, servicer, plugin, registry, _ = rig
    pod = _mk_pod(client, "doomed")
    client.delete_if_exists("v1", "Pod", "doomed", NS)
    with pytest.raises(PodGoneError, match="released 2"):
        kubelet.allocate(RES, 2, pod=pod)
    assert registry.total_held() == 0, "deleted pod leaked its reservation"
    survivor = _mk_pod(client, "survivor")
    kubelet.allocate(RES, 1, pod=survivor)
    client.delete_if_exists("v1", "Pod", "survivor", NS)
    kubelet.release_pod(survivor["uid"])
    assert registry.total_held() == 0


def test_reregistration_mid_churn_completes_or_fails_cleanly(rig, tmp_path):
    """Plugin re-registration and a kubelet restart mid-churn: every
    in-flight allocation completes under the live generation or fails
    cleanly; no card stays held on a plugin generation that is gone."""
    import grpc

    client, kubelet, servicer, plugin, registry, socket_dir = rig
    stop = threading.Event()
    succeeded = []
    clean_failures = []
    bad = []

    def hammer(widx):
        i = 0
        while not stop.is_set():
            key = f"h-{widx}-{i}"
            i += 1
            try:
                kubelet.allocate(RES, 1, pod={"uid": key})
                succeeded.append(key)
                time.sleep(0.002)
                kubelet.release_pod(key)
            except (StaleGenerationError, RuntimeError, grpc.RpcError):
                clean_failures.append(key)
            except Exception as e:  # pragma: no cover - failure detail
                bad.append((key, repr(e)))

    threads = [threading.Thread(target=hammer, args=(w,), daemon=True) for w in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(2):
            time.sleep(0.3)
            plugin.register_with_kubelet(kubelet.kubelet_socket)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not bad, bad
    assert len(succeeded) > 0
    for key in succeeded:
        kubelet.release_pod(key)
    assert registry.total_held() == 0, "cards held under a dead plugin generation"

    kubelet.stop()
    kubelet2 = KubeletDeviceManager(client, NODE, socket_dir, registry=registry)
    kubelet2.start()
    try:
        plugin.register_with_kubelet(kubelet2.kubelet_socket)
        assert wait_until(
            lambda: sum(1 for h in kubelet2.resources.get(RES, {}).values() if h == "Healthy") == 4
        )
        pod = _mk_pod(client, "post-restart")
        kubelet2.allocate(RES, 2, pod=pod)
        assert registry.total_held() == 2
        kubelet2.release_pod(pod["uid"])
        assert registry.total_held() == 0
    finally:
        kubelet2.stop()


# -- paired with the reference ----------------------------------------------


def _views(reg, nodes, gangs):
    return {
        "total": reg.total_held(),
        "pods": reg.pods_holding(),
        "keys": reg.holding_pod_keys(),
        "nodes": sorted(reg.nodes_holding()),
        "held": {n: sorted(reg.held_ids(n, "r")) for n in nodes},
        "on_node": {n: reg.pods_on_node(n) for n in nodes},
        "gangs": {g: reg.pods_of_gang(g) for g in gangs},
        "stats": reg.stats(),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_and_coordinator_replay_match_the_reference(seed):
    """One seeded sequence of ``hold`` (some clashing, some gang members),
    ``release_pod``, ``release_node`` and coordinator ``acquire`` /
    ``release`` / ``try_hold``, driven through both packages' ledgers and
    coordinators: every result, every view and ``stats()`` agree, and a
    ``DoubleAllocationError`` is raised at the same steps."""
    rng = random.Random(seed)
    nodes = [f"n{i}" for i in range(4)]
    gangs = [f"g{i}" for i in range(3)]
    sides = [
        (ref_registry.AllocationRegistry(), ref_gang.GangCoordinator(hold_ttl_s=3600.0), ref_registry),
        (AllocationRegistry(), GangCoordinator(hold_ttl_s=3600.0), None),
    ]
    raised = [[], []]
    for step in range(300):
        op = rng.choice(["hold", "hold", "hold", "release_pod", "release_node", "acquire", "release", "try_hold"])
        node = rng.choice(nodes)
        pod = f"p{rng.randrange(12)}"
        ids = [str(rng.randrange(8)) for _ in range(rng.randint(1, 3))]
        gang = rng.choice(gangs + [None])
        hosts = rng.sample(nodes, rng.randint(1, 3))
        results = []
        for side, (reg, coord, ref) in enumerate(sides):
            errors = (ref.DoubleAllocationError,) if ref else (DoubleAllocationError,)
            if op == "hold":
                try:
                    out = reg.hold(node, "r", pod, ids, gang_id=gang)
                except errors as e:
                    raised[side].append(step)
                    out = str(e)
            elif op == "release_pod":
                out = reg.release_pod(pod)
            elif op == "release_node":
                out = reg.release_node(node)
            elif op == "acquire":
                out = coord.acquire(gang or "solo", hosts, timeout_s=0.0)
            elif op == "release":
                out = coord.release(gang or "solo", hosts)
            else:
                out = coord.try_hold(node, gang or "solo")
            c = coord.stats()
            results.append((out, _views(reg, nodes, gangs), c, {n: coord.holder(n) for n in nodes}))
        assert results[0] == results[1], (step, op)
    assert raised[0] == raised[1] and raised[0], raised


def _ref_components(free):
    """The reference's ICI components of ``free`` in a v5e ``2x4`` host."""
    adjacency = ref_registry._adjacency("2x4", "v5e")
    comps, seen = [], set()
    for seed in sorted(free):
        if seed in seen:
            continue
        comp, frontier = {seed}, [seed]
        while frontier:
            cur = frontier.pop()
            for nb in adjacency[cur]:
                if nb in free and nb not in comp:
                    comp.add(nb)
                    frontier.append(nb)
        seen |= comp
        comps.append(comp)
    return comps


@settings(max_examples=150, deadline=None)
@given(
    st.sets(st.integers(0, 7)),
    st.lists(st.one_of(st.integers(8, 40), st.sampled_from(["weird", "x", ""])), max_size=3),
    st.booleans(),
    st.integers(1, 3),
)
def test_fragmentation_matches_the_reference_over_its_ici_components(free, strays, as_str, hosts):
    """For a free set of a reference ``2x4`` host (strays included), the
    port's table whose NVLink domains are the reference's ICI components
    of that set gives the reference's largest block and fragmentation."""
    assert ref_topo.chip_count("2x4") == 8
    comps = _ref_components(free)
    cards = {i: {"index": i, "nvlink_domain": 100 + i} for i in range(8)}  # busy cards: alone
    for d, comp in enumerate(comps):
        for i in comp:
            cards[i]["nvlink_domain"] = d
    ids = [str(i) if as_str else i for i in sorted(free)] + strays
    assert largest_contiguous_block(ids, cards) == ref_registry.largest_contiguous_block(ids, "2x4", "v5e")
    assert fragmentation_pct([ids] * hosts, cards) == ref_registry.fragmentation_pct([ids] * hosts, "2x4", "v5e")
