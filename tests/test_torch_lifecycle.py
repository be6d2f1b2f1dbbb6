"""The fleet's lifecycle on the port against the JAX package's, on the 4
cases of ``tests/test_lifecycle.py`` that no other port test holds: KubeSim's
node deletion with its pod cascade and Events, seeded joins and preemption
waves, and the disruption holds that a vanished node must free in the
upgrade FSM and in remediation. The fifth case, the churn engine's detach,
is ``tests/test_torch_schedsim.py``'s.

Each case runs on each package (``two_sided.hold``), with the reference's
assertions made on each side in that side's names. The KubeSim cases seed
each side with its own ``seed_cluster`` (the reference's TPU nodes, the
port's H100 nodes, one name for both). The FSM cases run over paired worlds
(``tests/test_torch_upgrade.py``'s ``World``): the reference's objects are
built with its own fixtures and cross to the port through ``convert``, and
after the script the worlds are compared as that file sets out (labels,
annotations, taints, pods, evictions and deletions, Events). Tolerance:
exact equality of those and of the returned outcomes (budgets, held slices,
FSM states, deletion events, victims). Every server stops in a
``finally``.
"""

import random
import time
from types import SimpleNamespace

import pytest

from tests import test_torch_remediation as trem
from tests import test_torch_upgrade as tu
from tests import test_upgrade as ref_t
from tests.two_sided import BY_SIDE, hold
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator_torch.kube import kubesim, testing

NS = tu.NS

SIDES = {
    "reference": SimpleNamespace(**vars(tu.SIDES["reference"]), kubesim=ref_kubesim),
    "port": SimpleNamespace(**vars(tu.SIDES["port"]), kubesim=kubesim),
}
assert SIDES["port"].testing is testing and SIDES["reference"].testing is ref_testing


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """``tests/test_torch_upgrade.py``'s clock: jitter at its upper bound,
    both remediation modules on one clock."""
    monkeypatch.setattr(random, "uniform", lambda a, b: b)
    for mod in (tu.ref_rem, tu.rem):
        monkeypatch.setattr(mod, "_utc_now", time.time)


def start(side):
    server = side.kubesim.KubeSimServer(side.kubesim.KubeSim()).start()
    return server, side.kubesim.make_client(server.port)


def in_world(script):
    """``script(world)`` on a fresh paired world of the side; the outcome
    is what it returns and what its world holds after it."""

    def run(side):
        w = tu.World(side)
        return script(w), w.view()

    run.__qualname__ = script.__qualname__
    return run


# --- KubeSim's lifecycle primitives -----------------------------------------

@BY_SIDE
def test_delete_node_cascades_pods_with_events(side):
    """One DELETED event for the node and one a bound pod, the lifecycle
    hooks fired once, and a second delete answering False."""

    def script(side):
        server, client = start(side)
        sim = server.sim
        try:
            side.testing.seed_cluster(client, NS, node_names=("lc-1", "lc-2"))
            for i in range(3):
                client.create({"apiVersion": "v1", "kind": "Pod",
                               "metadata": {"name": f"lc-pod-{i}", "namespace": NS},
                               "spec": {"nodeName": "lc-1"}})
            hooks = []
            sim.add_lifecycle_hook(lambda e, n: hooks.append((e, n)))
            rv_before = sim._rv

            verdicts = (sim.delete_node("lc-1"), sim.delete_node("lc-1"))
            assert verdicts == (True, False)

            deleted = sorted((key[2], key[4]) for rv, etype, key, _ in sim._events
                             if rv > rv_before and etype == "DELETED")
            assert ("nodes", "lc-1") in deleted
            assert {("pods", f"lc-pod-{i}") for i in range(3)} <= set(deleted)
            assert client.get_or_none("v1", "Pod", "lc-pod-0", NS) is None
            assert hooks == [("DELETED", "lc-1")]
            assert sim.nodes_deleted == 1
            survivors = sorted(n["metadata"]["name"] for n in client.list("v1", "Node"))
            return verdicts, deleted, hooks, sim.nodes_deleted, survivors
        finally:
            server.stop()

    hold(SIDES, side, script)


@BY_SIDE
def test_join_and_preemption_wave_are_deterministic(side):
    """The same seed gives the same join names and the same victims, on
    each package and across them."""

    def script(side):
        servers = []
        try:
            for _ in range(2):
                server, client = start(side)
                servers.append(server)
                side.testing.seed_cluster(client, NS, node_names=tuple(f"det-{i}" for i in range(6)))
            a, b = (s.sim for s in servers)
            names_a = a.add_nodes(3, name_prefix="wave")
            names_b = b.add_nodes(3, name_prefix="wave")
            assert names_a == names_b == ["wave-1", "wave-2", "wave-3"]
            va = a.preemption_wave(0.25, rng=random.Random(42))
            vb = b.preemption_wave(0.25, rng=random.Random(42))
            assert va == vb and len(va) == 3  # ceil(9 * 0.25)
            return names_a, va, (a.nodes_added, a.nodes_deleted)
        finally:
            for s in servers:
                s.stop()

    hold(SIDES, side, script)


# --- the upgrade FSM's hold on a vanished slice ------------------------------

def slice_node(w, name, sid, hosts=2):
    return tu.managed(w, name, extra={tu.ref_consts.TFD_SLICE_ID_LABEL: sid,
                                      tu.ref_consts.TFD_SLICE_HOSTS_LABEL: str(hosts)})


@BY_SIDE
def test_upgrade_budget_released_when_slice_vanishes_mid_roll(side):
    """maxUnavailable=1 slice: slice-a holds the pool mid-roll; its hosts
    are deleted; the next build admits slice-b, slice-a's FSM entries are
    retired and the dead hosts' drain bookkeeping is pruned."""

    @in_world
    def script(w):
        members = {"slice-a": ["a-1", "a-2"], "slice-b": ["b-1", "b-2"]}
        for sid, names in members.items():
            for n in names:
                w.create(slice_node(w, n, sid))
                w.create(ref_t.driver_pod(n, "stale-hash"))
                w.create(ref_t.validator_pod(n))
        w.create(ref_t.driver_ds())
        us = w.side.us
        mgr = tu.manager(w)
        pol = tu.policy(w, max_parallel_upgrades=8, max_unavailable=1)
        mgr.apply_state(mgr.build_state(), pol)
        budget = us.slice_budget(mgr.build_state(), pol)
        assert budget.active_sids == {"slice-a"}
        assert budget.admit == 0  # slice-b starved behind the cap
        before = (sorted(budget.active_sids), budget.admit, sorted(budget.groups))

        mgr.drain.last_block_reason["a-1"] = "pdb veto"
        for n in members["slice-a"]:
            w.client.delete("v1", "Node", n)
            for pod in w.client.list("v1", "Pod", NS, field_selector={"spec.nodeName": n}):
                w.client.delete_if_exists("v1", "Pod", pod["metadata"]["name"], NS)

        state = mgr.build_state()
        budget = us.slice_budget(state, pol)
        assert "slice-a" not in budget.groups  # FSM entries retired
        assert budget.admit == 1, "the vanished slice must release its hold"
        after = (sorted(budget.active_sids), budget.admit, sorted(budget.groups))
        mgr.apply_state(state, pol)
        assert "a-1" not in mgr.drain.last_block_reason  # bookkeeping pruned
        final = us.slice_budget(mgr.build_state(), pol).active_sids
        assert final == {"slice-b"}
        return before, after, sorted(mgr.drain.last_block_reason), sorted(final), tu.states(w, members["slice-b"])

    hold(SIDES, side, script)


# --- remediation's hold on a vanished node -----------------------------------

@BY_SIDE
def test_remediation_hold_released_when_node_vanishes(side):
    """cap=1 slice: rn-1's quarantine takes the pool and rn-2's escalation
    defers; deleting rn-1 mid-quarantine frees the pool, so rn-2 escalates,
    and rn-1's log-once state is pruned."""

    @in_world
    def script(w):
        c = w.c
        for i in (1, 2, 3, 4):
            w.create(trem.tpu_node(f"rn-{i}"))
            w.create(ref_testing.make_validator_pod(f"rn-{i}", True, NS))
        w.ctrl = w.side.rem.NodeRemediationController(w.client)
        sp = trem.spec(w, max_attempts=4, max_unavailable="25%", systemic_threshold="90%")
        log = []

        def run_pass():
            summary = trem.run_pass(w, sp)
            log.append((summary.disrupted_slices, summary.budget_cap, summary.budget_deferred))
            return summary

        trem.kill(w, "rn-1")
        for _ in range(4):
            run_pass()
        assert trem.rstate(w, "rn-1") in (c.REMEDIATION_STATE_CORDON_DRAIN, c.REMEDIATION_STATE_QUARANTINED)

        trem.kill(w, "rn-2")
        deferred = 0
        for _ in range(4):
            summary = run_pass()
            deferred += summary.budget_deferred
            assert summary.disrupted_slices <= summary.budget_cap == 1
        assert deferred > 0
        assert trem.rstate(w, "rn-2") == c.REMEDIATION_STATE_REVALIDATE
        held = (trem.rstate(w, "rn-1"), trem.rstate(w, "rn-2"))

        # the quarantined host is preempted: its hold must release
        w.client.delete("v1", "Node", "rn-1")
        w.client.delete_if_exists("v1", "Pod", "val-rn-1", NS)
        summary = run_pass()
        assert summary.disrupted_slices <= 1
        assert ("rn-1", "budget") not in w.ctrl._logged
        for _ in range(3):
            summary = run_pass()
            assert summary.disrupted_slices <= summary.budget_cap == 1
        assert trem.rstate(w, "rn-2") in (c.REMEDIATION_STATE_CORDON_DRAIN, c.REMEDIATION_STATE_QUARANTINED), \
            "freed budget must let the deferred node escalate"
        return held, deferred, log, {n: trem.rstate(w, n) for n in ("rn-2", "rn-3", "rn-4")}

    hold(SIDES, side, script)
