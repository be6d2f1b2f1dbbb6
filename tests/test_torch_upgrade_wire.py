"""The rolling driver upgrade over the wire on the port against the JAX
package's, on the four wire cases that ``tests/test_torch_upgrade_kubesim.py``
does not hold: ``tests/test_upgrade_kubesim.py``'s drain timeout with its
recovery and cleanup, the 25-node roll under ``maxUnavailable`` 25%, and
the drain a PodDisruptionBudget vetoes; and
``tests/test_upgrade_slices.py``'s two-slice roll.

Each case runs on each package (``two_sided.hold``), on the side's own
KubeSim seeded by its own ``seed_cluster`` (the reference's TPU nodes, the
port's H100 nodes, one name for both) with its own whole operator
(``running_operator``), with the reference's assertions made on each side.
The driver's spec section comes from the rename table (``KEY_RENAMES``),
the card resource and the FSM's labels from each side's ``consts``. The
outcomes compared are the states reached, whether nodes stayed cordoned,
which pods survived, the Event reasons and the veto's words, and the
throttle's verdicts (never a count a sampler's timing decides). Tolerance:
exact equality. Every wait on a condition has a limit of 60 s or more,
no time is asserted, and every server and operator stops in a
``finally``.
"""

from types import SimpleNamespace

import pytest

from tests import conftest
from tests.two_sided import BY_SIDE, hold
from tpu_operator import consts as ref_consts
from tpu_operator.controllers import operator_metrics as ref_om
from tpu_operator.kube import client as ref_kclient
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import rest as ref_rest
from tpu_operator.kube import testing as ref_testing
from tpu_operator.upgrade import upgrade_state as ref_us
from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import KEY_RENAMES
from tpu_operator_torch.controllers import operator_metrics as om
from tpu_operator_torch.kube import client as kclient
from tpu_operator_torch.kube import kubesim, rest, testing
from tpu_operator_torch.upgrade import upgrade_state as us

NS = "tpu-operator"
NODES = ("up-node-1", "up-node-2", "up-node-3")
MEMBERS = {"slice-a": [f"a-host-{i}" for i in range(1, 5)], "slice-b": [f"b-host-{i}" for i in range(1, 5)]}

SIDES = {
    "reference": SimpleNamespace(
        name="reference", kubesim=ref_kubesim, testing=ref_testing, consts=ref_consts, us=ref_us, rest=ref_rest,
        k=ref_kclient, om=ref_om, running_operator=conftest.running_operator, spec="libtpu",
        resource=ref_consts.TPU_RESOURCE, node=ref_testing.make_tpu_node),
    "port": SimpleNamespace(
        name="port", kubesim=kubesim, testing=testing, consts=consts, us=us, rest=rest, k=kclient, om=om,
        running_operator=testing.running_operator, spec=KEY_RENAMES[("spec", "libtpu")],
        resource=consts.GPU_RESOURCE, node=testing.make_gpu_node),
}


@pytest.fixture(autouse=True)
def operator_env(monkeypatch):
    monkeypatch.setenv(consts.OPERATOR_NAMESPACE_ENV, NS)
    monkeypatch.setenv("UNIT_TEST", "true")


def wait(pred, timeout_s=60.0):
    return testing.wait_until(pred, timeout_s, 0.1)


def on_cluster(node_names=NODES):
    """``fn(side, server, client)`` on a fresh KubeSim of the side seeded
    with ``node_names``."""

    def wrap(fn):
        def script(side):
            server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0)).start()
            try:
                client = side.kubesim.make_client(server.port)
                client.GET_RETRY_BACKOFF_S = 0.05
                side.testing.seed_cluster(client, NS, node_names=node_names)
                return fn(side, server, client)
            finally:
                server.stop()

        script.__qualname__ = fn.__qualname__
        return script

    return wrap


def cr_state(side, client):
    cp = client.get_or_none(f"{side.consts.GROUP}/v1", "ClusterPolicy", "cluster-policy") or {}
    return (cp.get("status") or {}).get("state")


def state(side, node):
    return (node["metadata"].get("labels") or {}).get(side.consts.UPGRADE_STATE_LABEL)


def states(side, client, names=NODES):
    return {n: state(side, client.get("v1", "Node", n)) for n in names}


def roll(side, client, version, **policy):
    side.testing.edit_clusterpolicy(
        client, lambda cp: cp["spec"][side.spec].update(upgradePolicy=dict(autoUpgrade=True, **policy),
                                                         version=version))


def card_pod(side, name, node, labels=None, owned=True):
    meta = {"name": name, "namespace": NS}
    if labels:
        meta["labels"] = labels
    if owned:
        meta["ownerReferences"] = [{"apiVersion": "batch/v1", "kind": "Job", "name": "j", "uid": f"u-{name}"}]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"nodeName": node, "containers": [{"name": "train",
                                                        "resources": {"limits": {side.resource: "4"}}}]},
            "status": {"phase": "Running"}}


def failed_first_others_done(side, client):
    s = states(side, client)
    return s[NODES[0]] == side.us.STATE_FAILED and all(s[n] == side.us.STATE_DONE for n in NODES[1:])


def cordoned(client, name):
    return bool(client.get("v1", "Node", name).get("spec", {}).get("unschedulable", False))


@BY_SIDE
def test_upgrade_drain_timeout_failure_recovery_and_cleanup(side):
    """A drain that cannot clear (an ownerless card pod, no force) spends
    its 1 s budget and lands ``upgrade-failed``, cordoned, with a Warning
    Event, while the other nodes finish; the documented recovery finishes
    it; turning autoUpgrade off strips every state label."""

    @on_cluster()
    def script(side, server, client):
        c = side.consts
        with side.running_operator(client, NS, NODES):
            out = [wait(lambda: cr_state(side, client) == "ready", 90)]
            client.create(card_pod(side, "adhoc-train", NODES[0], owned=False))
            roll(side, client, "2025.3.0", maxParallelUpgrades=3, maxUnavailable="100%",
                 drain={"enable": True, "timeoutSeconds": 1})
            settled = wait(lambda: failed_first_others_done(side, client), 90)
            assert settled, states(side, client)
            out += [settled, cordoned(client, NODES[0]), client.get_or_none("v1", "Pod", "adhoc-train", NS) is not None]
            reasons = sorted({e.get("reason") for e in client.list("v1", "Event", NS)
                              if e.get("involvedObject", {}).get("name") == NODES[0]})
            assert "UpgradeDrainTimeout" in reasons, reasons
            assert out[2:] == [True, True]
            client.delete("v1", "Pod", "adhoc-train", NS)  # the recovery: blocker gone, uncordon, clear the state

            def recover(node):
                node["spec"]["unschedulable"] = False
                node["metadata"]["labels"].pop(c.UPGRADE_STATE_LABEL, None)
                return True

            side.k.mutate_with_retry(client, "v1", "Node", NODES[0], mutate=recover)
            done = wait(lambda: state(side, client.get("v1", "Node", NODES[0])) == side.us.STATE_DONE, 90)
            assert done and not cordoned(client, NODES[0])
            side.testing.edit_clusterpolicy(
                client, lambda cp: cp["spec"][side.spec]["upgradePolicy"].update(autoUpgrade=False))
            stripped = wait(lambda: all(s is None for s in states(side, client).values()), 60)
            assert stripped, states(side, client)
            return out + ["UpgradeDrainTimeout" in reasons, done, stripped]

    hold(SIDES, side, script)


FLEET = tuple(f"fleet-node-{i}" for i in range(25))


@BY_SIDE
def test_rolling_upgrade_fleet_scale(side):
    """25 nodes roll with ``maxUnavailable`` 25%: never more than 6 in
    flight, every node done and uncordoned, the fleet ready again."""

    @on_cluster(FLEET)
    def script(side, server, client):
        max_active = [0]

        def sampler(halt):
            while not halt.is_set():
                try:
                    active = sum(1 for n in client.list("v1", "Node") if state(side, n) in side.us.ACTIVE_STATES)
                    max_active[0] = max(max_active[0], active)
                except (side.rest.TransientAPIError, OSError):
                    pass
                halt.wait(0.05)

        with side.running_operator(client, NS, FLEET, extra_threads=(sampler,)):
            out = [wait(lambda: cr_state(side, client) == "ready", 180)]
            assert out[0], "the 25-node pool never converged"
            roll(side, client, "2025.5.0", maxParallelUpgrades=6, maxUnavailable="25%")
            done = wait(lambda: all(state(side, n) == side.us.STATE_DONE for n in client.list("v1", "Node")), 240)
            assert done, sorted((n["metadata"]["name"], state(side, n)) for n in client.list("v1", "Node")
                                if state(side, n) != side.us.STATE_DONE)
            throttled = 1 <= max_active[0] <= 6
            assert throttled, f"{max_active[0]} in flight with a budget of 6"
            left_cordoned = [n["metadata"]["name"] for n in client.list("v1", "Node")
                             if n.get("spec", {}).get("unschedulable", False)]
            assert left_cordoned == []
            ready = wait(lambda: cr_state(side, client) == "ready", 120)
            assert ready, "the fleet is not ready after the roll"
            return out + [done, throttled, left_cordoned, ready]

    hold(SIDES, side, script)


@BY_SIDE
def test_pdb_blocked_drain_fails_with_veto_event(side):
    """The drain evicts through the Eviction subresource, so a budget
    over the workload vetoes it: ``upgrade-failed`` with an Event naming
    the budget and a climbing veto counter; without the budget the
    recovered node finishes and the pod is evicted."""

    @on_cluster()
    def script(side, server, client):
        m = side.om.OperatorMetrics()
        counter = getattr(m, "evictions_blocked", None)
        blocked_before = counter._value.get() if side.om.HAVE_PROM and counter is not None else None
        c = side.consts
        with side.running_operator(client, NS, NODES):
            out = [wait(lambda: cr_state(side, client) == "ready", 90)]
            client.create(card_pod(side, "guarded-train", NODES[0], labels={"app": "guarded"}))
            client.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                           "metadata": {"name": "guarded-pdb", "namespace": NS},
                           "spec": {"minAvailable": 1, "selector": {"matchLabels": {"app": "guarded"}}}})
            roll(side, client, "2026.1.0", maxParallelUpgrades=3, maxUnavailable="100%",
                 drain={"enable": True, "timeoutSeconds": 1})
            settled = wait(lambda: failed_first_others_done(side, client), 120)
            assert settled, states(side, client)
            survived = client.get_or_none("v1", "Pod", "guarded-train", NS) is not None
            assert survived, "the budget did not protect the pod"
            vetoes = [e for e in client.list("v1", "Event", NS) if e.get("reason") == "UpgradeDrainTimeout"
                      and "disruption budget" in e.get("message", "") and "guarded-pdb" in e.get("message", "")]
            assert vetoes
            climbed = None
            if blocked_before is not None:
                climbed = counter._value.get() > blocked_before
                assert climbed
            client.delete("policy/v1", "PodDisruptionBudget", "guarded-pdb", NS)

            def recover(node):
                node["spec"]["unschedulable"] = False
                node["metadata"]["labels"].pop(c.UPGRADE_STATE_LABEL, None)
                return True

            side.k.mutate_with_retry(client, "v1", "Node", NODES[0], mutate=recover)
            done = wait(lambda: state(side, client.get("v1", "Node", NODES[0])) == side.us.STATE_DONE, 90)
            assert done
            evicted = client.get_or_none("v1", "Pod", "guarded-train", NS) is None
            assert evicted, "the drain did not evict through the subresource"
            return out + [settled, survived, bool(vetoes), climbed, done, evicted]

    hold(SIDES, side, script)


@BY_SIDE
def test_two_slice_rolling_upgrade_over_the_wire(side):
    """slice-a's four hosts roll together (three or more active at once,
    beyond ``maxParallelUpgrades`` 2 a node), never beside slice-b, which
    starts only once slice-a is done; per-slice Events record the roll."""

    @on_cluster(())
    def script(side, server, client):
        c = side.consts
        all_nodes = MEMBERS["slice-a"] + MEMBERS["slice-b"]
        for sid, names in MEMBERS.items():
            for n in names:
                client.create(side.node(n, extra_labels={c.TFD_SLICE_ID_LABEL: sid, c.TFD_SLICE_HOSTS_LABEL: "4"}))
        max_active_a, overlap, b_before_a_done = [0], [], []

        def sampler(halt):
            while not halt.is_set():
                try:
                    nodes = {n["metadata"]["name"]: n for n in client.list("v1", "Node")}
                    active = {name for name, n in nodes.items() if state(side, n) in side.us.ACTIVE_STATES}
                    a_active = [n for n in MEMBERS["slice-a"] if n in active]
                    b_active = [n for n in MEMBERS["slice-b"] if n in active]
                    max_active_a[0] = max(max_active_a[0], len(a_active))
                    if a_active and b_active:
                        overlap.append((a_active, b_active))
                    if b_active and any(state(side, nodes[n]) != side.us.STATE_DONE
                                        for n in MEMBERS["slice-a"] if n in nodes):
                        b_before_a_done.append(b_active)
                except (side.rest.TransientAPIError, OSError):
                    pass
                halt.wait(0.03)

        with side.running_operator(client, NS, all_nodes, extra_threads=(sampler,)):
            out = [wait(lambda: cr_state(side, client) == "ready", 120)]
            assert out[0], "the cluster never converged before the upgrade"
            roll(side, client, "2026.2.0", maxParallelUpgrades=2, maxUnavailable="50%",
                 drain={"enable": True, "timeoutSeconds": 300})
            done = wait(lambda: all(state(side, client.get("v1", "Node", n)) == side.us.STATE_DONE
                                    for n in all_nodes), 180)
            assert done, states(side, client, all_nodes)
        together = max_active_a[0] >= 3
        assert together, f"slice-a's hosts never rolled together ({max_active_a[0]} at most)"
        assert not overlap, f"both slices disrupted at once: {overlap[:3]}"
        assert not b_before_a_done, f"slice-b rolled before slice-a was done: {b_before_a_done[:3]}"
        left_cordoned = [n for n in all_nodes if cordoned(client, n)]
        assert left_cordoned == []
        reasons = {e.get("reason") for e in client.list("v1", "Event", NS)}
        per_slice = sorted(reasons & {"SliceUpgradeStarted", "SliceUpgradeCompleted"})
        assert per_slice == ["SliceUpgradeCompleted", "SliceUpgradeStarted"], sorted(reasons)
        return out + [done, together, overlap, b_before_a_done, left_cordoned, per_slice]

    hold(SIDES, side, script)
