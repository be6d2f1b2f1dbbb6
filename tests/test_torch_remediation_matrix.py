"""The port's node remediation over the wire against the JAX package's, on
the 4 cases of ``tests/test_remediation_matrix.py``: KubeSim's node faults
(cards killed, restored and flapped; an operand pod put in
CrashLoopBackOff) drive the whole operator (manager, informer cache, the
pass with the remediation FSM of ``controllers/remediation.py`` and the
slice aggregate) through the ``RestClient``.

* a dead host of a 2-host slice is quarantined (cordon, the repair taint,
  the state label), the slice goes not ready with a ``SliceDegraded`` Event
  naming the host; with its cards back it is recovered and clean;
* a flapping host burns its attempt cap and lands ``exhausted``, fenced
  even once healthy;
* half the fleet dying at once opens the breaker with zero disruptions;
  half of it clearing closes the breaker and the rest is remediated;
* a crash-looping operand pod (``KubeSim.crashloop_pod``) is restarted
  without quarantine.

Each case runs one script on both packages (``both``, from
``tests/test_torch_fault_matrix.py``): each side on its own KubeSim with its
own CRD, CR and nodes (the reference's TPU nodes, the port's H100 nodes, one
name each for both), and its own ``running_operator``. The script returns
outcomes: whether each awaited state was reached, the final FSM state,
cordon, taint and labels, the count of disruptions, ``breakerOpen``, the
Event reasons, and the crash-looped operand's app in the port's names.
Tolerance: exact equality of those outcomes. Every wait on a condition has
a limit of 60 s or more (90 s for a convergence), no time is asserted, and
every server and operator stops in a ``finally``.
"""

import time

import yaml

from tests.test_torch_fault_matrix import NS, both, operator_env, start_server, wait  # noqa: F401

CPV = "tpu.k8s.io/v1"
SLICE_ID = "rm-slice-a"
SLICE_NODES = ("rm-node-1", "rm-node-2")
SINGLE_NODES = ("rm-node-3", "rm-node-4", "rm-node-5", "rm-node-6")
NODES = SLICE_NODES + SINGLE_NODES


def start_cluster(side, node_names=NODES, slice_nodes=SLICE_NODES, chips=8):
    """KubeSim with a fleet (a 2-host slice and single-host nodes), every
    host advertising its cards through the simulator."""
    server = start_server(side)
    try:
        client = side.kubesim.make_client(server.port)
        client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}})
        client.create(side.crdgen.build_crd())
        for name in node_names:
            extra = {}
            if name in slice_nodes:
                extra = {side.consts.TFD_SLICE_ID_LABEL: SLICE_ID,
                         side.consts.TFD_SLICE_HOSTS_LABEL: str(len(slice_nodes))}
            client.create(side.node(name, extra_labels=extra))
            server.sim.set_node_chips(name, chips)
        with open(side.sample) as f:
            client.create(yaml.safe_load(f))
    except BaseException:
        server.stop()
        raise
    return server, server.sim, client


def enable_remediation(side, client, **knobs):
    merged = {"enabled": True, "maxAttempts": 2, "backoffSeconds": 0, "maxUnavailable": "50%",
              "systemicThreshold": "50%"}
    merged.update(knobs)
    side.testing.edit_clusterpolicy(client, lambda cp: cp["spec"].update(remediation=merged))


def cp_status(client):
    return (client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}).get("status") or {}


def node(client, name):
    return client.get("v1", "Node", name)


def labels(client, name):
    return node(client, name)["metadata"].get("labels") or {}


def state(side, client, name):
    return labels(client, name).get(side.consts.REMEDIATION_STATE_LABEL)


def quarantined(side, client, name):
    n = node(client, name)
    c = side.consts
    return (state(side, client, name) == c.REMEDIATION_STATE_QUARANTINED and n.get("spec", {}).get("unschedulable", False)
            and side.kclient.has_taint(n, c.REPAIR_TAINT_KEY, c.REPAIR_PENDING))


def clean(side, client, name):
    n = node(client, name)
    c = side.consts
    lab = n["metadata"].get("labels") or {}
    return (c.REMEDIATION_STATE_LABEL not in lab and c.REPAIR_LABEL not in lab
            and not n.get("spec", {}).get("unschedulable", False) and not side.kclient.has_taint(n, c.REPAIR_TAINT_KEY))


def fence(side, client, name):
    """The node's remediation outcome: (state label, cordoned, tainted)."""
    n = node(client, name)
    return (state(side, client, name), bool(n.get("spec", {}).get("unschedulable", False)),
            side.kclient.has_taint(n, side.consts.REPAIR_TAINT_KEY))


def slice_ready(side, client, members):
    return all(labels(client, n).get(side.consts.SLICE_READY_LABEL) == "true" for n in members)


def event(client, reason, *needles):
    for e in client.list("v1", "Event", NS):
        if e.get("reason") == reason and all(n in e.get("message", "") for n in needles):
            return e
    return None


def remediation(client):
    return cp_status(client).get("remediation") or {}


def test_chip_death_quarantines_then_recovery_uncordons():
    """Row 1: one host of the 2-host slice loses its cards: quarantined, the
    slice flips, its Event and the quarantine's name the host and slice;
    the cards return: recovered, uncordoned, untainted, the slice READY."""
    victim = SLICE_NODES[0]

    def script(side):
        server, sim, client = start_cluster(side)
        try:
            out = {}
            with side.running_operator(client, NS, NODES):
                out["ready"] = wait(lambda: cp_status(client).get("state") == "ready", 90)
                out["slice ready"] = wait(lambda: slice_ready(side, client, SLICE_NODES), 60)
                enable_remediation(side, client)
                sim.kill_node_chips(victim)
                out["quarantined"] = wait(lambda: quarantined(side, client, victim), 90)
                out["fence"] = fence(side, client, victim)
                out["slice flipped"] = wait(lambda: not slice_ready(side, client, SLICE_NODES), 60)
                out["SliceDegraded names host"] = wait(
                    lambda: event(client, "SliceDegraded", SLICE_ID, victim) is not None, 60)
                out["NodeQuarantined names host"] = wait(
                    lambda: event(client, "NodeQuarantined", victim, SLICE_ID) is not None, 60)
                out["CR counts it"] = wait(lambda: remediation(client).get("quarantined", 0) >= 1, 60)
                out["sibling clean"] = clean(side, client, SLICE_NODES[1])
                sim.restore_node_chips(victim)
                out["recovered clean"] = wait(lambda: clean(side, client, victim), 90)
                out["slice ready again"] = wait(lambda: slice_ready(side, client, SLICE_NODES), 90)
                out["NodeRemediationRecovered"] = event(client, "NodeRemediationRecovered", victim) is not None
            return out
        finally:
            server.stop()

    out = both(script)
    assert out.pop("fence") == ("quarantined", True, True)
    assert all(out.values()), out


def test_flapping_host_lands_exhausted():
    """Row 2: kill, quarantine, restore, recover, kill again burns the
    attempt cap (``maxAttempts`` 2): the host lands ``exhausted``, fenced
    even with its cards healthy, its single-host slice not ready."""
    victim = SINGLE_NODES[0]

    def script(side):
        server, sim, client = start_cluster(side)
        c = side.consts
        try:
            out = {}
            with side.running_operator(client, NS, NODES):
                out["ready"] = wait(lambda: cp_status(client).get("state") == "ready", 90)
                enable_remediation(side, client)
                sim.kill_node_chips(victim)
                out["quarantined"] = wait(lambda: quarantined(side, client, victim), 90)
                sim.flap_node_chips(victim)
                out["clean"] = wait(lambda: clean(side, client, victim), 90)
                sim.flap_node_chips(victim)
                out["exhausted"] = wait(lambda: state(side, client, victim) == c.REMEDIATION_STATE_EXHAUSTED, 90)
                out["fence"] = fence(side, client, victim)
                out["NodeRemediationExhausted"] = event(client, "NodeRemediationExhausted", victim) is not None
                sim.restore_node_chips(victim)
                time.sleep(2.0)
                out["fence once healthy"] = fence(side, client, victim)
                out["slice not ready"] = wait(lambda: labels(client, victim).get(c.SLICE_READY_LABEL) == "false", 60)
                out["CR counts it"] = wait(lambda: remediation(client).get("exhausted", 0) >= 1, 60)
            return out
        finally:
            server.stop()

    out = both(script)
    assert out.pop("fence") == out.pop("fence once healthy") == ("exhausted", True, True)
    assert all(out.values()), out


def test_systemic_failure_opens_breaker_zero_disruptions():
    """Row 3: half the fleet dying at once opens the breaker: zero
    disruptions (no cordon, taint or eviction: the workload pod survives)
    and ``Degraded/SystemicNodeFailure`` on the CR; half of it clearing
    closes the breaker and the remaining dead host is remediated."""
    nodes = SINGLE_NODES

    def script(side):
        server, sim, client = start_cluster(side, node_names=nodes, slice_nodes=())
        try:
            out = {}
            with side.running_operator(client, NS, list(nodes)):
                out["ready"] = wait(lambda: cp_status(client).get("state") == "ready", 90)
                client.create({
                    "apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": "train-1", "namespace": "default", "labels": {"job": "train"},
                                 "ownerReferences": [{"kind": "Job", "name": "train", "uid": "j1"}]},
                    "spec": {"nodeName": nodes[0], "containers": [
                        {"name": "train", "resources": {"limits": {side.resource: "4"}}}]},
                    "status": {"phase": "Running"}})
                # both hosts die before remediation is on, so the first
                # enabled pass sees the systemic picture. The nodes and the
                # CR come to the operator on separate watches: wait until
                # its status names both dead hosts, else the CR edit can
                # land first and a pass seeing one victim fences it
                sim.kill_node_chips(nodes[0])
                sim.kill_node_chips(nodes[1])
                out["kills seen"] = wait(
                    lambda: (cp_status(client).get("slices") or {}).get("degraded") == sorted(nodes[:2]), 60)
                enable_remediation(side, client)
                out["breaker open"] = wait(lambda: remediation(client).get("breakerOpen") is True, 60)
                degraded = {c["type"]: c for c in cp_status(client).get("conditions") or []}["Degraded"]
                out["degraded"] = (degraded["status"], degraded["reason"])
                out["SystemicNodeFailure"] = event(client, "SystemicNodeFailure") is not None
                time.sleep(2.0)
                out["disruptions"] = sum(fence(side, client, n) != (None, False, False) for n in nodes)
                out["workload survived"] = client.get_or_none("v1", "Pod", "train-1", "default") is not None
                sim.restore_node_chips(nodes[1])
                out["rest remediated"] = wait(lambda: quarantined(side, client, nodes[0]), 120)
                out["workload drained"] = wait(lambda: client.get_or_none("v1", "Pod", "train-1", "default") is None,
                                               60)
                out["breaker closed"] = not remediation(client).get("breakerOpen")
            return out
        finally:
            server.stop()

    out = both(script)
    assert out.pop("degraded") == ("True", "SystemicNodeFailure")
    assert out.pop("disruptions") == 0
    assert all(out.values()), out


def test_crashloop_operand_remediated_by_restart_without_quarantine():
    """Row 4: a crash-looping operand pod is fixed by the cheap rung,
    restart-operands: the pod is deleted, its DaemonSet recreates it
    Running, and the node recovers with no cordon, taint or eviction."""
    nodes = SINGLE_NODES
    victim = nodes[0]

    def script(side):
        server, sim, client = start_cluster(side, node_names=nodes, slice_nodes=())
        try:
            out = {}
            with side.running_operator(client, NS, list(nodes)):
                out["ready"] = wait(lambda: cp_status(client).get("state") == "ready", 90)
                # backoffSeconds 1: the revalidate dwell outlasts the
                # simulated kubelet's recreate interval
                enable_remediation(side, client, backoffSeconds=1)
                app = side.app("tpu-device-plugin-daemonset")
                pod = next(p for p in client.list("v1", "Pod", NS) if p["spec"].get("nodeName") == victim
                           and (p["metadata"].get("labels") or {}).get("app") == app)
                pod_name = pod["metadata"]["name"]
                out["app"] = side.names(app)
                sim.crashloop_pod(NS, pod_name)
                out["restarted running"] = wait(
                    lambda: ((client.get_or_none("v1", "Pod", pod_name, NS) or {}).get("status", {}) or {}).get(
                        "containerStatuses") == [{"ready": True}], 90)
                out["clean"] = wait(lambda: clean(side, client, victim), 90)
                out["fence"] = fence(side, client, victim)
            return out
        finally:
            server.stop()

    out = both(script)
    assert out.pop("app") == "gpu-device-plugin-daemonset"
    assert out.pop("fence") == (None, False, False)
    assert all(out.values()), out
