"""The port's host-maintenance handler (``operands/maintenance.py``, the
``gpu-maintenance-handler`` command its asset runs) against the JAX
package's, on the 22 cases of ``tests/test_maintenance.py``.

Each case runs one script on both sides over paired worlds
(``tests/test_torch_reconciler.py``'s ``World``): the reference's nodes and
pods are built with its own fixtures and cross to the port through
``convert`` (a TPU node becomes an H100 node, ``google.com/tpu`` limits
``nvidia.com/gpu``). After the script each side's world is compared as
that file sets out: every node's labels, annotations, taints and
``unschedulable``, the pods left, every eviction and deletion issued, and
the Events (type, reason, object, message and count) with the messages in
the port's words (``TPU``→``GPU``, ``libtpu``→``driver``). Tolerance: exact
equality apart from those renames. Both Event correlators write every
record through. The metadata reader cases run each side's
``read_maintenance_event`` against one local server. The wire case runs
each side's operator (``running_operator``) on its own KubeSim; its waits
have limits of 30 s or more and every server stops in a ``finally``.
"""

import http.server
import threading
from types import SimpleNamespace

from tests import conftest
from tests import test_torch_reconciler as tr
from tests.test_torch_reconciler import (  # noqa: F401  (autouse fixtures)
    CPV, NS, paired_clocks, pinned_clock)
from tpu_operator import consts as ref_consts
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import testing as ref_testing
from tpu_operator.operands import maintenance as ref_maint
from tpu_operator.upgrade import upgrade_state as ref_us
from tpu_operator_torch import consts
from tpu_operator_torch.kube import kubesim, testing
from tpu_operator_torch.operands import maintenance as maint
from tpu_operator_torch.upgrade import upgrade_state as us

NODE = "m-node-1"
WINDOW = "TERMINATE_ON_HOST_MAINTENANCE"

SIDES = {
    "reference": tr._side(tr.SIDES["reference"], maint=ref_maint, us=ref_us, handler_app="tpu-maintenance-handler",
                          metric="tpu_operator_nodes_under_maintenance"),
    "port": tr._side(tr.SIDES["port"], maint=maint, us=us, handler_app="gpu-maintenance-handler",
                     metric="gpu_operator_nodes_under_maintenance"),
}


class World(tr.World):
    """``tests/test_torch_reconciler.py``'s ``World`` whose view keeps the
    evictions (``evict(name, namespace)``: a pod's name, one on both
    sides) beside the other calls."""

    def view(self):
        calls = self.calls
        self.calls = [c for c in calls if c[0] != "evict"]
        try:
            out = super().view()
        finally:
            self.calls = calls
        out["calls"] = sorted(out["calls"] + [c for c in calls if c[0] == "evict"])
        return out


def both(script, *args):
    """``script(world, *args)`` on each side; the worlds must agree.
    Returns the two results."""
    worlds, out = [], []
    for name in ("reference", "port"):
        w = World(SIDES[name])
        out.append(script(w, *args))
        worlds.append(w)
    ref, port = (w.view() for w in worlds)
    for key in ("nodes", "pods", "calls", "crs", "events"):
        assert ref[key] == port[key], key
    return out[0], out[1]


def card_pod(name, owned=True, card=True):
    """A reference workload pod on ``NODE`` (``google.com/tpu`` limits)."""
    pod = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": name, "namespace": "default"},
           "spec": {"nodeName": NODE, "containers": [
               {"name": "c", "resources": {"limits": {ref_consts.TPU_RESOURCE: "4"}} if card else {}}]},
           "status": {"phase": "Running"}}
    if owned:
        pod["metadata"]["ownerReferences"] = [{"apiVersion": "batch/v1", "kind": "Job", "name": "j", "uid": "u1"}]
    return pod


def env(w):
    """``tests/test_maintenance.py``'s ``env`` fixture on one side: the
    node, an owned and an unmanaged card pod and a sidecar, and a handler
    reading ``w.feed``."""
    w.create(conftest.make_tpu_node(NODE))
    w.create(card_pod("train-owned"))
    w.create(card_pod("train-adhoc", owned=False))
    w.create(card_pod("sidecar", card=False))
    w.feed = {"event": w.side.maint.EVENT_NONE}
    w.handler = w.side.maint.MaintenanceHandler(w.client, NODE, reader=lambda url: w.feed["event"])
    return w


def step(w, event):
    w.feed["event"] = event
    return w.handler.reconcile_once()


def node(w, name=NODE):
    return w.client.get("v1", "Node", name)


def pods(w):
    return sorted(p["metadata"]["name"] for p in w.client.list("v1", "Pod", "default"))


def messages(w, reason):
    return [tr.message(e.get("message", ""), w.side) for e in w.client.list("v1", "Event", NS)
            if e.get("reason") == reason]


def test_window_cordons_labels_and_evicts():
    def script(w):
        env(w)
        step(w, WINDOW)
        n = node(w)
        return (n["spec"]["unschedulable"], n["metadata"]["labels"][consts.MAINTENANCE_STATE_LABEL],
                n["metadata"]["annotations"][consts.MAINTENANCE_INITIAL_STATE_ANNOTATION], pods(w),
                messages(w, "HostMaintenanceImminent"))

    ref, port = both(script)
    assert ref == port
    assert port[:4] == (True, "pending", "false", ["sidecar", "train-adhoc"])
    assert port[4] == [f"{WINDOW}: node cordoned; 1 GPU workload pod(s) evicted; 1 unmanaged pod(s) left alone "
                       "(set FORCE_EVICT=true to remove) ahead of host maintenance"]


def test_all_clear_restores():
    def script(w):
        env(w)
        step(w, "MIGRATE_ON_HOST_MAINTENANCE")
        step(w, w.side.maint.EVENT_NONE)
        n = node(w)
        return (bool(n["spec"].get("unschedulable")), consts.MAINTENANCE_STATE_LABEL in n["metadata"]["labels"],
                consts.MAINTENANCE_INITIAL_STATE_ANNOTATION in n["metadata"]["annotations"],
                len(messages(w, "HostMaintenanceCleared")))

    ref, port = both(script)
    assert ref == port == (False, False, False, 1)


def test_precordoned_node_stays_cordoned():
    def script(w):
        env(w)
        w.set_unschedulable(NODE)
        step(w, WINDOW)
        step(w, w.side.maint.EVENT_NONE)
        n = node(w)
        return n["spec"]["unschedulable"], consts.MAINTENANCE_STATE_LABEL in n["metadata"]["labels"]

    ref, port = both(script)
    assert ref == port == (True, False)


def test_crash_recovery_from_label():
    def script(w):
        env(w)
        step(w, WINDOW)
        w.side.maint.MaintenanceHandler(w.client, NODE, reader=lambda url: w.side.maint.EVENT_NONE).reconcile_once()
        n = node(w)
        return bool(n["spec"].get("unschedulable")), consts.MAINTENANCE_STATE_LABEL in n["metadata"]["labels"]

    ref, port = both(script)
    assert ref == port == (False, False)


def test_restart_mid_window_reenters_idempotently():
    def script(w):
        env(w)
        step(w, WINDOW)
        w.create(card_pod("train-straggler"))
        w.side.maint.MaintenanceHandler(w.client, NODE, reader=lambda url: WINDOW).reconcile_once()
        out = ["train-straggler" in pods(w),
               node(w)["metadata"]["annotations"][consts.MAINTENANCE_INITIAL_STATE_ANNOTATION]]
        evs = [e for e in w.client.list("v1", "Event", NS) if e.get("reason") == "HostMaintenanceImminent"]
        out += [len(evs), int(evs[0].get("count", 1)) >= 2]
        w.side.maint.MaintenanceHandler(w.client, NODE, reader=lambda url: w.side.maint.EVENT_NONE).reconcile_once()
        return out + [bool(node(w)["spec"].get("unschedulable"))]

    ref, port = both(script)
    assert ref == port == [False, "false", 1, True, False]


def test_metadata_outage_holds_state():
    def script(w):
        env(w)
        step(w, WINDOW)
        step(w, None)  # the metadata server dies mid-window
        n = node(w)
        out = [n["spec"]["unschedulable"], n["metadata"]["labels"][consts.MAINTENANCE_STATE_LABEL]]
        step(w, w.side.maint.EVENT_NONE)
        return out + [bool(node(w)["spec"].get("unschedulable"))]

    ref, port = both(script)
    assert ref == port == [True, "pending", False]


def test_no_evict_mode():
    def script(w):
        env(w)
        w.handler.evict = False
        step(w, WINDOW)
        return node(w)["spec"]["unschedulable"], pods(w)

    ref, port = both(script)
    assert ref == port == (True, ["sidecar", "train-adhoc", "train-owned"])


def test_force_evicts_unmanaged():
    def script(w):
        env(w)
        w.handler.force = True
        step(w, WINDOW)
        return pods(w)

    ref, port = both(script)
    assert ref == port == ["sidecar"]


def test_metadata_unreachable_reads_unknown():
    got = [m.read_maintenance_event("http://127.0.0.1:1/nope", timeout_s=0.2) for m in (ref_maint, maint)]
    assert got == [None, None]


class metadata_server:
    """A local HTTP server standing in for the GCE metadata endpoint,
    answering ``body`` (with ``Metadata-Flavor: Google`` when ``flavor``)."""

    def __init__(self, body: bytes, flavor: bool = True):
        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                self.send_response(200)
                if flavor:
                    self.send_header("Metadata-Flavor", "Google")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.srv = http.server.HTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_port}/maintenance-event"

    def read(self):
        return [m.read_maintenance_event(self.url, timeout_s=30) for m in (ref_maint, maint)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


def test_known_bodies_pass_through():
    for body in (b"NONE", b"MIGRATE_ON_HOST_MAINTENANCE", b""):
        with metadata_server(body) as srv:
            assert srv.read() == [body.decode() or "NONE"] * 2


def test_arbitrary_200_body_reads_unknown():
    with metadata_server(b"<html>hotel wifi login</html>") as srv:
        assert srv.read() == [None, None]


def test_missing_metadata_flavor_header_reads_unknown():
    with metadata_server(b"NONE", flavor=False) as srv:
        assert srv.read() == [None, None]


def test_all_clear_defers_uncordon_to_upgrade_fsm():
    """The upgrade FSM cordoned the node mid-window: the all-clear leaves
    it cordoned and hands the cordon over (clears the FSM's initial-state
    annotation)."""

    def script(w):
        env(w)
        step(w, WINDOW)

        def fsm_cordon(obj):
            obj["metadata"]["labels"][w.c.UPGRADE_STATE_LABEL] = w.side.us.STATE_DRAIN_REQUIRED
            obj["metadata"].setdefault("annotations", {})[w.c.UPGRADE_INITIAL_STATE_ANNOTATION] = "true"
            obj["spec"]["unschedulable"] = True
            return True

        w.side.kclient.mutate_with_retry(w.client, "v1", "Node", NODE, mutate=fsm_cordon)
        step(w, w.side.maint.EVENT_NONE)
        n = node(w)
        return (n["spec"]["unschedulable"], consts.MAINTENANCE_STATE_LABEL in n["metadata"]["labels"],
                w.c.UPGRADE_INITIAL_STATE_ANNOTATION in n["metadata"].get("annotations", {}),
                messages(w, "HostMaintenanceCleared"))

    ref, port = both(script)
    assert ref == port == (True, False, False, [
        "maintenance window cleared; node restored (left cordoned: driver upgrade in progress)"])


def test_event_message_reflects_what_happened():
    def script(w):
        env(w)
        w.handler.evict = False
        step(w, WINDOW)
        return messages(w, "HostMaintenanceImminent")

    ref, port = both(script)
    assert ref == port == [f"{WINDOW}: node cordoned (eviction disabled) ahead of host maintenance"]


def test_fleet_gauge_counts_nodes_under_maintenance():
    from prometheus_client import REGISTRY

    def script(w):
        env(w)
        w.create_cr()
        rec = w.reconciler()
        out = []
        for event in (None, WINDOW, w.side.maint.EVENT_NONE):
            if event is not None:
                step(w, event)
            rec.reconcile()
            out.append(REGISTRY.get_sample_value(w.side.metric))
        return out

    ref, port = both(script)
    assert ref == port == [0, 1, 0]


def test_state_gating():
    """Disabled (the default) deploys nothing; enabling deploys the
    handler's DaemonSet with the deploy label driving its node selector."""

    def script(w):
        w.create_cr()
        w.create(conftest.make_tpu_node(NODE))
        rec = w.reconciler()
        rec.reconcile()
        names = {d["metadata"]["name"] for d in w.client.list("apps/v1", "DaemonSet", NS)}
        out = [w.side.handler_app in names]
        cp = w.client.get(CPV, "ClusterPolicy", "cluster-policy", copy=True)
        cp["spec"]["maintenanceHandler"]["enabled"] = True
        w.client.update(cp)
        rec.reconcile()
        ds = w.client.get_or_none("apps/v1", "DaemonSet", w.side.handler_app, NS)
        label = w.c.DEPLOY_LABEL_PREFIX + w.c.COMPONENT_MAINTENANCE_HANDLER
        out += [ds is not None, node(w)["metadata"]["labels"].get(label)]
        out.append(ds["spec"]["template"]["spec"]["containers"][0].get("command") if ds else None)
        return out

    ref, port = both(script)
    assert ref[:3] == port[:3] == [False, True, "true"]
    # the port's DaemonSet runs the port's command
    assert port[3] == ["gpu-maintenance-handler"]


def _guard_pdb(w, min_available=1):
    w.client.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                     "metadata": {"name": "train-pdb", "namespace": "default"},
                     "spec": {"minAvailable": min_available, "selector": {}}})


def test_pdb_vetoed_eviction_retries_while_window_open():
    def script(w):
        env(w)
        w.client.delete("v1", "Pod", "train-adhoc", "default")
        _guard_pdb(w, min_available=2)
        step(w, WINDOW)
        msgs = messages(w, "HostMaintenanceImminent")
        out = ["train-owned" in pods(w), any("vetoed by a disruption budget" in m for m in msgs),
               any("1 GPU workload pod(s) evicted" in m for m in msgs)]
        pdb = w.client.get("policy/v1", "PodDisruptionBudget", "train-pdb", "default", copy=True)
        pdb["spec"]["minAvailable"] = 0
        w.client.update(pdb)
        w.handler.reconcile_once()
        return out + ["train-owned" in pods(w)]

    ref, port = both(script)
    assert ref == port == [True, True, False, False]


def test_force_evicts_past_pdb_on_doomed_host():
    def script(w):
        env(w)
        w.handler.force = True
        _guard_pdb(w, min_available=3)
        step(w, WINDOW)
        return pods(w)

    ref, port = both(script)
    assert ref == port == ["sidecar"]


def test_skipped_unmanaged_not_reported_as_evicted():
    def script(w):
        env(w)
        w.client.delete("v1", "Pod", "train-owned", "default")
        step(w, WINDOW)
        return messages(w, "HostMaintenanceImminent")

    ref, port = both(script)
    assert ref == port
    assert port and all("unmanaged pod(s) left alone" in m and "evicted" not in m for m in port)


def _slice_member(name, sid, ready=None):
    extra = {ref_consts.TFD_SLICE_ID_LABEL: sid, ref_consts.TFD_SLICE_HOSTS_LABEL: "4"}
    if ready is not None:
        extra[ref_consts.SLICE_READY_LABEL] = ready
    return conftest.make_tpu_node(name, extra_labels=extra)


def test_slice_flip_on_member_maintenance():
    """A member of a 4-host slice entering maintenance flips the slice's
    ready label to false on every member before the drain, with one
    per-slice Event; the all-clear records the per-slice clear Event."""

    def script(w):
        members = [f"s-host-{i}" for i in range(1, 5)]
        for n in members:
            w.create(_slice_member(n, "slice-m", ready="true"))
        feed = {"event": WINDOW}
        handler = w.side.maint.MaintenanceHandler(w.client, "s-host-2", reader=lambda url: feed["event"])
        handler.reconcile_once()
        out = [[node(w, n)["metadata"]["labels"][consts.SLICE_READY_LABEL] for n in members],
               messages(w, "SliceMaintenanceScheduled")]
        feed["event"] = w.side.maint.EVENT_NONE
        handler.reconcile_once()
        return out + [messages(w, "SliceMaintenanceCleared")]

    ref, port = both(script)
    assert ref == port
    assert port[0] == ["false"] * 4 and len(port[1]) == 1 and len(port[2]) == 1
    assert "slice-m" in port[1][0] and "s-host-2" in port[1][0] and WINDOW in port[1][0]


def test_single_host_maintenance_does_not_touch_slice_labels():
    def script(w):
        w.create(conftest.make_tpu_node(NODE))
        w.side.maint.MaintenanceHandler(w.client, NODE, reader=lambda url: "MIGRATE_ON_HOST_MAINTENANCE").reconcile_once()
        return consts.SLICE_READY_LABEL in node(w)["metadata"]["labels"], messages(w, "SliceMaintenanceScheduled")

    ref, port = both(script)
    assert ref == port == (False, [])


WIRE = {
    "reference": SimpleNamespace(kubesim=ref_kubesim, testing=ref_testing, running_operator=conftest.running_operator,
                                 maint=ref_maint, node=lambda o: o),
    "port": SimpleNamespace(kubesim=kubesim, testing=testing, running_operator=testing.running_operator, maint=maint,
                            node=tr.port_node),
}


def test_slice_maintenance_end_to_end_over_the_wire():
    """On KubeSim with the whole operator: maintenance on one host of a
    4-host slice turns the slice not ready, with the window named in a
    per-slice Event, and the operator agrees while the window is open;
    after the all-clear the operator restores the verdict."""
    members = [f"w-host-{i}" for i in range(1, 5)]

    def script(side):
        server = side.kubesim.KubeSimServer(side.kubesim.KubeSim(bookmark_interval_s=1.0)).start()
        try:
            client = side.kubesim.make_client(server.port)
            client.GET_RETRY_BACKOFF_S = 0.05
            side.testing.seed_cluster(client, NS, node_names=())
            for n in members:
                client.create(side.node(_slice_member(n, "slice-w")))

            def labels():
                return [(client.get("v1", "Node", n)["metadata"].get("labels") or {}).get(consts.SLICE_READY_LABEL)
                        for n in members]

            def wait(pred, timeout_s=60.0):
                return testing.wait_until(pred, timeout_s, 0.1)

            with side.running_operator(client, NS, members):
                out = [wait(lambda: set(labels()) == {"true"}, 120)]
                feed = {"event": WINDOW}
                handler = side.maint.MaintenanceHandler(client, members[1], reader=lambda url: feed["event"])
                handler.reconcile_once()
                out.append(wait(lambda: set(labels()) == {"false"}))
                # the operator agrees while the window is open
                out.append(not testing.wait_until(lambda: set(labels()) != {"false"}, 5.0, 0.1))
                out.append(any(e.get("reason") == "SliceMaintenanceScheduled" and "slice-w" in e.get("message", "")
                               and members[1] in e.get("message", "") for e in client.list("v1", "Event", NS)))
                feed["event"] = side.maint.EVENT_NONE
                handler.reconcile_once()
                out.append(wait(lambda: set(labels()) == {"true"}))
                out.append(bool(client.get("v1", "Node", members[1]).get("spec", {}).get("unschedulable")))
            return out
        finally:
            server.stop()

    ref, port = (script(side) for side in WIRE.values())
    assert ref == port == [True, True, True, True, True, False]


def test_handler_main_needs_a_node_name(monkeypatch):
    """``gpu-maintenance-handler`` without ``--node-name`` or ``NODE_NAME``
    exits 1 on both sides before it reaches the API server."""
    monkeypatch.delenv("NODE_NAME", raising=False)
    assert ref_maint.main([]) == maint.main([]) == 1
