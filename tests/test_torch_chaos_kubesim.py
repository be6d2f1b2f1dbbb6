"""The port under randomized churn over the wire against the JAX package,
on the 1 case of ``tests/test_chaos_kubesim.py``: node pools joining and
leaving, operand DaemonSets and pods deleted behind the operator's back,
spec toggles, driver version bumps under an active rolling upgrade, label
scribbling, dropped watch lines, and a 4-host slice wing (2 members with
real gRPC kubelet rigs on shipped device plugins, plugin kills and card
flips included) while the whole manager runs, crashes halfway and
restarts. The promise: the operator never wedges. When the churn stops it
converges the survivors to READY, finishes every upgrade, its informer
caches agree with a fresh LIST, every slice verdict equals one recomputed
from live state (the storm slice ready again), and ``SliceDegraded`` Events
stay one per slice.

The script runs on both packages (``both``, from
``tests/test_torch_fault_matrix.py``), each on its own KubeSim, with the
churn drawn from ``random.Random(CHAOS_SEED)``, the same seed on both
sides. Thread timing differs between the packages, so the sides see
different interleavings; the outcomes compared are the promise's, each a
boolean. The reference keys a slice's members on its GKE accelerator
label; the port keys them on its GPU product label (``SIDES``'
``card_label``). ``INFORMER_RESYNC_INTERVAL_S`` is set through
``monkeypatch`` so it cannot leak into another test in the worker. The
reference appends its run's statistics to ``PROGRESS.jsonl``; this case
records none. Tolerance: exact equality of the outcomes, each true. Every
wait has a limit of 60 s or more (90 s for a convergence; the settle
budget scales with the fleet as the reference's does), no time is asserted,
and every server, rig, operator and thread stops in a ``finally``.
"""

import itertools
import random
import threading
import time

from tests.test_torch_fault_matrix import NS, both, operator_env, start_server, wait  # noqa: F401
from tests.test_torch_multihost_slice_loop import _devfs, features, no_nvml, node_of, servicer  # noqa: F401

CPV = "tpu.k8s.io/v1"
CHURN_S = 12.0
CHAOS_SEED = 20260730
CHAOS_WATCH_DROPS = 2
SLICE_ID = "storm-slice"
SLICE_MEMBERS = tuple(f"slice-storm-{i}" for i in range(4))
RIG_MEMBERS = SLICE_MEMBERS[:2]
MAX_NODES = 24


def expected_slice_verdicts(side, client):
    """Every slice verdict recomputed from live state (nodes, validator
    pods, allocatable, maintenance): the oracle the labels must meet."""
    c, ss = side.consts, side.slice_status
    live = [n for n in client.list("v1", "Node") if side.card_label in (n["metadata"].get("labels") or {})]
    validated = ss.validator_ready_nodes(client, NS)
    by_name = {n["metadata"]["name"]: n for n in live}
    expected = {}
    for info in ss.group_slices(live).values():
        ready = sum(1 for m in info.member_nodes if m in validated
                    and ss.host_allocatable_ok(by_name[m]) is not False
                    and not (by_name[m]["metadata"].get("labels") or {}).get(c.MAINTENANCE_STATE_LABEL))
        want = info.expected_hosts or len(info.member_nodes)
        verdict = "true" if want > 0 and ready >= want and len(info.member_nodes) >= want else "false"
        for m in info.member_nodes:
            expected[m] = verdict
    return expected


def actual_slice_verdicts(side, client):
    return {n["metadata"]["name"]: (n["metadata"].get("labels") or {}).get(side.consts.SLICE_READY_LABEL)
            for n in client.list("v1", "Node") if side.card_label in (n["metadata"].get("labels") or {})}


def test_chaos_churn_then_converge(monkeypatch, tmp_path):
    monkeypatch.setenv("INFORMER_RESYNC_INTERVAL_S", "5")

    def script(side):
        c = side.consts
        api_errors = (side.kclient.ConflictError, side.kclient.NotFoundError, side.rest.TransientAPIError, OSError)
        tmp = tmp_path / side.name
        server = start_server(side)
        rigs = {}
        halt = threading.Event()
        churn = None
        try:
            client = side.kubesim.make_client(server.port)
            client.GET_RETRY_BACKOFF_S = 0.05
            base = ["chaos-node-0", "chaos-node-1", "chaos-node-2"]
            side.testing.seed_cluster(client, NS, node_names=base)
            member, dev_roots = {}, {}
            for i, name in enumerate(SLICE_MEMBERS):
                client.create(node_of(side, name))
                dev_roots[name] = _devfs(side, tmp / f"dev-{i}")
                member[name] = features(side, client.get("v1", "Node", name), i, dev_roots[name], tmp, SLICE_ID)
                assert side.tfd.apply_features(client, name, member[name])

            def start_plugin(name):
                rig = rigs[name]
                svc = servicer(side, dev_roots[name])
                plugin = side.plugin.DevicePluginServer(svc, socket_dir=rig["socket_dir"])
                plugin.start()
                rig.update(servicer=svc, plugin=plugin)
                plugin.register_with_kubelet(rig["kubelet"].kubelet_socket)

            for i, name in enumerate(RIG_MEMBERS):
                socket_dir = str(tmp / f"kubelet-{i}")
                kubelet = side.kubelet_sim.KubeletDeviceManager(client, name, socket_dir)
                kubelet.start()
                rigs[name] = {"kubelet": kubelet, "socket_dir": socket_dir, "plugin": None}
                start_plugin(name)

            nodes = list(base) + list(SLICE_MEMBERS)
            rng = random.Random(CHAOS_SEED)
            next_node = [len(base)]
            versions = (f"2026.{i}.0" for i in itertools.count(1))
            drops_left = [CHAOS_WATCH_DROPS]

            def mutate_cp(fn):
                for _ in range(10):
                    try:
                        cp = client.get(CPV, "ClusterPolicy", "cluster-policy")
                        fn(cp)
                        client.update(cp)
                        return
                    except api_errors:
                        time.sleep(0.02)

            def add_node():
                if len(nodes) >= MAX_NODES:
                    return
                name = f"chaos-node-{next_node[0]}"
                next_node[0] += 1
                client.create(side.node(name))
                nodes.append(name)

            def del_node():
                candidates = [n for n in nodes if n not in RIG_MEMBERS]
                if len(nodes) <= 1 or not candidates:
                    return
                name = rng.choice(candidates)
                try:
                    client.delete("v1", "Node", name)
                finally:
                    if client.get_or_none("v1", "Node", name) is None and name in nodes:
                        nodes.remove(name)

            def del_random_ds():
                ds = client.list("apps/v1", "DaemonSet", NS)
                if ds:
                    client.delete("apps/v1", "DaemonSet", rng.choice(ds)["metadata"]["name"], NS)

            def del_random_pod():
                pods = client.list("v1", "Pod", NS)
                if pods:
                    client.delete("v1", "Pod", rng.choice(pods)["metadata"]["name"], NS)

            def toggle_exporter():
                mutate_cp(lambda cp: cp["spec"]["metricsExporter"].update(
                    enabled=not cp["spec"]["metricsExporter"].get("enabled", True)))

            def bump_driver():
                v = next(versions)
                mutate_cp(lambda cp: cp["spec"][side.driver_spec].update(version=v))

            def scribble_labels():
                name = rng.choice(nodes)
                node = client.get("v1", "Node", name)
                node["metadata"]["labels"]["chaos.test/touch"] = str(rng.randrange(1 << 30))
                client.update(node)

            def drop_watch_line():
                if drops_left[0] > 0:
                    drops_left[0] -= 1
                    server.sim.inject_watch_drop(rng.choice(["pods", "nodes", "daemonsets", "configmaps"]))

            def readd_slice_member():
                for name in SLICE_MEMBERS:
                    if name not in RIG_MEMBERS and client.get_or_none("v1", "Node", name) is None:
                        client.create(node_of(side, name))
                        side.tfd.apply_features(client, name, member[name])
                        if name not in nodes:
                            nodes.append(name)
                        return

            def scribble_slice_ready():
                name = rng.choice(SLICE_MEMBERS)
                node = client.get_or_none("v1", "Node", name)
                if node is not None:
                    node["metadata"].setdefault("labels", {})[c.SLICE_READY_LABEL] = rng.choice(
                        ["true", "false", "banana"])
                    client.update(node)

            def flip_rig_chips():
                svc = rigs[rng.choice(RIG_MEMBERS)]["servicer"]
                chip = str(rng.randrange(8))
                if rng.random() < 0.5:
                    svc.mark_unhealthy(chip)
                else:
                    svc.mark_healthy(chip)

            def kill_restart_plugin():
                name = rng.choice(RIG_MEMBERS)
                try:
                    rigs[name]["plugin"].stop()
                except Exception:
                    pass
                start_plugin(name)

            actions = [add_node, del_node, del_random_ds, del_random_pod, toggle_exporter, bump_driver,
                       scribble_labels, drop_watch_line, readd_slice_member, scribble_slice_ready, flip_rig_chips,
                       kill_restart_plugin]

            def chaos():
                deadline = time.monotonic() + CHURN_S
                while not halt.is_set() and time.monotonic() < deadline:
                    try:
                        rng.choice(actions)()
                    except api_errors:
                        pass
                    halt.wait(rng.uniform(0.02, 0.15))

            churn = threading.Thread(target=chaos, daemon=True)
            churn.start()
            out = {}
            with side.running_operator(client, NS, nodes):
                mutate_cp(lambda cp: cp["spec"][side.driver_spec].update(upgradePolicy={
                    "autoUpgrade": True, "maxParallelUpgrades": 2, "maxUnavailable": "50%"}))
                time.sleep(CHURN_S / 2)
            # the operator crashes mid-storm; a fresh one picks everything
            # up from the cluster alone
            with side.running_operator(client, NS, nodes) as mgr:
                time.sleep(CHURN_S / 2 + 1.0)
                mutate_cp(lambda cp: cp["spec"]["metricsExporter"].update(enabled=True))
                out["nodes survived"] = bool(nodes)
                for name in SLICE_MEMBERS:
                    if client.get_or_none("v1", "Node", name) is None:
                        client.create(node_of(side, name))
                    try:
                        side.tfd.apply_features(client, name, member[name])
                    except api_errors:
                        pass
                    if name not in nodes:
                        nodes.append(name)
                for name in RIG_MEMBERS:
                    for chip in range(8):
                        rigs[name]["servicer"].mark_healthy(str(chip))
                    try:
                        rigs[name]["plugin"].register_with_kubelet(rigs[name]["kubelet"].kubelet_socket)
                    except Exception:
                        start_plugin(name)

                def settled():
                    cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
                    if cp.get("status", {}).get("state") != "ready":
                        return False
                    for n in client.list("v1", "Node"):
                        if (n["metadata"].get("labels") or {}).get(c.UPGRADE_STATE_LABEL) not in (
                                None, side.us.STATE_DONE):
                            return False
                        if n.get("spec", {}).get("unschedulable", False):
                            return False
                    return True

                out["settled"] = wait(settled, max(180.0, 15.0 * len(nodes)))
                out["healthy"] = mgr.healthy()
                mgr.enqueue("clusterpolicy")
                out["worker alive"] = wait(lambda: mgr._last_reconcile_ok, 60)

                def cache_mismatches():
                    diffs = []
                    for (av, kind), inf in getattr(mgr.client, "_informers", {}).items():
                        if kind == "Event" or not inf.synced.is_set():
                            continue
                        try:
                            live = client.list(av, kind, inf.namespace)
                        except api_errors:
                            continue
                        if inf.keep is not None:
                            live = [o for o in live if inf.keep(o)]

                        def as_map(objs):
                            return {(o["metadata"].get("namespace", ""), o["metadata"]["name"]):
                                    o["metadata"].get("resourceVersion") for o in objs}

                        if as_map(live) != as_map(inf.list()):
                            diffs.append(kind)
                    return diffs

                out["no drift"] = wait(lambda: not cache_mismatches(), 60)

                def verdicts_converged():
                    try:
                        expected = expected_slice_verdicts(side, client)
                        return (expected == actual_slice_verdicts(side, client)
                                and expected.get(SLICE_MEMBERS[0]) == "true")
                    except api_errors:
                        return False

                out["slice verdicts"] = wait(verdicts_converged, 120)
                by_slice = {}
                for e in client.list("v1", "Event", NS):
                    if e.get("reason") == "SliceDegraded":
                        by_slice.setdefault(e.get("message", "").split(" ")[1], []).append(e["metadata"]["name"])
                out["SliceDegraded one per slice"] = all(len(v) == 1 for v in by_slice.values())
            return out
        finally:
            halt.set()
            if churn is not None:
                churn.join(timeout=10)
            for rig in rigs.values():
                for part in ("plugin", "kubelet"):
                    try:
                        rig[part].stop()
                    except Exception:
                        pass
            server.stop()

    out = both(script)
    assert all(out.values()), out
