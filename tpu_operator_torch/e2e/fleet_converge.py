"""Fleet time-to-Ready: converge an N-node GPU pool against the KubeSim
apiserver with the whole Manager runtime (watch-fed queue, both
reconcilers) and a per-node kubelet, and print one JSON line
``{"ok": ..., "nodes": N, "time_to_ready_s": ...}``.

The port's copy of ``tests/scripts/fleet_converge.py``, with its flags,
its defaults and its output keys. Its modes:

* plain convergence, then five steady passes against the warm cache
  (``apiserver_requests_per_reconcile`` must stay at most 2) and five
  traced ones (``trace_overhead_pct``);
* ``--pods``: unrelated non-GPU pods seeded first, which the scoped Pod
  informer must not mirror (``pod_informer_objects``);
* ``--alloc-churn``: the scheduling-churn engine (``schedsim``) beside
  the convergence;
* ``--join-storm``, ``--preempt-pct``, ``--rollout`` and
  ``--churn-storm``/``--churn-rounds``: an autoscale wave, a
  spot-preemption wave, a staged driver roll and a chip-health storm
  (delta router against a full pass per event), in that order;
* ``--trace-out``: the run's spans as Chrome trace-event JSON;
* ``--warm-restart``: a second operator started from the warm journal,
  whose first pass must write nothing and list nothing;
* ``--replicas``/``--shards``/``--kill-leader``: N sharded replicas as
  processes (``python -m tpu_operator_torch.e2e.shard_replica``) and a
  journal-seeded failover of the shard-0 leader.

What names the card comes from the port's tables: the driver's sub-spec
is ``spec.driver`` (the rename table in ``api/v1/clusterpolicy_types.py``),
the validator's pods carry ``consts.VALIDATOR_APP``, a roll is read on
``consts.DRIVER_VERSION_LABEL``, and a host's capacity is
``consts.GPU_RESOURCE`` with ``kube.testing.HOST_CARDS`` cards. Internal
names (``TPU_PRESENT_LABEL``, the ``/debug/vars`` keys) stay the
reference's. Each replica's stderr goes to a file in the run's temporary
directory; a replica that exits on its own fails the run at once, and
the line then carries ``replica_failures`` with each one's exit code and
stderr tail. Every child is killed before the driver returns.

Run: ``python -m tpu_operator_torch.e2e.fleet_converge --nodes 16
[--warm-restart] ...``. ``OPERATOR_NAMESPACE`` defaults to the
operator's namespace, ``UNIT_TEST`` to ``true`` and
``WRITE_PIPELINE_DEPTH`` to 4. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1.clusterpolicy_types import KEY_RENAMES
from tpu_operator_torch.kube.client import ConflictError, NotFoundError
from tpu_operator_torch.kube.kubesim import KubeSim, KubeSimServer, make_client
from tpu_operator_torch.kube.rest import TransientAPIError
from tpu_operator_torch.kube.testing import (
    DEFAULT_DRIVER_VERSION,
    HOST_CARDS,
    seed_cluster,
    simulate_kubelet_nodes,
)

CPV = consts.API_VERSION
# the driver's sub-spec (the reference's ``libtpu``)
DRIVER_SPEC = KEY_RENAMES[("spec", "libtpu")]
# what a replica runs: the package's module, never a file path
REPLICA_MODULE = "tpu_operator_torch.e2e.shard_replica"
# bytes of a dead replica's stderr the line carries
STDERR_TAIL_BYTES = 2000
# --rollout converges at a pinned base version, then rolls the fleet to
# the target. The reference pins 1.0.0 over TPU nodes that carry no
# version label until the simulated kubelet writes one, so its first
# pass stages no roll. A GPU node reports its driver from the start
# (``kube.testing.DEFAULT_DRIVER_VERSION``), so the base is that one, as
# ``chaos.soak`` pins its CR: any other would make the first pass a
# fleet-wide roll whose canary can be rolled back before its validator
# runs.
ROLLOUT_BASE_VERSION = DEFAULT_DRIVER_VERSION
ROLLOUT_TARGET_VERSION = "2.0.0"


def stage_rollout_spec(cp: dict) -> None:
    """``--rollout``'s ClusterPolicy edit before the operator starts: the
    base version, an automatic upgrade policy and a staged roll (canary
    1, one 10% wave, then the fleet) with a 1 s observation window: the
    axis measures the roll machinery, not the soak clock."""
    cp["spec"][DRIVER_SPEC]["version"] = ROLLOUT_BASE_VERSION
    cp["spec"][DRIVER_SPEC]["upgradePolicy"] = {
        "autoUpgrade": True,
        "maxParallelUpgrades": 256,
        "maxUnavailable": "25%",
    }
    cp["spec"]["rollout"] = {
        "enabled": True,
        "canary": 1,
        "waves": ["10%"],
        "observeSeconds": 1,
    }


def _peak_rss_mib() -> float:
    import resource

    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)


def _seed_bulk_pods(client, count: int, namespaces: int) -> None:
    """Populated-cluster variant: ``count`` unrelated (non-GPU) pods
    spread over ``namespaces`` user namespaces, the memory trap for a
    cluster-wide Pod informer."""
    from concurrent.futures import ThreadPoolExecutor

    for i in range(namespaces):
        client.create(
            {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": f"bulk-ns-{i}"}}
        )

    def mk(i):
        body = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"bulk-{i}",
                "namespace": f"bulk-ns-{i % namespaces}",
                "labels": {"app": f"web-{i % 50}"},
            },
            "spec": {
                "nodeName": f"bulk-node-{i % 64}",
                "containers": [
                    {
                        "name": "c",
                        "image": "nginx",
                        "resources": {"requests": {"cpu": "100m", "memory": "128Mi"}},
                    }
                ],
            },
            "status": {"phase": "Running"},
        }
        # tens of thousands of concurrent creates can reset an accept
        # queue connection; the seeding is scaffolding, so retry briefly.
        # A 409 after a reset means the interrupted create committed
        # server-side: that is success, not an error.
        for attempt in range(5):
            try:
                client.create(body)
                return
            except ConflictError:
                return
            except (OSError, TransientAPIError):
                time.sleep(0.05 * (attempt + 1))
        try:
            client.create(body)
        except ConflictError:
            pass

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(mk, range(count)))


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _debug_vars(probe_port: int, timeout: float = 3.0):
    import urllib.request

    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{probe_port}/debug/vars", timeout=timeout
        ) as r:
            return json.loads(r.read())
    except Exception:
        return None


def replica_command(
    port: int, shards: int, max_shards: int, probe: int, warm_path: str, identity: str
) -> list:
    """The argv of one replica: this interpreter running ``REPLICA_MODULE``."""
    return [
        sys.executable, "-m", REPLICA_MODULE,
        "--port", str(port),
        "--shards", str(shards),
        "--max-shards", str(max_shards),
        "--lease-s", "3",
        "--probe-port", str(probe),
        "--warm-state", warm_path,
        "--identity", identity,
    ]


def _stderr_tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - STDERR_TAIL_BYTES))
            return f.read().decode("utf-8", "replace")
    except OSError as e:
        return f"<stderr unreadable: {e}>"


def _run_replicated(args, ns: str) -> int:
    """Sharded scale-out: N operator replicas as processes over one
    KubeSim, consistent-hash sharded with per-shard Leases. Prints one
    JSON line (time_to_ready_s, per-shard event balance, the failover
    block) and exits 0 on a clean run."""
    import signal
    import subprocess

    replicas = max(1, args.replicas)
    shards = args.shards if args.shards > 0 else max(2, 2 * replicas)
    max_shards = -(-shards // replicas)  # ceil: balanced greedy split
    nodes = [f"fleet-{i}" for i in range(args.nodes)]
    run_dir = tempfile.mkdtemp(prefix="shard-run-")
    warm_path = os.path.join(run_dir, "warm.json")
    server = KubeSimServer(KubeSim(compact_keep=65536)).start()
    procs = []
    stderr_paths = []
    killed = set()  # replicas this driver killed on purpose
    dead = []  # replicas that exited on their own
    halt = threading.Event()
    try:
        client = make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05
        seed_cluster(client, ns, node_names=())
        server.sim.add_nodes(len(nodes), names=nodes)

        probes = []
        t0 = time.monotonic()
        for i in range(replicas):
            probe = _free_port()
            probes.append(probe)
            stderr_paths.append(os.path.join(run_dir, f"replica-{i}.stderr"))
            with open(stderr_paths[i], "wb") as err:
                procs.append(
                    subprocess.Popen(
                        replica_command(
                            server.port, shards, max_shards, probe, warm_path, f"replica-{i}"
                        ),
                        stdout=subprocess.DEVNULL,
                        stderr=err,
                    )
                )

        def died():
            return [
                i for i, proc in enumerate(procs)
                if i not in killed and proc.poll() is not None
            ]

        def kubelet():
            idle_sleep = 0.05

            def writes_now():
                return sum(
                    server.sim.request_counts.get(v, 0) for v in ("POST", "PUT", "APPLY")
                )

            while not halt.is_set():
                before = writes_now()
                t_sweep = time.monotonic()
                try:
                    simulate_kubelet_nodes(client, ns, nodes, halt_event=halt)
                except (ConflictError, NotFoundError, TransientAPIError, OSError):
                    pass
                sweep_s = time.monotonic() - t_sweep
                idle_sleep = (
                    0.05
                    if writes_now() > before
                    else min(max(idle_sleep * 2, 2.0 * sweep_s), 5.0)
                )
                halt.wait(idle_sleep)

        kubelet_thread = threading.Thread(target=kubelet, daemon=True)
        kubelet_thread.start()

        def cp_ready():
            cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
            return cp.get("status", {}).get("state") == "ready"

        ok = False
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline and not died():
            if cp_ready():
                ok = True
                break
            time.sleep(0.2)
        elapsed = time.monotonic() - t0

        def shard_views():
            out = {}
            for i, probe in enumerate(probes):
                if procs[i].poll() is not None:
                    continue
                payload = _debug_vars(probe)
                if payload and isinstance(payload.get("shards"), dict):
                    out[i] = payload["shards"]
            return out

        views = shard_views()
        routed = {}
        for view in views.values():
            for shard, n in (view.get("events_routed") or {}).items():
                routed[shard] = routed.get(shard, 0) + n
        balance = None
        if routed and min(routed.values()) > 0:
            balance = round(max(routed.values()) / min(routed.values()), 2)
        dropped = sum(v.get("events_dropped_total", 0) for v in views.values())
        owners = {i: v.get("owned", []) for i, v in views.items()}
        leader = next((i for i, v in views.items() if v.get("owns_full_pass")), None)

        # -- leader-kill failover ----------------------------------------
        failover = None
        if args.kill_leader and (leader is None or replicas < 2):
            # requested but cannot run (no shard-0 owner seen, or nothing
            # to fail over to): a failed run, not a skipped assertion
            ok = False
            failover = {
                "error": "kill-leader requested but no leader identified"
                if leader is None
                else "kill-leader needs >= 2 replicas"
            }
        if ok and args.kill_leader and leader is not None and replicas > 1:
            # let the leader publish a fresh post-READY journal first
            time.sleep(3.0)
            writes_before = server.sim.writes_total(exclude_plurals=("leases",))
            killed.add(leader)
            procs[leader].send_signal(signal.SIGKILL)
            procs[leader].wait()
            t_kill = time.monotonic()
            new_owner = None
            deadline_f = time.monotonic() + args.timeout
            while time.monotonic() < deadline_f and not died():
                views = shard_views()
                new_owner = next(
                    (i for i, v in views.items() if i != leader and v.get("owns_full_pass")),
                    None,
                )
                if new_owner is not None:
                    break
                time.sleep(0.2)
            steady_s = None
            if new_owner is not None:
                # zero-write steady state: no write verbs over a 2 s window
                # and the CR ready, the journal-seeded takeover complete.
                # Lease renewals are the shard control plane's heartbeat
                # (one PUT per owned shard per renew interval, forever) and
                # are excluded: they are not convergence work
                def writes_total():
                    return server.sim.writes_total(exclude_plurals=("leases",))

                last = writes_total()
                quiet_since = time.monotonic()
                while time.monotonic() < deadline_f and not died():
                    time.sleep(0.25)
                    now_w = writes_total()
                    if now_w != last:
                        last = now_w
                        quiet_since = time.monotonic()
                        continue
                    if time.monotonic() - quiet_since >= 2.0 and cp_ready():
                        steady_s = round(time.monotonic() - t_kill - 2.0, 2)
                        break
            view = shard_views().get(new_owner) if new_owner is not None else None
            failover = {
                "killed_leader": leader,
                "new_owner": new_owner,
                "time_to_steady_s": steady_s,
                "failover_stats": (view or {}).get("failover"),
                "writes_during_failover": server.sim.writes_total(exclude_plurals=("leases",))
                - writes_before,
            }
            ok = ok and steady_s is not None and steady_s <= 15.0
            # the cold re-list path must be unused: journal-seeded adoption
            fo = (view or {}).get("failover") or {}
            failover["journal_seeded"] = bool(fo.get("seeded_from_journal"))
            failover["relists"] = fo.get("relists", 0)
            ok = ok and failover["journal_seeded"] and not failover["relists"]

        dead = died()
        halt.set()
        kubelet_thread.join(timeout=60)
        converge_requests = server.sim.requests_total()
    finally:
        halt.set()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        server.stop()
        failures = {
            str(i): {"rc": procs[i].returncode, "stderr_tail": _stderr_tail(stderr_paths[i])}
            for i in dead
        }
        shutil.rmtree(run_dir, ignore_errors=True)

    out = {
        "ok": ok and not failures,
        "nodes": args.nodes,
        "replicas": replicas,
        "shards": shards,
        "time_to_ready_s": round(elapsed, 2),
        "converge_requests": converge_requests,
        "shard_events_routed": dict(sorted(routed.items())),
        "shard_balance": balance,
        "shard_events_dropped": dropped,
        "owners": owners,
        "leader": leader,
    }
    if failover is not None:
        out["failover"] = failover
    if failures:
        out["replica_failures"] = failures
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser("fleet-converge")
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument(
        "--pods",
        type=int,
        default=0,
        help="unrelated non-GPU pods to pre-seed (populated-cluster variant)",
    )
    p.add_argument("--pod-namespaces", type=int, default=8)
    p.add_argument(
        "--alloc-churn",
        action="store_true",
        help="run the scheduling-churn engine (tpu_operator_torch/schedsim) "
        "concurrently: short-lived GPU pods through the real "
        "device-plugin path while the fleet converges; allocation "
        "stats join the output line",
    )
    p.add_argument("--alloc-rate", type=float, default=1200.0)
    p.add_argument("--alloc-workers", type=int, default=6)
    p.add_argument("--alloc-gang-frac", type=float, default=0.15)
    p.add_argument(
        "--join-storm",
        type=int,
        default=0,
        help="after the initial fleet converges, join N more nodes in "
        "one autoscale wave and report join_time_to_ready_s (labeling, "
        "validation and slice formation must pipeline, not serialize)",
    )
    p.add_argument(
        "--preempt-pct",
        type=float,
        default=0.0,
        help="after convergence (and any join storm), delete this "
        "percentage of the fleet in one spot-preemption wave and report "
        "preempt_recover_s (orphaned state must reconcile)",
    )
    p.add_argument(
        "--rollout",
        action="store_true",
        help="after convergence, stage a clean health-gated driver "
        "version roll (canary -> wave -> fleet, spec.rollout) through "
        "the upgrade FSM and report rollout_time_s / rollout_stages, "
        "the fleet-wide staged-roll completion axis",
    )
    p.add_argument(
        "--churn-storm",
        type=int,
        default=0,
        help="after convergence, flap this many nodes' cards (kubelet "
        "health edges -> watch events) twice each mode: once through "
        "the event-scoped delta router and once with the router "
        "disabled (full pass per trigger), a same-box A/B of per-event "
        "reconcile cost; churn_speedup reports delta's advantage",
    )
    p.add_argument(
        "--churn-rounds",
        type=int,
        default=2,
        help="storm rounds per mode; per-event cost is min-of-rounds",
    )
    p.add_argument(
        "--trace-out",
        default=None,
        help="enable reconcile tracing (tpu_operator_torch/obs/trace.py) for "
        "the whole run and write the span buffer as Chrome trace-event "
        "JSON (Perfetto-loadable) to this path; trace_overhead_pct is "
        "measured and reported either way",
    )
    p.add_argument(
        "--replicas",
        type=int,
        default=0,
        help="sharded scale-out: run the operator as N replica processes "
        "(python -m tpu_operator_torch.e2e.shard_replica) against "
        "this kubesim, sharded over --shards consistent-hash shards "
        "with per-shard leases; reports per-shard event balance and "
        "(with --kill-leader) journal-seeded failover time",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=0,
        help="shard count for --replicas (default: 2x replicas)",
    )
    p.add_argument(
        "--kill-leader",
        action="store_true",
        help="(with --replicas) SIGKILL the shard-0 leader after "
        "convergence and measure time back to an owned, zero-write "
        "steady state (journal-seeded: the survivor must adopt from "
        "the shared warm journal, not re-list the world)",
    )
    p.add_argument(
        "--warm-restart",
        action="store_true",
        help="after the steady-state measurement, restart the operator "
        "from the warm journal (kube/warm.py) against the unchanged "
        "world and report warm_start_ms / warm_first_pass_writes / "
        "warm_relists; the first warm pass must be zero-write and "
        "zero-list",
    )
    args = p.parse_args(argv)
    ns = os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    os.environ.setdefault("UNIT_TEST", "true")
    # the KubeSim apiserver lives in this interpreter: depth 4 overlaps the
    # wire without the GIL convoy a 16-deep fan-out costs against a
    # same-process server (production keeps 16)
    os.environ.setdefault("WRITE_PIPELINE_DEPTH", "4")

    if args.replicas > 0:
        return _run_replicated(args, ns)

    from tpu_operator_torch.main import build_manager, wire_event_sources
    from tpu_operator_torch.obs import trace as trace_mod

    # a list, not a tuple: the join storm grows it mid-run and the
    # kubelet sweep reads the latest membership each pass
    nodes = [f"fleet-{i}" for i in range(args.nodes)]
    # event-log retention sized for fleet scale: real etcd keeps minutes
    # of history, so a watch stream that is a burst behind the head can
    # still resume; the unit-test default (512) would compact a single
    # fleet-wide label wave away mid-flight and force spurious 410 re-lists
    server = KubeSimServer(KubeSim(compact_keep=16384)).start()
    warm_dir = tempfile.mkdtemp(prefix="fleet-warm-") if args.warm_restart else None
    halt = threading.Event()
    stop = threading.Event()
    mgr = engine = None
    try:
        client = make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05
        # seed the namespace/CRD/CR over the wire, but materialize the fleet
        # in-process (kubesim add_nodes, the same admission path): the run
        # measures the operator converging an existing fleet
        seed_cluster(client, ns, node_names=())
        server.sim.add_nodes(len(nodes), names=nodes)
        if args.pods:
            _seed_bulk_pods(client, args.pods, args.pod_namespaces)
        if args.rollout:
            # the staged-roll axis: converge at the base version, then flip
            # the fleet target and measure canary->wave->fleet completion
            from tpu_operator_torch.kube.testing import edit_clusterpolicy

            edit_clusterpolicy(client, stage_rollout_spec)

        warm_path = os.path.join(warm_dir, "warm.json") if warm_dir else None

        if args.trace_out:
            trace_mod.enable()

        t0 = time.monotonic()
        mgr, reconciler, _ = build_manager(
            client, ns, metrics_port=0, probe_port=0, warm_state=warm_path
        )
        wire_event_sources(mgr, client, ns, stop_event=stop)
        mgr.start()

        def kubelet():
            # adaptive cadence: while the cluster is still materializing
            # (sweeps write) re-sweep at once; once a sweep changes nothing,
            # back off: a full-fleet no-op sweep LISTs thousands of pods, and
            # doing that 10×/s steals the shared interpreter from the
            # operator whose convergence this run measures
            idle_sleep = 0.05

            def writes_now():
                # pod creates ride the batched APPLY verb: POST/PUT alone
                # would read a pod-creating sweep as idle
                return sum(server.sim.request_counts.get(v, 0) for v in ("POST", "PUT", "APPLY"))

            while not halt.is_set():
                before = writes_now()
                t_sweep = time.monotonic()
                try:
                    simulate_kubelet_nodes(client, ns, nodes, halt_event=halt)
                except (ConflictError, NotFoundError, TransientAPIError, OSError):
                    pass
                sweep_s = time.monotonic() - t_sweep
                wrote = writes_now() > before
                # idle cadence proportional to sweep cost: pacing at 2× the
                # measured sweep caps the kubelet's idle CPU share at ~33%
                # whatever the fleet size
                idle_sleep = 0.05 if wrote else min(max(idle_sleep * 2, 2.0 * sweep_s), 5.0)
                halt.wait(idle_sleep)

        kubelet_thread = threading.Thread(target=kubelet, daemon=True)
        kubelet_thread.start()
        mgr.enqueue("clusterpolicy")

        # optional foreground allocation traffic (its own client: churn must
        # not share the operator's connection pool or circuit breaker)
        if args.alloc_churn:
            from tpu_operator_torch.schedsim.engine import ChurnEngine

            churn_client = make_client(server.port)
            churn_client.GET_RETRY_BACKOFF_S = 0.05
            engine = ChurnEngine(
                churn_client,
                nodes,
                workers=args.alloc_workers,
                rate_per_min=args.alloc_rate,
                gang_fraction=args.alloc_gang_frac,
                seed=11,
            )
            mgr.register_debug_vars("allocation", engine.stats)
            engine.wire_lifecycle(server.sim)
            engine.start()

        ok = False
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
            if cp.get("status", {}).get("state") == "ready":
                ok = True
                break
            time.sleep(0.1)
        elapsed = time.monotonic() - t0

        def _labels_by_name():
            # one node LIST per poll: a per-node GET loop at join-storm scale
            # would drown converge_requests in harness noise
            return {
                n["metadata"]["name"]: (n["metadata"].get("labels") or {})
                for n in client.list("v1", "Node")
            }

        # -- optional lifecycle axes (join storm, preemption wave) ---------
        join_time_to_ready = None
        join_phases = None
        if ok and args.join_storm > 0:
            t_join = time.monotonic()
            joined = server.sim.add_nodes(args.join_storm, name_prefix="storm", chips=HOST_CARDS)
            nodes.extend(joined)
            deadline_j = time.monotonic() + args.timeout

            # per-node convergence timeline: first-seen time of each phase
            # (join -> labeled -> validated -> slice-Ready) sampled once per
            # poll; the percentiles name where a slow join storm spends its
            # time (labeling vs validation vs slice math)
            phase_seen = {"labeled": {}, "validated": {}, "slice_ready": {}}

            def _validator_nodes():
                out = set()
                try:
                    pods = client.list(
                        "v1", "Pod", ns, label_selector={"app": consts.VALIDATOR_APP}
                    )
                except Exception:
                    return out
                for pod in pods:
                    if pod.get("status", {}).get("phase") != "Running":
                        continue
                    node = pod.get("spec", {}).get("nodeName")
                    if node:
                        out.add(node)
                return out

            def _sample_phases(now):
                labels = _labels_by_name()
                validated = _validator_nodes()
                for n in joined:
                    lab = labels.get(n, {})
                    if n not in phase_seen["labeled"] and lab.get(consts.TPU_PRESENT_LABEL) == "true":
                        phase_seen["labeled"][n] = now
                    if n not in phase_seen["validated"] and n in validated:
                        phase_seen["validated"][n] = now
                    if (
                        n not in phase_seen["slice_ready"]
                        and lab.get(consts.SLICE_READY_LABEL) == "true"
                    ):
                        phase_seen["slice_ready"][n] = now
                return labels

            def join_ready(labels):
                cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
                if cp.get("status", {}).get("state") != "ready":
                    return False
                # every joined node labeled, validated and slice-ready: the
                # whole label/validate/slice-form pipeline completed
                return all(
                    labels.get(n, {}).get(consts.SLICE_READY_LABEL) == "true" for n in joined
                )

            while time.monotonic() < deadline_j:
                labels_now = _sample_phases(time.monotonic())
                if join_ready(labels_now):
                    join_time_to_ready = round(time.monotonic() - t_join, 2)
                    break
                time.sleep(0.2)
            ok = ok and join_time_to_ready is not None

            def _pct(values, p):
                if not values:
                    return None
                ordered = sorted(values)
                idx = min(len(ordered) - 1, max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
                return round(ordered[idx], 2)

            join_phases = {}
            for phase, seen in phase_seen.items():
                lat = [t - t_join for t in seen.values()]
                join_phases[phase] = {
                    "nodes": len(lat),
                    "p50_s": _pct(lat, 50),
                    "p99_s": _pct(lat, 99),
                }

        preempt_recover = None
        if ok and args.preempt_pct > 0:
            import random as _random

            t_pre = time.monotonic()
            victims = server.sim.preemption_wave(args.preempt_pct / 100.0, rng=_random.Random(4242))
            for v in victims:
                try:
                    nodes.remove(v)
                except ValueError:
                    pass
            deadline_p = time.monotonic() + args.timeout

            def recovered():
                cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
                status = cp.get("status", {})
                if status.get("state") != "ready":
                    return False
                # the status aggregate reflects the shrunken fleet and every
                # survivor is back to slice-ready (orphaned state reconciled)
                if status.get("slices", {}).get("total") != len(nodes):
                    return False
                labels = _labels_by_name()
                return all(labels.get(n, {}).get(consts.SLICE_READY_LABEL) == "true" for n in nodes)

            while time.monotonic() < deadline_p:
                if recovered():
                    preempt_recover = round(time.monotonic() - t_pre, 2)
                    break
                time.sleep(0.2)
            ok = ok and preempt_recover is not None

        # -- staged roll (health-gated rollout): flip the fleet target and
        # drive the canary->wave->fleet roll to complete
        rollout_time = None
        rollout_stages = None
        if ok and args.rollout:
            from tpu_operator_torch.controllers.rollout import STATE_COMPLETE, load_record
            from tpu_operator_torch.kube.testing import edit_clusterpolicy
            from tpu_operator_torch.main import UPGRADE_KEY

            t_roll = time.monotonic()
            edit_clusterpolicy(
                client, lambda cp: cp["spec"][DRIVER_SPEC].update(version=ROLLOUT_TARGET_VERSION)
            )
            pump_halt = threading.Event()

            def upgrade_pump():
                while not pump_halt.is_set():
                    mgr.enqueue(UPGRADE_KEY)
                    pump_halt.wait(0.3)

            threading.Thread(target=upgrade_pump, daemon=True).start()
            deadline_r = time.monotonic() + args.timeout
            while time.monotonic() < deadline_r:
                cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
                rec_roll = load_record(cp)
                if rec_roll and rec_roll.get("state") == STATE_COMPLETE:
                    labels = _labels_by_name()
                    if all(
                        labels.get(n, {}).get(consts.DRIVER_VERSION_LABEL) == ROLLOUT_TARGET_VERSION
                        for n in nodes
                    ):
                        rollout_time = round(time.monotonic() - t_roll, 2)
                        rollout_stages = reconciler.rollout.stats()["promotions_total"] + 1
                        break
                time.sleep(0.25)
            pump_halt.set()
            ok = ok and rollout_time is not None

        # -- churn storm: N nodes' card health flapping -> per-event
        # reconcile cost, delta router vs full pass per trigger on the same
        # box. Cost is reconcile self time (the delta sub-reconciles'
        # cumulative wall + full passes' cumulative wall) over the storm's
        # state transitions, min-of-rounds per mode.
        churn = None
        churn_ok = True
        if ok and args.churn_storm > 0:
            victims = nodes[: min(args.churn_storm, len(nodes))]
            orig_chips = {}
            for v in victims:
                node = client.get_or_none("v1", "Node", v) or {}
                try:
                    orig_chips[v] = int(
                        (node.get("status", {}).get("capacity") or {}).get(
                            consts.GPU_RESOURCE, str(HOST_CARDS)
                        )
                    )
                except (TypeError, ValueError):
                    orig_chips[v] = HOST_CARDS

            def _slice_verdict(victim):
                node = client.get_or_none("v1", "Node", victim) or {}
                return (node.get("metadata", {}).get("labels") or {}).get(consts.SLICE_READY_LABEL)

            def _wait_verdict(victim, want, timeout=30.0):
                deadline_v = time.monotonic() + timeout
                while time.monotonic() < deadline_v:
                    if _slice_verdict(victim) == want:
                        return True
                    time.sleep(0.005)
                return False

            def _storm_round():
                delta0 = reconciler.delta.stats()
                full_ms0 = reconciler.full_ms_total
                passes0 = reconciler.passes_total
                events = 0
                round_ok = True
                t0_round = time.monotonic()
                for v in victims:
                    server.sim.kill_node_chips(v)
                    round_ok = _wait_verdict(v, "false") and round_ok
                    server.sim.restore_node_chips(v, orig_chips[v])
                    round_ok = _wait_verdict(v, "true") and round_ok
                    events += 2
                delta1 = reconciler.delta.stats()
                spent_ms = (
                    delta1["delta_ms_total"] - delta0["delta_ms_total"]
                    + reconciler.full_ms_total - full_ms0
                )
                return {
                    "ok": round_ok,
                    "events": events,
                    "wall_s": round(time.monotonic() - t0_round, 2),
                    "reconcile_ms": round(spent_ms, 1),
                    "per_event_ms": round(spent_ms / max(1, events), 3),
                    "delta_passes": delta1["delta_passes"] - delta0["delta_passes"],
                    "full_passes": reconciler.passes_total - passes0,
                }

            def _quiesce(timeout=90.0):
                # drain the workqueue (convergence-tail events, the other
                # mode's stragglers) so a round measures only its own storm
                deadline_q = time.monotonic() + timeout
                while time.monotonic() < deadline_q:
                    # busy_len is the queue's own processing set: unlike the
                    # watchdog bracket it cannot report idle between a
                    # worker's get() and its in-flight bookkeeping
                    if mgr.queue.due_len() == 0 and mgr.queue.busy_len() == 0:
                        return True
                    time.sleep(0.05)
                return False

            def _storm(mode_enabled):
                mgr.router.enabled = mode_enabled
                rounds_out = []
                for _ in range(max(1, args.churn_rounds)):
                    # a round that never drained is contaminated by the
                    # previous mode's stragglers: flag it instead of letting
                    # it skew the A/B as if it measured cleanly
                    drained = _quiesce()
                    result = _storm_round()
                    result["ok"] = result["ok"] and drained
                    rounds_out.append(result)
                return rounds_out

            # delta mode first (the shipped default), then the baseline:
            # router off routes every event to the full-pass barrier key
            was_enabled = mgr.router.enabled
            delta_rounds = _storm(True)
            baseline_rounds = _storm(False)
            mgr.router.enabled = was_enabled
            delta_cost = min(r["per_event_ms"] for r in delta_rounds)
            baseline_cost = min(r["per_event_ms"] for r in baseline_rounds)
            churn_ok = all(r["ok"] for r in delta_rounds + baseline_rounds)
            churn = {
                "churn_storm_nodes": len(victims),
                "churn_events_per_round": delta_rounds[0]["events"],
                "churn_delta_per_event_ms": delta_cost,
                "churn_baseline_per_event_ms": baseline_cost,
                "churn_speedup": round(baseline_cost / delta_cost, 1) if delta_cost > 0 else None,
                "churn_delta_rounds": delta_rounds,
                "churn_baseline_rounds": baseline_rounds,
                "churn_delta_stats": reconciler.delta.stats(),
            }
            ok = ok and churn_ok

        converge_requests = server.sim.requests_total()
        # write volume of the same converge: how many mutations it took and
        # what each cost in wall time
        converge_writes = sum(
            server.sim.request_counts.get(verb, 0)
            for verb in ("POST", "PUT", "PATCH", "APPLY", "DELETE")
        )
        converge_wall_per_write_us = (
            round(elapsed * 1e6 / converge_writes, 1) if converge_writes else None
        )
        # pipeline utilization over the converge window (reconcile-side
        # pipeline; the kubelet sim runs its own)
        pipeline_stats = reconciler.ctrl.writes.stats()
        pipeline_utilization = reconciler.ctrl.writes.utilization(elapsed)

        # the churn engine quiesces with the kubelet: its writes must not
        # pollute the per-reconcile steady-state request measurement
        alloc_stats = None
        alloc_ok = True
        if engine is not None:
            engine.stop()
            verdict = engine.drain_check()
            alloc_stats = engine.stats()
            alloc_ok = (
                verdict["chips_held"] == 0
                and verdict["pods_holding"] == 0
                and verdict["double_allocations"] == 0
                and verdict["invariant_violations"] == 0
                and alloc_stats["errors_total"] == 0
            )

        # steady-state apiserver cost: quiesce (stop the manager worker and
        # the kubelet), then pump the reconciler directly against the warm
        # cache; with the informer read path this must be O(1) (≈0)
        # requests a pass whatever the fleet size
        halt.set()
        # the in-flight kubelet sweep aborts mid-pass on halt; joining it
        # keeps its writes out of the per-reconcile request measurement
        kubelet_thread.join(timeout=60)
        mgr.stop()
        time.sleep(0.5)
        before = server.sim.requests_total()
        steady_ok = True
        rounds = 5
        round_ms = []
        # tracing off for the baseline rounds: the overhead comparison below
        # needs an untraced min even when --trace-out traced the convergence
        was_tracing = trace_mod.TRACER.enabled
        trace_mod.disable()
        pass_t0 = time.monotonic()
        for _ in range(rounds):
            t = time.monotonic()
            try:
                steady_ok = reconciler.reconcile().ready and steady_ok
            except Exception:
                steady_ok = False
            round_ms.append((time.monotonic() - t) * 1000.0)
        reconcile_pass_ms = (time.monotonic() - pass_t0) * 1000.0 / rounds
        per_reconcile = (server.sim.requests_total() - before) / rounds
        # tracing-on rounds: the same steady pass, spans live
        trace_mod.enable()
        traced_ms = []
        for _ in range(rounds):
            t = time.monotonic()
            try:
                steady_ok = reconciler.reconcile().ready and steady_ok
            except Exception:
                steady_ok = False
            traced_ms.append((time.monotonic() - t) * 1000.0)
        trace_overhead_pct = (
            round((min(traced_ms) / min(round_ms) - 1.0) * 100.0, 2) if min(round_ms) > 0 else None
        )
        trace_summary = dict(trace_mod.TRACER.last_pass)
        if not was_tracing:
            trace_mod.disable()
        # render-path steady state: the last quiesced pass must serve every
        # manifest from the fingerprint-gated render cache
        render_stats = reconciler.ctrl.render_cache.stats()
        # a cacheless read path would make O(states × nodes) requests here:
        # gate, don't just report
        cache_ok = per_reconcile <= 2

        # informer footprint: how many pods did the operator mirror? (the
        # scoped Pod informer must hold operand and GPU pods only, not the
        # bulk population)
        pod_informer_objects = None
        if hasattr(mgr.client, "_informers"):
            inf = mgr.client._informers.get(("v1", "Pod"))
            if inf is not None and inf.synced.is_set():
                pod_informer_objects = len(inf)

        # -- warm restart: restart the operator against the unchanged world
        # from the journal mgr.stop() just saved; the first pass must
        # re-derive nothing: zero writes, zero re-lists, informers seeded in
        # memory and watches resumed at the journal's rv
        warm = None
        warm_ok = True
        if args.warm_restart:
            # the claim is "unchanged inputs, zero re-derivation", so first
            # let the cold operator settle (a kubelet sweep aborted by the
            # halt can leave trailing drift that a pass or two repairs) and
            # re-save the journal against the settled world. mgr.stop()
            # froze the informer watch threads with whatever events were
            # still on the wire: repair the cache from live LISTs first so
            # the settle passes converge the real world
            resync_fn = getattr(mgr.client, "resync_once", None)
            if callable(resync_fn):
                resync_fn(ignore_stop=True)
            for _ in range(10):
                before_q = server.sim.requests_total()
                try:
                    reconciler.reconcile()
                except Exception:
                    break
                if server.sim.requests_total() == before_q:
                    break
            save_warm = getattr(reconciler, "save_warm_state", None)
            if callable(save_warm):
                save_warm()
            write_verbs = ("POST", "PUT", "PATCH", "APPLY", "DELETE")
            before_w = {v: server.sim.request_counts.get(v, 0) for v in write_verbs}
            before_l = server.sim.request_counts.get("LIST", 0)
            client2 = make_client(server.port)
            client2.GET_RETRY_BACKOFF_S = 0.05
            t_warm = time.monotonic()
            mgr2, rec2, _ = build_manager(client2, ns, metrics_port=0, probe_port=0, warm_state=warm_path)
            stop2 = threading.Event()
            wire_event_sources(mgr2, client2, ns, stop_event=stop2)
            mgr2.start()
            warm_start_ms = None
            try:
                mgr2.enqueue("clusterpolicy")
                deadline_w = time.monotonic() + args.timeout
                while time.monotonic() < deadline_w:
                    if rec2.passes_total >= 1:
                        warm_start_ms = round((time.monotonic() - t_warm) * 1000.0, 1)
                        break
                    time.sleep(0.05)
            finally:
                stop2.set()
                mgr2.stop()
            warm_writes = sum(
                server.sim.request_counts.get(v, 0) - before_w[v] for v in write_verbs
            )
            warm_relists = server.sim.request_counts.get("LIST", 0) - before_l
            warm_stats = getattr(rec2, "warm_stats", {})
            warm = {
                "warm_start_ms": warm_start_ms,
                "warm_seed_ms": warm_stats.get("seed_ms"),
                "warm_loaded": warm_stats.get("loaded", False),
                "warm_informer_kinds": warm_stats.get("seeded", {}).get("informer_kinds", 0),
                "warm_first_pass_writes": warm_writes,
                "warm_relists": warm_relists,
            }
            # the axis's whole claim: unchanged inputs, zero re-derivation
            warm_ok = (
                warm_start_ms is not None
                and bool(warm_stats.get("loaded"))
                and warm_writes == 0
                and warm_relists == 0
            )

        stop.set()
        server.stop()
        batch = reconciler.ctrl.batch_stats()
        all_ok = ok and steady_ok and cache_ok and alloc_ok and warm_ok
        out = {
            "ok": all_ok,
            "nodes": args.nodes,
            "bulk_pods": args.pods,
            "time_to_ready_s": round(elapsed, 2),
            "join_storm_nodes": args.join_storm,
            "join_time_to_ready_s": join_time_to_ready,
            # per-node convergence timeline (join -> labeled -> validated ->
            # slice-Ready), p50/p99 per phase over the joined wave
            "join_phase_latency": join_phases,
            "preempt_pct": args.preempt_pct,
            "preempt_recover_s": preempt_recover,
            # staged roll: wall time for a clean canary->wave->fleet driver
            # roll through the health gate (None when not requested)
            "rollout_time_s": rollout_time,
            "rollout_stages": rollout_stages,
            "converge_requests": converge_requests,
            "converge_writes": converge_writes,
            # the server-side-apply engine's own ledger: how many APPLYs the
            # converge took, how many hit a field-ownership conflict, and how
            # full the batch lanes ran
            "converge_applies": server.sim.request_counts.get("APPLY", 0),
            "apply_conflicts": server.sim.apply_conflicts,
            "batch_fill_avg": batch["fill_avg"],
            "batch_items_total": batch["items_total"],
            "batch_batches_total": batch["batches_total"],
            "applyset_members": reconciler.ctrl.applyset.stats()["members"],
            "converge_wall_per_write_us": converge_wall_per_write_us,
            "write_pipeline_depth": pipeline_stats["depth"],
            "write_pipeline_submitted": pipeline_stats["submitted_total"],
            "write_pipeline_errors": pipeline_stats["errors_total"],
            "write_pipeline_queue_wait_ms_avg": pipeline_stats["queue_wait_ms_avg"],
            "write_pipeline_utilization": pipeline_utilization,
            "apiserver_requests_per_reconcile": per_reconcile,
            "reconcile_pass_ms": round(reconcile_pass_ms, 1),
            # fastest round: the noise-robust comparator (a scheduler hiccup
            # inflates the mean; nothing deflates the min)
            "reconcile_pass_ms_min": round(min(round_ms), 1),
            "render_cache_hit_rate": render_stats["last_pass"]["hit_rate"],
            "render_cache_renders_total": render_stats["renders_total"],
            "render_cache_fingerprint": render_stats["fingerprint"],
            "peak_rss_mib": _peak_rss_mib(),
            "pod_informer_objects": pod_informer_objects,
            # tracing cost on the steady pass (min traced vs min untraced)
            # and the last traced pass's self-time-by-layer breakdown
            "trace_overhead_pct": trace_overhead_pct,
            "trace_summary": trace_summary,
        }
        if args.trace_out:
            try:
                out["trace_spans"] = trace_mod.TRACER.export_chrome(args.trace_out)
                out["trace_out"] = args.trace_out
            except Exception:
                out["trace_out"] = None
        if churn is not None:
            out.update(churn)
            out["churn_ok"] = churn_ok
        if warm is not None:
            out.update(warm)
            out["warm_ok"] = warm_ok
        if alloc_stats is not None:
            out.update(
                {
                    "alloc_total": alloc_stats["allocations_total"],
                    "alloc_per_min": alloc_stats["alloc_per_min"],
                    "alloc_p50_ms": alloc_stats["latency_ms"]["p50_ms"],
                    "alloc_p99_ms": alloc_stats["latency_ms"]["p99_ms"],
                    "alloc_failures": alloc_stats["failures_total"],
                    "alloc_gangs_admitted": alloc_stats["gangs"]["admitted"],
                    "alloc_fragmentation_pct": alloc_stats["fragmentation_pct"],
                    "alloc_invariants_ok": alloc_ok,
                }
            )
        print(json.dumps(out))
        return 0 if all_ok else 1
    finally:
        halt.set()
        stop.set()
        if engine is not None:
            engine.stop()
        if mgr is not None and not mgr._stop.is_set():
            mgr.stop()
        server.stop()
        if warm_dir:
            shutil.rmtree(warm_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
