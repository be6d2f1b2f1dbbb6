"""Allocation churn: sustained scheduling traffic through the real
device-plugin path at fleet scale, beside convergence and an active
remediation pass.

The port's copy of ``tests/scripts/alloc_churn.py``, with its flags, its
defaults and its output keys. It runs the whole Manager (watch-fed
queue, both reconcilers) against a KubeSim apiserver at ``--nodes``, the
per-node DaemonSet kubelet sweep, and the scheduling-churn engine
(``tpu_operator_torch/schedsim``): short-lived GPU pods at ``--rate`` a
minute routed through GetPreferredAllocation → Allocate on plugin
servicers over synthetic HGX boards (``schedsim.engine.
SyntheticChipServicer``, which never opens a device node), gang
admission for multi-host jobs, NVLink-aware placement and fragmentation
accounting. Once READY, a card-death wave hits ``--victims`` hosts
(KubeSim node injection and plugin-side health flips) so the
remediation FSM runs while churn continues; the hosts then recover and
the fleet must return to READY.

It prints one JSON line. ``ok`` requires initial convergence,
remediation observed active, re-convergence after recovery, a sustained
allocation rate of at least ``--min-rate``, and zero invariant
violations (no double-allocated card, no partially placed gang, no card
held after the drain) with no engine error.

Two of the port's deliberate differences from the reference's engine
show here:

* ``HostAgent.set_health`` flips a host's cards under its admission
  lock, so an admission in flight finishes before the flip and none
  that starts after it sees the old health; the reference flips
  without the lock.
* A gang that a lifecycle eviction hits while its admission is still
  placing members rolls back as a failed gang; the reference places the
  rest and counts a partial-gang violation, which it reports now and
  then under load.

Run: ``python -m tpu_operator_torch.e2e.alloc_churn --nodes 1000``.
``OPERATOR_NAMESPACE`` defaults to the operator's namespace,
``UNIT_TEST`` to ``true`` and ``WRITE_PIPELINE_DEPTH`` to 4. It needs no
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import ConflictError, NotFoundError
from tpu_operator_torch.kube.kubesim import KubeSim, KubeSimServer, make_client
from tpu_operator_torch.kube.rest import TransientAPIError
from tpu_operator_torch.kube.testing import (
    edit_clusterpolicy,
    seed_cluster,
    simulate_kubelet_nodes,
)

CPV = consts.API_VERSION


def _cp_status(client):
    cp = client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}
    return cp.get("status") or {}


def _wait(pred, timeout_s, poll_s=0.2):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll_s)
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser("alloc-churn")
    p.add_argument("--nodes", type=int, default=1000)
    p.add_argument("--rate", type=float, default=1800.0,
                   help="target pod allocations per minute (0 = unlimited)")
    p.add_argument("--min-rate", type=float, default=1000.0,
                   help="sustained allocations/min floor for ok")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--gang-frac", type=float, default=0.15)
    p.add_argument("--gang-hosts", type=int, default=2)
    p.add_argument("--victims", type=int, default=2,
                   help="hosts hit by the mid-run card-death wave")
    p.add_argument("--timeout", type=float, default=420.0,
                   help="per-phase convergence timeout (generous: a "
                   "loaded box converges 1000 nodes under churn far "
                   "slower than a quiet one)")
    p.add_argument("--churn-floor-s", type=float, default=45.0,
                   help="minimum churn window (rate needs a denominator)")
    args = p.parse_args(argv)

    ns = os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    os.environ.setdefault("UNIT_TEST", "true")
    # same rationale as fleet_converge: in-process apiserver, shallow pipeline
    os.environ.setdefault("WRITE_PIPELINE_DEPTH", "4")

    from tpu_operator_torch.main import CP_KEY, build_manager, wire_event_sources
    from tpu_operator_torch.schedsim.engine import ChurnEngine

    nodes = tuple(f"fleet-{i}" for i in range(args.nodes))
    server = KubeSimServer(KubeSim()).start()
    halt = threading.Event()
    stop = threading.Event()
    mgr = engine = None
    try:
        client = make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05
        seed_cluster(client, ns, node_names=nodes)
        edit_clusterpolicy(
            client,
            lambda cp: cp["spec"].update(
                remediation={
                    "enabled": True,
                    "maxAttempts": 3,
                    "backoffSeconds": 0,
                    "maxUnavailable": "50%",
                    "systemicThreshold": "50%",
                }
            ),
        )

        mgr, _, _ = build_manager(client, ns, metrics_port=0, probe_port=0)
        wire_event_sources(mgr, client, ns, stop_event=stop)
        mgr.start()

        def kubelet():
            idle_sleep = 0.05
            while not halt.is_set():
                before = server.sim.request_counts.get("POST", 0) + server.sim.request_counts.get("PUT", 0)
                try:
                    simulate_kubelet_nodes(client, ns, nodes, halt_event=halt)
                except (ConflictError, NotFoundError, TransientAPIError, OSError):
                    pass
                wrote = (
                    server.sim.request_counts.get("POST", 0) + server.sim.request_counts.get("PUT", 0)
                ) > before
                idle_sleep = 0.05 if wrote else min(idle_sleep * 2, 1.0)
                halt.wait(idle_sleep)

        threading.Thread(target=kubelet, daemon=True).start()
        mgr.enqueue(CP_KEY)

        # the churn engine rides its own client (separate connection pool
        # and breaker: allocation traffic must not share fate with the
        # operator)
        churn_client = make_client(server.port)
        churn_client.GET_RETRY_BACKOFF_S = 0.05
        engine = ChurnEngine(
            churn_client,
            nodes,
            workers=args.workers,
            rate_per_min=args.rate,
            gang_fraction=args.gang_frac,
            gang_hosts=args.gang_hosts,
            seed=11,
        )
        mgr.register_debug_vars("allocation", engine.stats)
        t0 = time.monotonic()
        engine.start()

        def ready():
            return _cp_status(client).get("state") == "ready"

        converged_first = _wait(ready, args.timeout)
        time_to_ready_s = round(time.monotonic() - t0, 2)

        # -- remediation wave: cards die on the victims while churn runs
        victims = list(nodes[: max(args.victims, 0)])
        remediation_active = False
        recovered = False
        if victims and converged_first:
            for v in victims:
                server.sim.kill_node_chips(v)
                engine.set_node_health(v, healthy=False)
            remediation_active = _wait(
                lambda: (
                    (_cp_status(client).get("remediation") or {}).get("unhealthy", 0)
                    + (_cp_status(client).get("remediation") or {}).get("quarantined", 0)
                )
                >= 1,
                args.timeout,
            )
            # churn through the active remediation pass
            time.sleep(8.0)
            for v in victims:
                server.sim.restore_node_chips(v)
                engine.set_node_health(v, healthy=True)
            recovered = _wait(
                lambda: ready()
                and (_cp_status(client).get("remediation") or {}).get("quarantined", 0) == 0,
                args.timeout,
            )

        # give the rate a denominator on small boxes / fast converges
        while time.monotonic() - t0 < args.churn_floor_s:
            time.sleep(0.5)

        engine.stop()
        churn_wall_s = round(time.monotonic() - t0, 2)
        verdict = engine.drain_check()
        stats = engine.stats()
    finally:
        halt.set()
        stop.set()
        if engine is not None:
            engine.stop()
        if mgr is not None:
            mgr.stop()
        server.stop()

    rate = stats["alloc_per_min"] or 0.0
    invariants_ok = (
        verdict["chips_held"] == 0
        and verdict["pods_holding"] == 0
        and verdict["double_allocations"] == 0
        and verdict["invariant_violations"] == 0
    )
    ok = (
        converged_first
        and remediation_active
        and recovered
        and invariants_ok
        and rate >= args.min_rate
        and stats["errors_total"] == 0
    )
    print(
        json.dumps(
            {
                "ok": ok,
                "nodes": args.nodes,
                "converged": converged_first,
                "time_to_ready_s": time_to_ready_s,
                "remediation_active": remediation_active,
                "recovered_after_wave": recovered,
                "churn_wall_s": churn_wall_s,
                "alloc_total": stats["allocations_total"],
                "alloc_per_min": rate,
                "alloc_p50_ms": stats["latency_ms"]["p50_ms"],
                "alloc_p99_ms": stats["latency_ms"]["p99_ms"],
                "alloc_failures": stats["failures_total"],
                "alloc_cancelled": stats["cancelled_total"],
                "gangs_admitted": stats["gangs"]["admitted"],
                "gangs_failed": stats["gangs"]["failed"],
                "gang_ready_p50_ms": stats["gangs"]["time_to_ready_ms"]["p50_ms"],
                "gang_ready_p99_ms": stats["gangs"]["time_to_ready_ms"]["p99_ms"],
                "gang_hold_conflicts": stats["coordinator"]["conflicts_total"],
                "fragmentation_pct": stats["fragmentation_pct"],
                "fragmentation_max_pct": stats["fragmentation_max_pct"],
                "double_allocations": verdict["double_allocations"],
                "partial_gang_violations": stats["partial_gang_violations"],
                "invariant_violations": stats["invariant_violations"],
                "chips_leaked": verdict["chips_held"],
                "pods_created": stats["pods_created"],
                "converge_requests": server.sim.requests_total(),
            }
        )
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
