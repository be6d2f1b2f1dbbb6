"""One sharded operator replica as a process: the cross-process half of
the scale-out run.

The port's copy of ``tests/scripts/shard_replica.py``.
``fleet_converge --replicas N`` starts N of these against its KubeSim
port. Each runs the whole shipped wiring (``build_manager`` +
``wire_event_sources``, per-shard Leases, scoped informers) in its own
interpreter, so the replicas overlap on the CPU instead of convoying on
one GIL. The probe port serves ``/debug/vars`` (the shards block, warm
state, the delta router's disposition) for the parent to scrape.

Where the port differs: the shard variables are the port's
``GPU_SHARDS``, ``GPU_SHARD_MAX`` and ``GPU_SHARD_LEASE_S``
(``shard.py``), and the namespace defaults to the operator's own
(``consts.DEFAULT_NAMESPACE`` under ``OPERATOR_NAMESPACE``, as ``main``
takes it). ``WRITE_PIPELINE_DEPTH``, ``WARM_STATE_SAVE_INTERVAL_S`` and
``RECONCILE_WORKERS`` keep the reference's names.

Run: ``python -m tpu_operator_torch.e2e.shard_replica --port <kubesim>
--shards <n> [--max-shards m] [--lease-s s] [--probe-port p]
[--warm-state path] [--identity name] [--workers w]``. It prints one
JSON line (``replica``, ``probe_port``) once started and runs until
SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser("shard-replica")
    p.add_argument("--port", type=int, required=True, help="kubesim port")
    p.add_argument("--shards", type=int, required=True)
    p.add_argument("--max-shards", type=int, default=0)
    p.add_argument("--lease-s", type=int, default=3)
    p.add_argument("--probe-port", type=int, default=0)
    p.add_argument("--warm-state", default=None)
    p.add_argument("--identity", default=None)
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)

    from tpu_operator_torch import consts

    ns = os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    os.environ.setdefault("UNIT_TEST", "true")
    # the apiserver is another local process: keep the fan-out modest
    os.environ.setdefault("WRITE_PIPELINE_DEPTH", "4")
    os.environ["GPU_SHARDS"] = str(args.shards)
    if args.max_shards > 0:
        os.environ["GPU_SHARD_MAX"] = str(args.max_shards)
    os.environ["GPU_SHARD_LEASE_S"] = str(args.lease_s)
    if args.identity:
        os.environ.setdefault("POD_NAME", args.identity)
    if args.workers > 0:
        os.environ["RECONCILE_WORKERS"] = str(args.workers)
    # aggressive journal cadence: the failover axis needs a fresh
    # journal when the leader is killed mid-run
    os.environ.setdefault("WARM_STATE_SAVE_INTERVAL_S", "2")

    from tpu_operator_torch.kube.kubesim import make_client
    from tpu_operator_torch.main import (
        CP_KEY,
        UPGRADE_KEY,
        build_manager,
        wire_event_sources,
    )

    client = make_client(args.port)
    client.GET_RETRY_BACKOFF_S = 0.05
    mgr, _, _ = build_manager(
        client,
        ns,
        metrics_port=0,
        probe_port=args.probe_port,
        debug_endpoints=bool(args.probe_port),
        warm_state=args.warm_state,
    )
    stop = threading.Event()
    wire_event_sources(mgr, client, ns, stop_event=stop)
    mgr.start()
    mgr.enqueue(CP_KEY)
    mgr.enqueue(UPGRADE_KEY)

    def _stop(*_):
        stop.set()
        mgr.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(
        json.dumps(
            {
                "replica": mgr.shard_state.identity if mgr.shard_state else None,
                "probe_port": args.probe_port,
            }
        ),
        flush=True,
    )
    while not mgr._stop.is_set():
        time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
