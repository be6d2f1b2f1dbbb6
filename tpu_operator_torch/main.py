"""Operator process entrypoint (reference ``main.go:60-159``).

The port's copy of ``tpu_operator/main.py``, whole; ``gpu-operator`` and
``python -m tpu_operator_torch.main`` run it. Builds the manager (metrics :8080, probes :8081, optional leader election),
registers the ClusterPolicy and Upgrade reconcilers, wires watch events into
the workqueue, and blocks on signals.

``--fake`` runs against an in-memory API server seeded from the sample CR —
the dev drive path (no cluster required).

What the port decides here (with ``manager.py``'s decisions):

* Internal names stay the reference's: ``build_args``, ``build_manager``,
  ``wire_event_sources``, ``make_kubesim_client``, ``make_fake_client``,
  ``start_grpc_kubelet``, ``main``, the keys ``CP_KEY`` and
  ``UPGRADE_KEY`` and the status key ``("status", "slices")``. The flags
  are the reference's: a reference command line parses unchanged.
* The process's own names are the card's: the program ``gpu-operator``,
  ``GPU_OPERATOR_DEBUG``, ``GPU_OPERATOR_TRACE_OUT``,
  ``consts.WARM_STATE_ENV`` (``GPU_OPERATOR_WARM_STATE``), ``GPU_SHARDS``
  and the ``gpu-operator`` loggers. ``RECONCILE_WORKERS``,
  ``INFORMER_RESYNC_INTERVAL_S``, ``RECONCILE_RESYNC_S`` and ``UNIT_TEST``
  name no accelerator and stay.
* The dev loop's simulated nodes are the card's: ``fake-gpu-node-<i>``,
  built by ``testing.make_gpu_node``; ``start_grpc_kubelet`` stubs a devfs
  of ``nvidia<i>`` files and serves the port's
  ``GPUDevicePluginServicer``.
* PyYAML is imported inside ``make_fake_client``, the one function that
  reads YAML, so the module imports without it.
* ``build_manager`` wires ``DeltaReconciler.wake_full``,
  ``enqueue_slice`` and ``enqueue_status``, and, with ``GPU_SHARDS`` > 1,
  ``shard_state`` on the manager, the reconciler and its controller;
  the reconcilers need no edit for it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.controllers import delta as delta_mod
from tpu_operator_torch.controllers.clusterpolicy_controller import ClusterPolicyReconciler
from tpu_operator_torch.manager import Manager

CP_KEY = "clusterpolicy"
UPGRADE_KEY = "upgrade"


def build_args(argv=None):
    p = argparse.ArgumentParser("gpu-operator")
    p.add_argument("--metrics-port", type=int, default=8080)
    p.add_argument("--probe-port", type=int, default=8081)
    p.add_argument("--leader-election", action="store_true")
    p.add_argument(
        "--debug-endpoints",
        action="store_true",
        default=os.environ.get("GPU_OPERATOR_DEBUG", "") == "true",
        help="expose /debug/stacks and /debug/vars on the probe port",
    )
    p.add_argument("--assets", default=None, help="asset dir override")
    backend = p.add_mutually_exclusive_group()
    backend.add_argument(
        "--fake",
        action="store_true",
        help="run against an in-memory API server seeded with the sample CR",
    )
    backend.add_argument(
        "--kubesim",
        action="store_true",
        help="run against an in-process kubesim HTTP apiserver (CRD "
        "admission, /status subresource, 409s, GC, watches) seeded like "
        "--fake, through the production RestClient",
    )
    p.add_argument(
        "--simulate-kubelet",
        action="store_true",
        help="(with --fake/--kubesim) mark DaemonSets scheduled/available "
        "and run their pods, so the cluster converges to Ready",
    )
    p.add_argument(
        "--grpc-kubelet",
        action="store_true",
        help="(with --kubesim) also run the kubelet device-manager sim + "
        "the real device-plugin gRPC server over a stub devfs, so node "
        "GPU capacity is DERIVED from the plugin's ListAndWatch "
        "advertisement instead of absent",
    )
    p.add_argument(
        "--nodes",
        type=int,
        default=1,
        help="(with --kubesim) how many simulated GPU nodes to seed — the "
        "dev loop at fleet scale",
    )
    p.add_argument(
        "--warm-state",
        default=os.environ.get(consts.WARM_STATE_ENV) or None,
        help="path to the warm-restart journal (kube/warm.py): informer "
        "snapshots + render fingerprint + apply-set persisted across "
        "restarts so an unchanged world converges with zero writes and "
        "no re-list",
    )
    p.add_argument(
        "--trace-out",
        default=os.environ.get("GPU_OPERATOR_TRACE_OUT") or None,
        help="enable reconcile tracing (obs/trace.py) and write the "
        "span buffer as Chrome trace-event JSON (Perfetto-loadable) to "
        "this path on exit",
    )
    p.add_argument("--log-level", default="INFO")
    p.add_argument(
        "--once",
        action="store_true",
        help="run a single reconcile pass of both controllers and exit "
        "(exit 0 when the ClusterPolicy is Ready, 2 otherwise) — for CI "
        "and scripted smoke checks",
    )
    return p.parse_args(argv)


def build_manager(
    client,
    namespace: str,
    metrics_port: int = 8080,
    probe_port: int = 8081,
    leader_election: bool = False,
    debug_endpoints: bool = False,
    assets_dir=None,
    informer_cache: bool = True,
    warm_state=None,
):
    """Manager + both reconcilers, registered exactly as the process runs
    them — shared by main() and the kubesim manager e2e so the tested
    wiring IS the shipped wiring. Returns (manager, cp_reconciler,
    upgrade_reconciler).

    By default the client is wrapped in the watch-fed ``CachedClient``
    (reference: controller-runtime's shared cache, ``main.go:88-108``) so
    every reconcile read is served from informers; ``Manager.start``
    warms it before the first reconcile."""
    from tpu_operator_torch.upgrade.upgrade_controller import UpgradeReconciler

    # sharded horizontal scale-out (shard.py):
    # GPU_SHARDS > 1 runs this replica as one of N cooperating operators
    # — per-shard Leases decide ownership, the event router drops
    # foreign-shard keys, and full-pass work pins to the shard-0 holder.
    # Built BEFORE the cache wrap so the Node/Pod informer mirrors can
    # scope themselves to owned shards (lease reads are live either way:
    # Lease is deliberately never cached).
    from tpu_operator_torch import shard as shard_mod

    shards_n = shard_mod.shards_enabled()
    shard_mgr = None
    keep_overrides = None
    if shards_n > 1:
        shard_mgr = shard_mod.ShardLeaseManager(client, namespace, shards_n)
        keep_overrides = {
            "Node": shard_mgr.keep_node,
            "Pod": shard_mgr.keep_pod,
        }

    if informer_cache and not hasattr(client, "add_event_hook"):
        from tpu_operator_torch.kube.cache import CachedClient

        client = CachedClient(
            client,
            namespace=namespace,
            # drift self-healing cadence (client-go reflector resync);
            # minutes-scale by default, env-tunable like the validator's
            # probe knobs
            resync_interval_s=float(
                os.environ.get("INFORMER_RESYNC_INTERVAL_S", "300")
            ),
            keep_overrides=keep_overrides,
        )

    if leader_election and shard_mgr is not None:
        # the per-shard leases SUBSUME global leader election (the
        # shard-0 lease IS the global-arbiter election): blocking a
        # sharded replica on the legacy single lease would leave its
        # owned shards renewed-but-never-reconciled — held hostage by a
        # replica that never starts its workers
        logging.getLogger("gpu-operator").warning(
            "leader election disabled: GPU_SHARDS>1 elects per shard "
            "(shard 0 is the global-arbiter lease)"
        )
        leader_election = False
    mgr = Manager(
        client,
        namespace,
        metrics_port=metrics_port,
        probe_port=probe_port,
        leader_election=leader_election,
        debug_endpoints=debug_endpoints,
    )
    reconciler = ClusterPolicyReconciler(client, assets_dir=assets_dir)

    # warm-restart journal (kube/warm.py): seed the informer stores, the
    # render cache and the apply-set from the last run's persisted
    # world-state BEFORE informers start — a restarted operator whose
    # inputs are unchanged reaches its first zero-write steady pass
    # without re-LISTing (or re-labeling) the world. Saved after READY
    # passes (rate-limited) and once more on clean shutdown.
    warm_state = (
        warm_state or os.environ.get(consts.WARM_STATE_ENV) or None
    )
    if warm_state:
        from tpu_operator_torch.kube import warm as warm_mod

        warm_journal = warm_mod.WarmJournal(warm_state)
        t0 = time.perf_counter()
        payload = warm_journal.load(namespace)
        seeded = (
            warm_mod.seed_state(client, reconciler, payload)
            if payload
            else {}
        )
        warm_stats = {
            "enabled": True,
            "path": warm_state,
            "loaded": bool(payload),
            "seeded": seeded,
            "seed_ms": round((time.perf_counter() - t0) * 1000.0, 2),
        }
        reconciler.warm_stats = warm_stats
        logging.getLogger("gpu-operator").info(
            "warm state %s: loaded=%s seeded=%s (%.1f ms)",
            warm_state,
            warm_stats["loaded"],
            seeded,
            warm_stats["seed_ms"],
        )

        def _export():
            return warm_mod.export_state(client, reconciler, namespace)

        def _may_save() -> bool:
            # sharded replicas share ONE journal path (the failover
            # seed): only the shard-0 owner holds the whole world, so
            # only it may write — a scoped worker's READY pass would
            # otherwise clobber the full-world snapshot with its
            # shard-scoped mirror, and the next failover would seed the
            # budget arbiter from a world missing most of the fleet
            return shard_mgr is None or shard_mgr.owns_full_pass()

        last_save = [0.0]
        save_every = warm_mod.save_interval_s()
        save_running = threading.Lock()

        def _save_now():
            # the journal may capture a world a few watch events behind
            # live (a busy stop freezes ingestion mid-stream) — that is
            # the design contract: the resume rv replays the gap on the
            # next start. Harnesses that need a bit-coherent snapshot
            # (the warm bench's zero-write claim) repair the frozen
            # cache first via resync_once(ignore_stop=True).
            # every save path holds save_running: a background save
            # caught mid-export by shutdown must not os.replace() its
            # OLDER snapshot over the stop hook's fresh final save
            if not _may_save():
                return
            with save_running:
                if warm_journal.save(_export()):
                    last_save[0] = time.monotonic()

        def _save_async():
            # the export thaws and JSON-encodes the full informer world
            # (fleet-sized — multi-MB at 1000 nodes), so it must not run
            # on the manager's reconcile worker where it would stall
            # every queued key behind pure serialization. One saver at a
            # time; an overlapping tick skips (the next ready pass
            # retries).
            if not _may_save():
                return
            if not save_running.acquire(blocking=False):
                return
            try:
                if warm_journal.save(_export()):
                    last_save[0] = time.monotonic()
            finally:
                save_running.release()

        ready_seen = [False]

        def _cp_reconcile(_key):
            res = reconciler.reconcile()
            if res.ready:
                ready_seen[0] = True
            if (
                res.ready
                and _may_save()
                and time.monotonic() - last_save[0] >= save_every
            ):
                threading.Thread(
                    target=_save_async, name="warm-save", daemon=True
                ).start()
            return res

        # periodic freshness loop: a converged fleet PARKS the CP key
        # (no requeue until the resync), so pass-driven saves alone
        # leave the journal frozen at the last active pass — at fleet
        # scale that misses the convergence tail (the last verdict
        # wave), and a failover seeded from it "corrects" the live
        # world from stale state. This loop keeps the journal within
        # one save interval of the informer world whenever the world
        # actually moved (the store-version key skips no-op exports).
        saver_stop = threading.Event()
        last_world = [None]

        def _periodic_saver():
            while not saver_stop.wait(save_every):
                if not ready_seen[0] or not _may_save():
                    continue
                wv_fn = getattr(client, "world_version", None)
                wv = wv_fn() if callable(wv_fn) else None
                if wv is not None and wv == last_world[0]:
                    continue
                # BLOCKING save on this thread, and the version key is
                # recorded only after the save actually ran: a
                # skip-on-contention here (an in-flight pass-driven
                # save exporting the PRE-change world) would mark the
                # changed world as journaled and never retry — the
                # exact tail-staleness this loop exists to close
                with save_running:
                    if warm_journal.save(_export()):
                        last_save[0] = time.monotonic()
                        last_world[0] = wv

        threading.Thread(
            target=_periodic_saver, name="warm-save-loop", daemon=True
        ).start()

        mgr.add_reconciler(
            CP_KEY, _cp_reconcile, resync_s=delta_mod.default_resync_s()
        )
        mgr.add_stop_hook(saver_stop.set)
        mgr.add_stop_hook(_save_now)
        # explicit save for harnesses that quiesce the world after
        # mgr.stop() and want the journal to reflect the settled state
        reconciler.save_warm_state = _save_now
        mgr.register_debug_vars(
            "warm_state",
            lambda: dict(
                warm_stats,
                saves_total=warm_journal.saves_total,
                last_save_bytes=warm_journal.last_save_bytes,
            ),
        )
    else:
        mgr.add_reconciler(
            CP_KEY,
            lambda _key: reconciler.reconcile(),
            resync_s=delta_mod.default_resync_s(),
        )
    # event-scoped delta reconciliation (controllers/delta.py): typed
    # (kind, name) queue keys dispatch targeted sub-reconciles — a node
    # event pays that node's label step, a pod event its slice's
    # readiness aggregate — while the full pass above is demoted to the
    # low-frequency resync safety net (RECONCILE_RESYNC_S). The queue
    # serializes per key and barriers the full-pass keys, so M workers
    # only ever overlap independent deltas.
    delta = reconciler.delta
    delta.wake_full = lambda delay=0.0: mgr.enqueue(CP_KEY, delay)
    delta.enqueue_slice = lambda sid, delay=0.0: mgr.enqueue(
        (delta_mod.SLICE_KIND, sid), delay
    )
    # coalesced status publish: foreign-verdict ingests (sharded mode)
    # observe on the watch-dispatch thread and must not write the CR
    # inline there — the queue coalesces a burst into one publish
    delta.enqueue_status = lambda: mgr.enqueue(("status", "slices"), 0.2)
    mgr.add_keyed_reconciler(delta_mod.NODE_KIND, delta.reconcile_node)
    mgr.add_keyed_reconciler(delta_mod.SLICE_KIND, delta.reconcile_slice)
    mgr.add_keyed_reconciler(
        "status", lambda _name: delta.publish_status_now()
    )
    # wire_event_sources builds its router against this handle
    mgr.delta = delta
    # delta-vs-full pass counts + router trigger/drop disposition
    mgr.register_debug_vars("delta_reconcile", delta.stats)
    # /debug/vars: the per-pass snapshot's hit/miss profile sits next to
    # cache_info so one curl answers "is the read path actually shared?"
    mgr.register_debug_vars(
        "reconcile_snapshot", reconciler.ctrl.snapshot_stats
    )
    # the render half of the hot loop: current desired-state fingerprint,
    # hit/miss profile, and per-state render cost
    mgr.register_debug_vars(
        "render_cache", reconciler.ctrl.render_cache.stats
    )
    # node-health remediation: last pass's verdicts + lifetime counters
    # (attempts, PDB vetoes, budget deferrals, breaker opens)
    mgr.register_debug_vars("remediation", reconciler.remediation.stats)
    # live slice re-partition roll: desired layout, rolling/pending
    # slices, budget deferrals (third shared-budget consumer)
    mgr.register_debug_vars("repartition", reconciler.repartition.stats)
    # health-gated rollout orchestrator: ledger state, stage, failing
    # evidence, promotion/rollback counters (controllers/rollout.py)
    mgr.register_debug_vars("rollout", reconciler.rollout.stats)
    # concurrent write pipeline: depth, in-flight, queue wait, errors —
    # one curl answers "are the convergence fan-outs actually wide?"
    mgr.register_debug_vars(
        "write_pipeline", reconciler.ctrl.writes.stats
    )
    # server-side-apply engine: batch-lane fill (is amortization real?)
    # and apply-set membership/pruning disposition
    mgr.register_debug_vars("apply_batches", reconciler.ctrl.batch_stats)
    # lambda, not the bound method: a warm seed REPLACES the applyset
    # instance with the journal's membership
    mgr.register_debug_vars(
        "applyset", lambda: reconciler.ctrl.applyset.stats()
    )
    # reconcile tracing: enabled flag, span totals, last pass's
    # self-time-by-layer summary (obs/trace.py)
    from tpu_operator_torch.obs import flight as _flight
    from tpu_operator_torch.obs import trace as _trace

    mgr.register_debug_vars("trace", _trace.TRACER.stats)
    # flight recorder: ring occupancy + dump disposition (obs/flight.py)
    mgr.register_debug_vars("flight", _flight.RECORDER.stats)
    # allocation traffic: inactive placeholder until a churn harness
    # (fleet_converge --alloc-churn, the soak) re-registers the live
    # engine stats under the same key — the key itself is part of the
    # stable /debug/vars schema
    mgr.register_debug_vars("allocation", lambda: {"active": False})
    upgrade = UpgradeReconciler(client, namespace)
    if shard_mgr is None:
        # sharding disabled: the stable-schema placeholder
        mgr.register_debug_vars("shards", lambda: {"enabled": False})
        mgr.add_reconciler(UPGRADE_KEY, lambda _key: upgrade.reconcile())
        return mgr, reconciler, upgrade

    # -- sharded scale-out wiring (GPU_SHARDS > 1) ----------------------
    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        Result as _Result,
    )

    mgr.shard_lease_manager = shard_mgr  # started/stopped with the mgr
    mgr.shard_state = shard_mgr  # the router's drop filter
    reconciler.shard_state = shard_mgr  # full-pass pinning + fencing
    reconciler.ctrl.shard_state = shard_mgr  # label-write partition
    shard_mgr.metrics = reconciler.metrics
    mgr.register_debug_vars("shards", shard_mgr.stats)

    def _upgrade_pass(_key):
        # the upgrade FSM admits against the GLOBAL disruption budget:
        # shard-0 owner only, re-confirmed live (split-brain guard)
        if not shard_mgr.confirm_full_pass_owner():
            return _Result()
        return upgrade.reconcile()

    mgr.add_reconciler(UPGRADE_KEY, _upgrade_pass)

    def _key_in_shard(key, shard: int) -> bool:
        if not (isinstance(key, tuple) and len(key) == 2):
            return False
        kind, name = key
        if kind == delta_mod.NODE_KIND:
            return shard_mgr.shard_of_node_name(name) == shard
        if kind == delta_mod.SLICE_KIND:
            return shard_mgr.shard_of_slice(name) == shard
        return False

    def _on_lose(shard):
        # ownership already flipped (the router drops this shard's
        # events now): drain pending keys + wait out in-flight ones so
        # nothing of ours runs concurrently with the new owner, then
        # shrink the mirror
        mgr.drain_shard_keys(lambda key: _key_in_shard(key, shard))
        if hasattr(client, "refilter_informers"):
            client.refilter_informers()
        shard_mgr.publish_metrics(reconciler.metrics)

    def _load_journal():
        if not warm_state:
            return None
        from tpu_operator_torch.kube import warm as _warm

        return _warm.WarmJournal(warm_state).load(namespace)

    def _adopt_global_view():
        """Failover seeding for a NEW shard-0 owner whose informers are
        already running scoped: journal first (zero re-lists), scoped
        per-shard label-selector re-lists as the fallback."""
        stats = {"seeded_from_journal": False, "adopted": 0, "relists": 0}
        payload = _load_journal()
        if payload and payload.get("informers"):
            stats["adopted"] = client.adopt_state(payload["informers"])
            stats["seeded_from_journal"] = True
        elif hasattr(client, "adopt_live"):
            # no (fresh) journal: re-list ONLY the shards we don't
            # already mirror, server-side filtered by the shard label —
            # never the whole world
            missing = [
                i
                for i in range(shard_mgr.shards)
                if i not in shard_mgr.owned()
            ]
            specs = [
                ("v1", "Node", "", {consts.SHARD_LABEL: str(i)})
                for i in missing
            ]
            # cluster-wide, like the Pod informer itself: user GPU
            # workload pods live in ANY namespace and the upgrade FSM's
            # drain sweeps read them — a namespace-scoped adoption
            # would let the budgeted pass see nodes as drained of jobs
            # they still run. The informer keep predicate filters.
            specs.append(("v1", "Pod", "", None))
            stats["relists"] = client.adopt_live(specs)
        shard_mgr.failover.update(stats)

    def _adopt_shard_view(shard):
        """Seeding for an ordinary shard gained mid-run (its owner
        died): the scoped keep predicate was dropping this shard's
        objects, so the mirror must adopt them — the journal's
        per-shard slice when fresh, else ONE shard-label-scoped
        re-list. Without this, a quietly-idle shard would see no
        label/verdict convergence until the periodic resync."""
        payload = _load_journal()
        informers = (payload or {}).get("informers")
        if informers:
            from tpu_operator_torch.kube.warm import journal_shard_slice

            client.adopt_state(
                journal_shard_slice(
                    informers,
                    lambda _name, node: (
                        shard_mgr.shard_of_node_obj(node) == shard
                    ),
                )
            )
        elif hasattr(client, "adopt_live"):
            client.adopt_live(
                [
                    ("v1", "Node", "", {consts.SHARD_LABEL: str(shard)}),
                    # cluster-wide for the same reason as the global
                    # adoption: GPU workload pods live anywhere
                    ("v1", "Pod", "", None),
                ]
            )

    def _on_gain(shard):
        if getattr(client, "_started", False):
            # a gain after the informers started is a TAKEOVER: the
            # mirror must grow by the gained shard (or the whole world
            # for the global-arbiter shard) before the next pass reads
            # it
            try:
                if shard == shard_mod.FULL_PASS_SHARD:
                    # the scoped pass's partial aggregate must not
                    # masquerade as global context: hold delta status
                    # publishing until the first GLOBAL full pass
                    # re-seeds the mirror
                    reconciler.delta.invalidate_context()
                    _adopt_global_view()
                else:
                    _adopt_shard_view(shard)
            except Exception:
                logging.getLogger("gpu-operator").exception(
                    "shard %d takeover adoption failed; the resync "
                    "repairs the mirror",
                    shard,
                )
        shard_mgr.publish_metrics(reconciler.metrics)
        mgr.enqueue(CP_KEY)
        mgr.enqueue(UPGRADE_KEY)

    shard_mgr.on_gain.append(_on_gain)
    shard_mgr.on_lose.append(_on_lose)
    return mgr, reconciler, upgrade


def wire_event_sources(mgr, client, namespace: str, stop_event=None) -> None:
    """Watches feed the workqueue (reference watch wiring,
    controllers/clusterpolicy_controller.go:317-344). Shared by main()
    and the kubesim manager e2e so the tested path IS the shipped path.

    Routing lives in ``controllers/delta.EventRouter``: each event maps
    to the minimal affected unit as a typed queue key (node label step,
    slice readiness aggregate, or the full pass for anything that moves
    cluster facts), with predicates dropping no-op deliveries before
    they enqueue. ``GPU_DELTA_RECONCILE=0`` — or a manager built without
    the delta handle — routes every relevant event to the full-pass
    keys, the pre-delta behavior."""
    router = delta_mod.EventRouter(
        mgr, getattr(mgr, "delta", None), CP_KEY, UPGRADE_KEY
    )
    # harnesses (the churn-storm bench's delta-vs-full A/B) flip
    # router.enabled at runtime through this handle
    mgr.router = router
    on_event = router.on_event

    # when the manager runs behind the informer cache, the workqueue is
    # fed from the SAME list+watch streams that keep the cache warm —
    # one set of watches, and a reconcile triggered by an event can
    # never read a cache older than that event (the controller-runtime
    # source-from-cache contract)
    cached = next(
        (
            c
            for c in (getattr(mgr, "client", None), client)
            if hasattr(c, "add_event_hook")
        ),
        None,
    )
    if cached is not None:
        cached.add_event_hook(on_event)
    elif hasattr(client, "add_watcher"):
        # fake client pushes events in-process
        client.add_watcher(on_event)
    elif hasattr(client, "watch"):
        # real API server: one list+watch loop per watched kind. The
        # operand Pod watch is namespace-scoped: the crashloop predicate
        # above only cares about operand pods, and a cluster-wide pod
        # stream would be pure overhead on this (non-cached) path
        for av, kind, ns in (
            (consts.API_VERSION, "ClusterPolicy", ""),
            ("v1", "Node", ""),
            ("apps/v1", "DaemonSet", namespace),
            ("v1", "Pod", namespace),
        ):
            threading.Thread(
                target=client.watch,
                args=(av, kind, on_event),
                kwargs={"namespace": ns, "stop_event": stop_event},
                daemon=True,
            ).start()
    else:
        def poll():
            while True:
                mgr.enqueue(CP_KEY)
                mgr.enqueue(UPGRADE_KEY)
                time.sleep(30)

        threading.Thread(target=poll, daemon=True).start()


def make_kubesim_client(n_nodes: int = 1):
    """An in-process kubesim apiserver seeded like ``make_fake_client``
    (namespace, CRD, ``n_nodes`` GPU nodes, the sample CR), reached
    through the production ``RestClient`` — the dev loop with wire
    semantics."""
    from tpu_operator_torch.kube.kubesim import KubeSim, KubeSimServer, make_client
    from tpu_operator_torch.kube.testing import seed_cluster

    ns = os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    server = KubeSimServer(KubeSim()).start()
    client = make_client(server.port)
    seed_cluster(
        client,
        ns,
        node_names=tuple(
            f"fake-gpu-node-{i + 1}" for i in range(max(1, n_nodes))
        ),
    )
    client._kubesim_server = server  # keep the server alive with the client
    return client


def make_fake_client():
    """An in-memory API server holding the namespace, one GPU node and
    the sample CR."""
    import yaml

    from tpu_operator_torch.kube.client import FakeClient
    from tpu_operator_torch.kube.testing import make_gpu_node

    ns = os.environ.setdefault(consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_NAMESPACE)
    client = FakeClient(
        [
            {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": ns}},
            make_gpu_node("fake-gpu-node-1"),
        ]
    )
    from tpu_operator_torch.kube.testing import sample_clusterpolicy_path

    with open(sample_clusterpolicy_path()) as f:
        cr = yaml.safe_load(f)
    cr["metadata"]["uid"] = "fake-uid"
    client.create(cr)
    return client


def start_grpc_kubelet(client, node_name: str, chips: Optional[int] = None):
    """Run the REAL device-plugin gRPC server against a stub devfs plus
    the kubelet device-manager sim for one node: Registration →
    ListAndWatch → node capacity/allocatable derived from the
    advertisement — the closed plugin loop inside the dev loop. Returns
    (kubelet, plugin) for shutdown.

    The devfs holds ``chips`` files ``nvidia<i>`` (default: the cards of
    one host of ``testing.DEFAULT_VARIANT``) and ``nvidiactl``,
    ``nvidia-uvm`` and ``nvidia-uvm-tools``. On a machine where NVML
    answers, ``gpuinfo.chip_summary`` reports the real cards whatever
    ``dev_root`` says, so there the node advertises the machine's cards,
    not the stub's."""
    import tempfile

    from tpu_operator_torch.kube.kubelet_sim import KubeletDeviceManager
    from tpu_operator_torch.kube.testing import DEFAULT_VARIANT
    from tpu_operator_torch.plugin.server import (
        DevicePluginServer,
        GPUDevicePluginServicer,
    )
    from tpu_operator_torch.workloads.topology import CARDS_PER_HOST

    if chips is None:
        chips = CARDS_PER_HOST[DEFAULT_VARIANT]
    tmp = tempfile.mkdtemp(prefix="gpu-dev-kubelet-")
    dev_root = os.path.join(tmp, "dev")
    os.makedirs(dev_root)
    for name in [f"nvidia{i}" for i in range(chips)] + [
        "nvidiactl",
        "nvidia-uvm",
        "nvidia-uvm-tools",
    ]:
        open(os.path.join(dev_root, name), "w").close()
    socket_dir = os.path.join(tmp, "sockets")
    kubelet = KubeletDeviceManager(client, node_name, socket_dir)
    kubelet.start()
    servicer = GPUDevicePluginServicer(
        dev_root=dev_root,
        generation=DEFAULT_VARIANT,
        poll_interval_s=2.0,
    )
    plugin = DevicePluginServer(servicer, socket_dir=socket_dir)
    try:
        plugin.start()
        plugin.register_with_kubelet(kubelet.kubelet_socket)
    except BaseException:
        plugin.stop()
        kubelet.stop()
        raise
    return kubelet, plugin


def _log_grpc_capacity(client, node_names, log, timeout_s: float = 30.0) -> None:
    """Log each node's allocatable ``nvidia.com/gpu`` as the gRPC kubelet
    wrote it from the plugin's advertisement (waiting up to ``timeout_s``
    for the first write), so a ``--once`` run shows what it derived."""
    deadline = time.monotonic() + timeout_s
    for name in node_names:
        got = None
        while True:
            node = client.get_or_none("v1", "Node", name) or {}
            got = (node.get("status") or {}).get("allocatable", {}).get(consts.GPU_RESOURCE)
            if got is not None or time.monotonic() >= deadline:
                break
            time.sleep(0.1)
        log.info("gRPC kubelet: node %s allocatable %s=%s", name, consts.GPU_RESOURCE, got)


def _simulate_kubelet(client, namespace: str, node_names=None) -> None:
    """Dev-mode kubelet loop (shared single-pass helpers keep this in sync
    with the test suite's simulation). Multi-node pools get the faithful
    per-node kubelet (nodeSelector-aware, real OnDelete semantics — a
    driver spec change then rolls through the upgrade FSM, as on a real
    cluster); the single-node loop keeps the stale-refresh shortcut so
    quick spec edits converge without enabling autoUpgrade."""
    from tpu_operator_torch.kube.testing import (
        simulate_kubelet_nodes,
        simulate_kubelet_once,
    )

    while True:
        try:
            if node_names and len(node_names) > 1:
                simulate_kubelet_nodes(client, namespace, node_names)
            else:
                simulate_kubelet_once(client, namespace)
        except Exception:
            logging.getLogger("gpu-operator").exception("kubelet sim error")
        time.sleep(1)


def main(argv=None) -> int:
    args = build_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("gpu-operator")

    trace_mod = None
    if args.trace_out:
        from tpu_operator_torch.obs import trace as trace_mod

        trace_mod.enable()
        log.info("reconcile tracing enabled -> %s", args.trace_out)

    def export_trace():
        if trace_mod is not None:
            try:
                n = trace_mod.TRACER.export_chrome(args.trace_out)
                log.info(
                    "trace exported: %d span(s) -> %s", n, args.trace_out
                )
            except Exception:
                log.exception("trace export failed")

    node_names = None
    if args.fake:
        client = make_fake_client()
    elif args.kubesim:
        client = make_kubesim_client(args.nodes)
        node_names = [f"fake-gpu-node-{i + 1}" for i in range(max(1, args.nodes))]
        log.info(
            "kubesim apiserver started in-process (%d node%s)",
            max(1, args.nodes),
            "s" if args.nodes > 1 else "",
        )
    else:
        from tpu_operator_torch.kube.rest import RestClient

        try:
            client = RestClient()
        except FileNotFoundError as e:
            log.error(
                "not running in a cluster (%s); use --fake or --kubesim "
                "for dev",
                e,
            )
            return 1

    namespace = os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "")
    if not namespace:
        log.error("%s must be set", consts.OPERATOR_NAMESPACE_ENV)
        return 1

    mgr, reconciler, upgrade = build_manager(
        client,
        namespace,
        metrics_port=args.metrics_port,
        probe_port=args.probe_port,
        leader_election=args.leader_election,
        debug_endpoints=args.debug_endpoints,
        assets_dir=args.assets,
        warm_state=args.warm_state,
    )

    # one hoisted block for BOTH --once and serve mode; handles are
    # retained because the plugin's gRPC ThreadPoolExecutor workers are
    # non-daemon — without stop() the ListAndWatch loop pins them and
    # concurrent.futures' atexit join hangs the process forever at exit
    grpc_rigs = []
    if args.kubesim and args.grpc_kubelet:
        for name in node_names or []:
            grpc_rigs.append(start_grpc_kubelet(client, name))
        log.info(
            "gRPC kubelet device managers running: node GPU capacity is "
            "derived from the plugin's ListAndWatch advertisement"
        )

    def stop_grpc_rigs():
        for kubelet, plugin in grpc_rigs:
            try:
                plugin.stop()
                kubelet.stop()
            except Exception:
                log.exception("gRPC kubelet rig shutdown failed")

    if args.once:
        try:
            if mgr.shard_lease_manager is not None:
                # --once never reaches Manager.start: one synchronous
                # lease round so a sharded single-pass dev run actually
                # owns its shards (and shard 0) before reconciling
                mgr.shard_lease_manager.tick()
            if (args.fake or args.kubesim) and args.simulate_kubelet:
                from tpu_operator_torch.kube.testing import (
                    simulate_kubelet_nodes,
                    simulate_kubelet_once,
                )

                # converge like the fake e2e: reconcile + kubelet sim rounds
                for _ in range(30):
                    res = reconciler.reconcile()
                    if node_names and len(node_names) > 1:
                        simulate_kubelet_nodes(client, namespace, node_names)
                    else:
                        simulate_kubelet_once(client, namespace)
                    if res.ready:
                        break
            else:
                res = reconciler.reconcile()
            upgrade.reconcile()
            # --once never reaches the manager's stop hook, so the warm
            # journal must save here or a single-pass dev run leaves no
            # state for the next start to warm from
            save_warm = getattr(reconciler, "save_warm_state", None)
            if callable(save_warm):
                save_warm()
            if grpc_rigs:
                _log_grpc_capacity(client, node_names or [], log)
            log.info("single pass done: ready=%s", res.ready)
            return 0 if res.ready else 2
        finally:
            export_trace()
            stop_grpc_rigs()

    wire_event_sources(mgr, client, namespace)

    if (args.fake or args.kubesim) and args.simulate_kubelet:
        threading.Thread(
            target=_simulate_kubelet,
            args=(client, namespace, node_names),
            daemon=True,
        ).start()
    mgr.enqueue(CP_KEY)
    mgr.enqueue(UPGRADE_KEY)
    mgr.install_signal_handlers()
    mode = "fake" if args.fake else "kubesim" if args.kubesim else "cluster"
    log.info("gpu-operator starting (namespace=%s mode=%s)", namespace, mode)
    try:
        mgr.run_forever()
    finally:
        export_trace()
        stop_grpc_rigs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
