"""``gpu-maintenance-handler`` — host-maintenance watcher.

The port's copy of ``tpu_operator/operands/maintenance.py``, whole: the
command the ``state-maintenance-handler`` DaemonSet runs
(``assets/state-maintenance-handler/0500_daemonset.yaml``). Cloud hosts
receive scheduled-maintenance notices through the GCE metadata server
(``instance/maintenance-event``), and a VM under maintenance loses its
cards mid-step. This node agent polls the metadata endpoint and, when
maintenance is imminent,

* labels the node ``tpu.k8s.io/maintenance=pending`` (ops visibility +
  a scheduling signal),
* cordons the node, remembering whether it was already cordoned so the
  all-clear restores the state the node was found in (the upgrade FSM's
  initial-state pattern, ``upgrade_state.go:419-429``),
* evicts GPU-consuming pods with kubectl-drain semantics (unmanaged
  pods are skipped unless ``force`` — reusing the upgrade engine's
  ``PodManager``), letting checkpoint-aware trainers resume elsewhere
  instead of dying with the host,
* records a Warning Event naming the maintenance window.

When the metadata server reports ``NONE`` again the handler uncordons
(unless the node was cordoned before), clears the label, and records a
Normal Event. All node writes are conflict-retried: the Node object is
shared with the deploy-label bus, the upgrade FSM, and feature discovery.

What the port decides here (with ``manager.py``'s decisions):

* The command is ``gpu-maintenance-handler`` (the reference's
  ``tpu-maintenance-handler``), the one the port's asset runs.
* The GCE metadata endpoint and its ``Metadata-Flavor`` header stay: GCE's
  GPU VMs get ``instance/maintenance-event`` from the same server. So do
  the label bus (``consts.MAINTENANCE_STATE_LABEL``), the annotation
  ``consts.MAINTENANCE_INITIAL_STATE_ANNOTATION``, the Event reasons and
  the variables ``METADATA_URL``, ``POLL_INTERVAL_S``, ``FORCE_EVICT``
  and ``EVICT_WORKLOADS``.
* The victims are the pods ``PodManager.tpu_pods_on_node`` returns: those
  asking for ``nvidia.com/gpu`` or ``nvidia.com/mig-*``. The deferral to
  the upgrade FSM reads the port's ``UPGRADE_STATE_LABEL`` and
  ``UPGRADE_INITIAL_STATE_ANNOTATION``.
* Messages name the card: "GPU workload pod(s) evicted", "left cordoned:
  driver upgrade in progress".
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
import urllib.request
from typing import Callable, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import Client, ConflictError

log = logging.getLogger("gpu-maintenance-handler")

# GCE metadata semantics: NONE, or MIGRATE_ON_HOST_MAINTENANCE /
# TERMINATE_ON_HOST_MAINTENANCE while a window is imminent/active
DEFAULT_METADATA_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/maintenance-event"
)
EVENT_NONE = "NONE"
# metadata server unreachable: NOT an all-clear and NOT a window — a
# transient outage mid-window must never uncordon a host that is still
# about to lose its cards, and must never trigger an eviction either
EVENT_UNKNOWN = None

# the only values the GCE metadata server emits for
# instance/maintenance-event; anything else (captive portal, proxy error
# page, misconfigured METADATA_URL answering 200 with arbitrary text)
# must NOT be read as an active window — it would evict live training
# workloads on every poll
KNOWN_EVENTS = frozenset(
    {EVENT_NONE, "MIGRATE_ON_HOST_MAINTENANCE", "TERMINATE_ON_HOST_MAINTENANCE"}
)

STATE_PENDING = "pending"


def read_maintenance_event(url: str, timeout_s: float = 5.0) -> Optional[str]:
    """One metadata poll. Unreachable/odd answers read as ``EVENT_UNKNOWN``
    (no state transition): a dead metadata server is neither a maintenance
    signal nor an all-clear. "Odd" includes a 200 whose body is not one of
    the documented GCE values or whose response lacks the
    ``Metadata-Flavor: Google`` header — the anti-SSRF marker every real
    metadata response carries."""
    req = urllib.request.Request(url, headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            if r.headers.get("Metadata-Flavor") != "Google":
                log.warning(
                    "metadata response from %s lacks Metadata-Flavor: Google; "
                    "treating as unknown",
                    url,
                )
                return EVENT_UNKNOWN
            body = (r.read().decode() or EVENT_NONE).strip() or EVENT_NONE
    except Exception:
        log.warning("metadata poll failed for %s", url)
        return EVENT_UNKNOWN
    if body not in KNOWN_EVENTS:
        log.warning("unrecognized maintenance-event body %r; treating as unknown", body)
        return EVENT_UNKNOWN
    return body


class MaintenanceHandler:
    def __init__(
        self,
        client: Client,
        node_name: str,
        metadata_url: str = DEFAULT_METADATA_URL,
        force: bool = False,
        evict: bool = True,
        reader: Optional[Callable[[str], str]] = None,
    ):
        self.client = client
        self.node_name = node_name
        self.metadata_url = metadata_url
        self.force = force
        self.evict = evict
        self.reader = reader or read_maintenance_event
        self._active = False
        # evictions vetoed by a PDB are retried every poll while the
        # window stays open (the budget may free up before the host dies)
        self._evict_pending = False

    # -- conflict-safe node writes (shared-Node discipline) -------------
    def _mutate_node(self, mutate) -> None:
        from tpu_operator_torch.kube.client import mutate_with_retry

        mutate_with_retry(
            self.client, "v1", "Node", self.node_name, mutate=mutate
        )

    def _event(self, etype: str, reason: str, message: str) -> None:
        from tpu_operator_torch.kube.events import record_event

        node = self.client.get("v1", "Node", self.node_name)
        record_event(
            self.client,
            os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "default"),
            node,
            etype,
            reason,
            message,
        )

    # -- transitions -----------------------------------------------------
    def _enter_maintenance(self, event: str) -> None:
        log.warning("maintenance imminent on %s: %s", self.node_name, event)

        def mutate(node):
            changed = False
            meta = node["metadata"]
            labels = meta.setdefault("labels", {})
            ann = meta.setdefault("annotations", {})
            if labels.get(consts.MAINTENANCE_STATE_LABEL) != STATE_PENDING:
                labels[consts.MAINTENANCE_STATE_LABEL] = STATE_PENDING
                changed = True
            spec = node.setdefault("spec", {})
            if consts.MAINTENANCE_INITIAL_STATE_ANNOTATION not in ann:
                ann[consts.MAINTENANCE_INITIAL_STATE_ANNOTATION] = (
                    "true" if spec.get("unschedulable", False) else "false"
                )
                changed = True
            if not spec.get("unschedulable", False):
                spec["unschedulable"] = True
                changed = True
            return changed

        self._mutate_node(mutate)
        # flip the WHOLE slice's verdict BEFORE the drain: every other
        # member host is about to become 0% useful too, and a multi-host
        # job gated on the slice-ready label should drain ONCE, ahead of the
        # window — not four times as each host's drain lands
        self._flip_slice_ready(event)
        action = self._evict_sweep()
        from tpu_operator_torch.kube.events import TYPE_WARNING

        self._event(
            TYPE_WARNING,
            "HostMaintenanceImminent",
            f"{event}: {action} ahead of host maintenance",
        )

    def _slice_members(self):
        """This node's slice id and its member nodes (empty for
        single-host slices, whose verdict the aggregate owns alone)."""
        from tpu_operator_torch.controllers.slice_status import slice_members

        node = self.client.get("v1", "Node", self.node_name)
        sid, members = slice_members(self.client, node)
        if len(members) <= 1:
            return sid, []
        return sid, members

    def _flip_slice_ready(self, event: str) -> None:
        """Proactive slice-verdict flip + ONE per-slice Event naming the
        window and the host. The operator's aggregate independently
        counts maintenance-labeled members as not-ready, so a reconcile
        racing this write agrees rather than flipping the verdict back;
        best-effort — never blocks the drain."""
        from tpu_operator_torch.kube.client import mutate_with_retry
        from tpu_operator_torch.kube.events import (
            TYPE_WARNING,
            cluster_policy_ref,
            record_event,
        )

        try:
            sid, members = self._slice_members()
            if not members:
                return
            for member in members:
                name = member["metadata"]["name"]

                def mutate(node):
                    labels = node["metadata"].setdefault("labels", {})
                    if labels.get(consts.SLICE_READY_LABEL) == "false":
                        return False
                    labels[consts.SLICE_READY_LABEL] = "false"
                    return True

                try:
                    mutate_with_retry(
                        self.client, "v1", "Node", name, mutate=mutate
                    )
                except Exception:
                    log.exception(
                        "failed to flip slice.ready on member %s", name
                    )
            record_event(
                self.client,
                os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "default"),
                cluster_policy_ref(),
                TYPE_WARNING,
                "SliceMaintenanceScheduled",
                f"slice {sid}: member host {self.node_name} has a "
                f"scheduled host-maintenance window ({event}); slice "
                f"marked not-ready ahead of the drain",
                dedup_extra=sid,
            )
        except Exception:
            log.exception("proactive slice flip failed; drain proceeds")

    def _evict_sweep(self) -> str:
        """One eviction pass over the node's GPU pods; returns the
        truthful description for Events. Sets ``_evict_pending`` when
        pods remain (PDB-vetoed or skipped-unmanaged) so the poll loop
        keeps retrying for the whole window — the budget may free up
        (a replica turns Ready elsewhere) before the host dies. With
        ``force``, a PDB-vetoed pod is deleted outright (kubectl's
        ``--disable-eviction`` escape hatch): the host termination will
        kill it anyway, so under an imminent window force means force."""
        self._evict_pending = False
        if not self.evict:
            return "node cordoned (eviction disabled)"
        from tpu_operator_torch.upgrade.upgrade_state import PodManager

        pods = PodManager(
            self.client,
            os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "default"),
        )
        victims = pods.tpu_pods_on_node(self.node_name)
        if not victims:
            return "node cordoned; no GPU workload pods to evict"
        log.warning(
            "evicting %d GPU pod(s) ahead of maintenance", len(victims)
        )
        res = pods.evict_pods(victims, force=self.force)
        forced = 0
        if res.blocked_pods and self.force:
            # the node is doomed: eviction was vetoed but FORCE_EVICT
            # promises removal — fall back to delete (disable-eviction
            # semantics), loudly, targeting EXACTLY the vetoed pods (a
            # re-list would double-count pods already evicted and merely
            # terminating through their grace period)
            for pod in res.blocked_pods:
                meta = pod["metadata"]
                log.warning(
                    "force-deleting %s/%s past its disruption budget "
                    "(host maintenance imminent)",
                    meta.get("namespace"),
                    meta["name"],
                )
                self.client.delete_if_exists(
                    "v1", "Pod", meta["name"], meta.get("namespace", "")
                )
                forced += 1
            res.blocked = []
            res.blocked_pods = []
        parts = ["node cordoned"]
        if res.evicted:
            parts.append(f"{res.evicted} GPU workload pod(s) evicted")
        if forced:
            parts.append(
                f"{forced} pod(s) force-deleted past their disruption budget"
            )
        if res.blocked:
            parts.append(
                f"{len(res.blocked)} eviction(s) vetoed by a disruption "
                f"budget (will retry: {res.blocked[0]})"
            )
            self._evict_pending = True
        if res.skipped:
            parts.append(
                f"{res.skipped} unmanaged pod(s) left alone (set "
                "FORCE_EVICT=true to remove)"
            )
        return "; ".join(parts)

    def _leave_maintenance(self) -> None:
        log.info("maintenance window cleared on %s", self.node_name)
        was_cordoned = {"value": False}
        fsm_holds = {"value": False}

        def mutate(node):
            changed = False
            meta = node["metadata"]
            labels = meta.setdefault("labels", {})
            ann = meta.setdefault("annotations", {})
            if consts.MAINTENANCE_STATE_LABEL in labels:
                del labels[consts.MAINTENANCE_STATE_LABEL]
                changed = True
            initial = ann.pop(consts.MAINTENANCE_INITIAL_STATE_ANNOTATION, None)
            if initial is not None:
                changed = True
            was_cordoned["value"] = initial == "true"
            # the reverse interleaving of upgrade_state's maintenance
            # deferral: if the upgrade FSM cordoned the node while our
            # window was open, the all-clear must NOT uncordon mid-drain /
            # mid-driver-swap — the FSM owns the cordon until it reaches
            # uncordon itself (or terminal-fails, which keeps the cordon
            # for the operator to surface)
            from tpu_operator_torch.upgrade.upgrade_state import (
                ACTIVE_STATES,
                STATE_FAILED,
            )

            fsm_state = labels.get(consts.UPGRADE_STATE_LABEL, "")
            fsm_holds["value"] = (
                fsm_state in ACTIVE_STATES or fsm_state == STATE_FAILED
            )
            if fsm_holds["value"] and not was_cordoned["value"]:
                # hand the cordon over, don't just defer: the FSM entered
                # while WE held the cordon, so it recorded
                # initial-state=cordoned and would skip its own uncordon
                # at completion (upgrade_state._to_uncordon_or_done) —
                # with our annotation now popped, nobody would ever
                # uncordon. Clearing the FSM's initial-state annotation
                # makes the FSM treat the node as its own cordon and
                # uncordon it when the upgrade finishes.
                ann.pop(consts.UPGRADE_INITIAL_STATE_ANNOTATION, None)
            spec = node.setdefault("spec", {})
            if (
                not was_cordoned["value"]
                and not fsm_holds["value"]
                and spec.get("unschedulable", False)
            ):
                spec["unschedulable"] = False
                changed = True
            return changed

        self._mutate_node(mutate)
        from tpu_operator_torch.kube.events import TYPE_NORMAL

        if fsm_holds["value"]:
            detail = " (left cordoned: driver upgrade in progress)"
        elif was_cordoned["value"]:
            detail = " (left cordoned: was cordoned before)"
        else:
            detail = ""
        self._event(
            TYPE_NORMAL,
            "HostMaintenanceCleared",
            "maintenance window cleared; node restored" + detail,
        )
        # per-slice all-clear: the aggregate restores the slice-ready label on
        # its next pass (the label diff re-triggers it); the Event tells
        # the multi-host story in one line
        try:
            from tpu_operator_torch.kube.events import cluster_policy_ref, record_event

            sid, members = self._slice_members()
            if members:
                record_event(
                    self.client,
                    os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "default"),
                    cluster_policy_ref(),
                    TYPE_NORMAL,
                    "SliceMaintenanceCleared",
                    f"slice {sid}: the maintenance window on member host "
                    f"{self.node_name} ended; the slice verdict is "
                    f"restored by the next readiness pass",
                    dedup_extra=sid,
                )
        except Exception:
            log.exception("slice maintenance-clear event failed")

    # -- the loop --------------------------------------------------------
    def reconcile_once(self) -> Optional[str]:
        event = self.reader(self.metadata_url)
        if event is EVENT_UNKNOWN:
            # metadata outage: hold the current state — neither an
            # eviction trigger nor an all-clear
            return event
        if event != EVENT_NONE:
            if not self._active:
                # idempotent entry: a restart mid-window re-runs it — the
                # cordon/label writes no-op when already applied, and the
                # eviction sweep clears any straggler a crashed previous
                # process (or a direct-nodeName placement) left holding
                # the cards; a lingering label alone is NOT proof the
                # eviction completed
                try:
                    self._enter_maintenance(event)
                    self._active = True
                except ConflictError:
                    log.warning(
                        "maintenance cordon hit persistent 409s; retrying"
                    )
            elif self._evict_pending:
                # a PDB vetoed part of the sweep: keep retrying while the
                # window is open — one-shot entry must not strand doomed
                # workloads behind a budget that later frees up
                log.info("retrying vetoed evictions (window still open)")
                self._evict_sweep()
        elif self._active:
            try:
                self._leave_maintenance()
                self._active = False
            except ConflictError:
                log.warning("maintenance uncordon hit persistent 409s; retrying")
        else:
            # crash-recovery: a restart after the window cleared loses
            # self._active; a lingering label means WE cordoned earlier
            node = self.client.get("v1", "Node", self.node_name)
            if (node["metadata"].get("labels") or {}).get(
                consts.MAINTENANCE_STATE_LABEL
            ):
                try:
                    self._leave_maintenance()
                except ConflictError:
                    log.warning("maintenance cleanup hit 409s; retrying")
        return event

    def run_loop(self, interval_s: float = 10.0, once: bool = False) -> None:
        while True:
            try:
                self.reconcile_once()
            except Exception:
                log.exception("maintenance pass failed")
            if once:
                return
            time.sleep(interval_s)


def main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-maintenance-handler")
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument(
        "--metadata-url",
        default=os.environ.get("METADATA_URL", DEFAULT_METADATA_URL),
    )
    p.add_argument(
        "--poll-interval",
        type=float,
        default=float(os.environ.get("POLL_INTERVAL_S", "10")),
    )
    p.add_argument(
        "--force",
        action="store_true",
        default=os.environ.get("FORCE_EVICT", "") == "true",
        help="also delete unmanaged (ownerless) GPU pods",
    )
    p.add_argument(
        "--no-evict",
        action="store_true",
        default=os.environ.get("EVICT_WORKLOADS", "true") == "false",
        help="cordon and label only; leave workloads running",
    )
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)
    if not args.node_name:
        log.error("--node-name (or NODE_NAME) required")
        return 1
    from tpu_operator_torch.kube.rest import RestClient

    handler = MaintenanceHandler(
        RestClient(),
        args.node_name,
        metadata_url=args.metadata_url,
        force=args.force,
        evict=not args.no_evict,
    )
    handler.run_loop(interval_s=args.poll_interval, once=args.once)
    return 0


if __name__ == "__main__":
    sys.exit(main())
