"""Kubernetes Event recording.

The port's copy of ``tpu_operator/kube/events.py``. The Events' source
component is ``consts.EVENT_COMPONENT``, ``gpu-operator``, the name the
port's server-side-apply field manager carries (the reference writes
``tpu-operator``); the refresh window and its variable are the
reference's.

The operator emits Events on state transitions and failures so ``kubectl
describe clusterpolicy``/``get events`` explains what happened (the
controller-runtime EventRecorder role). Events are deduplicated by
(involved object, reason): repeats bump ``count``/``lastTimestamp``.

An in-process **correlator** (the client-go ``EventCorrelator`` role)
sits in front of the apiserver writes: a repeat of the SAME
(reason, message) within ``EVENT_REFRESH_INTERVAL_S`` is coalesced
locally — no apiserver request at all — and its count is folded into
the next flush. Without it a converging fleet re-posts an identical
``OperandsNotReady`` Event every requeue pass (a GET plus a PUT each
time); with it consecutive identical passes cost zero writes.
A changed message always writes through immediately.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import weakref
from datetime import datetime, timezone
from typing import Any, Dict, Tuple

from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import Client, NotFoundError, Obj

log = logging.getLogger("gpu-operator.events")

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

COMPONENT = consts.EVENT_COMPONENT

# repeats of an identical (reason, message) within this window coalesce
# in process instead of re-writing the Event each pass; tests pin it to
# 0 to force every record through to the store
EVENT_REFRESH_INTERVAL_S = float(
    os.environ.get("EVENT_REFRESH_INTERVAL_S", "30")
)

# per-client correlator state: event key -> entry. WeakKey so a test's
# FakeClient takes its correlator with it when collected; one lock
# guards the whole table (record_event is not a hot path).
_correlators: "weakref.WeakKeyDictionary[Client, Dict[Tuple, Dict[str, Any]]]" = (
    weakref.WeakKeyDictionary()
)
_corr_lock = threading.Lock()


def reset_correlator(client: Client) -> None:
    """Drop the correlator state for ``client`` (test isolation)."""
    with _corr_lock:
        _correlators.pop(client, None)


def cluster_policy_ref() -> Obj:
    """The singleton ClusterPolicy as an Event involved-object — the
    shared events bus for slice-scoped records (degradation, upgrade
    rolls, maintenance windows)."""
    return {
        "apiVersion": consts.API_VERSION,
        "kind": "ClusterPolicy",
        "metadata": {"name": "cluster-policy"},
    }


def _now() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def record_event(
    client: Client,
    namespace: str,
    involved: Obj,
    event_type: str,
    reason: str,
    message: str,
    dedup_extra: str = "",
) -> None:
    """Create-or-bump an Event (best-effort: never raises).

    ``dedup_extra`` joins the dedup key for reasons whose messages carry
    per-subject detail (e.g. one SliceDegraded Event PER SLICE on the
    shared ClusterPolicy — without it a second slice's flip would
    overwrite the first one's host list).

    Identical repeats inside ``EVENT_REFRESH_INTERVAL_S`` never reach
    the apiserver: the correlator counts them locally and folds the
    accumulated count into the next write-through, so the stored Event's
    ``count`` stays truthful while steady-state re-posts cost nothing."""
    try:
        meta = involved.get("metadata", {})
        corr_key = (
            involved.get("kind", ""),
            meta.get("namespace", ""),
            meta.get("name", ""),
            reason,
            dedup_extra,
            namespace,
        )
        now_m = time.monotonic()
        with _corr_lock:
            table = _correlators.get(client)
            if table is None:
                table = _correlators.setdefault(client, {})
            entry = table.get(corr_key)
            if (
                entry is not None
                and entry["message"] == message
                and now_m - entry["last_write"] < EVENT_REFRESH_INTERVAL_S
            ):
                # coalesced: same story, told again inside the window
                entry["pending"] += 1
                return
            pending = entry["pending"] if entry is not None else 0
            # reserve the new window ATOMICALLY with the flush decision:
            # a concurrent recorder of the same key now coalesces against
            # the fresh window instead of racing us into a double flush
            # (which would double-fold `pending`), and a coalesce landing
            # while we write lands on the reserved entry instead of being
            # zeroed afterwards. If the write below fails, the reserved
            # window stands and the pending repeats are dropped — Events
            # are best-effort by contract.
            table[corr_key] = {
                "message": message,
                "last_write": now_m,
                "pending": 0,
            }
        key = hashlib.sha1(
            "/".join(
                [
                    involved.get("kind", ""),
                    meta.get("namespace", ""),
                    meta.get("name", ""),
                    reason,
                    dedup_extra,
                ]
            ).encode()
        ).hexdigest()[:12]
        name = f"{meta.get('name', 'unknown')}.{key}"
        now = _now()
        # copy=True: the bump path mutates the Event in place, and the
        # Event informer would otherwise hand back a shared frozen view
        existing = client.get_or_none("v1", "Event", name, namespace, copy=True)
        if existing is not None:
            existing["count"] = int(existing.get("count", 1)) + 1 + pending
            existing["lastTimestamp"] = now
            existing["message"] = message
            try:
                written = client.update(existing)
            except NotFoundError:
                # TTL-expired between read and write: recreate below
                written = None
            if written is not None:
                return
        client.create(
            {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {"name": name, "namespace": namespace},
                "involvedObject": {
                    "apiVersion": involved.get("apiVersion", ""),
                    "kind": involved.get("kind", ""),
                    "name": meta.get("name", ""),
                    "namespace": meta.get("namespace", ""),
                    "uid": meta.get("uid", ""),
                },
                "reason": reason,
                "message": message,
                "type": event_type,
                "source": {"component": COMPONENT},
                "firstTimestamp": now,
                "lastTimestamp": now,
                "count": 1 + pending,
            }
        )
    except Exception:
        log.debug("event recording failed", exc_info=True)

