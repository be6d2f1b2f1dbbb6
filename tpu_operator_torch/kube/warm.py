"""Warm-restart state journal.

The port's copy of ``tpu_operator/kube/warm.py``, with the same
``SCHEMA``: a journal the reference wrote over the same world seeds the
port's informers (``convert.warm_journal_from_reference`` maps its
objects), and the other way round. ``export_state`` and ``seed_state``
read a reconciler's ``ctrl.render_cache`` and ``ctrl.applyset`` by duck
typing, so any holder of a ``RenderCache`` and an ``ApplySet`` serves.

A cold operator restart pays three bills before its first steady pass:
every informer re-LISTs the whole world (18 kinds, fleet-sized Node and
Pod collections), every manifest re-renders, and the first pass
re-derives the label/apply-set world from scratch. None of that is
necessary when the inputs did not change across the restart — the
reference gets the same effect from the apiserver's watch cache plus
apply idempotency; here the operator persists a small on-disk journal
and resumes:

* **informer snapshots** — per-kind slim object stores plus the resume
  resourceVersion; a warm start seeds the stores and opens watches AT
  that rv (``RestClient.watch(seed_rv=...)``) instead of listing. A
  compacted rv 410s into a normal re-list; the periodic resync repairs
  any drift — bounded staleness, never wrong.
* **render cache** — the fingerprint-gated rendered manifests
  (``controllers/render_cache.py``): when the recomputed desired-state
  fingerprint matches the journal's, pass 1 serves every manifest from
  cache (hit rate 1.0 from the first pass); a mismatch simply drops the
  entries (the normal ``begin_pass`` invalidation).
* **apply-set membership** (``kube/apply.py``): a rename straddling the
  restart still prunes the abandoned object.

Invalidation rules (all fail open to a cold start):

* schema version mismatch — ignored;
* journal older than ``WARM_STATE_MAX_AGE_S`` (default 3600 s) —
  ignored (the world has certainly moved; a cold list is cheaper than
  chasing a long catch-up replay);
* unreadable/corrupt file — ignored;
* operator namespace mismatch — ignored;
* render fingerprint mismatch — render entries dropped by
  ``begin_pass``; informer seed still applies (the fleet state is
  orthogonal to the spec).

The journal is written atomically (tmp + rename) after READY passes, at
most every ``WARM_STATE_SAVE_INTERVAL_S`` (default 15 s), and on
manager shutdown. Enable with ``GPU_OPERATOR_WARM_STATE=<path>``
(``consts.WARM_STATE_ENV``; the reference reads
``TPU_OPERATOR_WARM_STATE``).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, Optional

log = logging.getLogger("gpu-operator.warm")

SCHEMA = 1

DEFAULT_MAX_AGE_S = 3600.0
DEFAULT_SAVE_INTERVAL_S = 15.0


def save_interval_s() -> float:
    try:
        return float(
            os.environ.get(
                "WARM_STATE_SAVE_INTERVAL_S", DEFAULT_SAVE_INTERVAL_S
            )
        )
    except ValueError:
        return DEFAULT_SAVE_INTERVAL_S


class WarmJournal:
    """Load/save the warm-restart payload with the invalidation rules
    above. One instance per operator process; thread-confinement is the
    caller's job (the reconciler saves from its own pass)."""

    def __init__(self, path: str, max_age_s: Optional[float] = None):
        self.path = path
        if max_age_s is None:
            try:
                max_age_s = float(
                    os.environ.get("WARM_STATE_MAX_AGE_S", DEFAULT_MAX_AGE_S)
                )
            except ValueError:
                max_age_s = DEFAULT_MAX_AGE_S
        self.max_age_s = max_age_s
        self.saves_total = 0
        self.last_save_bytes = 0

    def load(self, namespace: str = "") -> Optional[Dict[str, Any]]:
        """The journal payload, or None when absent/invalid (cold
        start). Every rejection logs WHY — a silently-cold warm start
        is a debugging trap."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            log.warning("warm journal %s unreadable (%s); cold start", self.path, e)
            return None
        if payload.get("schema") != SCHEMA:
            log.warning(
                "warm journal schema %r != %d; cold start",
                payload.get("schema"),
                SCHEMA,
            )
            return None
        age = time.time() - float(payload.get("saved_at") or 0)
        if self.max_age_s and not (0 <= age <= self.max_age_s):
            log.warning(
                "warm journal is %.0fs old (max %.0fs); cold start",
                age,
                self.max_age_s,
            )
            return None
        if namespace and payload.get("namespace") not in ("", None, namespace):
            log.warning(
                "warm journal namespace %r != %r; cold start",
                payload.get("namespace"),
                namespace,
            )
            return None
        return payload

    def save(self, payload: Dict[str, Any]) -> bool:
        """Atomic write (tmp + rename in the target directory so the
        rename never crosses filesystems). Best-effort: persistence
        must never fail a reconcile."""
        payload = dict(payload)
        payload["schema"] = SCHEMA
        payload["saved_at"] = time.time()
        try:
            blob = json.dumps(payload, separators=(",", ":"))
            d = os.path.dirname(os.path.abspath(self.path)) or "."
            fd, tmp = tempfile.mkstemp(prefix=".warm-", dir=d)
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(blob)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.saves_total += 1
            self.last_save_bytes = len(blob)
            return True
        except Exception:
            log.exception("warm journal save to %s failed", self.path)
            return False


def journal_shard_slice(informers, keep_node) -> Dict[str, Any]:
    """Per-shard slice of a warm-journal informer snapshot (sharded
    scale-out): Node objects failing
    ``keep_node(name, node)`` are dropped, Pods follow their
    ``spec.nodeName``, every other kind passes through whole (they are
    namespace-scoped operator state, not fleet-sharded). The per-kind
    resume rv is preserved — a seeded watch still resumes from it, and
    a stale rv 410s into the normal scoped re-list."""
    out: Dict[str, Any] = {}
    kept_nodes = set()
    for key, payload in (informers or {}).items():
        if key.partition("|")[2] != "Node":
            continue
        objs = [
            o
            for o in (payload.get("objects") or [])
            if keep_node(o.get("metadata", {}).get("name", ""), o)
        ]
        kept_nodes.update(
            o.get("metadata", {}).get("name", "") for o in objs
        )
        out[key] = dict(payload, objects=objs)
    for key, payload in (informers or {}).items():
        kind = key.partition("|")[2]
        if kind == "Node":
            continue
        if kind == "Pod":
            out[key] = dict(
                payload,
                objects=[
                    o
                    for o in (payload.get("objects") or [])
                    if not o.get("spec", {}).get("nodeName")
                    or o["spec"]["nodeName"] in kept_nodes
                ],
            )
        else:
            out[key] = payload
    return out


def export_state(client, reconciler, namespace: str = "") -> Dict[str, Any]:
    """Assemble the journal payload from a live operator: informer
    snapshots (when the client is cache-backed), the render cache, and
    the apply-set membership. Sharded operators journal the WHOLE world
    (only the shard-0 owner may save); per-shard slicing happens at
    LOAD time via ``journal_shard_slice``."""
    payload: Dict[str, Any] = {"namespace": namespace}
    export = getattr(client, "export_state", None)
    if callable(export):
        payload["informers"] = export()
    ctrl = getattr(reconciler, "ctrl", None)
    if ctrl is not None:
        payload["render_cache"] = ctrl.render_cache.export()
        payload["applyset"] = [list(k) for k in ctrl.applyset.members()]
    return payload


def seed_state(client, reconciler, payload: Dict[str, Any]) -> Dict[str, int]:
    """Apply a loaded journal to a not-yet-started operator. Returns
    what was seeded, for the startup log / warm bench."""
    out = {"informer_kinds": 0, "render_entries": 0, "applyset_members": 0}
    if not payload:
        return out
    seed = getattr(client, "seed_from", None)
    if callable(seed) and payload.get("informers"):
        out["informer_kinds"] = seed(payload["informers"])
    ctrl = getattr(reconciler, "ctrl", None)
    if ctrl is not None:
        rc = payload.get("render_cache")
        if rc:
            out["render_entries"] = ctrl.render_cache.seed(rc)
        members = payload.get("applyset")
        if members:
            from tpu_operator_torch.kube.apply import ApplySet

            ctrl.applyset = ApplySet(tuple(m) for m in members)
            out["applyset_members"] = len(members)
    return out
