"""Watch-backed informer cache — the reconcile read path.

The port's copy of ``tpu_operator/kube/cache.py``. The cluster-wide Pod
informer keeps operand pods and pods that request ``nvidia.com/gpu``
(``selector.pod_requests_gpu``); reads hand out the frozen views of
``kube/frozen.py``, zero-copy unless the caller asks ``copy=True``.

The operator this models serves every ``Get``/``List`` from
controller-runtime's shared, watch-fed cache (its ``main.go:88-108``
wires the manager's cache; the watches at
``controllers/clusterpolicy_controller.go:317-344`` keep it warm). Without
it, one reconcile pass re-LISTs Nodes per DaemonSet readiness check,
re-LISTs them again for labeling, slice aggregation and upgrade
``build_state``, and fetches all pods per node — O(states × nodes)
apiserver reads per pass, a different complexity class than the
reference at fleet scale.

``CachedClient`` wraps any ``Client`` (the production ``RestClient`` or
the ``FakeClient`` double) and serves reads for the operator's hot kinds
from per-kind in-memory stores fed by list+watch streams:

* **reads** (``get``/``list``) come from the informer store once that
  kind is synced; unsynced/uncached kinds pass through live, so the
  wrapper is a transparent proxy until ``start_informers`` runs;
* **writes** pass through and write-through the store with the
  apiserver's response (the new resourceVersion), so the common
  read-your-write patterns (apply → readiness check) see fresh data
  without waiting a watch round-trip;
* **event hooks** observe every watch event *after* the store is
  updated — the manager feeds its workqueue from the same streams that
  keep the cache warm (one set of watches, exactly like
  controller-runtime), and a reconcile triggered by an event can never
  read a cache older than that event;
* a per-object resourceVersion monotonicity guard drops stale events
  racing write-throughs.

Writers that need read-modify-write freshness use ``get_live`` — the
conflict-retry path of ``mutate_with_retry`` re-GETs live after a 409,
keeping the shared-Node discipline correct under a cache.
"""

from __future__ import annotations

import copy
import logging
import threading
from bisect import bisect_left, insort
from time import perf_counter
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from tpu_operator_torch.kube.client import (
    Client,
    ConflictError,
    NotFoundError,
    Obj,
    match_fields,
    match_labels,
    obj_key,
)
from tpu_operator_torch.kube.frozen import (  # noqa: F401  (re-exported API)
    FrozenObjectError,
    freeze,
    thaw,
)

log = logging.getLogger("gpu-operator.cache")

# (api_version, kind, namespace) — namespace "" means cluster-scoped or
# all-namespaces. One watch stream per entry. The set mirrors what one
# reconcile pass actually reads (state machine, object controls, upgrade
# FSM, slice aggregation); Lease is deliberately NOT cached — leader
# election must read live or two replicas could both believe they hold
# an expired lease.
def default_cache_specs(
    api_version: str, namespace: str
) -> List[Tuple[str, str, str]]:
    return [
        (api_version, "ClusterPolicy", ""),
        ("v1", "Node", ""),
        ("v1", "Namespace", ""),
        ("apps/v1", "DaemonSet", namespace),
        # Pods cluster-wide, not namespace-scoped: the upgrade engine's
        # drain and wait-for-jobs sweeps list GPU pods across ALL
        # namespaces (user workloads live anywhere), and a namespaced
        # informer would push those hot-loop reads back to live LISTs
        ("v1", "Pod", ""),
        ("v1", "Service", namespace),
        ("v1", "ServiceAccount", namespace),
        ("v1", "ConfigMap", namespace),
        ("v1", "Event", namespace),
        ("rbac.authorization.k8s.io/v1", "Role", namespace),
        ("rbac.authorization.k8s.io/v1", "RoleBinding", namespace),
        ("rbac.authorization.k8s.io/v1", "ClusterRole", ""),
        ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding", ""),
        ("node.k8s.io/v1", "RuntimeClass", ""),
        ("policy/v1beta1", "PodSecurityPolicy", ""),
        ("monitoring.coreos.com/v1", "ServiceMonitor", namespace),
        ("monitoring.coreos.com/v1", "PrometheusRule", namespace),
    ]


def default_index_spec(kind: str) -> Dict[str, Tuple[str, ...]]:
    """Per-kind indexer wiring (client-go registers field/label indexers
    per informer the same way). The hot selector lists of one reconcile
    pass are: operand pods by ``app`` (OnDelete readiness, upgrade FSM,
    validator sweeps), pods by ``spec.nodeName`` (drain/maintenance
    sweeps), and nodes by operator labels (DaemonSet nodeSelector match
    counts, deploy-label bus queries). The operator-label PREFIX entry
    makes the node index authoritative for every ``tpu.k8s.io/...`` key."""
    from tpu_operator_torch import consts

    if kind == "Pod":
        return {
            "index_label_keys": ("app",),
            "index_fields": ("spec.nodeName",),
        }
    if kind == "Node":
        # the GKE node-pool key joins the operator-label prefix: the
        # keyed slice sub-reconcile (controllers/delta.py) resolves one
        # slice's membership by selector — explicit tpu.k8s.io/ slice-id
        # label (prefix-covered) or the node-pool fallback — in
        # O(members) instead of scanning the fleet per event
        return {
            "index_label_keys": (consts.GKE_NODEPOOL_LABEL,),
            "index_label_prefixes": (consts.GROUP + "/",),
        }
    return {}


def pod_scope_filter(namespace: str) -> Callable[[Obj], bool]:
    """Scope predicate for the cluster-wide Pod informer: keep operand
    pods (the operator's namespace) and GPU-requesting workload pods
    anywhere — everything the reconcile/upgrade/slice paths actually read
    (the upgrade engine's node sweep filters to GPU pods,
    ``object_controls``/``slice_status`` read namespace pods). On a
    populated cluster (10k+ unrelated pods) an unscoped mirror is
    unbounded operator memory; the reference scopes its pod reads with a
    label selector (vendor/.../upgrade/upgrade_state.go:160-212), this is
    the same idea expressed as a cache filter (controller-runtime
    ByObject selector)."""
    from tpu_operator_torch.kube.selector import pod_requests_gpu

    def keep(pod: Obj) -> bool:
        if pod.get("metadata", {}).get("namespace", "") == namespace:
            return True
        return pod_requests_gpu(pod)

    return keep


def _slim(obj: Obj) -> Obj:
    """Frozen store form: a private READ-ONLY copy minus
    ``metadata.managedFields`` — on a real apiserver that block often
    outweighs the object itself, nothing in the operator reads it, and
    controller-runtime's cache strips it for the same reason
    (DefaultTransform). Frozen because reads now hand out the stored
    object itself (zero-copy, like client-go's shared cache); mutation
    of a view raises ``FrozenObjectError``."""
    meta = obj.get("metadata")
    if isinstance(meta, dict) and "managedFields" in meta:
        obj = dict(obj)
        obj["metadata"] = {
            k: v for k, v in meta.items() if k != "managedFields"
        }
    return freeze(obj)


def _monotonic() -> float:
    import time

    return time.monotonic()


# graveyard entries only need to outlive one resync pass; keep them well
# past any sane resync interval's LIST duration, then let resync prune
GRAVEYARD_TTL_S = 600.0

# the DELETED ingest path also prunes (resync may be disabled with
# INFORMER_RESYNC_INTERVAL_S=0, and the churny Event informer would then
# grow the graveyard for the process lifetime); a time-gate amortises the
# O(len) scan so a delete storm doesn't go quadratic
GRAVEYARD_PRUNE_EVERY_S = 60.0

# consecutive NotFound LIST passes required before resync accepts "kind
# not served" as authoritative emptiness — a single transient 404 (CRD
# re-registration, apiserver discovery flap) must not flush a kind's
# store and storm the workqueue with DELETED repairs
RESYNC_NOTFOUND_STREAK = 2


def _rv_int(obj: Obj) -> Optional[int]:
    """resourceVersion as an int, or None when non-numeric.

    The Kubernetes API contract treats resourceVersion as OPAQUE; numeric
    ordering is an etcd implementation detail that happens to hold on
    every etcd-backed apiserver (and on kubesim, which mints integers).
    The monotonicity guards below lean on that detail deliberately — it
    is what client-go's watch cache does too — and degrade safely where
    it doesn't hold: a non-numeric rv returns None here and every guard
    treats None as "can't compare", falling back to last-write-wins."""
    rv = obj.get("metadata", {}).get("resourceVersion")
    try:
        return int(rv)
    except (TypeError, ValueError):
        return None


class Informer:
    """One kind's watch-fed store. Thread-safe; ``synced`` is set after
    the first full list has been delivered."""

    def __init__(
        self,
        api_version: str,
        kind: str,
        namespace: str,
        keep: Optional[Callable[[Obj], bool]] = None,
        index_label_keys: Iterable[str] = (),
        index_label_prefixes: Iterable[str] = (),
        index_fields: Iterable[str] = (),
    ):
        self.api_version = api_version
        self.kind = kind
        self.namespace = namespace
        # scope filter (controller-runtime cache ByObject selector
        # analogue): objects failing ``keep`` are never stored — on a
        # populated cluster the cluster-wide Pod informer would otherwise
        # mirror every unrelated pod into operator memory, where the
        # reference scopes its pod reads by selector
        # (vendor/.../upgrade/upgrade_state.go:160-212)
        self.keep = keep
        self.synced = threading.Event()
        # objects repaired by resync() because the store disagreed with a
        # fresh LIST — each one is a watch event this informer never got
        self.drift_repairs = 0
        self._lock = threading.Lock()
        self._store: Dict[Tuple[str, str], Obj] = {}  # (ns, name) -> obj
        # client-go-style indexers: exact-value selector terms over the
        # configured label keys/prefixes and field paths are answered
        # from these buckets in O(result) instead of O(store). A prefix
        # entry makes the index AUTHORITATIVE for every label key under
        # it (an empty bucket then correctly means "no object matches").
        self._idx_label_keys: Set[str] = set(index_label_keys)
        self._idx_label_prefixes: Tuple[str, ...] = tuple(index_label_prefixes)
        self._idx_fields: Tuple[str, ...] = tuple(index_fields)
        self._label_index: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        self._field_index: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        # store keys in sorted order, maintained incrementally (bisect on
        # single-event ingest, one rebuild after a bulk replace/resync)
        # so list() never re-sorts the whole store per call
        self._sorted_keys: List[Tuple[str, str]] = []
        self._sorted_ok = True
        # read-path counters (exported via CachedClient.read_stats)
        self.gets = 0
        self.lists = 0
        self.list_seconds = 0.0
        self.indexed_lists = 0
        self.copied_reads = 0
        # monotonic store mutation counter: bumped whenever the mirrored
        # state changes (event ingest, seed, resync repair, write-through).
        # Pass-scoped memos key on it to skip pure recomputation over an
        # unchanged world (state_manager's label scan, slice aggregation)
        self.store_version = 0
        # deletions observed before the initial seed lands: a concurrent
        # DELETED between list() and replace() must not be resurrected by
        # the older snapshot
        self._tombstones: Dict[Tuple[str, str], int] = {}
        # stream resume position (client-go LastSyncResourceVersion):
        # advanced by every watch event AND bookmark, so a QUIET kind's
        # journal resume point tracks the collection head instead of its
        # own (ancient) max object rv — which the apiserver compacts past
        # within minutes, turning every warm resume into a 410 re-list
        self._resume_rv = 0
        # recent deletions (key -> (rv, monotonic)) consulted by resync's
        # ADDED-repair direction: an object deleted between the resync
        # LIST being cut and the repair pass must not be resurrected from
        # the stale snapshot (the delete guard has list_rv; this is its
        # symmetric add guard). Pruned on a timer — entries only need to
        # outlive one resync pass.
        self._graveyard: Dict[Tuple[str, str], Tuple[Optional[int], float]] = {}
        # graveyard keys whose tombstone came from the SCOPE predicate
        # (the object exists, it just is not ours) rather than a real
        # DELETE: a widened scope (shard takeover adopt) may revive
        # these, never the real-delete class
        self._scope_dropped: Set[Tuple[str, str]] = set()
        self._graveyard_next_prune = 0.0

    # -- store bookkeeping (caller holds ``_lock``) ----------------------
    def _covers_label(self, key: str) -> bool:
        return key in self._idx_label_keys or key.startswith(
            self._idx_label_prefixes
        )

    def _index_entries(
        self, obj: Obj
    ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
        labels = obj.get("metadata", {}).get("labels") or {}
        lab = [
            (k, str(v)) for k, v in labels.items() if self._covers_label(k)
        ]
        flds = []
        for path in self._idx_fields:
            cur: object = obj
            for part in path.split("."):
                if not isinstance(cur, dict) or part not in cur:
                    cur = None
                    break
                cur = cur[part]
            if cur is not None and not isinstance(cur, (dict, list)):
                flds.append((path, str(cur)))
        return lab, flds

    def _unindex_locked(self, key: Tuple[str, str], obj: Obj) -> None:
        lab, flds = self._index_entries(obj)
        for index, entries in (
            (self._label_index, lab),
            (self._field_index, flds),
        ):
            for e in entries:
                bucket = index.get(e)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del index[e]

    def _set_locked(self, key: Tuple[str, str], frozen: Obj) -> None:
        self.store_version += 1
        have = self._store.get(key)
        if have is not None:
            self._unindex_locked(key, have)
        elif self._sorted_ok:
            insort(self._sorted_keys, key)
        self._store[key] = frozen
        lab, flds = self._index_entries(frozen)
        for index, entries in (
            (self._label_index, lab),
            (self._field_index, flds),
        ):
            for e in entries:
                index.setdefault(e, set()).add(key)

    def _del_locked(self, key: Tuple[str, str]) -> Optional[Obj]:
        have = self._store.pop(key, None)
        if have is None:
            return None
        self.store_version += 1
        self._unindex_locked(key, have)
        if self._sorted_ok:
            i = bisect_left(self._sorted_keys, key)
            if i < len(self._sorted_keys) and self._sorted_keys[i] == key:
                del self._sorted_keys[i]
        return have

    def _sorted_keys_locked(self) -> List[Tuple[str, str]]:
        if not self._sorted_ok:
            self._sorted_keys = sorted(self._store)
            self._sorted_ok = True
        return self._sorted_keys

    def _prune_graveyard_locked(self, now: float) -> None:
        """TTL-expire graveyard entries; caller holds ``_lock``."""
        for k in [
            k
            for k, (_, t) in self._graveyard.items()
            if now - t > GRAVEYARD_TTL_S
        ]:
            del self._graveyard[k]
            self._scope_dropped.discard(k)

    # -- event ingestion -------------------------------------------------
    def on_event(self, etype: str, obj: Obj) -> None:
        meta = obj.get("metadata", {})
        key = (meta.get("namespace", ""), meta.get("name", ""))
        if not key[1]:
            return
        scope_drop = False
        if etype != "DELETED" and self.keep is not None and not self.keep(obj):
            # out of scope — and an in-scope object mutated OUT of scope
            # must leave the store, like a label-selector cache would drop
            # it (fall through to the DELETED path if we hold it).
            # PRE-sync the fall-through must happen even on a store miss:
            # the DELETED path records the tombstone that stops replace()
            # from reseeding the snapshot's stale in-scope version.
            # scope_drop marks the tombstone's CLASS: the object exists,
            # it is just not ours — adopt() (shard takeover, when the
            # scope widens) may revive it, where a real-delete tombstone
            # must stay authoritative
            scope_drop = True
            etype = "DELETED"
            with self._lock:
                if self.synced.is_set() and key not in self._store:
                    self._scope_dropped.add(key)
                    return
        with self._lock:
            have = self._store.get(key)
            # monotonicity guard: a watch event older than what a
            # write-through already stored must not roll the cache back.
            # An EQUAL rv is the same revision — re-storing it would be
            # a no-op except that it bumps store_version, and a watch
            # window re-list (ADDED for every object, unchanged rvs)
            # would then invalidate every version-keyed memo fleet-wide
            # (the 1000-node label/slice scans) once per window.
            if have is not None:
                old_rv, new_rv = _rv_int(have), _rv_int(obj)
                if old_rv is not None and new_rv is not None:
                    if new_rv < old_rv:
                        return
                    if new_rv == old_rv and etype != "DELETED":
                        return
            if etype == "DELETED":
                self._del_locked(key)
                now = _monotonic()
                if now >= self._graveyard_next_prune:
                    self._graveyard_next_prune = now + GRAVEYARD_PRUNE_EVERY_S
                    self._prune_graveyard_locked(now)
                self._graveyard[key] = (_rv_int(obj), now)
                # a REAL delete overrides any earlier scope-drop class
                (
                    self._scope_dropped.add
                    if scope_drop
                    else self._scope_dropped.discard
                )(key)
                if not self.synced.is_set():
                    self._tombstones[key] = _rv_int(obj) or 0
            elif etype in ("ADDED", "MODIFIED"):
                self._set_locked(key, _slim(obj))
                self._scope_dropped.discard(key)

    def replace(self, objs: List[Obj]) -> None:
        """Guarded seed from an initial list. Events may already have
        flowed (subscription precedes the list so nothing is missed):
        newer store entries win over the snapshot, and keys deleted since
        the snapshot was taken stay deleted."""
        if self.keep is not None:
            objs = [o for o in objs if self.keep(o)]
        with self._lock:
            self._sorted_ok = False  # bulk seed: one rebuild at the end
            for o in objs:
                meta = o.get("metadata", {})
                key = (meta.get("namespace", ""), meta.get("name", ""))
                rv = _rv_int(o)
                dead_rv = self._tombstones.get(key)
                if dead_rv is not None and (rv is None or rv <= dead_rv):
                    continue  # deleted after this snapshot was cut
                have = self._store.get(key)
                if have is not None:
                    old_rv = _rv_int(have)
                    if old_rv is not None and rv is not None and rv < old_rv:
                        continue  # a live event already delivered newer state
                self._set_locked(key, _slim(o))
            self._tombstones.clear()
            self._sorted_keys_locked()
        self.synced.set()

    def resync(
        self, objs: List[Obj], list_rv: Optional[int] = None
    ) -> List[Tuple[str, Obj]]:
        """Repair the store against a fresh LIST (client-go reflector
        resync semantics: the watch stream is trusted but verified). A
        bounded watch window restart catches a DEAD stream; only a
        re-list catches a stream that silently swallowed one event.
        Returns the repair events applied, for hook re-dispatch:

        * fresh object missing from the store        -> ADDED repair
        * fresh object newer than the store's        -> MODIFIED repair
        * store object absent from the list and not
          newer than the list snapshot               -> DELETED repair

        ``list_rv`` (the List response's collection resourceVersion)
        guards deletes: a store entry written through AFTER the snapshot
        was cut (rv > list_rv) is not drift, just a faster write path.
        Repairs observed during active churn may include events still in
        flight on the watch stream — harmless (idempotent), so the
        drift_repairs metric is meaningful in quiescence, not mid-storm."""
        if self.keep is not None:
            objs = [o for o in objs if self.keep(o)]
        repairs: List[Tuple[str, Obj]] = []
        with self._lock:
            fresh: Dict[Tuple[str, str], Obj] = {}
            for o in objs:
                meta = o.get("metadata", {})
                key = (meta.get("namespace", ""), meta.get("name", ""))
                if key[1]:
                    fresh[key] = o
            self._prune_graveyard_locked(_monotonic())
            self._sorted_ok = False  # bulk repair: one rebuild at the end
            for key, o in fresh.items():
                have = self._store.get(key)
                if have is None:
                    dead = self._graveyard.get(key)
                    if dead is not None:
                        dead_rv, o_rv = dead[0], _rv_int(o)
                        if (
                            dead_rv is None
                            or o_rv is None
                            or o_rv <= dead_rv
                        ):
                            # deleted at/after this snapshot version —
                            # re-adding it would resurrect a ghost the
                            # watch already buried (no further event
                            # would ever remove it again)
                            continue
                    self._set_locked(key, _slim(o))
                    repairs.append(("ADDED", o))
                    continue
                old_rv, new_rv = _rv_int(have), _rv_int(o)
                if old_rv is not None and new_rv is not None:
                    if new_rv > old_rv:
                        self._set_locked(key, _slim(o))
                        repairs.append(("MODIFIED", o))
                elif have != _slim(o):
                    # opaque rvs: can't order, repair on inequality
                    self._set_locked(key, _slim(o))
                    repairs.append(("MODIFIED", o))
            for key in [k for k in self._store if k not in fresh]:
                have = self._store[key]
                have_rv = _rv_int(have)
                if (
                    list_rv is not None
                    and have_rv is not None
                    and have_rv > list_rv
                ):
                    continue  # created after the snapshot; watch will tell
                self._del_locked(key)
                repairs.append(("DELETED", have))
            self.drift_repairs += len(repairs)
            self._sorted_keys_locked()
        return repairs

    def adopt(self, obj: Obj) -> bool:
        """Journal-seed ONE object into a RUNNING store via the normal
        ingest path, honoring deletion tombstones (``resync``'s rule):
        a journal snapshot older than a watch-delivered DELETE must not
        resurrect the object — ``on_event('ADDED')`` alone would, since
        only replace/resync consult the graveyard. Returns whether the
        object was newly adopted."""
        meta = obj.get("metadata", {})
        key = (meta.get("namespace", ""), meta.get("name", ""))
        with self._lock:
            dead = self._graveyard.get(key)
            # a SCOPE-class tombstone never blocks adoption: the keep
            # predicate dropped the object because it wasn't ours, and
            # the adopt is happening precisely because the scope just
            # widened (shard takeover) — only a real watch-delivered
            # DELETE is authoritative against a journal snapshot
            if key in self._scope_dropped:
                dead = None
            before = key in self._store
        if dead is not None and not before:
            dead_rv, o_rv = dead[0], _rv_int(obj)
            if dead_rv is None or o_rv is None or o_rv <= dead_rv:
                return False  # deleted at/after the journal snapshot
        self.on_event("ADDED", obj)
        with self._lock:
            return not before and key in self._store

    def refilter(self) -> int:
        """Re-apply the keep predicate over the whole store — for
        DYNAMIC scope predicates (sharded scale-out: a lost shard's
        nodes leave this replica's mirror at handoff instead of aging
        out event-by-event). Keep runs OUTSIDE the store lock (the
        shard predicate takes its own lock; no nested order edge)."""
        if self.keep is None:
            return 0
        with self._lock:
            items = list(self._store.items())
        drop = [k for k, o in items if not self.keep(o)]
        if not drop:
            return 0
        n = 0
        with self._lock:
            for k in drop:
                if self._del_locked(k) is not None:
                    n += 1
            self._sorted_keys_locked()
        return n

    # -- reads -----------------------------------------------------------
    def get(self, name: str, namespace: str = "", copy: bool = False) -> Obj:
        """Read one object. Default is a SHARED read-only view of the
        stored object (zero-copy; mutation raises ``FrozenObjectError``);
        ``copy=True`` returns a private mutable copy for
        read-modify-write callers."""
        with self._lock:
            obj = self._store.get((namespace or "", name))
            if obj is None:
                raise NotFoundError(
                    f"{self.kind} {namespace}/{name} not found (cache)"
                )
            self.gets += 1
            if copy:
                self.copied_reads += 1
                return thaw(obj)
            return obj

    def _candidate_keys_locked(
        self, label_selector, field_selector
    ) -> Optional[Set[Tuple[str, str]]]:
        """Smallest index-bucket intersection answering the selector, or
        None when no indexed term applies (full scan). Only exact-value
        terms are index-eligible; the caller still runs the full match on
        the candidates, so a partial index narrowing stays correct."""
        buckets: List[Set[Tuple[str, str]]] = []
        if isinstance(label_selector, dict):
            for k, v in label_selector.items():
                if k.startswith("!") or not self._covers_label(k):
                    continue
                if v is None or isinstance(v, (list, tuple)):
                    continue
                v = str(v)
                if not v or "*" in v:
                    continue
                buckets.append(self._label_index.get((k, v), set()))
        if isinstance(field_selector, dict):
            for path, v in field_selector.items():
                if path in self._idx_fields:
                    buckets.append(
                        self._field_index.get((path, str(v)), set())
                    )
        if not buckets:
            return None
        buckets.sort(key=len)
        out = buckets[0]
        for b in buckets[1:]:
            out = out & b
            if not out:
                break
        return out

    def list(
        self,
        namespace: str = "",
        label_selector=None,
        field_selector=None,
        copy: bool = False,
    ) -> List[Obj]:
        """List in stable (namespace, name) order. Default returns SHARED
        read-only views (zero-copy); ``copy=True`` thaws each result.
        Exact-value selector terms over indexed label keys/field paths
        are served from index buckets in O(result)."""
        t0 = perf_counter()
        with self._lock:
            candidates = self._candidate_keys_locked(
                label_selector, field_selector
            )
            if candidates is None:
                keys: Iterable[Tuple[str, str]] = self._sorted_keys_locked()
            else:
                self.indexed_lists += 1
                keys = sorted(candidates)
            out = []
            for key in keys:
                obj = self._store.get(key)
                if obj is None:
                    continue  # raced by a test poking _store directly
                if namespace and key[0] != namespace:
                    continue
                if not match_labels(obj, label_selector):
                    continue
                if field_selector and not match_fields(obj, field_selector):
                    continue
                out.append(thaw(obj) if copy else obj)
            self.lists += 1
            if copy:
                self.copied_reads += len(out)
            self.list_seconds += perf_counter() - t0
            return out

    def note_progress(self, rv) -> None:
        """Record the watch stream's position (event or bookmark rv).
        Monotonic — a racing older report can't rewind the resume point."""
        try:
            rv = int(rv)
        except (TypeError, ValueError):
            return
        with self._lock:
            if rv > self._resume_rv:
                self._resume_rv = rv

    def export(self) -> Tuple[List[Obj], int]:
        """Snapshot for the warm-restart journal: private mutable copies
        of every stored object plus the stream's resume position — the
        bookmark-advanced rv where a warm watch picks up (falling back
        to the max stored object rv when no stream ever reported)."""
        with self._lock:
            objs = [thaw(self._store[k]) for k in self._sorted_keys_locked()]
            max_rv = max(
                (_rv_int(o) or 0 for o in self._store.values()), default=0
            )
            return objs, max(self._resume_rv, max_rv)

    def read_stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "gets": self.gets,
                "lists": self.lists,
                "list_seconds": round(self.list_seconds, 6),
                "indexed_lists": self.indexed_lists,
                "copied_reads": self.copied_reads,
            }

    def __len__(self):
        with self._lock:
            return len(self._store)


class CachedClient(Client):
    """``Client`` whose reads are served from watch-fed informers.

    Transparent proxy until ``start_informers`` has synced a kind; after
    that, ``get``/``list`` for cached kinds never touch the apiserver.
    """

    def __init__(
        self,
        client: Client,
        namespace: str = "",
        specs: Optional[List[Tuple[str, str, str]]] = None,
        resync_interval_s: float = 300.0,
        keep_overrides: Optional[Dict[str, Callable[[Obj], bool]]] = None,
        world_scoped: Iterable[str] = ("Node",),
    ):
        """``keep_overrides``: per-KIND scope predicates composed (AND)
        with the defaults — the sharded operator scopes its Node and Pod
        mirrors to owned shards this way (controller-runtime ByObject
        selector, expressed dynamically).

        ``world_scoped``: kinds whose keep-override-scoped store IS the
        authoritative world view for this replica (reads never fall
        through live on account of the filter). The sharded Node mirror
        is the canonical case: a scoped replica's "fleet" is by design
        its shards — falling through would re-LIST the whole cluster on
        every pass, the exact cost sharding removes. Only consulted for
        kinds carrying a keep override."""
        from tpu_operator_torch import consts

        self.live = client
        self.namespace = namespace
        self._world_scoped = frozenset(world_scoped or ())
        self._keep_overridden = frozenset(keep_overrides or ())
        # client-go reflector resync analogue: every interval each synced
        # informer re-LISTs and repairs divergence (a dropped/misdelivered
        # watch event becomes a bounded-staleness incident with a metric,
        # not permanent drift). 0 disables the background loop
        # (resync_once stays available for tests).
        self.resync_interval_s = resync_interval_s
        if specs is None:
            specs = default_cache_specs(consts.API_VERSION, namespace)
        def _keep_for(kind: str, ns: str):
            base = (
                pod_scope_filter(namespace)
                if kind == "Pod" and not ns and namespace
                else None
            )
            extra = (keep_overrides or {}).get(kind)
            if extra is None:
                return base
            if base is None:
                return extra
            return lambda obj, _b=base, _e=extra: _b(obj) and _e(obj)

        self._informers: Dict[Tuple[str, str], Informer] = {
            (av, kind): Informer(
                av,
                kind,
                ns,
                keep=_keep_for(kind, ns),
                **default_index_spec(kind),
            )
            for av, kind, ns in specs
        }
        self._hooks: List[Callable[[str, Obj], None]] = []
        # (av, kind) -> (resume rv, known keys) installed by seed_from:
        # a warm-restarted informer opens its watch AT the journal's
        # resourceVersion instead of re-LISTing the world
        self._warm_seed: Dict[Tuple[str, str], Tuple[str, set]] = {}
        self._started = False
        self._threads: List[threading.Thread] = []
        # owned by this cache so stop() works even when the caller never
        # passes a stop_event (controller-runtime's manager owns its
        # cache's shutdown the same way, main.go:88-108);
        # start_informers links a caller-provided event to this one
        self._stop_event = threading.Event()
        # per-kind consecutive NotFound LIST passes (see
        # RESYNC_NOTFOUND_STREAK)
        self._notfound_streak: Dict[Tuple[str, str], int] = {}
        # one resync pass at a time: overlapping passes (background
        # thread + an explicit caller) would widen the stale-snapshot
        # race the graveyard guard narrows
        self._resync_lock = threading.Lock()

    # -- wiring ----------------------------------------------------------
    def add_event_hook(self, fn: Callable[[str, Obj], None]) -> None:
        """``fn(event_type, obj)`` runs after the cache ingested the
        event — the workqueue feed rides the same streams as the cache."""
        self._hooks.append(fn)

    def _dispatch_hooks(self, etype: str, obj: Obj, kind: str) -> None:
        for fn in list(self._hooks):
            try:
                fn(etype, obj)
            except Exception:
                log.exception("cache event hook failed for %s %s", etype, kind)

    def _dispatch(self, inf: Informer, etype: str, obj: Obj) -> None:
        inf.on_event(etype, obj)
        self._dispatch_hooks(etype, obj, inf.kind)

    def start_informers(
        self, stop_event: Optional[threading.Event] = None, timeout_s: float = 30.0
    ) -> bool:
        """Warm the cache before the first reconcile. Returns whether all
        informers synced within ``timeout_s`` (on False the unsynced kinds
        keep passing reads through live — degraded, never wrong)."""
        if self._started:
            return True
        self._started = True
        if stop_event is not None and stop_event is not self._stop_event:
            # all internal threads observe the OWNED event so stop() works
            # regardless of who started us; a linker mirrors the caller's
            # event in. It polls rather than waits forever: if the cache
            # is stopped directly the linker must exit too, not pin the
            # CachedClient (and every informer store) for the process
            # lifetime. Stays off _threads — join would race the poll.
            def _link():
                while not stop_event.wait(1.0):
                    if self._stop_event.is_set():
                        return
                self._stop_event.set()

            threading.Thread(
                target=_link, daemon=True, name="cache-stop-link"
            ).start()
        if hasattr(self.live, "add_watcher"):
            # FakeClient: synchronous in-process events; seed then subscribe
            def fan_out(etype, obj):
                if self._stop_event.is_set():
                    return
                inf = self._informers.get(
                    (obj.get("apiVersion", ""), obj.get("kind", ""))
                )
                if inf is not None:
                    self._dispatch(inf, etype, obj)

            self.live.add_watcher(fan_out)
            for (av, kind), inf in self._informers.items():
                inf.replace(self.live.list(av, kind, inf.namespace))
            self._start_resync_thread(self._stop_event)
            return True
        if not hasattr(self.live, "watch"):
            log.warning("underlying client has no watch; cache stays passthrough")
            return False
        for (av, kind), inf in self._informers.items():
            kwargs = {
                "namespace": inf.namespace,
                "stop_event": self._stop_event,
                "on_sync": inf.synced.set,
                "on_progress": inf.note_progress,
                # rest.WATCH_WINDOW_S windows bound SILENT staleness:
                # a watch whose server half died without closing the
                # socket freezes this informer until the socket times
                # out, and a frozen Node cache can pin the upgrade
                # budget on ghost nodes
            }
            seed = self._warm_seed.get((av, kind))
            if seed is not None:
                # warm restart: stream from the journal rv, no re-list
                # (a 410 inside watch() falls back to a normal list)
                kwargs["seed_rv"], kwargs["seed_known"] = seed
            t = threading.Thread(
                target=self.live.watch,
                args=(av, kind, lambda e, o, i=inf: self._dispatch(i, e, o)),
                kwargs=kwargs,
                daemon=True,
                name=f"informer-{kind}",
            )
            t.start()
            self._threads.append(t)
        self._start_resync_thread(self._stop_event)
        deadline = timeout_s
        ok = True
        import time as _time

        t0 = _time.monotonic()
        for (_, kind), inf in self._informers.items():
            remaining = max(0.0, deadline - (_time.monotonic() - t0))
            if not inf.synced.wait(remaining):
                log.warning("informer for %s not synced after %.0fs", kind, timeout_s)
                ok = False
        return ok

    def _start_resync_thread(self, stop_event: threading.Event) -> None:
        if not self.resync_interval_s:
            return

        def loop():
            while not stop_event.wait(self.resync_interval_s):
                try:
                    self.resync_once(stop_event)
                except Exception:
                    log.exception("informer resync pass failed")

        t = threading.Thread(target=loop, daemon=True, name="informer-resync")
        t.start()
        self._threads.append(t)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Graceful cache shutdown: signal every informer watch loop and
        the resync loop, then JOIN them so no thread LISTs a dead server
        after the caller tears its fixture (or process) down —
        controller-runtime's manager stops its cache the same way before
        returning from Start (main.go:88-108). Idempotent;
        safe to call even if start_informers never ran."""
        self._stop_event.set()
        deadline = _monotonic() + timeout_s
        for t in self._threads:
            t.join(max(0.0, deadline - _monotonic()))
        leftover = [t.name for t in self._threads if t.is_alive()]
        if leftover:
            # daemon threads: they cannot outlive the process, but a
            # watch blocked inside a socket read can outlast the join
            # budget — report it rather than hang shutdown
            log.warning("cache stop timed out waiting for: %s", leftover)
        self._threads = [t for t in self._threads if t.is_alive()]

    def _list_live_with_rv(
        self, api_version: str, kind: str, namespace: str
    ) -> Tuple[List[Obj], Optional[int]]:
        if hasattr(self.live, "list_with_rv"):
            items, rv = self.live.list_with_rv(api_version, kind, namespace)
            try:
                return items, int(rv)
            except (TypeError, ValueError):
                return items, None
        return self.live.list(api_version, kind, namespace), None

    def resync_once(
        self,
        stop_event: Optional[threading.Event] = None,
        ignore_stop: bool = False,
    ) -> int:
        """One repair pass over every synced informer: fresh LIST, diff,
        repair, and re-dispatch repair events through the hooks so the
        workqueue reconciles anything a swallowed watch event hid.
        Returns the number of repairs applied. Concurrent calls coalesce
        (the second returns 0 immediately).

        ``ignore_stop=True`` runs the repair even after ``stop()`` froze
        the watch threads: the warm journal's FINAL save uses it so a
        clean shutdown's snapshot reflects the live world, not whatever
        watch backlog was un-ingested at freeze time (a busy stop could
        otherwise journal a world a few events behind, and the restarted
        operator's resume-rv replay would pay warm-start writes for
        state that never actually changed)."""
        from tpu_operator_torch.kube.client import NotFoundError as _NF

        if not self._resync_lock.acquire(blocking=False):
            return 0
        try:
            return self._resync_once_locked(stop_event, _NF, ignore_stop)
        finally:
            self._resync_lock.release()

    def _resync_once_locked(self, stop_event, _NF, ignore_stop=False) -> int:
        def stopping() -> bool:
            if ignore_stop:
                return False
            return self._stop_event.is_set() or (
                stop_event is not None and stop_event.is_set()
            )

        total = 0
        for (av, kind), inf in self._informers.items():
            if stopping():
                return total  # shutting down: don't log list noise
            if not inf.synced.is_set():
                continue
            try:
                objs, list_rv = self._list_live_with_rv(av, kind, inf.namespace)
                self._notfound_streak.pop((av, kind), None)
            except _NF:
                # kind not served — but only a *streak* of NotFounds is
                # authoritative emptiness; one transient 404 (CRD
                # re-registration, discovery flap) must not flush the
                # store and dispatch a DELETED storm
                streak = self._notfound_streak.get((av, kind), 0) + 1
                self._notfound_streak[(av, kind)] = streak
                if streak < RESYNC_NOTFOUND_STREAK:
                    log.warning(
                        "resync list for %s returned NotFound (%d/%d); "
                        "skipping until the streak confirms it",
                        kind,
                        streak,
                        RESYNC_NOTFOUND_STREAK,
                    )
                    continue
                objs, list_rv = [], None
            except Exception:
                if stopping():
                    return total  # shutdown race, not drift
                log.warning("resync list for %s failed; skipping", kind)
                continue
            for o in objs:
                o.setdefault("apiVersion", av)
                o.setdefault("kind", kind)
            repairs = inf.resync(objs, list_rv)
            if repairs:
                total += len(repairs)
                log.warning(
                    "informer %s drifted from live state: repaired %d "
                    "object(s) (missed watch events)",
                    kind,
                    len(repairs),
                )
                for etype, obj in repairs:
                    self._dispatch_hooks(etype, obj, kind)
        return total

    def drift_repairs_total(self) -> int:
        return sum(inf.drift_repairs for inf in self._informers.values())

    # -- fault-tolerance surface (delegates to the wrapped client, which
    # owns the wire: one policy/breaker per transport, however many
    # caching layers sit above it) ---------------------------------------
    @property
    def retry_policy(self):
        return getattr(self.live, "retry_policy", None)

    @property
    def breaker(self):
        return getattr(self.live, "breaker", None)

    def fault_stats(self):
        """Delegate to the wrapped client: RestClient's version carries
        extra transport detail (the keep-alive connection pool) the base
        retry/breaker surface doesn't know about."""
        fn = getattr(self.live, "fault_stats", None)
        if callable(fn):
            return fn()
        return super().fault_stats()

    def _informer_for(
        self, api_version: str, kind: str, namespace: str
    ) -> Optional[Informer]:
        inf = self._informers.get((api_version, kind))
        if inf is None or not inf.synced.is_set():
            return None
        # a namespaced informer can only answer for its own namespace;
        # "" (all) informers answer anything
        if inf.namespace and namespace and namespace != inf.namespace:
            return None
        if inf.namespace and not namespace:
            return None  # caller wants all namespaces; we hold one
        return inf

    def world_version(self) -> int:
        """Sum of every synced informer's store mutation counter — a
        cheap "did anything change since I last looked" key (the warm
        journal's periodic saver skips exports of an unchanged world)."""
        return sum(
            inf.store_version
            for inf in self._informers.values()
            if inf.synced.is_set()
        )

    def store_version(self, api_version: str, kind: str) -> Optional[int]:
        """The kind's informer store mutation counter, or ``None`` when
        the kind has no synced informer (a memo keyed on it must then
        recompute — the safe default)."""
        inf = self._informers.get((api_version, kind))
        if inf is None or not inf.synced.is_set():
            return None
        return inf.store_version

    # -- warm restart (kube/warm.py journal) -----------------------------
    def export_state(self) -> Dict[str, Dict]:
        """Per-kind store snapshot + resume resourceVersion for the
        warm-restart journal — everything a restarted operator needs to
        reach its first steady pass without re-LISTing the world."""
        out: Dict[str, Dict] = {}
        for (av, kind), inf in self._informers.items():
            if not inf.synced.is_set():
                continue
            objs, rv = inf.export()
            out[f"{av}|{kind}"] = {
                "namespace": inf.namespace,
                "rv": rv,
                "objects": objs,
            }
        return out

    def seed_from(self, state: Dict[str, Dict]) -> int:
        """Seed informer stores from a journal snapshot BEFORE
        ``start_informers``: each seeded kind marks synced immediately
        and its watch stream resumes from the journal rv instead of
        issuing an initial LIST. Self-healing covers a stale journal —
        a compacted rv 410s into a normal re-list, and the periodic
        resync repairs drift. Returns how many kinds were seeded."""
        if self._started:
            return 0
        seeded = 0
        for key, payload in (state or {}).items():
            av, _, kind = key.partition("|")
            inf = self._informers.get((av, kind))
            if inf is None or not kind:
                continue
            objs = payload.get("objects") or []
            for o in objs:
                o.setdefault("apiVersion", av)
                o.setdefault("kind", kind)
            inf.replace(objs)
            inf.note_progress(payload.get("rv"))
            known = {
                (
                    o.get("metadata", {}).get("namespace", ""),
                    o.get("metadata", {}).get("name", ""),
                )
                for o in objs
            }
            self._warm_seed[(av, kind)] = (str(payload.get("rv") or ""), known)
            seeded += 1
        return seeded

    # -- sharded failover ------------------------------------------------
    def adopt_state(self, state: Dict[str, Dict]) -> int:
        """Fold a warm-journal informer snapshot into ALREADY-RUNNING
        stores — the journal-seeded shard handoff: a replica that just
        took over shard 0 needs the whole world in its mirror without
        re-LISTing it. Each object rides the normal ingest path
        (``on_event``), so the per-object rv monotonicity guard keeps a
        stale journal from rolling back anything a live watch already
        delivered, and the scope predicates apply. Hooks are NOT
        dispatched — the caller enqueues one full pass instead of
        storming the queue with thousands of synthetic keys. Returns
        how many objects were newly adopted."""
        adopted = 0
        for key, payload in (state or {}).items():
            av, _, kind = key.partition("|")
            inf = self._informers.get((av, kind))
            if inf is None or not kind:
                continue
            for o in payload.get("objects") or []:
                o.setdefault("apiVersion", av)
                o.setdefault("kind", kind)
                if inf.adopt(o):
                    adopted += 1
        return adopted

    def adopt_live(
        self, specs: List[Tuple[str, str, str, Optional[dict]]]
    ) -> int:
        """SCOPED live re-list adoption — the fallback when no (fresh)
        journal exists at shard handoff: each ``(api_version, kind,
        namespace, label_selector)`` is ONE server-side-filtered LIST
        (e.g. Nodes of one shard via the ``tpu.k8s.io/shard`` label)
        ingested through ``on_event``. Returns LISTs issued."""
        lists = 0
        for av, kind, ns, selector in specs:
            inf = self._informers.get((av, kind))
            if inf is None:
                continue
            try:
                objs = self.live.list(av, kind, ns, label_selector=selector)
                lists += 1
            except Exception:
                log.exception("scoped adoption list for %s failed", kind)
                continue
            for o in objs:
                o.setdefault("apiVersion", av)
                o.setdefault("kind", kind)
                inf.adopt(o)
        return lists

    def refilter_informers(self, kinds: Iterable[str] = ("Node", "Pod")) -> int:
        """Re-apply dynamic scope predicates after a shard handoff
        (lost shard's objects leave the mirror now, not event-by-event)."""
        dropped = 0
        for (_, kind), inf in self._informers.items():
            if kind in kinds:
                dropped += inf.refilter()
        return dropped

    def cache_info(self) -> Dict[str, Optional[int]]:
        """Per-kind store sizes for the debug surface; an UNSYNCED kind
        reports ``None`` (reads fall through live) — distinguishable from
        a healthy-but-empty kind's 0."""
        return {
            f"{kind}": (len(inf) if inf.synced.is_set() else None)
            for (_, kind), inf in self._informers.items()
        }

    def read_stats(self) -> Dict[str, float]:
        """Aggregated zero-copy read-path counters across every informer
        (the observability half of the zero-copy contract): total
        gets/lists served from cache, cumulative list latency, how many
        lists the indexers answered, and how many reads paid a copy
        (the explicit ``copy=True`` writers)."""
        totals = {
            "gets": 0,
            "lists": 0,
            "list_seconds": 0.0,
            "indexed_lists": 0,
            "copied_reads": 0,
        }
        for inf in self._informers.values():
            for k, v in inf.read_stats().items():
                totals[k] += v
        totals["list_seconds"] = round(totals["list_seconds"], 6)
        return totals

    # -- reads -----------------------------------------------------------
    def get(self, api_version, kind, name, namespace="", copy=False):
        inf = self._informer_for(api_version, kind, namespace)
        if inf is None:
            return self.live.get(api_version, kind, name, namespace)
        try:
            return inf.get(name, namespace, copy=copy)
        except NotFoundError:
            if inf.keep is not None and namespace != self.namespace:
                # a scoped informer cannot prove absence outside its
                # authoritative namespace: the object may exist live and
                # simply be filtered (e.g. a non-GPU pod elsewhere)
                return self.live.get(api_version, kind, name, namespace)
            raise

    def get_live(self, api_version, kind, name, namespace=""):
        """Bypass the cache — read-modify-write retry paths after a 409."""
        return self.live.get(api_version, kind, name, namespace)

    def list_live(
        self,
        api_version,
        kind,
        namespace="",
        label_selector=None,
        field_selector=None,
    ):
        """Bypass the cache — user-selector safety gates (see Client)."""
        return self.live.list(
            api_version, kind, namespace, label_selector, field_selector
        )

    def list(
        self,
        api_version,
        kind,
        namespace="",
        label_selector=None,
        field_selector=None,
        copy=False,
    ):
        inf = self._informer_for(api_version, kind, namespace)
        if inf is None:
            return self.live.list(
                api_version, kind, namespace, label_selector, field_selector
            )
        if (
            inf.keep is not None
            and namespace != self.namespace
            and not (
                kind in self._world_scoped
                and kind in self._keep_overridden
            )
        ):
            # a scope-filtered informer cannot answer a general query it
            # might hold only partially (cluster-wide or foreign-ns Pod
            # lists would be silently truncated to GPU/operand pods);
            # callers whose own filter ⊆ the scope opt in via
            # list_scoped, everyone else reads live and stays correct.
            # EXCEPT world-scoped kinds (the sharded Node mirror): their
            # truncation IS this replica's intended world view
            return self.live.list(
                api_version, kind, namespace, label_selector, field_selector
            )
        return inf.list(namespace, label_selector, field_selector, copy=copy)

    def list_scoped(
        self,
        api_version,
        kind,
        namespace="",
        label_selector=None,
        field_selector=None,
        copy=False,
    ):
        """Served from the informer even when scope-filtered — the
        caller asserts its filter ⊆ the scope (see Client.list_scoped)."""
        inf = self._informer_for(api_version, kind, namespace)
        if inf is None:
            return self.live.list(
                api_version, kind, namespace, label_selector, field_selector
            )
        return inf.list(namespace, label_selector, field_selector, copy=copy)

    # -- writes (pass through + write-through the response) --------------
    def _write_through(self, obj: Obj) -> None:
        inf = self._informers.get((obj.get("apiVersion", ""), obj.get("kind", "")))
        if inf is not None and inf.synced.is_set():
            inf.on_event("MODIFIED", obj)

    def create(self, obj):
        created = self.live.create(obj)
        if isinstance(created, dict):
            self._write_through(created)
        return created

    def update(self, obj):
        updated = self.live.update(obj)
        if isinstance(updated, dict):
            self._write_through(updated)
        return updated

    def update_status(self, obj):
        updated = self.live.update_status(obj)
        if isinstance(updated, dict):
            self._write_through(updated)
        return updated

    def patch_labels(
        self, api_version, kind, name, namespace="", labels=None,
        resource_version=None,
    ):
        updated = self.live.patch_labels(
            api_version, kind, name, namespace, labels=labels,
            resource_version=resource_version,
        )
        if isinstance(updated, dict):
            self._write_through(updated)
        return updated

    def apply_ssa(
        self, obj, field_manager=None, force=True, prune=True,
        create_only=False, update_only=False,
    ):
        """APPLY passes through to the live client (which owns the
        merge — natively or over the wire) and write-throughs the
        response, so apply → readiness-check sees fresh data without a
        watch round-trip."""
        fn = getattr(self.live, "apply_ssa", None)
        if callable(fn):
            applied = fn(
                obj, field_manager=field_manager, force=force, prune=prune,
                create_only=create_only, update_only=update_only,
            )
        else:
            applied = super().apply_ssa(
                obj, field_manager=field_manager, force=force, prune=prune,
                create_only=create_only, update_only=update_only,
            )
        if isinstance(applied, dict):
            self._write_through(applied)
        return applied

    def apply_ssa_batch(
        self, items, field_manager=None, force=True, prune=True,
        update_only=False,
    ):
        fn = getattr(self.live, "apply_ssa_batch", None)
        if callable(fn):
            results = fn(
                items, field_manager=field_manager, force=force, prune=prune,
                update_only=update_only,
            )
        else:
            results = super().apply_ssa_batch(
                items, field_manager=field_manager, force=force, prune=prune,
                update_only=update_only,
            )
        for obj, err in results:
            if err is None and isinstance(obj, dict):
                self._write_through(obj)
        return results

    def delete(self, api_version, kind, name, namespace=""):
        self.live.delete(api_version, kind, name, namespace)
        inf = self._informers.get((api_version, kind))
        if inf is not None and inf.synced.is_set():
            # immediate removal so delete→recreate flows don't trip over
            # a cached ghost; the watch DELETED event is then a no-op
            inf.on_event(
                "DELETED",
                {
                    "apiVersion": api_version,
                    "kind": kind,
                    "metadata": {"namespace": namespace, "name": name},
                },
            )

    def evict(self, name, namespace=""):
        self.live.evict(name, namespace)
        inf = self._informers.get(("v1", "Pod"))
        if inf is not None and inf.synced.is_set():
            inf.on_event(
                "DELETED",
                {
                    "apiVersion": "v1",
                    "kind": "Pod",
                    "metadata": {"namespace": namespace, "name": name},
                },
            )

    def delete_if_exists(self, api_version, kind, name, namespace=""):
        """Probe the cache before issuing the DELETE: disabled-state
        controls call this every pass for operands that were never
        deployed, and a blind DELETE-then-404 per pass defeats the O(0)
        steady state (the reference reads its cache before deleting,
        object_controls.go:3753-3761). A stale-cache miss self-heals:
        the ADDED watch event re-enqueues a reconcile."""
        inf = self._informer_for(api_version, kind, namespace)
        if inf is not None:
            try:
                inf.get(name, namespace)
            except NotFoundError:
                if inf.keep is None or namespace == self.namespace:
                    return False
                # scoped informer, foreign namespace: the miss is
                # ambiguous — fall through to the live DELETE probe
        return super().delete_if_exists(api_version, kind, name, namespace)

    def apply(self, obj):
        """Create-or-update where the existence probe may be cached: a
        stale miss turning into 409 AlreadyExists falls back to a live
        read + update instead of failing the reconcile."""
        av, kind, ns, name = obj_key(obj)
        existing = self.get_or_none(av, kind, name, ns)
        if existing is None:
            try:
                return self.create(obj)
            except ConflictError:
                existing = self.live.get(av, kind, name, ns)
        obj = copy.deepcopy(obj)
        obj.setdefault("metadata", {})["resourceVersion"] = existing[
            "metadata"
        ].get("resourceVersion")
        try:
            return self.update(obj)
        except ConflictError:
            # cached rv was stale; one live refresh, then give up to the
            # level-triggered requeue
            fresh = self.live.get(av, kind, name, ns)
            obj["metadata"]["resourceVersion"] = fresh["metadata"].get(
                "resourceVersion"
            )
            return self.update(obj)
