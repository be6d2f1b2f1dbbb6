"""Per-reconcile-pass cluster snapshot.

The port's copy of ``tpu_operator/controllers/cluster_snapshot.py``.

One reconcile pass steps 18 states, and before this existed every
state's readiness check issued its own cluster-wide reads: each
DaemonSet control re-listed all Nodes to count nodeSelector matches
(``object_controls._nodes_wanting``), each OnDelete readiness check
re-listed the namespace pods for its app, and init's runtime/labeling
passes listed Nodes again — O(states × nodes) scans per pass even with
every read served from the informer cache (the requests were free; the
CPU was not).

``ClusterSnapshot`` is the pass-scoped memo the reference gets
implicitly from controller-runtime's cache + per-reconcile locality:
created by ``ClusterPolicyController.begin_pass()``, dropped at pass
end, it memoizes

* the Node list (one informer read per pass, shared frozen views),
* per-nodeSelector match counts (each unique selector costs one scan
  of the memoized node list, then O(1)),
* per-app namespace pod lists (one indexed informer read per app).

Objects inside the snapshot are the informer's SHARED FROZEN views —
the snapshot never copies; consumers follow the same read-only
contract as any cached read. Within one pass the snapshot is
deliberately NOT invalidated by concurrent watch events: a reconcile
computes one consistent verdict from one state of the world and the
level-triggered requeue picks up anything newer (exactly the
controller-runtime cache-read semantics). Writers that change what
they then re-read in the same pass (init's node labeling) refresh the
node list explicitly via ``set_nodes``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

from tpu_operator_torch.kube.client import Client, Obj
from tpu_operator_torch.kube.frozen import FrozenList


class ClusterSnapshot:
    """Pass-scoped read memo. Thread-safe: one reconcile pass still owns
    one snapshot (the manager serializes per key), but the write
    pipeline now runs a wave's state controls CONCURRENTLY within that
    pass, and they all share these memos — an RLock guards every
    fill-or-serve (held across the fill: informer reads are
    milliseconds, and double-computing a memo under contention would
    double-count the miss).

    ``namespace`` may be a callable: the snapshot is created at pass
    start, BEFORE ``init()`` resolves the operator namespace on the very
    first pass, so it is read at use time."""

    def __init__(
        self, client: Client, namespace: Union[str, Callable[[], str]]
    ):
        self._lock = threading.RLock()
        self._client = client
        self._namespace_src = namespace
        self._nodes: Optional[List[Obj]] = None
        self._selector_counts: Dict[Tuple[Tuple[str, str], ...], int] = {}
        self._pods_by_app: Dict[str, List[Obj]] = {}
        self._daemonsets: Optional[List[Obj]] = None
        #: Node informer store version captured immediately BEFORE the
        #: memoized node list was taken (None on unversioned clients).
        #: Memos derived from the list (label scan, slice aggregation)
        #: must key on THIS — a version read any later can be newer than
        #: the list and would pin stale derived state under it
        self.nodes_version: Optional[int] = None
        self.hits = 0
        self.misses = 0

    @property
    def _namespace(self) -> str:
        src = self._namespace_src
        return src() if callable(src) else src

    # -- nodes -----------------------------------------------------------
    def _node_list_locked(self) -> List[Obj]:
        """Memoized node list WITHOUT touching the hit/miss counters —
        internal consumers (selector counting) record their own outcome,
        so one consumer read never counts twice."""
        if self._nodes is None:
            fn = getattr(self._client, "store_version", None)
            # read BEFORE listing: an event landing in between makes the
            # list newer than the version, which only ever forces a
            # spurious recompute, never masks the event
            self.nodes_version = fn("v1", "Node") if fn is not None else None
            # shallow FrozenList wrap: the memo is shared pass-wide, so
            # outer-list mutation (sort/append) must fail loudly like
            # any other shared cached view
            self._nodes = FrozenList(self._client.list("v1", "Node"))
        return self._nodes

    def nodes(self) -> List[Obj]:
        """The pass's Node list (shared frozen views; do not mutate)."""
        with self._lock:
            if self._nodes is None:
                self.misses += 1
            else:
                self.hits += 1
            return self._node_list_locked()

    def set_nodes(self, nodes: List[Obj]) -> None:
        """Refresh the memoized node list after a writer changed node
        state it (or a later state) re-reads this pass — init's labeling
        pass calls this with the post-write objects. Selector counts
        derive from the node list, so they reset with it.
        ``nodes_version`` deliberately keeps the ORIGINAL listing's
        version: the writes that motivated the refresh moved the store
        past it, so version-keyed memos correctly refuse to form this
        pass."""
        with self._lock:
            self._nodes = FrozenList(nodes)
            self._selector_counts.clear()

    def count_nodes_matching(self, selector: Dict[str, str]) -> int:
        """How many nodes carry every ``k == v`` of ``selector`` (the
        DaemonSet nodeSelector semantics). Memoized per unique selector;
        18 states re-asking about the same handful of deploy-label
        selectors share one scan each."""
        key = tuple(sorted(selector.items()))
        with self._lock:
            cached = self._selector_counts.get(key)
            if cached is not None:
                self.hits += 1
                return cached
            self.misses += 1
            count = 0
            for node in self._node_list_locked():
                labels = node.get("metadata", {}).get("labels", {}) or {}
                if all(labels.get(k) == v for k, v in selector.items()):
                    count += 1
            self._selector_counts[key] = count
            return count

    # -- pods ------------------------------------------------------------
    def pods_by_app(self, app: str) -> List[Obj]:
        """Operator-namespace pods labeled ``app=<app>`` (shared frozen
        views). One indexed informer read per app per pass."""
        with self._lock:
            cached = self._pods_by_app.get(app)
            if cached is not None:
                self.hits += 1
                return cached
            self.misses += 1
            pods = FrozenList(
                self._client.list(
                    "v1", "Pod", self._namespace, label_selector={"app": app}
                )
            )
            self._pods_by_app[app] = pods
            return pods

    # -- daemonsets ------------------------------------------------------
    def daemonsets(self) -> List[Obj]:
        """The operator namespace's DaemonSets (shared frozen views) —
        one informer read per pass, shared by every disabled state's GC
        sweep and the driver variant fan-out's stale-DaemonSet GC
        (``object_controls._delete_daemonsets_like``). Deliberately not
        refreshed after in-pass creates/deletes: the sweeps carry their
        own ``keep`` sets, and ``delete_if_exists`` probes the cache, so
        a pass-start view stays correct."""
        with self._lock:
            if self._daemonsets is None:
                self.misses += 1
                self._daemonsets = FrozenList(
                    self._client.list("apps/v1", "DaemonSet", self._namespace)
                )
            else:
                self.hits += 1
            return self._daemonsets

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "selectors_memoized": len(self._selector_counts),
                "apps_memoized": len(self._pods_by_app),
                "daemonsets_memoized": 1 if self._daemonsets is not None else 0,
            }
