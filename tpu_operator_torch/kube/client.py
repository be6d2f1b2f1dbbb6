"""Minimal Kubernetes client abstraction: the API server's errors, the
conflict-retried update, the ``Client`` interface and ``FakeClient``.

The port's copy of ``tpu_operator/kube/client.py``. The controllers and
node agents speak to the cluster through ``Client``:

* ``FakeClient`` — an in-memory object store with resourceVersions, label
  selectors, watch events, server-side apply and PDB-checked eviction;
* ``RestClient`` (``kube/rest.py``) — a stdlib-only HTTP client (paging,
  watches, apply, the retry policy and breaker);
* ``InClusterClient`` (``kube/incluster.py``) — the node agents' seven
  verbs over HTTPS.

All three raise the error classes below, which ``incluster.py``,
``eviction.py`` and the validator catch. Objects are plain dicts in
Kubernetes wire format (``apiVersion``/``kind``/``metadata``/...).
Cluster-scoped objects have no ``metadata.namespace``.
"""

from __future__ import annotations

import copy
import fnmatch
import threading
from copy import deepcopy
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

Obj = Dict


class NotFoundError(KeyError):
    """Object does not exist (HTTP 404)."""


class ConflictError(RuntimeError):
    """resourceVersion conflict on update (HTTP 409)."""


class EvictionBlockedError(RuntimeError):
    """Eviction vetoed by a PodDisruptionBudget (HTTP 429 on the
    ``pods/<name>/eviction`` subresource); the caller retries later."""


# observability hook the metrics layer installs (OperatorMetrics points
# it at its conflict_retries_total counter) — an injection point rather
# than an upward import, so the kube layer stays controllers-free
on_conflict_retry: Optional[Callable[[], None]] = None


def _count_conflict_retry() -> None:
    """Bump the installed conflict-retry counter (best-effort: the
    metrics surface must never break a write path)."""
    hook = on_conflict_retry
    if hook is None:
        return
    try:
        hook()
    except Exception:
        pass


def mutate_with_retry(
    client: "Client",
    api_version: str,
    kind: str,
    name: str,
    namespace: str = "",
    *,
    mutate: Callable[[Obj], bool],
    attempts: int = 5,
    backoff_s: float = 0.05,
    backoff_cap_s: float = 1.0,
) -> Obj:
    """Optimistic-concurrency read-mutate-update: re-GET and re-apply on a
    409 — the discipline every writer of a SHARED object (Nodes carry
    labels from the deploy-label bus, the upgrade FSM, TFD, the slice and
    maintenance operands) must follow. ``mutate(obj) -> bool`` returns
    whether anything changed; False short-circuits without a write.
    Backoff is jittered exponential with a cap: the writers racing here
    are exactly the ones that would otherwise re-collide in lockstep.
    Raises the last ConflictError when the race outlasts ``attempts``."""
    import random
    import time

    last: Optional[Exception] = None
    for attempt in range(attempts):
        if attempt:
            _count_conflict_retry()
            delay = min(backoff_cap_s, backoff_s * (2 ** (attempt - 1)))
            time.sleep(random.uniform(delay / 2, delay))
        if attempt == 0:
            # copy=True: the informer-backed client otherwise hands back
            # a SHARED frozen view, and mutate() is about to mutate
            obj = client.get(api_version, kind, name, namespace, copy=True)
        else:
            # after a 409 the read MUST be live: a CachedClient's store
            # may not have ingested the conflicting write yet, and
            # re-reading the same stale object would 409 forever
            obj = getattr(client, "get_live", client.get)(
                api_version, kind, name, namespace
            )
        if not mutate(obj):
            return obj
        try:
            client.update(obj)
            return obj
        except ConflictError as e:
            last = e
    raise last  # type: ignore[misc]


def apply_label_delta(
    labels: Dict[str, str], delta: Dict[str, Optional[str]]
) -> bool:
    """Apply a labels-only merge delta in place (value ``None`` deletes
    the key); returns whether anything changed. The single definition of
    the ``patch_labels`` merge semantics — every implementation (generic
    fallback, FakeClient, kubesim via RFC 7386) must match it."""
    changed = False
    for k, v in (delta or {}).items():
        if v is None:
            if k in labels:
                del labels[k]
                changed = True
        elif labels.get(k) != v:
            labels[k] = v
            changed = True
    return changed


def node_taints(node: Obj) -> List[Dict[str, Any]]:
    """The node's taint list (possibly a shared frozen view — read-only)."""
    return node.get("spec", {}).get("taints") or []


def has_taint(node: Obj, key: str, value: Optional[str] = None) -> bool:
    """Whether the node carries a taint with ``key`` (and ``value`` when
    given) — the read half of the taint contract, shared by the
    remediation FSM, the slice aggregate, and tests."""
    for taint in node_taints(node):
        if taint.get("key") != key:
            continue
        if value is None or taint.get("value") == value:
            return True
    return False


def merge_taint(
    taints: List[Dict[str, Any]], key: str, value: str, effect: str
) -> bool:
    """Strategic-merge one taint into ``taints`` in place, keyed on
    ``(key, effect)`` like the apiserver's strategic merge patch for
    ``spec.taints`` (patchMergeKey=key): an existing same-key+effect
    entry is replaced, anything else appended. Returns whether the list
    changed — the single merge definition every writer goes through."""
    desired = {"key": key, "value": value, "effect": effect}
    for i, taint in enumerate(taints):
        if taint.get("key") == key and taint.get("effect") == effect:
            if taint == desired:
                return False
            taints[i] = desired
            return True
    taints.append(desired)
    return True


def set_node_taint(
    client: "Client",
    node_name: str,
    key: str,
    value: str,
    effect: str = "NoSchedule",
) -> Obj:
    """Apply (or update) one taint on a Node with the shared-Node
    conflict-retry discipline. Works identically across every client
    layer (FakeClient, kubesim-backed RestClient, CachedClient): the
    merge is computed on a fresh read and re-applied on 409."""

    def mutate(node: Obj) -> bool:
        taints = node.setdefault("spec", {}).setdefault("taints", [])
        return merge_taint(taints, key, value, effect)

    return mutate_with_retry(client, "v1", "Node", node_name, mutate=mutate)


def remove_node_taint(client: "Client", node_name: str, key: str) -> Obj:
    """Remove every taint with ``key`` from a Node (conflict-retried);
    no-op (no write) when the node doesn't carry it."""

    def mutate(node: Obj) -> bool:
        spec = node.get("spec") or {}
        taints = spec.get("taints")
        if not taints:
            return False
        kept = [t for t in taints if t.get("key") != key]
        if len(kept) == len(taints):
            return False
        if kept:
            spec["taints"] = kept
        else:
            # an empty taint list round-trips as absent, like kubectl
            spec.pop("taints", None)
        return True

    return mutate_with_retry(client, "v1", "Node", node_name, mutate=mutate)


def obj_key(obj: Obj) -> Tuple[str, str, str, str]:
    meta = obj.get("metadata", {})
    return (
        obj.get("apiVersion", ""),
        obj.get("kind", ""),
        meta.get("namespace", ""),
        meta.get("name", ""),
    )


def match_fields(obj: Obj, selector: Dict[str, str]) -> bool:
    """Dotted-path field-selector match (shared by FakeClient and the
    informer cache so both doubles filter identically)."""
    for path, want in selector.items():
        cur: Any = obj
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return False
            cur = cur[part]
        if str(cur) != str(want):
            return False
    return True


def match_labels(obj: Obj, selector) -> bool:
    """Label-selector match. Accepts either the dict convenience form —
    exact values, ``*`` globs (client-side only, mirroring how the
    reference filters ``nvidia.com/gpu*`` resource names,
    ``main.go:161-183``), list values (``in``), ``!key`` (absent) — or a
    raw apiserver selector STRING with the full set-based grammar
    (``k in (a,b)``, ``k notin (...)``, ``!k``, ``k!=v``), so FakeClient
    and the informer cache filter exactly like kubesim/the apiserver.
    """
    if not selector:
        return True
    labels = obj.get("metadata", {}).get("labels", {}) or {}
    if isinstance(selector, str):
        from tpu_operator_torch.kube.selector import matches

        return matches(labels, selector)
    for k, v in selector.items():
        if k.startswith("!"):
            if k[1:] in labels:
                return False
            continue
        if k not in labels:
            return False
        if v is None or v == "":
            continue
        if isinstance(v, (list, tuple)):
            if str(labels[k]) not in {str(x) for x in v}:
                return False
        elif "*" in v:
            if not fnmatch.fnmatchcase(str(labels[k]), v):
                return False
        elif str(labels[k]) != str(v):
            return False
    return True


class Client:
    """Interface all controllers use. Mirrors the subset of
    controller-runtime's client the reference exercises.

    Read contract (``copy``): with ``copy=False`` (the default) the
    result MAY be a shared read-only view — the informer-backed
    ``CachedClient`` serves zero-copy frozen views, and mutating one
    raises ``FrozenObjectError``. A caller that intends to mutate the
    result (read-modify-write) MUST pass ``copy=True``, which guarantees
    a private mutable object. Plain clients (FakeClient, RestClient)
    always return private objects and simply ignore the flag, so passing
    ``copy=True`` is portable across every implementation."""

    # fault-tolerance surface (kube/retry.py): every implementation
    # carries the same pair so callers and tests tune one object
    # regardless of backend. ``RestClient`` consults them on the wire;
    # ``FakeClient`` holds them for parity (no wire, no transients);
    # ``CachedClient`` delegates to its wrapped live client.
    retry_policy = None
    breaker = None

    def fault_stats(self) -> Dict[str, Any]:
        """Retry + breaker counters for /debug/vars and metrics."""
        out: Dict[str, Any] = {}
        if self.retry_policy is not None:
            out["retry"] = self.retry_policy.stats()
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        return out

    # -- reads ----------------------------------------------------------
    def get(
        self,
        api_version: str,
        kind: str,
        name: str,
        namespace: str = "",
        copy: bool = False,
    ) -> Obj:
        raise NotImplementedError

    def list(
        self,
        api_version: str,
        kind: str,
        namespace: str = "",
        label_selector: Optional[Dict[str, str]] = None,
        field_selector: Optional[Dict[str, str]] = None,
        copy: bool = False,
    ) -> List[Obj]:
        raise NotImplementedError

    # -- writes ---------------------------------------------------------
    def create(self, obj: Obj) -> Obj:
        raise NotImplementedError

    def update(self, obj: Obj) -> Obj:
        raise NotImplementedError

    def update_status(self, obj: Obj) -> Obj:
        raise NotImplementedError

    def patch_labels(
        self,
        api_version: str,
        kind: str,
        name: str,
        namespace: str = "",
        labels: Optional[Dict[str, Optional[str]]] = None,
        resource_version: Optional[str] = None,
    ) -> Obj:
        """Labels-only merge patch; value ``None`` deletes the key.
        Returns the updated object.

        The write payload is the label delta instead of the whole object
        (a fleet Node carries kubelet status and an image list).
        ``resource_version`` makes the patch CONDITIONAL (apiserver
        merge-patch semantics: an rv in the body is an optimistic-
        concurrency precondition, 409 on mismatch) — a caller whose
        delta was computed from a possibly-stale view passes the rv it
        observed and recomputes on conflict; omitting it is last-writer-
        wins, safe only for keys no other actor writes.

        This generic fallback is a read-modify-write for clients without
        native PATCH; with ``resource_version`` it is single-shot (the
        caller owns conflict recomputation — blindly re-applying a stale
        delta is exactly the race the rv guards against)."""
        delta = labels or {}

        def mutate(obj: Obj) -> bool:
            if resource_version is not None and str(
                obj.get("metadata", {}).get("resourceVersion")
            ) != str(resource_version):
                raise ConflictError(
                    f"{kind} {namespace}/{name}: resourceVersion "
                    f"{resource_version} is stale"
                )
            meta = obj.setdefault("metadata", {})
            current = meta.get("labels")
            if not isinstance(current, dict):
                current = meta["labels"] = {}
            return apply_label_delta(current, delta)

        return mutate_with_retry(
            self,
            api_version,
            kind,
            name,
            namespace,
            mutate=mutate,
            attempts=1 if resource_version is not None else 5,
        )

    def delete(
        self, api_version: str, kind: str, name: str, namespace: str = ""
    ) -> None:
        raise NotImplementedError

    def evict(self, name: str, namespace: str = "") -> None:
        """Evict a pod through the Eviction subresource so
        PodDisruptionBudgets can veto (429 → ``EvictionBlockedError``) —
        the PDB-respecting path every workload-pod disruption must take
        (reference: kubectl drain via
        ``vendor/.../upgrade/drain_manager.go:76-89``).
        Raises ``NotFoundError`` when the pod is already gone."""
        self.create(
            {
                "apiVersion": "policy/v1",
                "kind": "Eviction",
                "metadata": {"name": name, "namespace": namespace},
            }
        )

    # -- conveniences shared by all implementations ---------------------
    def get_live(
        self, api_version: str, kind: str, name: str, namespace: str = ""
    ) -> Obj:
        """Cache-bypassing read. On plain clients this IS ``get``; the
        informer-backed ``CachedClient`` overrides it — conflict-retry
        paths call this after a 409 to observe the conflicting write."""
        return self.get(api_version, kind, name, namespace)

    def list_live(
        self,
        api_version: str,
        kind: str,
        namespace: str = "",
        label_selector=None,
        field_selector=None,
    ) -> List[Obj]:
        """Cache-bypassing list. On plain clients this IS ``list``; the
        informer-backed ``CachedClient`` overrides it. Safety gates that
        evaluate USER-authored selectors over arbitrary pods (the
        wait-for-jobs drain shield) must use this: the scoped Pod
        informer holds only operand + GPU pods, and a gate silently
        narrowed to that scope would drain a node while the job it was
        written to shield is still running."""
        return self.list(
            api_version, kind, namespace, label_selector, field_selector
        )

    def list_scoped(
        self,
        api_version: str,
        kind: str,
        namespace: str = "",
        label_selector=None,
        field_selector=None,
        copy: bool = False,
    ) -> List[Obj]:
        """List that MAY be served from a scope-filtered cache. By
        calling this the caller asserts its own filter is a subset of
        the informer scope (operand pods and pods that request
        ``nvidia.com/gpu``, ``selector.pod_requests_gpu``) — the upgrade
        engine's GPU-pod sweeps qualify; anything evaluating arbitrary
        user selectors does not (use ``list_live``). On plain clients
        this IS ``list``."""
        return self.list(
            api_version, kind, namespace, label_selector, field_selector,
            copy=copy,
        )

    def get_or_none(
        self,
        api_version: str,
        kind: str,
        name: str,
        namespace: str = "",
        copy: bool = False,
    ) -> Optional[Obj]:
        try:
            return self.get(api_version, kind, name, namespace, copy=copy)
        except NotFoundError:
            return None

    def apply(self, obj: Obj) -> Obj:
        """Create-or-update by key (server-side-apply analogue).

        The caller's object is never mutated: a reconcile loop can re-apply
        the same rendered manifest dict without a stale resourceVersion
        leaking into its template.
        """
        av, kind, ns, name = obj_key(obj)
        existing = self.get_or_none(av, kind, name, ns)
        if existing is None:
            return self.create(obj)
        obj = copy.deepcopy(obj)
        obj.setdefault("metadata", {})["resourceVersion"] = existing[
            "metadata"
        ].get("resourceVersion")
        return self.update(obj)

    def apply_ssa(
        self,
        obj: Obj,
        field_manager: Optional[str] = None,
        force: bool = True,
        prune: bool = True,
        create_only: bool = False,
        update_only: bool = False,
    ) -> Obj:
        """Server-side APPLY (``kube/apply.py`` semantics):
        ONE idempotent request merging the applied configuration into
        the live object under per-field ownership. ``force`` transfers
        conflicting fields; ``prune`` removes fields this manager
        stopped applying; ``create_only`` refuses to touch an existing
        object (POST semantics for batched pod creation);
        ``update_only`` refuses to create — a label apply racing a node
        deletion must 404, never resurrect the node as a ghost.

        This generic fallback emulates the verb with a conflict-retried
        read-merge-update so ANY ``Client`` supports it; FakeClient,
        kubesim/RestClient and CachedClient override it with native
        single-shot implementations.

        Ownership survives write paths that discard caller-supplied
        ``managedFields`` (every ``update`` implementation does, by
        design — non-apply writes must not forge ownership): the
        fallback remembers, per object, the leaves this manager
        committed AND their values, and re-grafts that ownership before
        the next merge for leaves whose live value still matches. A
        foreign writer's change breaks the match, so it still surfaces
        as a conflict — but the manager can never spuriously conflict
        with its own previous apply."""
        from tpu_operator_torch.kube import apply as ssa

        manager = field_manager or ssa.DEFAULT_FIELD_MANAGER
        av, kind, ns, name = obj_key(obj)
        ledger: dict = self.__dict__.setdefault("_ssa_fallback_owned", {})
        lkey = (av, kind, ns, name, manager)

        def _remember(committed: Obj) -> None:
            owned = ssa.decode_managed(committed).get(manager, set())
            ledger[lkey] = {
                p: copy.deepcopy(ssa.get_path(committed, p, None))
                for p in owned
            }

        last: Optional[Exception] = None
        for _ in range(5):
            existing = self.get_or_none(av, kind, name, ns, copy=True)
            if existing is None:
                if update_only:
                    raise NotFoundError(f"{kind} {ns}/{name} not found")
                try:
                    created = ssa.create_from_applied(obj, manager)
                    result = self.create(created)
                    _remember(created)
                    return result
                except ConflictError as e:
                    if create_only:
                        raise
                    last = e
                    continue  # created under us: merge onto it
            if create_only:
                raise ConflictError(f"{kind} {ns}/{name} already exists")
            remembered = ledger.get(lkey)
            if remembered:
                owned = ssa.decode_managed(existing)
                mine = owned.setdefault(manager, set())
                for path, val in remembered.items():
                    if ssa.get_path(existing, path, None) == val:
                        # untouched since our commit: reclaim the leaf
                        # from wherever the write path's bookkeeping
                        # parked it (usually ``unmanaged``)
                        for other, paths in owned.items():
                            if other != manager:
                                paths.discard(path)
                        mine.add(path)
                ssa.encode_managed(existing, owned)
            merged, changed, conflicts = ssa.apply_merge(
                existing, obj, manager=manager, force=force, prune=prune
            )
            if conflicts:
                raise ssa.ApplyConflictError(
                    ssa.conflict_message(kind, name, conflicts), conflicts
                )
            if not changed:
                _remember(existing)
                return existing
            try:
                result = self.update(merged)
                _remember(merged)
                return result
            except ConflictError as e:  # racing writer: re-read, re-merge
                last = e
        raise last  # type: ignore[misc]

    def apply_ssa_batch(
        self,
        items,
        field_manager: Optional[str] = None,
        force: bool = True,
        prune: bool = True,
        update_only: bool = False,
    ):
        """Apply many objects in one submission; returns a list aligned
        to ``items`` of ``(object, error)`` pairs — exactly one of the
        two is ``None`` per item, and one failed item never fails its
        siblings. ``items`` are ``(obj, create_only)`` pairs (or bare
        objects). The generic fallback loops ``apply_ssa``; the
        kubesim-backed RestClient overrides it with a single wire
        request (the batch lane's amortization)."""
        out = []
        for item in items:
            obj, create_only = (
                item if isinstance(item, tuple) else (item, False)
            )
            try:
                out.append(
                    (
                        self.apply_ssa(
                            obj,
                            field_manager=field_manager,
                            force=force,
                            prune=prune,
                            create_only=create_only,
                            update_only=update_only,
                        ),
                        None,
                    )
                )
            except Exception as e:  # noqa: BLE001 - per-item fan-back
                out.append((None, e))
        return out

    def delete_if_exists(
        self, api_version: str, kind: str, name: str, namespace: str = ""
    ) -> bool:
        try:
            self.delete(api_version, kind, name, namespace)
            return True
        except NotFoundError:
            return False


class FakeClient(Client):
    """In-memory API server double with watch support.

    Thread-safe; resourceVersion is a monotonically increasing integer
    stamped on every write, enabling optimistic-concurrency conflict checks
    and hash-idempotency tests.
    """

    def __init__(self, objs: Iterable[Obj] = ()):  # noqa: D401
        from tpu_operator_torch.kube.retry import CircuitBreaker, RetryPolicy

        self._lock = threading.RLock()
        self._store: Dict[Tuple[str, str, str, str], Obj] = {}
        self._rv = 0
        self._watchers: List[Callable[[str, Obj], None]] = []
        # same policy surface as RestClient (tests tune/observe it
        # uniformly); the in-memory store has no transient failures, so
        # these are carried, not consulted
        self.retry_policy = RetryPolicy()
        self.breaker = CircuitBreaker()
        for o in objs:
            self.create(copy.deepcopy(o))

    # -- watch ----------------------------------------------------------
    def add_watcher(self, fn: Callable[[str, Obj], None]) -> None:
        """Register ``fn(event_type, obj)``; event_type ∈ ADDED/MODIFIED/DELETED."""
        with self._lock:
            self._watchers.append(fn)

    def _notify(self, event: str, obj: Obj) -> None:
        for fn in list(self._watchers):
            fn(event, copy.deepcopy(obj))

    # -- reads ----------------------------------------------------------
    def get(self, api_version, kind, name, namespace="", copy=False):
        # ``copy`` accepted for Client-interface parity; FakeClient
        # always returns a private deep copy, so the flag is a no-op
        with self._lock:
            key = (api_version, kind, namespace or "", name)
            if key not in self._store:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return deepcopy(self._store[key])

    def list(
        self,
        api_version,
        kind,
        namespace="",
        label_selector=None,
        field_selector=None,
        copy=False,
    ):
        with self._lock:
            out = []
            for (av, k, ns, _), obj in sorted(self._store.items()):
                if av != api_version or k != kind:
                    continue
                if namespace and ns != namespace:
                    continue
                if not match_labels(obj, label_selector):
                    continue
                if field_selector and not self._match_fields(obj, field_selector):
                    continue
                out.append(deepcopy(obj))
            return out

    def list_with_rv(self, api_version, kind, namespace=""):
        """List plus the store's current resourceVersion (what a real
        List response carries in its collection metadata)."""
        with self._lock:
            rv = str(self._rv)
        return self.list(api_version, kind, namespace), rv

    @staticmethod
    def _match_fields(obj: Obj, selector: Dict[str, str]) -> bool:
        return match_fields(obj, selector)

    # -- writes ---------------------------------------------------------
    def _stamp_locked(self, obj: Obj) -> None:
        self._rv += 1
        meta = obj.setdefault("metadata", {})
        meta["resourceVersion"] = str(self._rv)
        # a uid on every object, like the apiserver (and kubesim): ownerRef
        # GC keys on it, so an absent uid silently disables cascades
        if not meta.get("uid"):
            meta["uid"] = f"fake-uid-{self._rv:012d}"
        # creationTimestamp is set once; the monotonic counter keeps ordering
        # deterministic even within one wall-clock second
        if "creationTimestamp" not in meta:
            meta["creationTimestamp"] = f"fake-{self._rv:012d}"

    def create(self, obj):
        with self._lock:
            key = obj_key(obj)
            if not key[3]:
                raise ValueError(f"object has no name: {obj}")
            if key in self._store:
                raise ConflictError(f"{key[1]} {key[2]}/{key[3]} already exists")
            stored = copy.deepcopy(obj)
            self._stamp_locked(stored)
            self._store[key] = stored
            self._notify("ADDED", stored)
            return copy.deepcopy(stored)

    @staticmethod
    def _reown(existing: Obj, stored: Obj) -> None:
        """Non-apply writes move ownership of the leaves they changed to
        the ``unmanaged`` bucket (see kube/apply.py): a human or foreign
        controller touching a field an APPLY manager owns must surface
        as a conflict on the next non-forced apply, never be silently
        reverted. Caller-supplied ``managedFields`` are ignored — the
        bookkeeping always starts from the STORED object's."""
        from tpu_operator_torch.kube import apply as ssa

        stored.setdefault("metadata", {}).pop("managedFields", None)
        if existing["metadata"].get("managedFields"):
            stored["metadata"]["managedFields"] = copy.deepcopy(
                existing["metadata"]["managedFields"]
            )
        ssa.reown(existing, stored)

    def update(self, obj):
        with self._lock:
            key = obj_key(obj)
            if key not in self._store:
                raise NotFoundError(f"{key[1]} {key[2]}/{key[3]} not found")
            existing = self._store[key]
            want_rv = obj.get("metadata", {}).get("resourceVersion")
            have_rv = existing["metadata"].get("resourceVersion")
            if want_rv is not None and str(want_rv) != str(have_rv):
                raise ConflictError(
                    f"resourceVersion conflict on {key}: {want_rv} != {have_rv}"
                )
            stored = copy.deepcopy(obj)
            # status is a subresource: plain updates preserve existing status
            if "status" in existing and "status" not in stored:
                stored["status"] = copy.deepcopy(existing["status"])
            if "creationTimestamp" in existing["metadata"]:
                stored["metadata"]["creationTimestamp"] = existing["metadata"][
                    "creationTimestamp"
                ]
            # uid is immutable: always the stored one, never caller-supplied
            if existing["metadata"].get("uid"):
                stored.setdefault("metadata", {})["uid"] = existing["metadata"]["uid"]
            self._reown(existing, stored)
            self._stamp_locked(stored)
            self._store[key] = stored
            self._notify("MODIFIED", stored)
            return copy.deepcopy(stored)

    def update_status(self, obj):
        with self._lock:
            key = obj_key(obj)
            if key not in self._store:
                raise NotFoundError(f"{key[1]} {key[2]}/{key[3]} not found")
            before = self._store[key]
            existing = copy.deepcopy(before)
            existing["status"] = copy.deepcopy(obj.get("status", {}))
            self._reown(before, existing)
            self._stamp_locked(existing)
            self._store[key] = existing
            self._notify("MODIFIED", existing)
            return copy.deepcopy(existing)

    def apply_ssa(
        self,
        obj,
        field_manager=None,
        force=True,
        prune=True,
        create_only=False,
        update_only=False,
    ):
        """Native server-side APPLY on the in-memory store: single-shot
        under the store lock (no read-merge-update race), conflict
        detection against recorded field ownership, and — like the real
        apiserver — a no-op apply does NOT bump the resourceVersion or
        emit a watch event (repeated applies stay free)."""
        from tpu_operator_torch.kube import apply as ssa

        manager = field_manager or ssa.DEFAULT_FIELD_MANAGER
        with self._lock:
            key = obj_key(obj)
            if not key[3]:
                raise ValueError(f"object has no name: {obj}")
            stored = self._store.get(key)
            if stored is None:
                if update_only:
                    raise NotFoundError(
                        f"{key[1]} {key[2]}/{key[3]} not found"
                    )
                new = ssa.create_from_applied(obj, manager)
                self._stamp_locked(new)
                self._store[key] = new
                self._notify("ADDED", new)
                return copy.deepcopy(new)
            if create_only:
                raise ConflictError(
                    f"{key[1]} {key[2]}/{key[3]} already exists"
                )
            merged, changed, conflicts = ssa.apply_merge(
                stored, obj, manager=manager, force=force, prune=prune
            )
            if conflicts:
                raise ssa.ApplyConflictError(
                    ssa.conflict_message(key[1], key[3], conflicts), conflicts
                )
            if not changed:
                return copy.deepcopy(stored)
            self._stamp_locked(merged)
            self._store[key] = merged
            self._notify("MODIFIED", merged)
            return copy.deepcopy(merged)

    def patch_labels(
        self, api_version, kind, name, namespace="", labels=None,
        resource_version=None,
    ):
        """Native merge-patch: the delta lands on the CURRENT stored
        object under the store lock. Unconditional by default; with
        ``resource_version`` it is an optimistic-concurrency
        precondition (409 on mismatch), like the apiserver."""
        with self._lock:
            key = (api_version, kind, namespace or "", name)
            stored = self._store.get(key)
            if stored is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            if resource_version is not None and str(
                stored["metadata"].get("resourceVersion")
            ) != str(resource_version):
                raise ConflictError(
                    f"resourceVersion conflict on {key}: "
                    f"{resource_version} != "
                    f"{stored['metadata'].get('resourceVersion')}"
                )
            fresh = copy.deepcopy(stored)
            current = fresh.setdefault("metadata", {}).setdefault("labels", {})
            if apply_label_delta(current, labels or {}):
                self._reown(stored, fresh)
                self._stamp_locked(fresh)
                self._store[key] = fresh
                self._notify("MODIFIED", fresh)
                return copy.deepcopy(fresh)
            return copy.deepcopy(stored)

    def delete(self, api_version, kind, name, namespace=""):
        with self._lock:
            key = (api_version, kind, namespace or "", name)
            if key not in self._store:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            self._delete_stored_locked(key)

    def evict(self, name, namespace=""):
        """Eviction subresource with PDB enforcement — same arithmetic as
        kubesim (``tpu_operator/kube/disruption.py``) so FakeClient tests
        see apiserver-faithful 429 vetoes."""
        from tpu_operator_torch.kube.disruption import eviction_blocked_by

        with self._lock:
            key = ("v1", "Pod", namespace or "", name)
            pod = self._store.get(key)
            if pod is None:
                raise NotFoundError(f"Pod {namespace}/{name} not found")
            pods = [
                o for (av, k, ns, _), o in self._store.items()
                if k == "Pod" and ns == (namespace or "")
            ]
            pdbs = [
                o for (av, k, ns, _), o in self._store.items()
                if k == "PodDisruptionBudget" and ns == (namespace or "")
            ]
            blocked = eviction_blocked_by(pod, pods, pdbs)
            if blocked is not None:
                raise EvictionBlockedError(blocked[1])
            self._delete_stored_locked(key)

    def _delete_stored_locked(self, key) -> None:
        """Remove + notify with deletion-rv semantics, then cascade GC —
        the single deletion path, in the SAME order as kubesim's
        (ownerRef cascade, then node-bound pod GC) so the two doubles
        emit identical DELETED event sequences. No-op when the object is
        already gone (an earlier cascade step may have removed it)."""
        obj = self._store.pop(key, None)
        if obj is None:
            return
        _, kind, _, name = key
        # the DELETED event carries the DELETION resourceVersion (real
        # apiserver + kubesim semantics)
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        self._notify("DELETED", obj)
        # ownerReference cascade, like the API server's garbage collector
        # (the reference leans on SetControllerReference for operand
        # cleanup on CR deletion)
        deleted_uid = obj.get("metadata", {}).get("uid")
        if deleted_uid:
            for k, _o in [
                (k, o)
                for k, o in list(self._store.items())
                if any(
                    ref.get("uid") == deleted_uid
                    for ref in o.get("metadata", {}).get("ownerReferences", [])
                )
            ]:
                self._delete_stored_locked(k)
        # node-lifecycle/pod-GC behavior: deleting a Node removes pods
        # bound to it (stale DaemonSet pods on a dead node would
        # otherwise pin readiness NotReady forever)
        if kind == "Node":
            for k, _o in [
                (k, o)
                for k, o in list(self._store.items())
                if k[1] == "Pod"
                and o.get("spec", {}).get("nodeName") == name
            ]:
                self._delete_stored_locked(k)

    # -- test helpers ----------------------------------------------------
    def all_objects(self) -> List[Obj]:
        with self._lock:
            return [copy.deepcopy(o) for o in self._store.values()]
