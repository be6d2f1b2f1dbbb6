"""kubesim — a real-HTTP Kubernetes API server simulator (envtest slot).

The port's copy of ``tpu_operator/kube/kubesim.py``: the node's capacity
is ``nvidia.com/gpu`` (``set_node_chips`` and the chip-fault helpers),
``add_nodes`` joins GPU nodes of ``CARDS_PER_HOST`` cards
(``kube/testing.make_gpu_node``), and admission runs the port's
``cfg.schema_validate`` against the port's CRD once it is registered.

The reference tests its reconcilers against envtest's real apiserver
binaries (``Makefile:81-86``); this sandbox has no such binaries, so
kubesim implements the apiserver *behaviors* the in-memory FakeClient
cannot prove, behind the genuine REST/JSON wire the operator's
``RestClient`` speaks:

* optimistic concurrency: monotonically increasing ``resourceVersion``
  on every write, 409 Conflict on stale updates, 409 AlreadyExists on
  duplicate creates;
* the **status subresource**: for kinds that declare it, a main-resource
  PUT cannot change status and a ``/status`` PUT cannot change spec;
* **CRD structural-schema validation at admission**: a registered CRD's
  openAPIV3Schema rejects malformed CRs with 422 (via
  ``cfg.schema_validate`` — the same schema ``crdgen`` generates), and
  unknown fields are pruned exactly like a structural schema would;
* **ownerReference garbage collection**: deleting an owner cascades to
  its dependents (by uid), transitively;
* **watch streams**: ``?watch=true&resourceVersion=N`` replays from the
  event log and then streams live JSON-lines events, emits periodic
  BOOKMARK events, honors ``timeoutSeconds``, and answers a compacted
  (too-old) resourceVersion with a 410 Gone ERROR event — the re-list
  path clients must survive;
* namespacing, labelSelector/fieldSelector list filtering, and the
  ``pods/{name}/eviction`` subresource;
* **server-side apply** (the APPLY verb): a PATCH with content type
  ``application/apply-patch+yaml`` merges the applied configuration
  under per-field manager ownership (``kube/apply.py`` —
  ``metadata.managedFields`` recorded on stored objects, 409
  ``FieldConflict`` naming the owning manager, ``force``/``prune``/
  ``createOnly`` query knobs), a no-op apply does not bump the
  resourceVersion, non-apply writes re-own the leaves they change, and
  a name-less collection PATCH applies a BATCH of sibling objects in
  one request with per-item status fan-back.

Deliberately NOT simulated: authn/authz (any token accepted) and
admission webhooks. Pod and DaemonSet status stays writable
by the test's node simulator, which plays the kubelet's role. One
controller behavior IS modeled because every real cluster has it and its
absence diverges operator behavior: deleting a Node garbage-collects the
pods bound to it (the pod-GC / node-lifecycle controllers).
"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
import time
import uuid
from bisect import bisect_right
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from tpu_operator_torch import consts
from tpu_operator_torch.kube.rest import KIND_TABLE
from tpu_operator_torch.kube.testing import HOST_CARDS, make_gpu_node

# plural -> (kind, namespaced)
PLURAL_TABLE: Dict[str, Tuple[str, bool]] = {
    plural: (kind, namespaced) for kind, (plural, namespaced) in KIND_TABLE.items()
}

# kinds whose status is a subresource here (the operator is the writer
# under test for these; Pod/DaemonSet status stays open for the
# kubelet-simulator, which legitimately owns it)
STATUS_SUBRESOURCE_KINDS = {"ClusterPolicy"}

_GV_RE = re.compile(r"^/api(?:s/(?P<group>[^/]+))?/(?P<version>[^/]+)(?P<rest>/.*)?$")


class KubeSim:
    """In-memory cluster state with apiserver semantics (thread-safe)."""

    def __init__(self, compact_keep: int = 512, bookmark_interval_s: float = 5.0):
        self._lock = threading.RLock()
        # one condition per plural, all sharing the store lock: a write
        # wakes only the streams watching THAT plural — with ~18 informer
        # streams attached, notify_all amplified every one of a pod
        # storm's writes into 18 wakeups (17 of them spurious), and the
        # wake churn was a measurable slice of fleet convergence
        self._conds: Dict[str, threading.Condition] = {}
        self._rv = 0
        # (group, version, plural, namespace, name) -> object
        self._objs: Dict[Tuple[str, str, str, str, str], dict] = {}
        # bounded event log for watches: (rv, etype, key, object-copy),
        # rv strictly ascending; _event_rvs mirrors the rv column so a
        # watcher wake can bisect straight to its cursor instead of
        # re-scanning the whole log — with W watch streams each waking
        # on every write, the linear scan was O(W × log) CPU per write
        # and the single hottest path of the convergence bench
        self._events: List[Tuple[int, str, Tuple, dict]] = []
        self._event_rvs: List[int] = []
        self._min_event_rv = 0  # oldest rv still replayable
        self.compact_keep = compact_keep
        self.bookmark_interval_s = bookmark_interval_s
        # CRD name -> schema (installed via the real CRD API)
        self._cr_schemas: Dict[str, dict] = {}
        # HTTP request accounting (reads vs writes vs watch streams) —
        # the informer-cache bench axis counts apiserver requests per
        # reconcile against these
        self.request_counts: Dict[str, int] = {}
        # plural -> {verb: count}: per-kind request accounting (the shard
        # bench separates lease-heartbeat writes from convergence writes)
        self.request_counts_by_plural: Dict[str, Dict[str, int]] = {}
        # fault injection: plural -> number of watch event lines to
        # silently swallow (first consuming stream eats one) — models a
        # proxy hiccup / lost line that real informers must self-heal
        # from via resync
        self._watch_drop_faults: Dict[str, int] = {}
        self.watch_drops_injected = 0
        # verb-level fault injection (the generalization of
        # inject_watch_drop): (verb, plural) -> FIFO of fault dicts, with
        # "*" wildcards on either axis; plus a full-partition window
        # during which EVERY request answers 503 (and active watch
        # streams are cut). Drives the deterministic fault-matrix test.
        self._faults: Dict[Tuple[str, str], List[dict]] = {}
        self._partition_until = 0.0
        self.faults_injected = 0
        self.partition_rejects = 0
        # plural -> highest event rv compacted out of the log (the
        # per-kind 410 horizon; see _emit_locked)
        self._compacted_rv_by_plural: Dict[str, int] = {}
        # server-side-apply accounting: field-ownership 409s answered
        # (the bench's apply_conflicts signal) and batch submissions
        self.apply_conflicts = 0
        self.apply_batches = 0
        self.apply_batch_items = 0
        # Events expire like a real apiserver's --event-ttl (default 1h):
        # without it an hour-scale Event storm grows the store — and
        # every informer mirroring it — without bound. Keyed by store
        # key, stamped at create AND update (TTL measures from last
        # touch, matching apiserver behavior).
        self.event_ttl_s = float(os.environ.get("KUBESIM_EVENT_TTL_S", "3600"))
        self._event_touch: Dict[Tuple, float] = {}
        # fleet-lifecycle hooks: fn(event, node_name) with event in
        # ("ADDED", "DELETED"), fired OUTSIDE the store lock by the
        # lifecycle helpers (add_nodes/delete_node/preemption_wave) so
        # co-resident simulators (the kubelet device manager) can
        # attach/detach with the node — a deleted host's cards must leave
        # the allocation registry, not zombie-hold
        self._lifecycle_hooks: List = []
        self._join_seq = 0
        self.nodes_added = 0
        self.nodes_deleted = 0

    def inject_watch_drop(self, plural: str, count: int = 1) -> None:
        """Arrange for the next ``count`` watch event lines for ``plural``
        to be silently dropped on whichever client stream would have
        delivered them (the event stays in history; other streams and
        re-lists still see the state)."""
        with self._lock:
            self._watch_drop_faults[plural] = (
                self._watch_drop_faults.get(plural, 0) + count
            )

    def _consume_watch_drop(self, plural: str) -> bool:
        with self._lock:
            n = self._watch_drop_faults.get(plural, 0)
            if n <= 0:
                return False
            self._watch_drop_faults[plural] = n - 1
            self.watch_drops_injected += 1
            return True

    # -- verb-level fault injection --------------------------------------
    def inject_fault(
        self,
        verb: str = "*",
        plural: str = "*",
        *,
        code: Optional[int] = None,
        retry_after: Optional[float] = None,
        latency_s: float = 0.0,
        count: int = 1,
    ) -> None:
        """Queue ``count`` injected faults for requests matching
        ``(verb, plural)`` — verbs are the request-accounting names
        (GET/LIST/WATCH/POST/PUT/PATCH/APPLY/DELETE; APPLY is
        server-side apply, which rides PATCH on the wire but is its own
        verb to fault injection and accounting), ``"*"`` matches any.
        Each consumed fault adds ``latency_s`` of service delay, then
        answers HTTP ``code`` when given (with a ``Retry-After`` header
        when ``retry_after`` is set — the 429 contract clients must
        honor); ``code=None`` makes it latency-only (delay, then serve
        normally). Faults are consumed FIFO, most-specific key first."""
        with self._lock:
            self._faults.setdefault((verb, plural), []).extend(
                {
                    "code": code,
                    "retry_after": retry_after,
                    "latency_s": latency_s,
                }
                for _ in range(count)
            )

    def partition(self, duration_s: float) -> None:
        """Open a full apiserver partition window: until it closes,
        every request (every verb, watch streams included) answers 503
        and active watch streams are cut — the operator must ride it out
        on backoff and converge after the wall comes down."""
        with self._lock:
            self._partition_until = time.monotonic() + duration_s

    def partitioned(self) -> bool:
        with self._lock:
            return time.monotonic() < self._partition_until

    def next_fault(self, verb: str, plural: str) -> Optional[dict]:
        """Consume the next matching injected fault (or a synthetic 503
        while a partition window is open); None = serve normally."""
        with self._lock:
            if time.monotonic() < self._partition_until:
                self.partition_rejects += 1
                return {"code": 503, "retry_after": None, "latency_s": 0.0}
            for key in (
                (verb, plural),
                (verb, "*"),
                ("*", plural),
                ("*", "*"),
            ):
                q = self._faults.get(key)
                if q:
                    self.faults_injected += 1
                    return q.pop(0)
        return None

    # -- node-level fault injection --------------------------------------
    def _mutate_stored(self, plural: str, namespace: str, name: str, fn) -> dict:
        """Copy-on-write mutation under the lock: the stored object is
        REPLACED, never mutated in place (the store-wide invariant the
        zero-copy LIST serialization leans on), then a fresh
        resourceVersion is stamped and MODIFIED emitted — the injection
        primitive the node-fault helpers share. The watch stream carries
        the change, so informer-backed operators see injected state like
        any kubelet write."""
        with self._lock:
            key = self._key("", "v1", plural, namespace, name)
            stored = self._objs.get(key)
            if stored is None:
                raise KeyError(f"{plural} {namespace}/{name} not found")
            fresh = copy.deepcopy(stored)
            fn(fresh)
            fresh["metadata"]["resourceVersion"] = self._bump()
            self._objs[key] = fresh
            self._emit_locked("MODIFIED", key, fresh)
            return copy.deepcopy(fresh)

    def set_node_chips(self, name: str, allocatable: int, capacity: Optional[int] = None) -> dict:
        """Write the node's ``nvidia.com/gpu`` capacity/allocatable —
        the kubelet's resource advertisement, injected."""

        def fn(node):
            status = node.setdefault("status", {})
            status.setdefault("capacity", {})[consts.GPU_RESOURCE] = str(
                capacity if capacity is not None else max(allocatable, 0)
            )
            status.setdefault("allocatable", {})[consts.GPU_RESOURCE] = str(
                allocatable
            )

        return self._mutate_stored("nodes", "", name, fn)

    def kill_node_chips(self, name: str) -> dict:
        """Card death: allocatable drops to 0 while capacity stays — the
        exact shape a real kubelet reports when the device plugin marks
        every card Unhealthy (``slice_status.host_allocatable_ok`` reads
        it as False)."""

        def fn(node):
            status = node.setdefault("status", {})
            cap = status.setdefault("capacity", {})
            if consts.GPU_RESOURCE not in cap:
                cap[consts.GPU_RESOURCE] = str(HOST_CARDS)
            status.setdefault("allocatable", {})[consts.GPU_RESOURCE] = "0"

        return self._mutate_stored("nodes", "", name, fn)

    def restore_node_chips(self, name: str, count: int = HOST_CARDS) -> dict:
        """Cards pass probes again: allocatable returns to ``count``."""
        return self.set_node_chips(name, count, capacity=count)

    def flap_node_chips(self, name: str, count: int = HOST_CARDS) -> dict:
        """One flap edge: kill if the node currently advertises cards,
        restore otherwise — drives the flapping-host matrix row."""
        with self._lock:
            key = self._key("", "v1", "nodes", "", name)
            stored = self._objs.get(key)
            alive = stored is not None and (
                stored.get("status", {}).get("allocatable", {}) or {}
            ).get(consts.GPU_RESOURCE) not in (None, "0")
        return (
            self.kill_node_chips(name)
            if alive
            else self.restore_node_chips(name, count)
        )

    def crashloop_pod(self, namespace: str, name: str) -> dict:
        """Force a (DaemonSet) pod into CrashLoopBackOff: phase Running
        with a waiting container — the kubelet status shape the
        remediator's health derivation keys on."""

        def fn(pod):
            pod["status"] = {
                "phase": "Running",
                "containerStatuses": [
                    {
                        "ready": False,
                        "restartCount": 5,
                        "state": {
                            "waiting": {"reason": "CrashLoopBackOff"}
                        },
                    }
                ],
            }

        return self._mutate_stored("pods", namespace, name, fn)

    # -- fleet lifecycle --------------------------------------------------
    def add_lifecycle_hook(self, fn) -> None:
        """Register ``fn(event, node_name)`` for node ADDED/DELETED
        lifecycle transitions driven through the helpers below. Hooks run
        outside the store lock and are failure-isolated (a broken sim
        detach must not wedge the apiserver)."""
        self._lifecycle_hooks.append(fn)

    def _fire_lifecycle(self, event: str, name: str) -> None:
        for fn in list(self._lifecycle_hooks):
            try:
                fn(event, name)
            except Exception:
                pass  # hooks are observers, never load-bearing

    def add_nodes(
        self,
        count: int,
        template: Optional[dict] = None,
        name_prefix: str = "join",
        chips: int = HOST_CARDS,
        extra_labels: Optional[dict] = None,
        names: Optional[List[str]] = None,
    ) -> List[str]:
        """Autoscale join: create ``count`` GPU nodes, each through the
        normal admission path (real ADDED watch events, monotonically
        named ``{name_prefix}-{seq}`` unless ``names`` pins them — the
        chaos generator pins names so a replay is byte-identical), then
        advertise ``chips`` allocatable cards the way a booting kubelet
        would. ``template`` overrides the default GPU node shape
        (``make_gpu_node``); ``extra_labels`` ride on top (slice-id labels
        make a join wave form NEW multi-host slices)."""
        created: List[str] = []
        for i in range(count):
            if names is not None:
                name = names[i]
            else:
                with self._lock:
                    self._join_seq += 1
                    name = f"{name_prefix}-{self._join_seq}"
            if template is not None:
                node = copy.deepcopy(template)
                node.setdefault("metadata", {})["name"] = name
                node["metadata"].setdefault("labels", {})[
                    "kubernetes.io/hostname"
                ] = name
            else:
                node = make_gpu_node(name, extra_labels=extra_labels)
            if extra_labels and template is not None:
                node["metadata"].setdefault("labels", {}).update(extra_labels)
            code, body = self.create("", "v1", "nodes", "", node)
            if code == 409:
                continue  # name collision with a live node: skip, no retry
            if code >= 400:
                raise RuntimeError(f"add_nodes: {body.get('message')}")
            if chips > 0:
                self.set_node_chips(name, chips, capacity=chips)
            created.append(name)
            with self._lock:
                self.nodes_added += 1
        for name in created:
            self._fire_lifecycle("ADDED", name)
        return created

    def delete_node(self, name: str) -> bool:
        """Spot preemption / scale-down of ONE node: the DELETED watch
        event, the apiserver's at-deletion pod cascade (every bound pod
        deleted with its own DELETED event — ``_gc_node_pods``), and the
        lifecycle hooks that detach the node's kubelet/plugin simulators
        (releasing its cards from an allocation registry). Returns False
        when the node was already gone."""
        code, _ = self.delete("", "v1", "nodes", "", name)
        if code != 200:
            return False
        with self._lock:
            self.nodes_deleted += 1
        self._fire_lifecycle("DELETED", name)
        return True

    def preemption_wave(
        self,
        fraction: float,
        rng=None,
        name_filter=None,
    ) -> List[str]:
        """Spot-preemption wave: delete ``ceil(fraction × fleet)`` nodes
        picked by ``rng`` (a ``random.Random``; pass a seeded one for a
        replayable wave) from the sorted live node list — mid-upgrade,
        mid-remediation, mid-repartition nodes are all fair game, which
        is the point. ``name_filter(name) -> bool`` scopes the candidate
        pool (e.g. spare the operator's seed slice)."""
        import math
        import random as _random

        rng = rng or _random.Random()
        with self._lock:
            live = sorted(
                key[4] for key in self._objs if key[2] == "nodes"
            )
        if name_filter is not None:
            live = [n for n in live if name_filter(n)]
        if not live or fraction <= 0:
            return []
        count = min(len(live), max(1, math.ceil(len(live) * fraction)))
        victims = rng.sample(live, count)
        return [v for v in victims if self.delete_node(v)]

    def faults_pending(self) -> int:
        """Injected (queued) faults not yet consumed — the fault-matrix
        test asserts this drains to zero, proving every injection was
        actually exercised."""
        with self._lock:
            return sum(len(q) for q in self._faults.values())

    def count_request(
        self, verb: str, is_watch: bool = False, plural: str = ""
    ) -> None:
        key = "WATCH" if is_watch else verb
        with self._lock:
            self.request_counts[key] = self.request_counts.get(key, 0) + 1
            if plural:
                by = self.request_counts_by_plural.setdefault(plural, {})
                by[key] = by.get(key, 0) + 1

    def requests_total(self, include_watch: bool = False) -> int:
        with self._lock:
            return sum(
                n
                for k, n in self.request_counts.items()
                if include_watch or k != "WATCH"
            )

    def writes_total(self, exclude_plurals: Tuple[str, ...] = ()) -> int:
        """Mutating requests, optionally excluding plurals — the shard
        bench's steady-state check excludes ``leases`` (lease renewals
        are the sharded control plane's heartbeat, not convergence
        work; counting them makes zero-write steady state unreachable
        by construction)."""
        verbs = ("POST", "PUT", "PATCH", "APPLY", "DELETE")
        with self._lock:
            total = sum(self.request_counts.get(v, 0) for v in verbs)
            for plural in exclude_plurals:
                by = self.request_counts_by_plural.get(plural, {})
                total -= sum(by.get(v, 0) for v in verbs)
            return total

    # -- helpers ---------------------------------------------------------
    def _bump(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _key(self, group, version, plural, namespace, name):
        _, namespaced = PLURAL_TABLE[plural]
        return (group, version, plural, namespace if namespaced else "", name)

    def _cond_for(self, plural: str) -> threading.Condition:
        """The plural's watch condition (caller holds the lock)."""
        cond = self._conds.get(plural)
        if cond is None:
            cond = self._conds[plural] = threading.Condition(self._lock)
        return cond

    def _emit_locked(self, etype: str, key, obj: dict) -> None:
        # the log holds REFERENCES: every write path replaces stored
        # objects instead of mutating them (copy-on-write invariant), so
        # a logged revision can never change after the fact — the
        # per-write deepcopy this replaces was a measurable slice of the
        # fleet-convergence bench
        self._events.append((self._rv, etype, key, obj))
        self._event_rvs.append(self._rv)
        if len(self._events) > self.compact_keep:
            drop = len(self._events) - self.compact_keep
            self._min_event_rv = self._events[drop - 1][0]
            for rv, _et, dkey, _obj in self._events[:drop]:
                # per-plural compaction horizon: a watch resuming at rv
                # X only missed history if an event FOR ITS PLURAL was
                # dropped past X (a real apiserver's watch cache is
                # per-kind; the global log here must not 410 a quiet
                # kind's warm resume just because Nodes were busy)
                if rv > self._compacted_rv_by_plural.get(dkey[2], 0):
                    self._compacted_rv_by_plural[dkey[2]] = rv
            del self._events[:drop]
            del self._event_rvs[:drop]
        self._cond_for(key[2]).notify_all()

    def expire_events(self) -> int:
        """Drop Events untouched for ``event_ttl_s`` (the apiserver's
        ``--event-ttl``, default 1h), emitting DELETED watch events so
        informers unmirror them. Called lazily from the read/watch paths;
        idempotent and cheap when nothing expired."""
        if self.event_ttl_s <= 0:
            return 0
        cutoff = time.monotonic() - self.event_ttl_s
        with self._lock:
            stale = [k for k in self._event_touch if k not in self._objs]
            for k in stale:
                self._event_touch.pop(k, None)
            expired = [
                (k, self._objs[k])
                for k, t in list(self._event_touch.items())
                if t < cutoff
            ]
            for key, obj in expired:
                self._delete_stored_locked(key, obj)
        return len(expired)

    def compact_now(self) -> None:
        """Force-compact the whole event log (tests use this to drive the
        410 Gone path deterministically)."""
        with self._lock:
            if self._events:
                self._min_event_rv = self._events[-1][0]
                for rv, _et, dkey, _obj in self._events:
                    if rv > self._compacted_rv_by_plural.get(dkey[2], 0):
                        self._compacted_rv_by_plural[dkey[2]] = rv
                self._events.clear()
                self._event_rvs.clear()

    # -- CR schema admission ---------------------------------------------
    def _register_crd(self, crd: dict) -> None:
        kind = crd.get("spec", {}).get("names", {}).get("kind", "")
        if kind:
            self._cr_schemas[kind] = crd

    def _admit(self, kind: str, obj: dict) -> List[str]:
        """Default + validate + prune a CR against its registered CRD
        schema. Returns problems (empty = admitted); applies schema
        defaults and prunes unknown fields in place, in the apiserver's
        order (defaulting at decode, before validation)."""
        crd = self._cr_schemas.get(kind)
        if crd is None:
            return []
        # deliberate inversion: the SIM plays apiserver admission, and
        # the structural-schema engine lives in cfg/ — a runtime kube/
        # module would never reach upward like this
        from tpu_operator_torch.cfg.schema_validate import (  # lint: ignore[layering]
            default_cr,
            validate_cr,
        )

        default_cr(crd, obj)
        problems = validate_cr(crd, obj)
        rejects = []
        for p in problems:
            if p.endswith(": unknown field"):
                self._prune_path(obj, p.rsplit(":", 1)[0])
            else:
                rejects.append(p)
        return rejects

    @staticmethod
    def _prune_path(obj: dict, path: str) -> None:
        parts = path.split(".")
        cur = obj
        for part in parts[:-1]:
            if not isinstance(cur, dict) or part not in cur:
                return
            cur = cur[part]
        if isinstance(cur, dict):
            cur.pop(parts[-1], None)

    # -- CRUD -------------------------------------------------------------
    def create(self, group, version, plural, namespace, body: dict):
        kind, namespaced = PLURAL_TABLE[plural]
        meta = body.setdefault("metadata", {})
        name = meta.get("name", "")
        if not name:
            return 422, _status(422, "Invalid", "metadata.name required")
        with self._lock:
            key = self._key(group, version, plural, namespace, name)
            if key in self._objs:
                return 409, _status(409, "AlreadyExists", f"{plural} {name} exists")
            rejects = self._admit(kind, body)
            if rejects:
                return 422, _status(422, "Invalid", "; ".join(rejects))
            meta["uid"] = meta.get("uid") or str(uuid.uuid4())
            meta["resourceVersion"] = self._bump()
            meta["generation"] = 1
            meta.setdefault(
                "creationTimestamp",
                time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            )
            if namespaced:
                meta["namespace"] = namespace
            if kind in STATUS_SUBRESOURCE_KINDS:
                # the apiserver drops status on create; it is written
                # through the /status subresource only
                body.pop("status", None)
            self._objs[key] = copy.deepcopy(body)
            if plural == "customresourcedefinitions":
                self._register_crd(self._objs[key])
            if plural == "events":
                self._event_touch[key] = time.monotonic()
            self._emit_locked("ADDED", key, self._objs[key])
            # a store REFERENCE: the HTTP handler serializes it, and the
            # copy-on-write invariant keeps it immutable — callers must
            # copy before mutating
            return 201, self._objs[key]

    def update(self, group, version, plural, namespace, name, body: dict, status_only=False):
        kind, _ = PLURAL_TABLE[plural]
        with self._lock:
            key = self._key(group, version, plural, namespace, name)
            stored = self._objs.get(key)
            if stored is None:
                return 404, _status(404, "NotFound", f"{plural} {name} not found")
            body_rv = body.get("metadata", {}).get("resourceVersion")
            if body_rv is not None and str(body_rv) != stored["metadata"]["resourceVersion"]:
                return 409, _status(
                    409,
                    "Conflict",
                    f"{plural} {name}: resourceVersion {body_rv} is stale "
                    f"(current {stored['metadata']['resourceVersion']})",
                )
            new = copy.deepcopy(body)
            meta = new.setdefault("metadata", {})
            # immutable fields come from the store
            meta["uid"] = stored["metadata"]["uid"]
            meta["creationTimestamp"] = stored["metadata"].get("creationTimestamp")
            meta.setdefault("name", name)
            if stored["metadata"].get("namespace"):
                meta["namespace"] = stored["metadata"]["namespace"]
            if status_only:
                # a /status PUT can ONLY change status
                merged = copy.deepcopy(stored)
                merged["status"] = new.get("status", {})
                self._reown(stored, merged)
                merged["metadata"]["resourceVersion"] = self._bump()
                self._objs[key] = merged
                if plural == "events":
                    self._event_touch[key] = time.monotonic()
                self._emit_locked("MODIFIED", key, self._objs[key])
                return 200, self._objs[key]  # reference (see create)
            if kind in STATUS_SUBRESOURCE_KINDS:
                # a main-resource PUT cannot change status
                if "status" in stored:
                    new["status"] = copy.deepcopy(stored["status"])
                else:
                    new.pop("status", None)
            elif "status" not in new and "status" in stored:
                # real apiserver semantics for every kind: a
                # status-less main PUT (the operator re-applying a
                # rendered manifest) must not wipe status the kubelet
                # wrote — otherwise each reconcile would bounce
                # DaemonSet readiness through NotReady
                new["status"] = copy.deepcopy(stored["status"])
            return self._commit_main_locked(key, plural, kind, stored, new)

    @staticmethod
    def _reown(stored, new) -> None:
        """Ownership bookkeeping for non-apply writes (see
        kube/apply.py): leaves this write changed move to the
        ``unmanaged`` manager so a later non-forced APPLY on them
        conflicts instead of silently reverting. Caller-supplied
        ``managedFields`` never win — the computation always starts
        from the STORED object's."""
        from tpu_operator_torch.kube import apply as ssa

        ssa.reown(stored, new)

    def _commit_main_locked(self, key, plural, kind, stored, new, reown=True):
        """Shared commit tail for main-resource PUT, PATCH and APPLY
        (caller holds the lock and has already resolved subresource +
        immutable fields): ownership bookkeeping (skipped for APPLY,
        whose merge already computed it), admission, conditional
        generation bump, rv stamp, store, CRD/event hooks, MODIFIED
        emit. One definition so the write verbs cannot drift apart."""
        if reown:
            self._reown(stored, new)
        rejects = self._admit(kind, new)
        if rejects:
            return 422, _status(422, "Invalid", "; ".join(rejects))
        meta = new["metadata"]
        meta["generation"] = stored["metadata"].get("generation", 1) + (
            1 if new.get("spec") != stored.get("spec") else 0
        )
        meta["resourceVersion"] = self._bump()
        self._objs[key] = new
        if plural == "customresourcedefinitions":
            # an updated CRD schema takes effect immediately, as on a
            # real apiserver
            self._register_crd(self._objs[key])
        if plural == "events":
            self._event_touch[key] = time.monotonic()
        self._emit_locked("MODIFIED", key, self._objs[key])
        return 200, self._objs[key]  # reference (see create)

    def patch(self, group, version, plural, namespace, name, body: dict):
        """RFC 7386 JSON merge patch against the CURRENT revision: a
        patch body without ``metadata.resourceVersion`` has no conflict
        window (apiserver PATCH semantics — the operator's labels-only
        node writes ride this). A body that does carry an rv gets the
        same stale-rv 409 a PUT would."""
        kind, _ = PLURAL_TABLE[plural]
        with self._lock:
            key = self._key(group, version, plural, namespace, name)
            stored = self._objs.get(key)
            if stored is None:
                return 404, _status(404, "NotFound", f"{plural} {name} not found")
            body_rv = (body.get("metadata") or {}).get("resourceVersion")
            if body_rv is not None and str(body_rv) != stored["metadata"]["resourceVersion"]:
                return 409, _status(
                    409,
                    "Conflict",
                    f"{plural} {name}: resourceVersion {body_rv} is stale "
                    f"(current {stored['metadata']['resourceVersion']})",
                )
            new = copy.deepcopy(stored)
            patch = copy.deepcopy(body)
            if kind in STATUS_SUBRESOURCE_KINDS:
                # a main-resource PATCH cannot change a subresource status
                patch.pop("status", None)
            _json_merge_patch(new, patch)
            meta = new.setdefault("metadata", {})
            # immutable fields come from the store (a merge patch could
            # otherwise overwrite or null them)
            meta["uid"] = stored["metadata"]["uid"]
            if stored["metadata"].get("creationTimestamp") is not None:
                meta["creationTimestamp"] = stored["metadata"][
                    "creationTimestamp"
                ]
            meta["name"] = stored["metadata"]["name"]
            if stored["metadata"].get("namespace"):
                meta["namespace"] = stored["metadata"]["namespace"]
            return self._commit_main_locked(key, plural, kind, stored, new)

    def apply_ssa(
        self,
        group,
        version,
        plural,
        namespace,
        name,
        body: dict,
        field_manager=None,
        force: bool = True,
        prune: bool = True,
        create_only: bool = False,
        update_only: bool = False,
    ):
        """Server-side apply (``application/apply-patch+yaml``): ONE
        request that creates-or-merges under field-manager ownership
        (semantics in ``kube/apply.py``). A conflicting
        non-forced apply answers 409 with reason ``FieldConflict``
        naming the field and its owner; a no-op apply answers 200
        WITHOUT bumping the resourceVersion or emitting a watch event —
        the property that keeps a converged reconcile pass free."""
        from tpu_operator_torch.kube import apply as ssa

        kind, _ = PLURAL_TABLE[plural]
        manager = field_manager or ssa.DEFAULT_FIELD_MANAGER
        body = copy.deepcopy(body)
        meta = body.setdefault("metadata", {})
        if name:
            meta.setdefault("name", name)
        obj_name = meta.get("name", "")
        if not obj_name:
            return 422, _status(422, "Invalid", "metadata.name required")
        if kind in STATUS_SUBRESOURCE_KINDS:
            # apply to the main resource cannot touch a subresource status
            body.pop("status", None)
        with self._lock:
            key = self._key(group, version, plural, namespace, obj_name)
            stored = self._objs.get(key)
            if stored is None:
                if update_only:
                    return 404, _status(
                        404, "NotFound", f"{plural} {obj_name} not found"
                    )
                return self.create(
                    group,
                    version,
                    plural,
                    namespace,
                    ssa.create_from_applied(body, manager),
                )
            if create_only:
                return 409, _status(
                    409, "AlreadyExists", f"{plural} {obj_name} exists"
                )
            merged, changed, conflicts = ssa.apply_merge(
                stored, body, manager=manager, force=force, prune=prune
            )
            if conflicts:
                self.apply_conflicts += 1
                return 409, _status(
                    409,
                    "FieldConflict",
                    ssa.conflict_message(kind, obj_name, conflicts),
                )
            if not changed:
                return 200, stored  # reference (see create); NO rv bump
            return self._commit_main_locked(
                key, plural, kind, stored, merged, reown=False
            )

    def apply_batch(
        self,
        group,
        version,
        plural,
        namespace,
        items,
        field_manager=None,
        force: bool = True,
        prune: bool = True,
        update_only: bool = False,
    ):
        """Batched apply: one wire request carrying N sibling applied
        configurations (``{"items": [{"object": ..., "createOnly":
        bool}, ...]}``), processed strictly in order, answered with
        per-item status fan-back — one failed item fails only itself.
        The batch lane (kube/write_pipeline.BatchLane) rides this to
        amortize per-request overhead across a slice's label applies or
        a wave's DaemonSet applies."""
        out = []
        with self._lock:
            self.apply_batches += 1
            self.apply_batch_items += len(items)
        for item in items:
            if isinstance(item, dict) and "object" in item:
                obj = item.get("object") or {}
                create_only = bool(item.get("createOnly"))
            else:
                obj, create_only = item, False
            code, payload = self.apply_ssa(
                group,
                version,
                plural,
                namespace,
                "",
                obj,
                field_manager=field_manager,
                force=force,
                prune=prune,
                create_only=create_only,
                update_only=update_only,
            )
            entry = {"code": code}
            if code < 400:
                entry["object"] = payload
            else:
                entry["status"] = payload
            out.append(entry)
        return 200, {
            "apiVersion": "v1",
            "kind": "ApplyBatchResult",
            "items": out,
        }

    def delete(self, group, version, plural, namespace, name):
        with self._lock:
            key = self._key(group, version, plural, namespace, name)
            stored = self._objs.get(key)
            if stored is None:
                return 404, _status(404, "NotFound", f"{plural} {name} not found")
            # _delete_stored_locked stamps the DELETION resourceVersion on the
            # event (real apiserver semantics), cascades ownerRef GC, and
            # for Nodes removes bound pods (pod-GC / node-lifecycle
            # behavior — stale DaemonSet pods on dead nodes would pin
            # readiness NotReady forever, unlike any real cluster)
            self._delete_stored_locked(key, stored)
            return 200, _status(200, "Success", f"{plural} {name} deleted")

    def _delete_stored_locked(self, key, obj: dict) -> None:
        """Remove + emit with deletion-rv semantics, then cascade GC —
        the single deletion path shared by delete/_gc/_gc_node_pods.
        No-op when the object is already gone (an earlier cascade step in
        the same snapshot loop may have removed it): an object must never
        get two DELETED events."""
        if self._objs.pop(key, None) is None:
            return
        self._event_touch.pop(key, None)
        # copy before stamping the deletion rv: the last stored revision
        # may still be referenced by the event log / an in-flight LIST
        # serialization, and a logged revision must never change
        obj = copy.deepcopy(obj)
        obj["metadata"]["resourceVersion"] = self._bump()
        self._emit_locked("DELETED", key, obj)
        self._gc(obj["metadata"].get("uid"))
        if key[2] == "nodes":
            self._gc_node_pods(key[4])

    def _gc(self, owner_uid: Optional[str]) -> None:
        """Cascade-delete dependents (the apiserver's foreground GC)."""
        if not owner_uid:
            return
        dependents = [
            (key, obj)
            for key, obj in list(self._objs.items())
            if any(
                ref.get("uid") == owner_uid
                for ref in obj.get("metadata", {}).get("ownerReferences", [])
            )
        ]
        for key, obj in dependents:
            self._delete_stored_locked(key, obj)

    def _gc_node_pods(self, node_name: str) -> None:
        orphans = [
            (key, obj)
            for key, obj in list(self._objs.items())
            if key[2] == "pods"
            and obj.get("spec", {}).get("nodeName") == node_name
        ]
        for key, obj in orphans:
            self._delete_stored_locked(key, obj)

    def evict(self, group, version, namespace, name):
        """pods/{name}/eviction with PodDisruptionBudget enforcement: a
        disruption that would violate a matching budget answers 429 (the
        apiserver's disruption-controller contract kubectl drain retries
        against — ``vendor/k8s.io/kubectl/pkg/drain/drain.go:43-45``)."""
        from tpu_operator_torch.kube.disruption import eviction_blocked_by

        with self._lock:
            key = self._key("", "v1", "pods", namespace, name)
            pod = self._objs.get(key)
            if pod is None:
                return 404, _status(404, "NotFound", f"pods {name} not found")
            pods = [
                o for k, o in self._objs.items()
                if k[2] == "pods" and k[3] == namespace
            ]
            pdbs = [
                o for k, o in self._objs.items()
                if k[2] == "poddisruptionbudgets" and k[3] == namespace
            ]
            blocked = eviction_blocked_by(pod, pods, pdbs)
            if blocked is not None:
                return 429, _status(429, "TooManyRequests", blocked[1])
            self._delete_stored_locked(key, pod)
            return 201, _status(201, "Success", f"pod {name} evicted")

    def get(self, group, version, plural, namespace, name):
        with self._lock:
            stored = self._objs.get(self._key(group, version, plural, namespace, name))
            if stored is None:
                return 404, _status(404, "NotFound", f"{plural} {name} not found")
            return 200, copy.deepcopy(stored)

    def list(
        self,
        group,
        version,
        plural,
        namespace,
        label_sel="",
        field_sel="",
        limit=0,
        cont="",
    ):
        code, payload = self._list_refs(
            group, version, plural, namespace, label_sel, field_sel,
            limit, cont,
        )
        if code != 200:
            return code, payload
        # public/in-process callers get private copies (they may mutate)
        payload["items"] = [copy.deepcopy(o) for o in payload["items"]]
        return 200, payload

    def list_json(
        self,
        group,
        version,
        plural,
        namespace,
        label_sel="",
        field_sel="",
        limit=0,
        cont="",
    ) -> Tuple[int, bytes]:
        """LIST serialized straight from the store references — the HTTP
        handler's path. A fleet LIST (1000 Nodes, 9000 operand pods per
        kubelet sweep) used to deepcopy every object only for the result
        to be json-dumped and discarded; serializing under the lock
        skips the copy entirely (json.dumps never mutates). Stored
        objects are only ever REPLACED on write, so the references are
        stable for the duration of the dump."""
        code, payload = self._list_refs(
            group, version, plural, namespace, label_sel, field_sel,
            limit, cont,
        )
        return code, json.dumps(payload).encode()

    @staticmethod
    def _continue_token(rv: int, after_key) -> str:
        import base64

        blob = json.dumps({"rv": rv, "after": list(after_key)})
        return base64.urlsafe_b64encode(blob.encode()).decode()

    @staticmethod
    def _parse_continue(token: str):
        """(pinned rv, after (ns, name)) or None for a bad token."""
        import base64

        try:
            doc = json.loads(base64.urlsafe_b64decode(token.encode()))
            return int(doc["rv"]), tuple(doc["after"])
        except Exception:
            return None

    def _list_refs(
        self,
        group,
        version,
        plural,
        namespace,
        label_sel,
        field_sel,
        limit=0,
        cont="",
    ):
        """Shared LIST body; ``items`` holds STORE REFERENCES (callers
        must copy or serialize, never mutate). Serialization/copy happens
        outside the lock — safe because EVERY write path (create/update/
        patch/_mutate_stored/_delete_stored_locked) REPLACES stored objects
        copy-on-write instead of mutating them in place, so a reference
        always denotes one immutable revision.

        ``limit``/``cont`` implement apiserver chunked LIST semantics
        (required at 50k nodes, useful at 1k: one unbounded fleet LIST
        serialized the whole store in one response): results are ordered
        by (namespace, name), a truncated page carries an opaque
        ``metadata.continue`` token naming the last key, and EVERY page
        reports the resourceVersion pinned when the first page was cut —
        so a watch resumed from it replays anything that landed while
        the client paged."""
        kind, namespaced = PLURAL_TABLE[plural]
        if plural == "events":
            self.expire_events()
        if label_sel:
            # parse once up front: a malformed selector is 400 Bad
            # Request, not an empty result
            from tpu_operator_torch.kube.selector import parse_selector

            try:
                parse_selector(label_sel)
            except ValueError as e:
                return 400, _status(400, "BadRequest", str(e))
        pinned_rv = None
        after = None
        if cont:
            parsed = self._parse_continue(cont)
            if parsed is None:
                return 400, _status(
                    400, "BadRequest", "malformed continue token"
                )
            pinned_rv, after = parsed
        limit = max(0, int(limit or 0))
        with self._lock:
            items = []
            for (g, v, p, ns, name), obj in self._objs.items():
                if (g, v, p) != (group, version, plural):
                    continue
                if namespaced and namespace and ns != namespace:
                    continue
                if after is not None and (ns, name) <= after:
                    continue
                if label_sel and not _match_label_selector(obj, label_sel):
                    continue
                if field_sel and not _match_field_selector(obj, field_sel):
                    continue
                items.append(((ns, name), obj))
            meta = {
                "resourceVersion": str(
                    pinned_rv if pinned_rv is not None else self._rv
                )
            }
            if limit and len(items) > limit:
                items.sort(key=lambda e: e[0])
                page, rest = items[:limit], items[limit:]
                meta["continue"] = self._continue_token(
                    pinned_rv if pinned_rv is not None else self._rv,
                    page[-1][0],
                )
                meta["remainingItemCount"] = len(rest)
                items = page
            elif after is not None or limit:
                items.sort(key=lambda e: e[0])
            return 200, {
                "apiVersion": f"{group}/{version}" if group else version,
                "kind": f"{kind}List",
                "metadata": meta,
                "items": [obj for _, obj in items],
            }

    # -- watch ------------------------------------------------------------
    def watch_events(self, group, version, plural, namespace, since_rv, stop, timeout_s):
        """Generator of (etype, obj) watch events; raises nothing. Yields
        ('ERROR', gone-status) once when since_rv was compacted away."""
        kind, namespaced = PLURAL_TABLE[plural]

        def relevant(key):
            g, v, p, ns, _ = key
            if (g, v, p) != (group, version, plural):
                return False
            return not (namespaced and namespace and ns != namespace)

        deadline = time.monotonic() + timeout_s
        last_bookmark = time.monotonic()
        with self._lock:
            # 410 only when an event for THIS plural was compacted past
            # the resume rv — the per-kind watch-cache contract; a global
            # horizon would force a quiet kind into a pointless re-list
            gone = bool(since_rv) and (
                self._compacted_rv_by_plural.get(plural, 0) > int(since_rv)
            )
            cursor = int(since_rv) if since_rv else self._rv
        # NEVER yield while holding the sim lock: the consumer writes to a
        # client socket, and a stalled client must not freeze the cluster
        if gone:
            yield "ERROR", _status(
                410, "Expired", f"resourceVersion {since_rv} is too old"
            )
            return
        while not stop.is_set() and time.monotonic() < deadline:
            if self.partitioned():
                # a partition cuts live streams too: the client sees a
                # clean close, and its reconnect hits the 503 wall
                return
            if plural == "events":
                # any active Event watch keeps expiry live even when
                # nobody lists — informers must see the DELETEDs
                self.expire_events()
            batch: List[Tuple[str, dict]] = []
            with self._lock:
                cond = self._cond_for(plural)
                if self._compacted_rv_by_plural.get(plural, 0) > cursor:
                    # events for this plural between our cursor and the
                    # log head were compacted away while we waited: the
                    # client MUST re-list (the 410 Gone contract)
                    gone = True
                else:
                    # bisect to the first event past the cursor: a wake
                    # touches only NEW events, not the whole log. The
                    # batch carries references — logged revisions are
                    # immutable and the consumer only json-serializes
                    start = bisect_right(self._event_rvs, cursor)
                    for rv, etype, key, obj in self._events[start:]:
                        if relevant(key):
                            batch.append((etype, obj))
                    if self._events:
                        cursor = max(cursor, self._events[-1][0])
                    if not batch:
                        # cond wraps self._lock (_cond_for), so this
                        # wait RELEASES the lock — the one correct
                        # under-lock wait; the resolver cannot see
                        # through the local variable
                        cond.wait(0.2)  # lint: ignore[lock-blocking]
            if gone:
                yield "ERROR", _status(410, "Expired", "history compacted")
                return
            for etype, obj in batch:
                if self._consume_watch_drop(plural):
                    continue  # injected fault: this stream never sees it
                yield etype, obj
            now = time.monotonic()
            if now - last_bookmark >= self.bookmark_interval_s:
                last_bookmark = now
                yield "BOOKMARK", {"metadata": {"resourceVersion": str(cursor)}}


def _json_merge_patch(target: dict, patch: dict) -> None:
    """RFC 7386 merge patch, in place: dicts merge recursively, ``null``
    deletes, everything else replaces."""
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict):
            current = target.get(k)
            if not isinstance(current, dict):
                current = target[k] = {}
            _json_merge_patch(current, v)
        else:
            target[k] = v


def _status(code: int, reason: str, message: str) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Status",
        "status": "Success" if code < 400 else "Failure",
        "code": code,
        "reason": reason,
        "message": message,
    }


def _match_label_selector(obj: dict, selector: str) -> bool:
    """Full apiserver selector grammar including set-based terms
    (``in``/``notin``/``!key``); raises ValueError on malformed input,
    which the handler answers with 400 like a real apiserver."""
    from tpu_operator_torch.kube.selector import matches

    return matches(obj.get("metadata", {}).get("labels", {}) or {}, selector)


def _match_field_selector(obj: dict, selector: str) -> bool:
    for term in selector.split(","):
        if "=" not in term:
            continue
        k, v = term.split("=", 1)
        cur: Any = obj
        for part in k.split("."):
            if not isinstance(cur, dict):
                return False
            cur = cur.get(part)
        if str(cur) != v:
            return False
    return True


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # a response goes out as two writes (headers, then body); with Nagle on,
    # the body waits for the client's delayed ACK of the headers, ~40 ms a
    # request on Linux. An API server answers with TCP_NODELAY set (Go's
    # default), so the simulator does too.
    disable_nagle_algorithm = True
    sim: KubeSim = None  # injected by serve()
    stop_event: threading.Event = None

    def log_message(self, *a):  # quiet
        pass

    # -- plumbing ---------------------------------------------------------
    def _json(self, code: int, obj: dict, headers: Optional[dict] = None) -> None:
        self._json_bytes(code, json.dumps(obj).encode(), headers)

    def _json_bytes(
        self, code: int, data: bytes, headers: Optional[dict] = None
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def _maybe_fault(self, verb: str, plural: str) -> bool:
        """Consume an injected fault for this request. Returns True when
        the request was answered with an injected error (the caller must
        return); latency-only faults delay, then fall through to normal
        service."""
        fault = self.sim.next_fault(verb, plural)
        if fault is None:
            return False
        if fault["latency_s"]:
            time.sleep(fault["latency_s"])
        code = fault["code"]
        if not code:
            return False  # latency-only: serve normally after the delay
        headers = {}
        if fault["retry_after"] is not None:
            headers["Retry-After"] = fault["retry_after"]
        reason = {
            429: "TooManyRequests",
            500: "InternalError",
            503: "ServiceUnavailable",
        }.get(code, "InjectedFault")
        self._json(
            code,
            _status(code, reason, f"injected fault on {verb} {plural}"),
            headers,
        )
        return True

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    def _route(self):
        """path -> (group, version, plural, namespace, name, subresource)
        or None for unroutable paths."""
        parsed = urlparse(self.path)
        m = _GV_RE.match(parsed.path)
        if not m:
            return None
        group = m.group("group") or ""
        version = m.group("version")
        rest = [s for s in (m.group("rest") or "").split("/") if s]
        namespace = ""
        if rest and rest[0] == "namespaces":
            if len(rest) <= 2:
                # the Namespace collection/object itself:
                # /api/v1/namespaces[/{name}]
                return group, version, "namespaces", "", (
                    rest[1] if len(rest) == 2 else ""
                ), ""
            # /namespaces/{ns}/<plural>[/{name}[/{subresource}]]
            namespace = rest[1]
            rest = rest[2:]
        if not rest:
            return None
        plural = rest[0]
        name = rest[1] if len(rest) > 1 else ""
        sub = rest[2] if len(rest) > 2 else ""
        if plural not in PLURAL_TABLE:
            return None
        return group, version, plural, namespace, name, sub

    # -- verbs ------------------------------------------------------------
    def do_GET(self):
        route = self._route()
        if route is None:
            return self._json(404, _status(404, "NotFound", self.path))
        group, version, plural, namespace, name, _ = route
        qs = parse_qs(urlparse(self.path).query)
        if name:
            self.sim.count_request("GET", plural=plural)
            if self._maybe_fault("GET", plural):
                return None
            code, obj = self.sim.get(group, version, plural, namespace, name)
            return self._json(code, obj)
        if qs.get("watch", ["false"])[0] == "true":
            self.sim.count_request("GET", is_watch=True, plural=plural)
            if self._maybe_fault("WATCH", plural):
                return None
            return self._watch(group, version, plural, namespace, qs)
        self.sim.count_request("LIST", plural=plural)
        if self._maybe_fault("LIST", plural):
            return None
        # zero-copy serialization: the response is dumped straight from
        # store references (fleet LISTs used to deepcopy every object
        # just to discard the copies after serializing)
        try:
            limit = int(qs.get("limit", ["0"])[0])
        except ValueError:
            limit = 0
        code, data = self.sim.list_json(
            group,
            version,
            plural,
            namespace,
            label_sel=qs.get("labelSelector", [""])[0],
            field_sel=qs.get("fieldSelector", [""])[0],
            limit=limit,
            cont=qs.get("continue", [""])[0],
        )
        return self._json_bytes(code, data)

    def _watch(self, group, version, plural, namespace, qs):
        since_rv = qs.get("resourceVersion", [""])[0]
        timeout_s = int(qs.get("timeoutSeconds", ["300"])[0])
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_chunk(payload: bytes):
            self.wfile.write(f"{len(payload):X}\r\n".encode())
            self.wfile.write(payload + b"\r\n")
            self.wfile.flush()

        try:
            for etype, obj in self.sim.watch_events(
                group, version, plural, namespace, since_rv,
                self.stop_event, timeout_s,
            ):
                line = json.dumps({"type": etype, "object": obj}) + "\n"
                send_chunk(line.encode())
                if etype == "ERROR":
                    break
        except (BrokenPipeError, ConnectionResetError):
            return
        try:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            pass

    def do_POST(self):
        route = self._route()
        if route is None:
            return self._json(404, _status(404, "NotFound", self.path))
        group, version, plural, namespace, name, sub = route
        self.sim.count_request("POST", plural=plural)
        body = self._body()
        if self._maybe_fault("POST", plural):
            return None
        if plural == "pods" and sub == "eviction":
            code, obj = self.sim.evict(group, version, namespace, name)
            return self._json(code, obj)
        code, obj = self.sim.create(group, version, plural, namespace, body)
        return self._json(code, obj)

    def do_PUT(self):
        route = self._route()
        if route is None:
            return self._json(404, _status(404, "NotFound", self.path))
        group, version, plural, namespace, name, sub = route
        self.sim.count_request("PUT", plural=plural)
        # the body MUST be consumed before an injected error reply:
        # unread bytes would corrupt the next request on the keep-alive
        # connection
        body = self._body()
        if self._maybe_fault("PUT", plural):
            return None
        code, obj = self.sim.update(
            group, version, plural, namespace, name, body,
            status_only=(sub == "status"),
        )
        return self._json(code, obj)

    def do_PATCH(self):
        route = self._route()
        if route is None:
            return self._json(404, _status(404, "NotFound", self.path))
        group, version, plural, namespace, name, sub = route
        ctype = self.headers.get("Content-Type", "") or ""
        if ctype.startswith("application/apply-patch"):
            # server-side apply rides PATCH on the wire but is its own
            # verb for accounting AND fault injection: the chaos
            # matrices target APPLY directly
            self.sim.count_request("APPLY", plural=plural)
            body = self._body()  # consume before injected replies (framing)
            if self._maybe_fault("APPLY", plural):
                return None
            if sub:
                return self._json(
                    405,
                    _status(
                        405,
                        "MethodNotAllowed",
                        f"apply on subresource {sub!r} is not supported",
                    ),
                )
            qs = parse_qs(urlparse(self.path).query)
            field_manager = qs.get("fieldManager", [None])[0]
            force = qs.get("force", ["false"])[0] == "true"
            prune = qs.get("prune", ["true"])[0] == "true"
            update_only = qs.get("updateOnly", ["false"])[0] == "true"
            if name:
                create_only = qs.get("createOnly", ["false"])[0] == "true"
                code, obj = self.sim.apply_ssa(
                    group, version, plural, namespace, name, body,
                    field_manager=field_manager, force=force, prune=prune,
                    create_only=create_only, update_only=update_only,
                )
            else:
                code, obj = self.sim.apply_batch(
                    group, version, plural, namespace,
                    body.get("items") or [],
                    field_manager=field_manager, force=force, prune=prune,
                    update_only=update_only,
                )
            return self._json(code, obj)
        self.sim.count_request("PATCH", plural=plural)
        body = self._body()  # consume before any injected reply (framing)
        if self._maybe_fault("PATCH", plural):
            return None
        if sub:
            # subresource PATCH is not simulated: refusing loudly beats
            # silently merging a /status patch into the main resource
            return self._json(
                405,
                _status(
                    405,
                    "MethodNotAllowed",
                    f"PATCH on subresource {sub!r} is not supported by kubesim",
                ),
            )
        code, obj = self.sim.patch(
            group, version, plural, namespace, name, body
        )
        return self._json(code, obj)

    def do_DELETE(self):
        route = self._route()
        if route is None:
            return self._json(404, _status(404, "NotFound", self.path))
        group, version, plural, namespace, name, _ = route
        self.sim.count_request("DELETE", plural=plural)
        if self._maybe_fault("DELETE", plural):
            return None
        code, obj = self.sim.delete(group, version, plural, namespace, name)
        return self._json(code, obj)


class KubeSimServer:
    """Owns the HTTP server lifecycle around a KubeSim store."""

    def __init__(self, sim: Optional[KubeSim] = None, port: int = 0):
        self.sim = sim or KubeSim()
        self.stop_event = threading.Event()
        handler = type(
            "BoundHandler", (_Handler,), {"sim": self.sim, "stop_event": self.stop_event}
        )
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "KubeSimServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.stop_event.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def make_client(port: int):
    """A RestClient speaking plain HTTP to a local kubesim (the operator's
    production client class, not a test double)."""
    from http.client import HTTPConnection

    from tpu_operator_torch.kube.rest import RestClient

    class _HttpRestClient(RestClient):
        def __init__(self):
            super().__init__(
                host="127.0.0.1", port=str(port), token="kubesim", insecure=True
            )

        def _make_conn(self, timeout: float = 30):
            return HTTPConnection(self.host, self.port, timeout=timeout)

    return _HttpRestClient()
