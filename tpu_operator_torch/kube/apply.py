"""Server-side-apply engine: field-ownership APPLY semantics.

The port's copy of ``tpu_operator/kube/apply.py``; the operator's field
manager is ``gpu-operator``.

The reference operator leans on controller-runtime's server-side apply
(`client.Apply` with a field manager) so convergence is ONE idempotent
request per object: the apiserver merges the applied configuration into
the live object honoring per-field *ownership* recorded in
``metadata.managedFields``, detects conflicts with other managers, and
removes fields the manager stopped applying. This module is that model
for the stdlib-only client stack — the single definition of
the merge/ownership semantics every implementation shares:

* ``FakeClient.apply_ssa`` applies it natively in-store;
* kubesim applies it server-side behind a real
  ``application/apply-patch+yaml`` PATCH (the APPLY verb);
* ``RestClient.apply_ssa`` speaks that wire verb;
* ``CachedClient`` write-throughs the response;
* the generic ``Client.apply_ssa`` fallback emulates it with
  read-merge-update for exotic wrappers.

Field model (deliberately compact — structured for what the operator
writes, not the full Kubernetes fieldsV1 grammar):

* an object is a tree of dicts; every non-dict value (scalars AND
  lists) is an atomic **leaf**. Lists are atomic on purpose: the
  operator owns its manifests outright, so strategic list merging buys
  nothing here (``listType=map`` is out of scope).
* leaf paths are recorded as RFC 6901 JSON pointers
  (``/metadata/labels/tpu.k8s.io~1tpu.present``) under
  ``metadata.managedFields`` as ``[{"manager": m, "fields": [ptr..]}]``.
* **conflict**: an apply that SETS a leaf owned by a different manager
  to a different value fails with ``ApplyConflictError`` naming the
  field and its owner; ``force=True`` transfers ownership (the escape
  hatch the operator uses on its own operands).
* **removal on omission** (``prune=True``, real SSA semantics): leaves
  this manager owned but no longer applies are removed. Delta-style
  writers (the node-label bus) pass ``prune=False``: omission means
  "not mine to say", and ownership accrues across applies.
* **explicit delete**: a leaf applied as ``None`` is removed from the
  live object and from every manager's ownership — the merge-patch
  ``null`` dialect, kept because the label bus must be able to strip
  keys other actors (TFD) wrote without first force-owning them.
  Deletes never conflict.
* non-apply writes (PUT / merge PATCH) re-own the leaves they changed
  under the writing manager (default ``"unmanaged"``), exactly so a
  human ``kubectl label`` landing between an operator read and its
  APPLY surfaces as a conflict instead of being silently reverted —
  the guarantee the old rv-conditional label patch provided, without
  the rv's false conflicts against unrelated writers.

``ApplySet`` is the pruning half: a render pass registers every object
it intends; objects applied by a previous pass but absent from the
current one (a renamed DaemonSet, a dropped generation fan-out) are
abandoned and deleted — no hand-written delete path per rename.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from tpu_operator_torch.kube.client import ConflictError, Obj

Path = Tuple[str, ...]

#: the operator's field manager identity (reference: the controller's
#: ``FieldOwner`` on every Apply call)
DEFAULT_FIELD_MANAGER = "gpu-operator"

#: ownership bucket for writes that arrive without a manager (plain
#: PUT/PATCH from humans, simulators, other controllers)
UNMANAGED = "unmanaged"

#: sentinel for "path absent from the object"
MISSING = object()

# server-owned / identity fields: never merged, never owned, never
# conflicting (the apiserver treats these the same way)
_EXCLUDED: Set[Path] = {
    ("apiVersion",),
    ("kind",),
    ("metadata", "name"),
    ("metadata", "namespace"),
    ("metadata", "uid"),
    ("metadata", "resourceVersion"),
    ("metadata", "creationTimestamp"),
    ("metadata", "generation"),
    ("metadata", "managedFields"),
}


class ApplyConflictError(ConflictError):
    """A non-forced apply tried to set a field owned by another manager
    to a different value. ``conflicts`` is ``[(json_pointer, manager)]``
    so callers (and the error message) name exactly what clashed."""

    def __init__(self, message: str, conflicts=None):
        super().__init__(message)
        self.conflicts: List[Tuple[str, str]] = list(conflicts or ())


# ---------------------------------------------------------------------------
# JSON-pointer path encoding (RFC 6901)
# ---------------------------------------------------------------------------


def _escape(seg: str) -> str:
    return seg.replace("~", "~0").replace("/", "~1")


def _unescape(seg: str) -> str:
    return seg.replace("~1", "/").replace("~0", "~")


def encode_path(path: Path) -> str:
    return "/" + "/".join(_escape(s) for s in path)


def decode_path(ptr: str) -> Path:
    return tuple(_unescape(s) for s in ptr.lstrip("/").split("/"))


# ---------------------------------------------------------------------------
# leaf-path math
# ---------------------------------------------------------------------------


def leaf_paths(obj: Obj, _prefix: Path = ()) -> Dict[Path, Any]:
    """Every atomic leaf of ``obj`` as ``{path: value}``, excluding the
    server-owned identity fields. Dicts recurse; empty dicts, scalars
    and lists are leaves."""
    out: Dict[Path, Any] = {}
    for k, v in obj.items():
        p = _prefix + (k,)
        if p in _EXCLUDED:
            continue
        if isinstance(v, dict) and v:
            out.update(leaf_paths(v, p))
        else:
            out[p] = v
    return out


def get_path(obj: Obj, path: Path, default: Any = MISSING) -> Any:
    cur: Any = obj
    for seg in path:
        if not isinstance(cur, dict) or seg not in cur:
            return default
        cur = cur[seg]
    return cur


def set_path(obj: Obj, path: Path, value: Any) -> None:
    cur = obj
    for seg in path[:-1]:
        nxt = cur.get(seg)
        if not isinstance(nxt, dict):
            nxt = cur[seg] = {}
        cur = nxt
    cur[path[-1]] = value


def delete_path(obj: Obj, path: Path) -> None:
    """Remove ``path`` and prune parents emptied by the removal (an
    empty ``labels`` dict round-trips as absent, like the apiserver)."""
    parents: List[Tuple[Obj, str]] = []
    cur: Any = obj
    for seg in path[:-1]:
        if not isinstance(cur, dict) or seg not in cur:
            return
        parents.append((cur, seg))
        cur = cur[seg]
    if isinstance(cur, dict):
        cur.pop(path[-1], None)
    for parent, seg in reversed(parents):
        child = parent.get(seg)
        if isinstance(child, dict) and not child:
            del parent[seg]
        else:
            break


# ---------------------------------------------------------------------------
# managedFields encoding
# ---------------------------------------------------------------------------


def decode_managed(obj: Obj) -> Dict[str, Set[Path]]:
    """``metadata.managedFields`` → ``{manager: {paths}}`` (tolerant of
    absent/malformed blocks — an object that never saw ownership
    tracking is simply unowned)."""
    out: Dict[str, Set[Path]] = {}
    for entry in obj.get("metadata", {}).get("managedFields") or []:
        if not isinstance(entry, dict):
            continue
        manager = entry.get("manager")
        fields = entry.get("fields")
        if not manager or not isinstance(fields, list):
            continue
        out.setdefault(manager, set()).update(
            decode_path(p) for p in fields if isinstance(p, str)
        )
    return out


def encode_managed(obj: Obj, owned: Dict[str, Set[Path]]) -> None:
    """Write ``owned`` back as ``metadata.managedFields`` (sorted, so
    stored objects are deterministic and no-op detection is exact);
    empty ownership removes the block entirely."""
    entries = [
        {"manager": m, "fields": sorted(encode_path(p) for p in paths)}
        for m, paths in sorted(owned.items())
        if paths
    ]
    meta = obj.setdefault("metadata", {})
    if entries:
        meta["managedFields"] = entries
    else:
        meta.pop("managedFields", None)


def strip_managed(obj: Obj) -> Obj:
    """A shallow-cloned view without ``managedFields`` (content
    comparison must ignore ownership bookkeeping)."""
    meta = obj.get("metadata")
    if isinstance(meta, dict) and "managedFields" in meta:
        obj = dict(obj)
        obj["metadata"] = {k: v for k, v in meta.items() if k != "managedFields"}
    return obj


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


def _content_equal(a: Obj, b: Obj) -> bool:
    sa, sb = dict(strip_managed(a)), dict(strip_managed(b))
    for d in (sa, sb):
        meta = d.get("metadata")
        if isinstance(meta, dict) and "resourceVersion" in meta:
            d["metadata"] = {
                k: v for k, v in meta.items() if k != "resourceVersion"
            }
    return sa == sb


def apply_merge(
    stored: Obj,
    applied: Obj,
    *,
    manager: str = DEFAULT_FIELD_MANAGER,
    force: bool = False,
    prune: bool = True,
) -> Tuple[Obj, bool, List[Tuple[str, str]]]:
    """Merge ``applied`` into a deep copy of ``stored`` under SSA
    semantics. Returns ``(merged, changed, conflicts)``:

    * ``conflicts`` non-empty (and ``merged is stored`` untouched) when
      ``force=False`` and another manager owns a differing leaf;
    * ``changed`` covers content OR ownership movement — ``False`` means
      the apply is a complete no-op (callers skip the rv bump and the
      watch event, which is what keeps repeated applies free).
    """
    applied_leaves = leaf_paths(applied)
    owned = decode_managed(stored)
    conflicts: List[Tuple[str, str]] = []
    for path, val in applied_leaves.items():
        if val is None:
            continue  # explicit deletes never conflict (see module doc)
        if get_path(stored, path, MISSING) == val:
            continue  # same value: co-sets agree, ownership just moves
        others = sorted(
            m for m, paths in owned.items() if path in paths and m != manager
        )
        if others:
            conflicts.append((encode_path(path), others[0]))
    if conflicts:
        if not force:
            return stored, False, conflicts
        conflicts = []  # force: ownership of the clashing leaves transfers

    new = copy.deepcopy(stored)
    mine = set(owned.get(manager, ()))
    applied_set = {p for p, v in applied_leaves.items() if v is not None}
    deleted = {p for p, v in applied_leaves.items() if v is None}
    if prune:
        # removal on omission: fields I owned and stopped applying go
        for path in mine - set(applied_leaves):
            delete_path(new, path)
            deleted.add(path)
    for path, val in applied_leaves.items():
        if val is None:
            delete_path(new, path)
        else:
            set_path(new, path, copy.deepcopy(val))
    # ownership: applied leaves become mine (exclusively — a forced or
    # value-equal apply transfers them); deleted leaves leave everyone
    new_owned: Dict[str, Set[Path]] = {}
    for m, paths in owned.items():
        kept = paths - applied_set - deleted
        if kept:
            new_owned[m] = kept
    new_mine = applied_set if prune else (mine - deleted) | applied_set
    if new_mine:
        new_owned[manager] = new_mine
    encode_managed(new, new_owned)
    changed = not _content_equal(new, stored) or new_owned != owned
    return new, changed, conflicts


def create_from_applied(
    applied: Obj, manager: str = DEFAULT_FIELD_MANAGER
) -> Obj:
    """The object an apply CREATES when nothing exists: the applied
    config minus ``None`` (delete-directive) leaves, with every leaf
    owned by ``manager``."""
    new = copy.deepcopy(applied)
    for path, val in leaf_paths(applied).items():
        if val is None:
            delete_path(new, path)
    encode_managed(new, {manager: set(leaf_paths(new))})
    return new


def reown(old: Obj, new: Obj, manager: str = UNMANAGED) -> None:
    """Ownership bookkeeping for a NON-apply write committing ``new``
    over ``old``: leaves the write changed or added move to ``manager``;
    leaves it removed drop from every manager. Mutates ``new`` in place
    (its ``managedFields`` always start from the STORED object's — a
    caller-supplied stale copy must never win)."""
    owned = decode_managed(old)
    old_leaves = leaf_paths(old)
    new_leaves = leaf_paths(new)
    touched = {
        p
        for p in set(old_leaves) | set(new_leaves)
        if old_leaves.get(p, MISSING) != new_leaves.get(p, MISSING)
    }
    if not touched and owned == decode_managed(new):
        encode_managed(new, owned)
        return
    removed = touched - set(new_leaves)
    changed = touched & set(new_leaves)
    new_owned: Dict[str, Set[Path]] = {}
    for m, paths in owned.items():
        kept = paths - removed - changed
        if kept:
            new_owned[m] = kept
    if changed:
        new_owned.setdefault(manager, set()).update(changed)
    encode_managed(new, new_owned)


def conflict_message(kind: str, name: str, conflicts) -> str:
    detail = "; ".join(f"{ptr} (owned by {m})" for ptr, m in conflicts)
    return (
        f"apply to {kind} {name} conflicts with other field managers: "
        f"{detail}"
    )


# ---------------------------------------------------------------------------
# batch flush
# ---------------------------------------------------------------------------


def batch_flush(
    client,
    payloads,
    field_manager: Optional[str] = None,
    force: bool = True,
    prune: bool = True,
    update_only: bool = False,
):
    """BatchLane flush function body: group mixed payloads by their
    (apiVersion, kind, namespace) collection — a wire batch submission
    targets ONE collection — issue one ``apply_ssa_batch`` per group,
    and fan the per-item results back in the caller's order. Payloads
    are objects or ``(object, create_only)`` pairs."""
    norm = [p if isinstance(p, tuple) else (p, False) for p in payloads]
    groups: Dict[Tuple[str, str, str], List[int]] = {}
    for i, (obj, _) in enumerate(norm):
        gk = (
            obj.get("apiVersion", ""),
            obj.get("kind", ""),
            obj.get("metadata", {}).get("namespace", ""),
        )
        groups.setdefault(gk, []).append(i)
    results: List[Tuple[Any, Optional[BaseException]]] = [
        (None, RuntimeError("batch item unflushed"))
    ] * len(norm)
    for indexes in groups.values():
        group_results = client.apply_ssa_batch(
            [norm[i] for i in indexes],
            field_manager=field_manager,
            force=force,
            prune=prune,
            update_only=update_only,
        )
        for slot, res in zip(indexes, group_results):
            results[slot] = res
    return results


# ---------------------------------------------------------------------------
# apply-set pruning
# ---------------------------------------------------------------------------

ApplyKey = Tuple[str, str, str, str]  # (apiVersion, kind, namespace, name)


class ApplySet:
    """Membership tracker for one writer's applied objects (the
    ``kubectl apply --prune`` / applyset.kubernetes.io role).

    A pass brackets its registrations with ``begin_pass`` … ``commit``;
    ``commit`` returns the keys applied by an earlier committed pass but
    absent from this one — abandoned objects the caller deletes. Only
    keys the set has SEEN are ever returned, so pruning can never touch
    an object this writer didn't create. A pass that died mid-way calls
    ``abort`` (or simply never commits) and membership stays at the last
    complete picture. Thread-safe (states of one DAG wave register
    concurrently); persisted through the warm-restart journal so a
    rename straddling a restart still prunes."""

    def __init__(self, members: Iterable[ApplyKey] = ()):
        self._lock = threading.Lock()
        self._members: Set[ApplyKey] = {tuple(m) for m in members}
        self._current: Optional[Set[ApplyKey]] = None
        self.pruned_total = 0

    def begin_pass(self) -> None:
        with self._lock:
            self._current = set()

    def seen(self, api_version: str, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            if self._current is not None:
                self._current.add((api_version, kind, namespace or "", name))

    def seen_obj(self, obj: Obj) -> None:
        meta = obj.get("metadata", {})
        self.seen(
            obj.get("apiVersion", ""),
            obj.get("kind", ""),
            meta.get("namespace", ""),
            meta.get("name", ""),
        )

    def abort(self) -> None:
        with self._lock:
            self._current = None

    def commit(self) -> List[ApplyKey]:
        """Seal the pass: membership becomes this pass's set; returns
        the abandoned keys (sorted, so pruning order is deterministic).
        A no-pass commit (begin_pass never ran) returns nothing."""
        with self._lock:
            if self._current is None:
                return []
            abandoned = sorted(self._members - self._current)
            self._members = self._current
            self._current = None
            return abandoned

    def retain(self, key: ApplyKey) -> None:
        """Re-add a key to sealed membership (a prune delete that failed
        must stay a member so the next pass's commit returns it again)."""
        with self._lock:
            self._members.add(tuple(key))

    def record_pruned(self) -> None:
        """Count one RESOLVED abandonment — called by the pruner after
        the delete lands (or the object proved already gone), never at
        commit: a delete that keeps failing and re-retaining its key
        must not inflate the counter once per pass."""
        with self._lock:
            self.pruned_total += 1

    def members(self) -> List[ApplyKey]:
        with self._lock:
            return sorted(self._members)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "members": len(self._members),
                "pruned_total": self.pruned_total,
            }
