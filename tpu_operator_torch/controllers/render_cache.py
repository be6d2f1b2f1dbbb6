"""Memoized manifest render pipeline keyed by a desired-state fingerprint.

The port's copy of ``tpu_operator/controllers/render_cache.py``. The
set the per-entry half is keyed by is the set of card variants present
(``h100-sxm``, ...), as the port's ClusterPolicy keys
``generationConfigs`` by card variant; the reference keys it by TPU
generation. A digest of the same payload is the reference's byte for
byte (``_digest``).

The reconcile hot loop is "render manifests → transform → hash-gated
apply → readiness". The informer cache makes the *read* half zero-copy;
this module removes the *render* half from the steady state. At steady state the
desired output of every control is a pure function of a small input
fingerprint — the ClusterPolicy spec (+ generation/uid), the operator
namespace, the discovered container runtime, the openshift flag and the
set of card variants present. While that fingerprint holds, each
control's ``copy.deepcopy`` + transform chain + ``compute_hash`` is
skipped entirely: the cached, pre-hashed, FROZEN rendered manifest
(``kube/frozen.py``) goes straight to the hash-annotation compare and
the readiness check.

Invalidation granularity:

* the **base fingerprint** covers every input a transform may read
  (spec, generation, uid, namespace, runtime, openshift). Any change —
  a spec edit, a runtime flip, a CR recreate — clears the whole cache:
  transforms read arbitrary spec fields, so nothing finer is safe.
* the **card-variant set** affects only the per-variant driver
  fan-out. A new variant appearing renders exactly one new DaemonSet
  (its key simply misses); a variant vanishing drops exactly its
  entry. Nothing else re-renders.

Entries are frozen shared views: a consumer mutating a cached manifest
raises ``FrozenObjectError`` — the same always-on guard the informer
read path runs behind. ``apply_with_hash`` deep-copies (which thaws)
only on actual drift.

The cache is process-lifetime state on the ``ClusterPolicyController``
(one per reconciler); ``begin_pass`` is called from ``init()`` once the
pass's inputs are known.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

Obj = Dict[str, Any]

# cache key: (state_name, kind, asset name, generation-or-"")
Key = Tuple[str, str, str, str]
# entry: (frozen rendered manifest, content hash, generation-or-None)
Entry = Tuple[Obj, str, Optional[str]]


def _digest(payload: Any) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def render_fingerprint(
    cp_obj: Obj, namespace: str, runtime: str, openshift: bool
) -> str:
    """The base desired-state fingerprint: a stable hash over every
    render input except the card-variant set (which only scopes the
    driver fan-out and is handled at entry granularity).

    ``metadata.generation`` rides along even though ``spec`` is hashed
    directly (belt and braces against a lossy spec read), and ``uid``
    because ``set_owner_reference`` bakes it into every manifest — a
    deleted-and-recreated CR with an identical spec must not serve
    manifests owned by the dead UID. The daemonsets overrides named in
    the contract are part of ``spec``."""
    meta = cp_obj.get("metadata", {}) or {}
    return _digest(
        {
            "spec": cp_obj.get("spec", {}),
            "generation": meta.get("generation"),
            "uid": meta.get("uid"),
            "namespace": namespace,
            "runtime": runtime,
            "openshift": bool(openshift),
        }
    )


class RenderCache:
    """Fingerprint-gated memo of rendered-and-hashed manifests.

    Thread-safe: the manager still serializes passes
    (MaxConcurrentReconciles=1), but within a pass the write pipeline
    runs a wave's state controls concurrently and they all look up /
    store here — a lock guards the entry dict and the counters
    (``begin_pass`` stays single-threaded by construction, but takes
    the lock anyway so a racing /debug/vars scrape reads a consistent
    picture)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._base_fp: Optional[str] = None
        self._generations: Tuple[str, ...] = ()
        #: full fingerprint (base + sorted generations) — the /debug/vars
        #: identity of the world the cached manifests were rendered for
        self.fingerprint: Optional[str] = None
        self._entries: Dict[Key, Entry] = {}
        # cumulative render wall time per state since the last
        # invalidation (the cost the cache is amortizing)
        self._render_s_by_state: Dict[str, float] = {}
        self.hits_total = 0
        self.misses_total = 0
        self.pass_hits = 0
        self.pass_misses = 0
        self.renders_total = 0
        self.invalidations = 0

    # ------------------------------------------------------------------
    def begin_pass(self, base_fp: str, generations: Iterable[str]) -> None:
        """Reset per-pass counters and reconcile the cache against this
        pass's fingerprint: a base change clears everything, a
        generation-set change drops exactly the vanished generations'
        fan-out entries."""
        gens = tuple(sorted(generations))
        with self._lock:
            self._begin_pass_locked(base_fp, gens)

    def _begin_pass_locked(self, base_fp: str, gens: Tuple[str, ...]) -> None:
        if self._base_fp is not None and base_fp != self._base_fp:
            self._entries.clear()
            self._render_s_by_state.clear()
            self.invalidations += 1
        elif gens != self._generations:
            stale = [
                key
                for key, (_, _, gen) in self._entries.items()
                if gen is not None and gen not in gens
            ]
            for key in stale:
                del self._entries[key]
        self._base_fp = base_fp
        self._generations = gens
        self.fingerprint = _digest({"base": base_fp, "generations": list(gens)})
        self.pass_hits = 0
        self.pass_misses = 0

    # ------------------------------------------------------------------
    def lookup(self, key: Key) -> Optional[Tuple[Obj, str]]:
        """The memoized (frozen manifest, content hash) for ``key``, or
        None on a miss (the caller renders and ``store``s)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.pass_misses += 1
                self.misses_total += 1
                return None
            self.pass_hits += 1
            self.hits_total += 1
            return ent[0], ent[1]

    def store(
        self,
        key: Key,
        frozen_obj: Obj,
        content_hash: str,
        state_name: str,
        render_s: float,
        generation: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._entries[key] = (frozen_obj, content_hash, generation)
            self._render_s_by_state[state_name] = (
                self._render_s_by_state.get(state_name, 0.0) + render_s
            )
            self.renders_total += 1

    # ------------------------------------------------------------------
    # warm restart (kube/warm.py journal)
    # ------------------------------------------------------------------
    def export(self) -> Dict[str, Any]:
        """JSON-serializable snapshot of the cache (entries thawed to
        plain dicts) plus the base fingerprint it was rendered for —
        the warm journal's render half."""
        from tpu_operator_torch.kube.frozen import thaw

        with self._lock:
            return {
                "base_fp": self._base_fp,
                "generations": list(self._generations),
                "entries": [
                    {
                        "key": list(key),
                        "obj": thaw(obj),
                        "hash": h,
                        "generation": gen,
                    }
                    for key, (obj, h, gen) in self._entries.items()
                ],
            }

    def seed(self, payload: Dict[str, Any]) -> int:
        """Load a journal snapshot BEFORE the first pass. The seeded
        base fingerprint is compared by the next ``begin_pass`` exactly
        like a live one: a restart whose inputs changed invalidates the
        seeded entries through the normal path, so a stale journal can
        never serve wrong manifests. Returns entries seeded."""
        from tpu_operator_torch.kube.frozen import freeze

        base_fp = payload.get("base_fp")
        entries = payload.get("entries") or []
        if not base_fp or not entries:
            return 0
        with self._lock:
            if self._base_fp is not None:
                return 0  # a live pass already ran: its picture wins
            self._base_fp = base_fp
            self._generations = tuple(sorted(payload.get("generations") or ()))
            self.fingerprint = _digest(
                {"base": base_fp, "generations": list(self._generations)}
            )
            for ent in entries:
                key = ent.get("key")
                obj = ent.get("obj")
                h = ent.get("hash")
                if not key or len(key) != 4 or obj is None or not h:
                    continue
                self._entries[tuple(key)] = (
                    freeze(obj),
                    h,
                    ent.get("generation"),
                )
            return len(self._entries)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        """Debug-surface / metrics payload: current fingerprint, entry
        count, last pass's hit profile, lifetime totals, and per-state
        render cost. Called from the /debug/vars HTTP thread while the
        reconcile thread mutates the cache — snapshot the dicts before
        iterating (a racing scrape may read a mid-pass value, but must
        never trip 'dict changed size during iteration')."""
        with self._lock:
            render_s_by_state = dict(self._render_s_by_state)
            total = self.hits_total + self.misses_total
            pass_total = self.pass_hits + self.pass_misses
            entries = len(self._entries)
            return {
                "fingerprint": self.fingerprint,
                "entries": entries,
                "last_pass": {
                    "hits": self.pass_hits,
                    "misses": self.pass_misses,
                    "hit_rate": (
                        round(self.pass_hits / pass_total, 4)
                        if pass_total
                        else 0.0
                    ),
                },
                "hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "hit_rate_total": (
                    round(self.hits_total / total, 4) if total else 0.0
                ),
                "renders_total": self.renders_total,
                "invalidations": self.invalidations,
                "render_ms_by_state": {
                    state: round(sec * 1000.0, 3)
                    for state, sec in sorted(render_s_by_state.items())
                },
            }
