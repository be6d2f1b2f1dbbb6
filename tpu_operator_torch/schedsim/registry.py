"""Fleet-wide chip-allocation ledger + fragmentation math.

The correctness spine of the scheduling-churn engine: every admitted
allocation records its chips here, every pod termination releases them,
and the two invariants the churn harness exists to prove are enforced at
the ledger, not asserted after the fact —

* **no chip double-allocated**: a hold naming a chip another pod already
  holds raises :class:`DoubleAllocationError` (and counts, so a bench
  can assert the counter stayed zero);
* **no leaked reservations**: once every pod of a churn wave terminates,
  ``total_held()`` must read zero — the steady-state check both the
  tier-1 engine test and the 1000-node bench gate on.

Fragmentation is defined over this ledger too (``fragmentation_pct``):
the share of free cards NOT inside their host's largest NVLink-connected
free block — 0 when every host's free cards sit in one domain, growing
as churn shreds hosts into leftovers spread over domains that can only
serve small or non-contiguous requests.

No k8s imports here: the ledger is shared by the kubelet device-manager
simulator (``kube/kubelet_sim.py``) and the in-process churn agents.

The port's copy of ``tpu_operator/schedsim/registry.py``. The ledger is
the reference's, names and ``stats()`` keys included. The geometry is the
card's (``workloads/topology.py``): NVSwitch joins every pair of cards in
one NVLink domain, so a free set's largest contiguous block is the largest
number of its cards inside one domain of the host's chip table (``cards``,
keyed by card id, each entry's ``nvlink_domain``, 0 where it has none),
not a breadth-first search over a torus. Ids outside the table count as
singleton blocks, as the reference's ids outside the mesh do. On one HGX
board (one domain) fragmentation reads 0 by construction: every free card
is NVLink-contiguous with every other.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tpu_operator_torch.workloads import topology as topo


class DoubleAllocationError(AssertionError):
    """A chip was offered/held twice — the invariant violation the churn
    harness exists to catch. AssertionError subclass on purpose: this is
    a bug in the admission path, never a load condition to retry."""


class AllocationRegistry:
    """Thread-safe ledger of (node, resource) → chip → holder."""

    def __init__(self):
        self._lock = threading.Lock()
        # (node, resource) -> {device_id: pod_key}
        self._held: Dict[Tuple[str, str], Dict[str, str]] = {}
        # pod_key -> [(node, resource, ids)]
        self._pods: Dict[str, List[Tuple[str, str, Tuple[str, ...]]]] = {}
        self._gang_of: Dict[str, str] = {}
        # holder generation at record time (observability: a hold must
        # only ever be recorded under the plugin generation that
        # admitted it — the fence lives in the kubelet sim)
        self._gen_of: Dict[str, object] = {}
        self.holds_total = 0
        self.releases_total = 0
        self.chips_held_peak = 0
        self.double_allocation_attempts = 0

    # -- hold / release --------------------------------------------------
    def hold(
        self,
        node: str,
        resource: str,
        pod_key: str,
        device_ids: Iterable[str],
        gang_id: Optional[str] = None,
        generation: object = None,
    ) -> None:
        ids = tuple(str(i) for i in device_ids)
        with self._lock:
            slot = self._held.setdefault((node, resource), {})
            clash = [i for i in ids if i in slot]
            if clash or len(set(ids)) != len(ids):
                self.double_allocation_attempts += 1
                holders = sorted({slot[i] for i in clash}) or [pod_key]
                raise DoubleAllocationError(
                    f"chip(s) {clash or sorted(ids)} on {node} already "
                    f"held by {holders}; refused for {pod_key}"
                )
            for i in ids:
                slot[i] = pod_key
            self._pods.setdefault(pod_key, []).append((node, resource, ids))
            if gang_id:
                self._gang_of[pod_key] = gang_id
            if generation is not None:
                self._gen_of[pod_key] = generation
            self.holds_total += 1
            self.chips_held_peak = max(
                self.chips_held_peak, self._total_held_locked()
            )

    def release_pod(self, pod_key: str) -> int:
        """Free every chip ``pod_key`` holds; returns chips freed (0 when
        the pod held nothing — release is idempotent, termination paths
        race)."""
        with self._lock:
            entries = self._pods.pop(pod_key, [])
            self._gang_of.pop(pod_key, None)
            self._gen_of.pop(pod_key, None)
            freed = 0
            for node, resource, ids in entries:
                slot = self._held.get((node, resource), {})
                for i in ids:
                    if slot.get(i) == pod_key:
                        del slot[i]
                        freed += 1
                if not slot:
                    self._held.pop((node, resource), None)
            if entries:
                self.releases_total += 1
            return freed

    def release_node(self, node: str) -> int:
        """Free every chip held on ``node`` — the host vanished (spot
        preemption, scale-down): its kubelet/plugin sim is being
        detached and a hold on hardware that no longer exists is a
        zombie. Pods left holding chips ONLY on other nodes keep those
        holds (their gang is the engine's problem — it terminates the
        whole job); pods whose last hold this was leave the ledger.
        Returns chips freed."""
        with self._lock:
            freed = 0
            for (n, resource) in [
                k for k in self._held if k[0] == node
            ]:
                slot = self._held.pop((n, resource))
                freed += len(slot)
            if not freed:
                return 0
            for pod_key in list(self._pods):
                kept = [
                    e for e in self._pods[pod_key] if e[0] != node
                ]
                if kept:
                    self._pods[pod_key] = kept
                else:
                    del self._pods[pod_key]
                    self._gang_of.pop(pod_key, None)
                    self._gen_of.pop(pod_key, None)
            self.releases_total += 1
            return freed

    # -- views -----------------------------------------------------------
    def held_ids(self, node: str, resource: str) -> Set[str]:
        with self._lock:
            return set(self._held.get((node, resource), {}))

    def holder_of(self, node: str, resource: str, dev_id: str):
        with self._lock:
            return self._held.get((node, resource), {}).get(str(dev_id))

    def _total_held_locked(self) -> int:
        return sum(len(s) for s in self._held.values())

    def total_held(self) -> int:
        with self._lock:
            return self._total_held_locked()

    def pods_holding(self) -> int:
        with self._lock:
            return len(self._pods)

    def holding_pod_keys(self) -> List[str]:
        """Every pod key currently holding chips (the drain sweep's
        worklist)."""
        with self._lock:
            return sorted(self._pods)

    def pods_of_gang(self, gang_id: str) -> List[str]:
        with self._lock:
            return sorted(
                p for p, g in self._gang_of.items() if g == gang_id
            )

    def pods_on_node(self, node: str) -> List[str]:
        """Pod keys holding any chip on ``node`` — the worklist a
        lifecycle/repartition eviction sweeps (gang-aware: the caller
        expands each pod to its whole gang)."""
        with self._lock:
            return sorted(
                pod_key
                for pod_key, entries in self._pods.items()
                if any(e[0] == node for e in entries)
            )

    def gang_of(self, pod_key: str) -> Optional[str]:
        with self._lock:
            return self._gang_of.get(pod_key)

    def nodes_holding(self) -> Set[str]:
        """Every node with at least one held chip — the zombie-hold
        invariant check compares this against the live fleet."""
        with self._lock:
            return {n for (n, _r), s in self._held.items() if s}

    def generation_of(self, pod_key: str):
        with self._lock:
            return self._gen_of.get(pod_key)

    def stats(self) -> dict:
        with self._lock:
            return {
                "chips_held": self._total_held_locked(),
                "chips_held_peak": self.chips_held_peak,
                "pods_holding": len(self._pods),
                "holds_total": self.holds_total,
                "releases_total": self.releases_total,
                "double_allocation_attempts": self.double_allocation_attempts,
            }


# -- fragmentation math ----------------------------------------------------


def largest_contiguous_block(free_ids: Iterable, cards: topo.Cards) -> int:
    """Size of the biggest NVLink-connected block of ``free_ids``: the most
    free cards inside one domain of the chip table ``cards``. Ids outside
    the table (fallback registries) count as singleton blocks — no
    geometry means no contiguity to lose."""
    free: Set[int] = set()
    strays = 0
    for i in free_ids:
        try:
            idx = int(i)
        except (TypeError, ValueError):
            strays += 1
            continue
        if idx in cards:
            free.add(idx)
        else:
            strays += 1
    per_domain = Counter(cards[i].get("nvlink_domain", 0) for i in free)
    return max([1 if strays else 0, *per_domain.values()])


def hosts_fragmentation_pct(hosts: Iterable[Tuple[Iterable, topo.Cards]]) -> float:
    """Fleet fragmentation over ``(free-card set, chip table)`` per host:
    ``100 × (1 − Σ largest_block / Σ free)``. 0.0 when every host's free
    cards sit in one domain (an empty fleet reads 0.0 too — nothing free
    means nothing fragmented); approaches 100 as churn strands free cards
    in domains of one."""
    free_total = 0
    contiguous_total = 0
    for free, cards in hosts:
        free = list(free)
        if not free:
            continue
        free_total += len(free)
        contiguous_total += largest_contiguous_block(free, cards)
    if free_total == 0:
        return 0.0
    return round(100.0 * (1.0 - contiguous_total / free_total), 2)


def fragmentation_pct(free_sets: Iterable[Iterable], cards: topo.Cards) -> float:
    """``hosts_fragmentation_pct`` over hosts that share one chip table."""
    return hosts_fragmentation_pct((free, cards) for free in free_sets)
