"""The scheduling-churn engine — sustained allocation traffic through the
real device-plugin admission path.

One :class:`HostAgent` per simulated host wraps a REAL
``GPUDevicePluginServicer`` (synthetic card discovery, production RPC
handlers) behind the kubelet admission sequence
(``kubelet_sim.admit_and_allocate``: options → GetPreferredAllocation
with fail-closed preference checks → Allocate). The engine's workers
create short-lived pods against the cluster (kubesim or FakeClient),
pick hosts with NVLink-aware scoring, admit through the shared
:class:`~tpu_operator_torch.schedsim.gang.GangCoordinator` gate (single jobs
are gangs of one — holds only protect anything if every admission path
honors them), record allocation latency, and a reaper terminates pods at
end-of-life and releases their chips from the
:class:`~tpu_operator_torch.schedsim.registry.AllocationRegistry`.

The engine is simultaneously a load generator and a correctness harness:
double allocations raise at the ledger, gang placement is asserted
all-or-nothing after every admission and rollback, and ``drain()`` ends
with a zero-held-chips steady-state check.

The port's copy of ``tpu_operator/schedsim/engine.py``:

* Internal names stay the reference's: the classes, ``stats()`` keys and
  counters, the hooks ``attach_host``/``detach_host``/``evict_host``/
  ``wire_lifecycle``, the ``alloc.*`` span and flight names.
* What names the card comes from ``consts``: pods request
  ``consts.GPU_RESOURCE``; the logger is ``gpu-schedsim``; the metrics are
  the port's ``OperatorMetrics().alloc_*`` (``gpu_operator_`` prefix).
* The geometry is the card's NVLink domains. ``ChurnEngine`` takes the
  variant tag (``generation``) and a chip table ``cards`` (card id to its
  entry, ``nvlink_domain`` among the keys) in place of the reference's
  ``host_topology``; ``chips_per_host`` defaults to
  ``topology.CARDS_PER_HOST[generation]`` and ``cards`` to one HGX board,
  every card in domain 0, where fragmentation reads 0 by construction.
  Each agent scores and samples fragmentation over its own table
  (``HostAgent.cards``, what its servicer discovers), so a real host's
  agent among synthetic ones is measured by its own cards.
* Synthetic hosts never touch a card: :class:`SyntheticChipServicer`
  discovers ``nvidia<i>`` under a root that does not exist (the
  reference's ``dev_root``), so an open probe of one fails instead of
  opening ``/dev/nvidia0`` on a machine that has it, and each entry
  carries its domain and a UUID, so ``Allocate`` names the card without
  NVML. A host agent may wrap the real servicer instead (put it into
  ``agents`` before ``start``).
* ``HostAgent.set_health`` flips a host's cards under its admission lock,
  as the kubelet's device manager updates health under its own: an
  admission in flight finishes before the flip, and none that starts
  after it sees the old health. The reference flips without the lock.
* A lifecycle eviction (``evict_host``, ``detach_host``) that terminates
  a gang while its admission is still placing members makes that
  admission roll back as a failed gang. The reference goes on placing
  the remaining members and counts the gang a partial-gang invariant
  violation, which its soak reports under load (the eviction lands
  between two members' admissions); a partial gang with no eviction
  behind it is still a violation.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import random
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from tpu_operator_torch import consts
from tpu_operator_torch.controllers import operator_metrics
from tpu_operator_torch.kube.kubelet_sim import (
    InProcessPluginStub,
    PodGoneError,
    admit_and_allocate,
)
from tpu_operator_torch.obs import flight, trace
from tpu_operator_torch.plugin.server import HEALTHY, GPUDevicePluginServicer
from tpu_operator_torch.schedsim.gang import GangCoordinator
from tpu_operator_torch.schedsim.registry import (
    AllocationRegistry,
    DoubleAllocationError,
    hosts_fragmentation_pct,
    largest_contiguous_block,
)
from tpu_operator_torch.workloads import topology as topo

log = logging.getLogger("gpu-schedsim")


def board_cards(chips: int) -> topo.Cards:
    """The chip table of one HGX board: ``chips`` cards, all in NVLink
    domain 0."""
    return {i: {"index": i, "nvlink_domain": 0} for i in range(chips)}


class InsufficientChipsError(RuntimeError):
    """The host cannot serve the request right now (free healthy chips <
    requested) — a load condition, not a bug."""


class SyntheticChipServicer(GPUDevicePluginServicer):
    """The production servicer over synthetic card discovery — no devfs,
    no poller, real GetPreferredAllocation/Allocate. A 1000-host fleet
    needs a thousand of these; stat-ing eight thousand stub device files
    per refresh would measure the filesystem, and asking NVML would
    measure the one real card eight thousand times.

    Each entry is ``{"index", "path", "nvlink_domain", "uuid"}``: the path
    lies under ``dev_root``, which does not exist, the domain comes from
    ``cards`` (one board by default) and the UUID from ``host`` and the
    index, so ``Allocate`` names the card as on a real host."""

    def __init__(
        self,
        chips: int = 8,
        cards: Optional[topo.Cards] = None,
        host: str = "schedsim",
        **kw,
    ):
        self._n_chips = chips
        self._table = cards if cards is not None else board_cards(chips)
        self._host = host
        kw.setdefault("dev_root", "/nonexistent-schedsim-devfs")
        super().__init__(**kw)

    def discover(self):
        return [
            {
                "index": i,
                "path": os.path.join(self.dev_root, f"nvidia{i}"),
                "nvlink_domain": self._table.get(i, {}).get(
                    "nvlink_domain", 0
                ),
                "uuid": "GPU-"
                + str(uuid.uuid5(uuid.NAMESPACE_URL, f"schedsim/{self._host}/{i}")),
            }
            for i in range(self._n_chips)
        ]


class LatencyRecorder:
    """Bounded latency sample sink with percentile readout. An
    optional ``observer`` (the alloc-latency Prometheus histogram's
    ``observe``) sees every sample as it lands."""

    def __init__(self, cap: int = 200_000, observer=None):
        self.cap = cap
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self.count = 0
        self.observer = observer

    def add(self, ms: float) -> None:
        with self._lock:
            self.count += 1  # under self._lock
            if len(self._samples) < self.cap:
                self._samples.append(ms)
        obs = self.observer
        if obs is not None:
            try:
                obs(ms)
            except Exception:
                pass

    @staticmethod
    def _at(ordered: List[float], p: float) -> float:
        idx = min(
            len(ordered) - 1,
            max(0, int(round(p / 100.0 * (len(ordered) - 1)))),
        )
        return round(ordered[idx], 3)

    def percentile(self, p: float) -> Optional[float]:
        # copy under the lock, sort OUTSIDE it: add() sits on the timed
        # allocation hot path and must never wait behind an O(n log n)
        # sort of a six-figure sample buffer
        with self._lock:
            if not self._samples:
                return None
            samples = list(self._samples)
        return self._at(sorted(samples), p)

    def summary(self) -> dict:
        with self._lock:
            count = self.count
            samples = list(self._samples)
        if not samples:
            return {"count": count, "p50_ms": None, "p99_ms": None}
        ordered = sorted(samples)  # one sort serves both percentiles
        return {
            "count": count,
            "p50_ms": self._at(ordered, 50),
            "p99_ms": self._at(ordered, 99),
        }


class HostAgent:
    """One simulated host: the real plugin servicer driven through the
    kubelet admission sequence in-process, chips accounted in the shared
    registry."""

    def __init__(
        self,
        node: str,
        servicer: GPUDevicePluginServicer,
        registry: AllocationRegistry,
        resource: str = consts.GPU_RESOURCE,
        pod_gone: Optional[Callable[[dict], bool]] = None,
    ):
        self.node = node
        self.servicer = servicer
        self.registry = registry
        self.resource = resource
        self.stub = InProcessPluginStub(servicer)
        # the host's chip table, for placement scoring and fragmentation
        self.cards: topo.Cards = {c["index"]: c for c in servicer.discover()}
        self._pod_gone = pod_gone
        # the kubelet serializes pod admission per node; two concurrent
        # admissions would otherwise be offered the same free chips
        self._lock = threading.Lock()

    def free_ids(self) -> Set[str]:
        healthy = {
            i for i, h in self.servicer.snapshot().items() if h == HEALTHY
        }
        return healthy - self.registry.held_ids(self.node, self.resource)

    def set_health(self, healthy: bool) -> None:
        """Flip every card of the host, under the admission lock: an
        admission in flight completes first."""
        with self._lock:
            for dev in list(self.servicer.snapshot()):
                if healthy:
                    self.servicer.mark_healthy(dev)
                else:
                    self.servicer.mark_unhealthy(dev)

    def allocate(
        self,
        count: int,
        pod: dict,
        must_include: Sequence[str] = (),
        gang_id: Optional[str] = None,
    ) -> List[str]:
        """Admit ``count`` chips for ``pod`` through the real plugin
        path; returns the chip ids held. Raises
        :class:`InsufficientChipsError` when the host can't serve it,
        :class:`PodGoneError` (chips released) when the pod was deleted
        mid-allocation."""
        with self._lock:
            available = sorted(self.free_ids(), key=str)
            must = [str(m) for m in must_include]
            if len(available) < count or any(
                m not in available for m in must
            ):
                raise InsufficientChipsError(
                    f"{self.node}: want {count} (must={must}), "
                    f"free {available}"
                )
            chosen, _resp = admit_and_allocate(
                self.stub, self.resource, available, count, must
            )
            self.registry.hold(
                self.node, self.resource, pod["uid"], chosen, gang_id=gang_id
            )
        # outside the admission lock: the existence probe is I/O. A
        # FAILED probe reads as "still alive" — the hold stands and the
        # normal reap path releases it; treating a transient probe error
        # as gone would release chips under a live pod
        gone = False
        if self._pod_gone is not None:
            try:
                gone = self._pod_gone(pod)
            except Exception:
                log.debug("pod-gone probe failed", exc_info=True)
        if gone:
            freed = self.registry.release_pod(pod["uid"])
            raise PodGoneError(
                f"pod {pod.get('namespace', '')}/{pod.get('name', '')} "
                f"deleted mid-allocation; released {freed} chip(s)"
            )
        return chosen


class ChurnEngine:
    """The load generator + correctness harness."""

    def __init__(
        self,
        client,
        node_names: Sequence[str],
        *,
        namespace: str = "alloc-churn",
        chips_per_host: Optional[int] = None,
        cards: Optional[topo.Cards] = None,
        generation: str = "h100-sxm",
        workers: int = 8,
        rate_per_min: float = 0.0,
        gang_fraction: float = 0.15,
        gang_hosts: int = 2,
        sizes: Sequence[int] = (1, 2, 4, 8),
        lifetime_s: Tuple[float, float] = (0.3, 1.2),
        cancel_prob: float = 0.02,
        sample_k: int = 16,
        seed: int = 0,
        registry: Optional[AllocationRegistry] = None,
        coordinator: Optional[GangCoordinator] = None,
    ):
        self.client = client
        self.node_names = list(node_names)
        self.namespace = namespace
        self.chips_per_host = (
            topo.CARDS_PER_HOST[generation]
            if chips_per_host is None
            else chips_per_host
        )
        self.cards = (
            board_cards(self.chips_per_host) if cards is None else cards
        )
        self.generation = generation
        self.workers = workers
        self.rate_per_min = rate_per_min
        self.gang_fraction = gang_fraction
        self.gang_hosts = gang_hosts
        self.sizes = tuple(sizes)
        self.lifetime_s = lifetime_s
        self.cancel_prob = cancel_prob
        self.sample_k = sample_k
        self.seed = seed
        self.registry = registry or AllocationRegistry()
        self.coordinator = coordinator or GangCoordinator()
        self.resource = consts.GPU_RESOURCE

        def pod_gone(pod: dict) -> bool:
            return (
                self.client.get_or_none(
                    "v1", "Pod", pod["name"], pod["namespace"]
                )
                is None
            )

        self._pod_gone = pod_gone
        # guards fleet membership (node_names + agents) against the
        # lifecycle hooks: joins/preemptions mutate the fleet while the
        # workers place against it
        self._fleet_lock = threading.Lock()
        self.agents: Dict[str, HostAgent] = {
            node: self._make_agent(node) for node in self.node_names
        }

        # shared counters: updated via _bump() only — a plain `+=` from
        # 8 worker threads is LOAD/ADD/STORE and loses increments under
        # preemption, and a lost invariant_violations increment would
        # turn a detected violation into a false-green round
        self._count_lock = threading.Lock()
        self.allocations_total = 0
        self.failures_total = 0
        self.failures_no_host = 0
        self.failures_insufficient = 0
        self.failures_hold_contention = 0
        self.cancelled_total = 0
        self.errors_total = 0
        self.invariant_violations = 0
        # the gang-specific slice of invariant_violations: a red gate
        # must point its reader at the right admission path
        self.partial_gang_violations = 0
        self.gangs_admitted = 0
        self.gangs_failed = 0
        self.gangs_timed_out = 0
        self.pods_created = 0
        self.pods_reaped = 0
        # fleet lifecycle (joins/preemptions/layout shifts mid-churn)
        self.hosts_attached = 0
        self.hosts_detached = 0
        self.pods_evicted_lifecycle = 0
        self.gangs_rescheduled = 0
        self.fragmentation_last_pct = 0.0
        self.fragmentation_max_pct = 0.0

        self.alloc_latency = LatencyRecorder(
            observer=self._alloc_hist_observer()
        )
        self.gang_ready_latency = LatencyRecorder()
        # gangs between coordinator acquire and release, and those of
        # them a lifecycle eviction terminated meanwhile (under
        # _count_lock)
        self._admitting: Set[str] = set()
        self._evicted_mid_admission: Set[str] = set()

        self._seq = itertools.count()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._reap_lock = threading.Lock()
        self._reap_cond = threading.Condition(self._reap_lock)
        self._reap_heap: List[Tuple[float, int, dict]] = []
        self._tokens_lock = threading.Lock()
        self._tokens = float(workers)
        self._tokens_at = time.monotonic()
        self._started_at: Optional[float] = None
        self._stopped_at: Optional[float] = None

    def _bump(self, attr: str, n: int = 1) -> None:
        with self._count_lock:
            setattr(self, attr, getattr(self, attr) + n)

    def host_agent(self, node: str, servicer: GPUDevicePluginServicer) -> HostAgent:
        """A host agent over ``servicer`` on this engine's ledger and
        pod-gone probe: the synthetic hosts' and, put into ``agents``
        before ``start``, a real host's over its real servicer."""
        return HostAgent(
            node, servicer, self.registry, self.resource, pod_gone=self._pod_gone
        )

    def _make_agent(self, node: str) -> HostAgent:
        return self.host_agent(
            node,
            SyntheticChipServicer(
                chips=self.chips_per_host,
                cards=self.cards,
                host=node,
                generation=self.generation,
                cdi_enabled=True,
            ),
        )

    # -- fleet lifecycle --------------------------------------------------
    def attach_host(self, node: str) -> None:
        """Autoscale join: a fresh host (real servicer, empty ledger)
        enters the placement pool. Idempotent."""
        with self._fleet_lock:
            if node in self.agents:
                return
            self.agents[node] = self._make_agent(node)
            self.node_names.append(node)
        self._bump("hosts_attached")

    def detach_host(self, node: str) -> int:
        """Spot preemption / scale-down: the host leaves the placement
        pool, every gang with a member on it is terminated whole (a
        slice job without one member host is dead, not degraded), and
        the registry drops the node's chips — a hold on vanished
        hardware is a zombie. Returns chips freed. Idempotent."""
        with self._fleet_lock:
            if self.agents.pop(node, None) is None:
                return 0
            try:
                self.node_names.remove(node)
            except ValueError:
                pass
        self._evict_holders(node, reschedule=False)
        freed = self.registry.release_node(node)
        self._bump("hosts_detached")
        return freed

    def evict_host(self, node: str) -> int:
        """Layout shift (live re-partition): the host stays in the
        fleet, but every job holding chips on it is terminated — gangs
        whole — so the churn workers re-admit the demand against the new
        layout (gang rescheduling). Returns pods evicted."""
        evicted = self._evict_holders(node, reschedule=True)
        return evicted

    def _evict_holders(self, node: str, reschedule: bool) -> int:
        evicted = 0
        gangs: Set[str] = set()
        for pod_key in self.registry.pods_on_node(node):
            gang = self.registry.gang_of(pod_key)
            if gang is not None:
                gangs.add(gang)
                continue
            ns, _, name = pod_key.partition("/")
            self._terminate({"uid": pod_key, "namespace": ns, "name": name})
            evicted += 1
        for gang in gangs:
            for pod_key in self.registry.pods_of_gang(gang):
                ns, _, name = pod_key.partition("/")
                self._terminate(
                    {"uid": pod_key, "namespace": ns, "name": name}
                )
                evicted += 1
            if reschedule:
                self._bump("gangs_rescheduled")
        with self._count_lock:
            self._evicted_mid_admission |= gangs & self._admitting
        if evicted:
            self._bump("pods_evicted_lifecycle", evicted)
        return evicted

    # -- lifecycle --------------------------------------------------------
    def ensure_namespace(self) -> None:
        try:
            self.client.create(
                {
                    "apiVersion": "v1",
                    "kind": "Namespace",
                    "metadata": {"name": self.namespace},
                }
            )
        except Exception:
            pass  # exists (or FakeClient without namespace admission)

    def start(self) -> None:
        self.ensure_namespace()
        self._started_at = time.monotonic()
        self._stop.clear()
        reaper = threading.Thread(
            target=self._reaper, daemon=True, name="churn-reaper"
        )
        reaper.start()
        self._threads = [reaper]
        for w in range(self.workers):
            t = threading.Thread(
                target=self._worker,
                args=(w,),
                daemon=True,
                name=f"churn-worker-{w}",
            )
            t.start()
            self._threads.append(t)

    def stop(self, drain_timeout_s: float = 60.0) -> None:
        """Halt intake, terminate every live pod, release every chip.

        The drain must survive a straggler worker: under a loaded box a
        worker can sit in one slow client call past any join timeout and
        schedule its last job's reap AFTER a one-shot heap drain — so
        the drain loops until the heap is empty AND every worker exited,
        then sweeps the ledger for pods that still exist but were never
        scheduled. Holds whose pod is ALREADY GONE are genuine leaks and
        deliberately survive to ``drain_check``. A second ``stop`` after
        the first returned is a no-op."""
        if self._stop.is_set() and self._stopped_at is not None:
            return
        self._stop.set()
        with self._reap_cond:
            self._reap_cond.notify_all()
        workers = [t for t in self._threads if t.name != "churn-reaper"]
        # ONE shared deadline across every join: sequential per-thread
        # timeouts would let N wedged threads stretch the "bounded"
        # drain to N × timeout
        join_deadline = time.monotonic() + drain_timeout_s / 2
        for t in self._threads:
            t.join(timeout=max(0.0, join_deadline - time.monotonic()))
        self._stopped_at = time.monotonic()
        deadline = time.monotonic() + drain_timeout_s
        while True:
            with self._reap_lock:
                leftovers = [pod for _, _, pod in self._reap_heap]
                self._reap_heap = []
            for pod in leftovers:
                self._terminate(pod)
            workers_alive = any(t.is_alive() for t in workers)
            with self._reap_lock:
                heap_empty = not self._reap_heap
            if (not workers_alive and heap_empty) or (
                time.monotonic() >= deadline
            ):
                if workers_alive:
                    log.warning(
                        "churn drain: %d worker(s) still alive at the "
                        "drain deadline",
                        sum(1 for t in workers if t.is_alive()),
                    )
                break
            time.sleep(0.05)
        # final ledger sweep: a pod that still EXISTS but holds chips was
        # admitted in the shutdown race and never scheduled for reaping —
        # terminate it like the reaper would have
        for pod_key in self.registry.holding_pod_keys():
            ns, _, name = pod_key.partition("/")
            if not name:
                continue
            try:
                if (
                    self.client.get_or_none("v1", "Pod", name, ns)
                    is not None
                ):
                    self._terminate(
                        {"uid": pod_key, "namespace": ns, "name": name}
                    )
            except Exception:
                log.debug("drain sweep probe failed", exc_info=True)

    def drain_check(self) -> dict:
        """Post-stop steady-state verdict: zero held chips, zero holding
        pods — the no-leaked-reservations invariant."""
        return {
            "chips_held": self.registry.total_held(),
            "pods_holding": self.registry.pods_holding(),
            "double_allocations": self.registry.double_allocation_attempts,
            "invariant_violations": self.invariant_violations,
        }

    def wire_lifecycle(self, sim) -> None:
        """Attach to a kubesim's fleet-lifecycle hooks: node ADDED joins
        the placement pool, node DELETED detaches (gangs terminated
        whole, chips released) — the plugin/kubelet half of a lifecycle
        event the apiserver half already emitted watch events for."""

        def hook(event: str, name: str) -> None:
            if event == "ADDED":
                self.attach_host(name)
            elif event == "DELETED":
                self.detach_host(name)

        sim.add_lifecycle_hook(hook)

    # -- rate control -----------------------------------------------------
    def _take_token(self) -> bool:
        """Token bucket at ``rate_per_min`` (0 = unlimited); False when
        stopping."""
        if self.rate_per_min <= 0:
            return not self._stop.is_set()
        rate_s = self.rate_per_min / 60.0
        while not self._stop.is_set():
            with self._tokens_lock:
                now = time.monotonic()
                self._tokens = min(
                    float(self.workers),
                    self._tokens + (now - self._tokens_at) * rate_s,
                )
                self._tokens_at = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return True
            self._stop.wait(min(0.05, 1.0 / rate_s))
        return False

    # -- pod plumbing -----------------------------------------------------
    def _make_pod(self, node: str, size: int, job_id: str) -> Optional[dict]:
        name = f"churn-{next(self._seq)}"
        body = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": self.namespace,
                "labels": {"app": "alloc-churn", "schedsim/job": job_id},
            },
            "spec": {
                "nodeName": node,
                "containers": [
                    {
                        "name": "w",
                        "image": "cuda-workload",
                        "resources": {
                            "requests": {self.resource: str(size)},
                            "limits": {self.resource: str(size)},
                        },
                    }
                ],
            },
        }
        try:
            self.client.create(body)
        except Exception:
            return None
        self._bump("pods_created")
        return {
            "uid": f"{self.namespace}/{name}",
            "namespace": self.namespace,
            "name": name,
            "node": node,
            "size": size,
        }

    def _terminate(self, pod: dict) -> None:
        try:
            self.client.delete_if_exists(
                "v1", "Pod", pod["name"], pod["namespace"]
            )
        except Exception:
            log.debug("churn pod delete failed", exc_info=True)
        self.registry.release_pod(pod["uid"])
        self._bump("pods_reaped")

    def _schedule_reap(self, pods: Sequence[dict], rng: random.Random) -> None:
        lo, hi = self.lifetime_s
        expiry = time.monotonic() + rng.uniform(lo, hi)
        with self._reap_cond:
            for pod in pods:
                heapq.heappush(
                    self._reap_heap, (expiry, next(self._seq), pod)
                )
            self._reap_cond.notify()

    def _reaper(self) -> None:
        last_sample = 0.0
        while not self._stop.is_set():
            due: List[dict] = []
            with self._reap_cond:
                now = time.monotonic()
                while self._reap_heap and self._reap_heap[0][0] <= now:
                    _, _, pod = heapq.heappop(self._reap_heap)
                    due.append(pod)
                if not due:
                    timeout = (
                        min(0.2, max(0.0, self._reap_heap[0][0] - now))
                        if self._reap_heap
                        else 0.2
                    )
                    self._reap_cond.wait(timeout)
            # terminate OUTSIDE the scheduling lock: deletes are I/O and
            # workers must keep scheduling reaps meanwhile
            for pod in due:
                self._terminate(pod)
            now = time.monotonic()
            if now - last_sample >= 0.5:
                last_sample = now
                try:
                    self.sample_fragmentation()
                    self.publish_metrics()
                except Exception:
                    log.debug("fragmentation sample failed", exc_info=True)

    # -- placement --------------------------------------------------------
    def _score(self, node: str, size: int) -> Optional[Tuple[int, int]]:
        """NVLink-aware best-fit score (lower is better): prefer hosts
        whose free cards still hold a contiguous block (one domain)
        covering the request, then the tightest fit — churn packs instead
        of shredding."""
        agent = self.agents.get(node)
        if agent is None:
            return None  # detached between snapshot and scoring
        free = agent.free_ids()
        if len(free) < size:
            return None
        fits = largest_contiguous_block(free, agent.cards) >= size
        return (0 if fits else 1, len(free) - size)

    def _pick_hosts(
        self, size: int, count: int, rng: random.Random
    ) -> List[str]:
        """Up to ``count`` distinct hosts by score, sampled
        power-of-k-choices first (O(sample) per job at any fleet size),
        full scan only when the sample comes up short."""
        with self._fleet_lock:
            fleet = list(self.node_names)
        if not fleet:
            return []
        sample_n = min(max(self.sample_k, count * 4), len(fleet))
        candidates = rng.sample(fleet, sample_n)
        scored = []
        for node in candidates:
            s = self._score(node, size)
            if s is not None:
                scored.append((s, node))
        if len(scored) < count and sample_n < len(fleet):
            scored = []
            for node in fleet:
                s = self._score(node, size)
                if s is not None:
                    scored.append((s, node))
        scored.sort()
        return [node for _, node in scored[:count]]

    # -- job bodies -------------------------------------------------------
    def _worker(self, widx: int) -> None:
        rng = random.Random((self.seed << 8) ^ widx)
        while self._take_token():
            try:
                if rng.random() < self.gang_fraction:
                    self._run_gang(rng)
                else:
                    self._run_single(rng)
            except DoubleAllocationError:
                self._bump("invariant_violations")
                log.exception("INVARIANT VIOLATION: double allocation")
            except Exception:
                self._bump("errors_total")
                log.exception("churn job failed unexpectedly")

    def _run_single(self, rng: random.Random) -> None:
        size = rng.choice(self.sizes)
        for _attempt in range(3):
            hosts = self._pick_hosts(size, 1, rng)
            if not hosts:
                self._bump("failures_total")
                self._bump("failures_no_host")
                return
            node = hosts[0]
            job_id = f"job-{next(self._seq)}"
            if not self.coordinator.acquire(job_id, [node], timeout_s=0.25):
                continue  # a gang holds this host; re-pick
            try:
                if self._stop.is_set():
                    return  # shutting down: don't admit into the drain
                agent = self.agents.get(node)
                if agent is None:
                    # host preempted between pick and admission: a load
                    # condition of a churning fleet, not an error
                    self._bump("failures_total")
                    self._bump("failures_no_host")
                    return
                pod = self._make_pod(node, size, job_id)
                if pod is None:
                    self._bump("failures_total")
                    return
                if rng.random() < self.cancel_prob:
                    # deletion racing allocation: the admission path must
                    # release the reservation it just took
                    try:
                        self.client.delete_if_exists(
                            "v1", "Pod", pod["name"], pod["namespace"]
                        )
                    except Exception:
                        pass
                t0 = time.perf_counter()
                try:
                    with trace.span(
                        "alloc.allocate", node=node, size=size
                    ):
                        agent.allocate(size, pod)
                except PodGoneError:
                    self._bump("cancelled_total")
                    return
                except InsufficientChipsError:
                    self._bump("failures_total")
                    self._bump("failures_insufficient")
                    self._terminate(pod)
                    return
                self.alloc_latency.add((time.perf_counter() - t0) * 1000.0)
                self._bump("allocations_total")
                self._schedule_reap([pod], rng)
                return
            finally:
                self.coordinator.release(job_id, [node])
        # three straight coordinator-hold losses: contention, NOT
        # missing capacity — label it so a red round reads right
        self._bump("failures_total")
        self._bump("failures_hold_contention")

    def _run_gang(self, rng: random.Random) -> None:
        """Multi-host slice job: one pod per member host, admitted
        all-or-nothing under coordinator holds."""
        m = self.gang_hosts
        size = self.chips_per_host  # slice jobs take whole hosts
        gang_id = f"gang-{next(self._seq)}"
        t0 = time.perf_counter()
        nodes = self._pick_hosts(size, m, rng)
        if len(nodes) < m:
            self._bump("gangs_failed")
            self._bump("failures_total")
            self._bump("failures_no_host")
            return
        if not self.coordinator.acquire(gang_id, nodes):
            self._bump("gangs_timed_out")
            self._bump("failures_total")
            return
        with self._count_lock:
            self._admitting.add(gang_id)
        placed: List[dict] = []
        gang_span = trace.span(
            "alloc.gang_admit", gang=gang_id, hosts=m
        )
        gang_span.__enter__()
        try:
            if self._stop.is_set():
                return  # shutting down: don't admit into the drain
            for node in nodes:
                agent = self.agents.get(node)
                if agent is None:
                    # member host preempted mid-admission: the gang
                    # rolls back whole (all-or-nothing)
                    raise InsufficientChipsError(f"{node}: host vanished")
                pod = self._make_pod(node, size, gang_id)
                if pod is None:
                    raise InsufficientChipsError(f"{node}: pod create failed")
                placed.append(pod)
                t_alloc = time.perf_counter()
                agent.allocate(size, pod, gang_id=gang_id)
                self.alloc_latency.add(
                    (time.perf_counter() - t_alloc) * 1000.0
                )
            # all members placed: the all-or-nothing half is observable
            held = self.registry.pods_of_gang(gang_id)
            with self._count_lock:
                evicted = gang_id in self._evicted_mid_admission
            if len(held) != m and evicted:
                # a lifecycle eviction terminated a placed member: the
                # job is dead, not partially admitted — roll the rest back
                raise InsufficientChipsError(
                    f"{gang_id}: a member was evicted mid-admission"
                )
            if len(held) != m:
                self._bump("invariant_violations")
                self._bump("partial_gang_violations")
                flight.record(
                    "alloc.partial_gang", gang=gang_id, held=len(held),
                    want=m,
                )
                raise AssertionError(
                    f"{gang_id}: {len(held)}/{m} members hold chips after "
                    f"admission ({held})"
                )
            self.gang_ready_latency.add((time.perf_counter() - t0) * 1000.0)
            self._bump("allocations_total", m)
            self._bump("gangs_admitted")
            self._schedule_reap(placed, rng)
        except Exception as e:
            # rollback on ANY failure — the none half of all-or-nothing
            # must hold for unexpected errors too (a fail-closed
            # preference RuntimeError, a ledger DoubleAllocationError),
            # not just the expected load conditions
            for pod in placed:
                self._terminate(pod)
            if self.registry.pods_of_gang(gang_id):
                self._bump("invariant_violations")
                self._bump("partial_gang_violations")
                flight.record(
                    "alloc.partial_gang", gang=gang_id, phase="rollback"
                )
                raise AssertionError(
                    f"{gang_id}: rollback left members holding chips"
                )
            self._bump("gangs_failed")
            self._bump("failures_total")
            if not isinstance(e, (InsufficientChipsError, PodGoneError)):
                raise  # unexpected: surface to the worker's counters
        finally:
            gang_span.__exit__(None, None, None)
            with self._count_lock:
                self._admitting.discard(gang_id)
                self._evicted_mid_admission.discard(gang_id)
            self.coordinator.release(gang_id, nodes)

    # -- observability ----------------------------------------------------
    def _alloc_hist_observer(self):
        """The alloc-latency histogram's observe hook (a no-op stub
        without prometheus)."""
        return operator_metrics.OperatorMetrics().alloc_latency_ms_hist.observe

    def set_node_health(self, node: str, healthy: bool) -> None:
        """Flip every chip on one simulated host (the churn half of a
        chip-death injection — kubesim's ``kill_node_chips`` covers the
        operator's view; this covers the plugin's)."""
        agent = self.agents.get(node)
        if agent is None:
            return  # host left the fleet: nothing to flip
        agent.set_health(healthy)

    def sample_fragmentation(self) -> float:
        with self._fleet_lock:
            agents = list(self.agents.values())
        pct = hosts_fragmentation_pct((a.free_ids(), a.cards) for a in agents)
        self.fragmentation_last_pct = pct
        self.fragmentation_max_pct = max(self.fragmentation_max_pct, pct)
        return pct

    def rate_per_min_observed(self) -> Optional[float]:
        if self._started_at is None:
            return None
        end = self._stopped_at or time.monotonic()
        elapsed = max(end - self._started_at, 1e-6)
        return round(self.allocations_total * 60.0 / elapsed, 1)

    def publish_metrics(self) -> None:
        """Feed the ``alloc_*`` operator gauges (no-op without
        prometheus)."""
        if not operator_metrics.HAVE_PROM:
            return
        try:
            m = operator_metrics.OperatorMetrics()
            m.alloc_requests.set(
                self.allocations_total
                + self.failures_total
                + self.cancelled_total
            )
            m.alloc_failures.set(self.failures_total)
            # gangs actually admitted, NOT coordinator.acquires_total:
            # single jobs are gangs of one and would inflate the gauge
            # an order of magnitude past its help text
            m.alloc_gang_holds.set(self.gangs_admitted)
            m.alloc_fragmentation_pct.set(self.fragmentation_last_pct)
            p99 = self.alloc_latency.percentile(99)
            if p99 is not None:
                m.alloc_latency_ms_p99.set(p99)
        except Exception:
            log.debug("alloc metrics publish failed", exc_info=True)

    def stats(self) -> dict:
        """The ``/debug/vars`` "allocation" payload."""
        return {
            "nodes": len(self.node_names),
            "hosts_attached": self.hosts_attached,
            "hosts_detached": self.hosts_detached,
            "pods_evicted_lifecycle": self.pods_evicted_lifecycle,
            "gangs_rescheduled": self.gangs_rescheduled,
            "allocations_total": self.allocations_total,
            "alloc_per_min": self.rate_per_min_observed(),
            "failures_total": self.failures_total,
            "failures_no_host": self.failures_no_host,
            "failures_insufficient": self.failures_insufficient,
            "failures_hold_contention": self.failures_hold_contention,
            "cancelled_total": self.cancelled_total,
            "errors_total": self.errors_total,
            "invariant_violations": self.invariant_violations,
            "partial_gang_violations": self.partial_gang_violations,
            "pods_created": self.pods_created,
            "pods_reaped": self.pods_reaped,
            "latency_ms": self.alloc_latency.summary(),
            "gangs": {
                "admitted": self.gangs_admitted,
                "failed": self.gangs_failed,
                "timed_out": self.gangs_timed_out,
                "hosts_per_gang": self.gang_hosts,
                "time_to_ready_ms": self.gang_ready_latency.summary(),
            },
            "fragmentation_pct": self.fragmentation_last_pct,
            "fragmentation_max_pct": self.fragmentation_max_pct,
            "registry": self.registry.stats(),
            "coordinator": self.coordinator.stats(),
        }
