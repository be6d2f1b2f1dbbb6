"""Kubelet device-manager simulator — the kubelet's half of the
DevicePlugin gRPC contract.

The port's copy of ``tpu_operator/kube/kubelet_sim.py``, over the port's
``plugin/grpc_glue.py`` and ``plugin/proto``. The plugin component reads
node capacity the kubelet produced from the plugin's advertisement; this
module closes that loop in one system: it serves the
``v1beta1.Registration`` service on ``kubelet.sock``, and when the
``DevicePluginServer`` registers, it dials the plugin's endpoint back,
consumes ``ListAndWatch``, and derives the node's ``status.capacity`` /
``status.allocatable`` from the advertisement exactly like the kubelet's
device manager:

* ``capacity[resource]``   = all advertised devices,
* ``allocatable[resource]`` = healthy devices only,

so marking a card Unhealthy in the plugin shrinks allocatable over the
wire. ``allocate()`` drives admission the way the kubelet does —
``GetPreferredAllocation`` (when offered) then ``Allocate``. The optional
``registry`` (an allocation ledger with ``held_ids``, ``hold``,
``release_pod`` and ``release_node``) is duck-typed.

Everything it talks to is production code (the real gRPC servicer over a
real unix socket, the real RestClient against KubeSim). grpc is imported
at module import: this module needs it by nature, and nothing imports it
when the package is imported.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures
from typing import Dict, Optional

import grpc

from tpu_operator_torch.kube.client import Client, mutate_with_retry
from tpu_operator_torch.plugin import grpc_glue

pb2 = grpc_glue.pb2()

log = logging.getLogger("gpu-kubelet-sim")

HEALTHY = "Healthy"


class StaleGenerationError(RuntimeError):
    """The plugin re-registered while an allocation was in flight: the
    admission was answered by a plugin generation that no longer exists,
    so the chips are NOT recorded as held — the caller retries against
    the fresh registration."""


class PodGoneError(RuntimeError):
    """The pod was deleted mid-allocation: its chips were released the
    moment the race was detected (a dead pod must never leak a
    reservation through a churn wave)."""


class InProcessPluginStub:
    """The ``DevicePluginStub`` call surface over an in-process servicer
    — the real RPC handlers invoked as direct calls, no socket. A fleet of
    simulated hosts runs one real ``GPUDevicePluginServicer`` each, where
    a thousand gRPC servers (8 worker threads each) would measure the
    transport, not the allocator."""

    def __init__(self, servicer):
        self._servicer = servicer

    def GetDevicePluginOptions(self, request, timeout=None):
        return self._servicer.GetDevicePluginOptions(request, None)

    def GetPreferredAllocation(self, request, timeout=None):
        return self._servicer.GetPreferredAllocation(request, None)

    def Allocate(self, request, timeout=None):
        return self._servicer.Allocate(request, None)


def admit_and_allocate(stub, resource: str, available, count: int, must):
    """The kubelet device-manager admission sequence against one plugin
    endpoint: GetDevicePluginOptions → GetPreferredAllocation (when
    offered, with the fail-closed preference checks a real kubelet
    applies) → Allocate. ``available`` is the allocatable-and-unheld id
    list the caller computed; ``must`` ⊆ available is the caller's
    contract. Returns ``(chosen_ids, AllocateResponse)``.

    Shared by the gRPC :class:`KubeletDeviceManager` and the churn
    engine's in-process host agents so the two admission paths cannot
    drift."""
    opts = stub.GetDevicePluginOptions(pb2.Empty())
    # default (no preference): must-include devices first, like the
    # kubelet's allocator — the non-preference path must not silently
    # drop them either
    chosen = (list(must) + [i for i in available if i not in must])[:count]
    if opts.get_preferred_allocation_available:
        req = pb2.GetPreferredAllocationRequest()
        creq = req.container_requests.add()
        creq.available_deviceIDs.extend(available)
        creq.must_include_deviceIDs.extend(must)
        creq.allocation_size = count
        pref = stub.GetPreferredAllocation(req)
        if pref.container_responses:
            ids = list(pref.container_responses[0].deviceIDs)
            if ids:
                # fail closed, like the kubelet's device manager: a
                # preference outside the offered available set, one
                # that drops a must-include device, or one of the
                # wrong size is a plugin bug — "admitting" it would
                # hide exactly the class of bug this sim exists to
                # catch
                bad = [i for i in ids if i not in available]
                if bad:
                    raise RuntimeError(
                        f"{resource}: plugin preferred unavailable "
                        f"device(s) {bad} (available: {available})"
                    )
                missing = [m for m in must if m not in ids]
                if missing:
                    raise RuntimeError(
                        f"{resource}: plugin preference dropped "
                        f"must-include device(s) {missing}"
                    )
                if len(ids) != count:
                    raise RuntimeError(
                        f"{resource}: plugin preferred {len(ids)} "
                        f"device(s), asked for {count}"
                    )
                chosen = ids
    areq = pb2.AllocateRequest()
    acreq = areq.container_requests.add()
    acreq.devicesIDs.extend(chosen)
    return chosen, stub.Allocate(areq)


class KubeletDeviceManager:
    """Registration server + per-resource ListAndWatch consumers +
    capacity writer for ONE node."""

    def __init__(
        self, client: Client, node_name: str, socket_dir: str, registry=None
    ):
        self.client = client
        self.node_name = node_name
        self.socket_dir = socket_dir
        self.kubelet_socket = os.path.join(socket_dir, "kubelet.sock")
        # optional allocation registry (duck-typed): when attached,
        # allocate() subtracts held cards from the offer and records
        # admitted cards under the requesting pod (the kubelet's
        # podDevices ledger)
        self.registry = registry
        # the real kubelet serializes pod admission per node; without
        # this two concurrent allocate() calls would both be offered the
        # same free chips and the second would double-allocate
        self._admission_lock = threading.Lock()
        # resource -> {device_id: health}
        self.resources: Dict[str, Dict[str, str]] = {}
        # resource -> generation of the latest registration. Consumers
        # compare generations, NOT endpoint paths: the plugin re-registers
        # with the same fixed socket name (nvidia-gpu.sock), so an endpoint-string
        # check would let a zombie stream's error path clobber the fresh
        # advertisement after a plugin restart
        self._generations: Dict[str, int] = {}
        self._gen_counter = 0
        self._channels: Dict[str, grpc.Channel] = {}
        self._lock = threading.Lock()
        # serializes node-status writes WITH their snapshots: two
        # consumers writing concurrently must not land an older snapshot
        # after a newer one (plugin-restart race: the zombie's all-
        # Unhealthy write would otherwise bury the fresh advertisement)
        self._write_lock = threading.Lock()
        self._stop = threading.Event()
        self._server: Optional[grpc.Server] = None
        self._threads: list = []

    # -- Registration service (what the plugin dials) -------------------
    def Register(self, request, context):
        resource = request.resource_name
        endpoint = os.path.join(self.socket_dir, request.endpoint)
        log.info(
            "plugin registered: %s at %s (version %s)",
            resource,
            endpoint,
            request.version,
        )
        with self._lock:
            # re-registration replaces the previous stream (kubelet
            # behavior on plugin restart)
            self._gen_counter += 1
            gen = self._gen_counter
            self._generations[resource] = gen
        t = threading.Thread(
            target=self._consume,
            args=(resource, endpoint, gen),
            daemon=True,
            name=f"kubelet-law-{resource}",
        )
        t.start()
        self._threads.append(t)
        return pb2.Empty()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> str:
        os.makedirs(self.socket_dir, exist_ok=True)
        if os.path.exists(self.kubelet_socket):
            os.unlink(self.kubelet_socket)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers(
            (grpc_glue.registration_handler(self),)
        )
        self._server.add_insecure_port(f"unix://{self.kubelet_socket}")
        self._server.start()
        return self.kubelet_socket

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            try:
                ch.close()
            except Exception:
                pass
        if self._server is not None:
            self._server.stop(grace=1)
        # node lifecycle: a stopped kubelet sim means the host left the
        # fleet (spot preemption / scale-down in the lifecycle chaos) —
        # its chips must leave the shared ledger, or the registry holds
        # reservations on hardware that no longer exists (zombie holds)
        if self.registry is not None and hasattr(
            self.registry, "release_node"
        ):
            self.registry.release_node(self.node_name)

    # -- ListAndWatch consumption ---------------------------------------
    def _dial(self, resource: str, endpoint: str, gen: int):
        """Fresh channel for this registration, installed as the
        resource's current channel (superseding any previous one). The
        channel-local subchannel pool matters: grpc's GLOBAL pool can hand
        a re-registration's channel the existing connection to the OLD
        server process (same unix target string), silently serving the
        "new" stream from the plugin that just died — the real kubelet
        dials a fresh connection per registration."""
        channel = grpc.insecure_channel(
            f"unix://{endpoint}",
            options=[("grpc.use_local_subchannel_pool", 1)],
        )
        with self._lock:
            if self._generations.get(resource) != gen:
                channel.close()
                return None
            old = self._channels.pop(resource, None)
            self._channels[resource] = channel
        if old is not None:
            old.close()  # cancels the superseded stream's consumer
        return channel

    def _consume(self, resource: str, endpoint: str, gen: int) -> None:
        """Consume ListAndWatch until stopped or superseded. A broken
        stream is retried with a FRESH dial (kubelet behavior: it re-dials
        the plugin socket); devices are marked Unhealthy only when the
        endpoint is genuinely dead — an in-process connection mixup or a
        transient blip must not bury a live plugin's advertisement."""
        # retry budget: 5 dials with exponential backoff (~6 s total) —
        # wide enough to ride out a superseded server's shutdown guard
        # briefly renaming the socket. Both a clean stream END and an
        # RpcError consume from the budget, and the budget only refills
        # after a DURABLE stream (delivered a response AND lived ≥1 s):
        # a crash-looping plugin that advertises once per dial must
        # still run out of road and read as dead, not spin forever.
        MAX_ATTEMPTS = 5
        DURABLE_S = 1.0
        attempts = 0
        while not self._stop.is_set():
            channel = self._dial(resource, endpoint, gen)
            if channel is None:
                return  # superseded
            stub = grpc_glue.DevicePluginStub(channel)
            stream_t0 = time.monotonic()
            got_response = False
            try:
                stub.GetDevicePluginOptions(pb2.Empty(), timeout=5)
                for resp in stub.ListAndWatch(pb2.Empty()):
                    if self._stop.is_set():
                        return
                    got_response = True
                    with self._lock:
                        if self._generations.get(resource) != gen:
                            return  # superseded by a re-registration
                        self.resources[resource] = {
                            d.ID: d.health for d in resp.devices
                        }
                    self._write_node_status()
            except (grpc.RpcError, ValueError):
                # RpcError: broken stream/endpoint. ValueError: grpc's
                # "Cannot invoke RPC: Channel closed!" when stop() or a
                # supersession closed this channel mid-dial — same
                # disposition, fall through to the retry/death logic
                pass
            if self._stop.is_set():
                return
            with self._lock:
                if self._generations.get(resource) != gen:
                    return  # a newer registration owns this resource
            if got_response and time.monotonic() - stream_t0 >= DURABLE_S:
                attempts = 0  # the stream was real; fresh budget
            attempts += 1
            if attempts < MAX_ATTEMPTS:
                self._stop.wait(0.2 * (2 ** (attempts - 1)))
                continue  # re-dial: maybe the plugin is still there
            with self._lock:
                if self._generations.get(resource) != gen:
                    return
                log.warning(
                    "ListAndWatch stream for %s dead after %d dials",
                    resource,
                    attempts,
                )
                # plugin died: the kubelet zeroes allocatable but keeps
                # the capacity entry until a re-registration or restart
                devs = self.resources.get(resource, {})
                self.resources[resource] = {i: "Unhealthy" for i in devs}
            self._write_node_status()
            return

    def _write_node_status(self) -> None:
        with self._write_lock:
            self._write_node_status_locked()

    def _write_node_status_locked(self) -> None:
        with self._lock:
            snapshot = {r: dict(d) for r, d in self.resources.items()}

        def mutate(node):
            status = node.setdefault("status", {})
            cap = status.setdefault("capacity", {})
            alloc = status.setdefault("allocatable", {})
            changed = False
            for resource, devices in snapshot.items():
                total = str(len(devices))
                healthy = str(
                    sum(1 for h in devices.values() if h == HEALTHY)
                )
                if cap.get(resource) != total:
                    cap[resource] = total
                    changed = True
                if alloc.get(resource) != healthy:
                    alloc[resource] = healthy
                    changed = True
            # resources are never removed once advertised: the
            # DevicePlugin API has no unregister — a dead plugin reads as
            # allocatable 0 with capacity retained (see the stream-loss
            # path in _consume), and only a kubelet restart forgets a
            # resource entirely, which this steady-state sim doesn't model
            return changed

        try:
            mutate_with_retry(
                self.client, "v1", "Node", self.node_name, mutate=mutate
            )
        except Exception:
            log.exception("failed to write node device status")

    # -- admission-time allocation (what placing a pod does) -------------
    def allocate(
        self, resource: str, count: int, must_include=(), pod=None
    ) -> pb2.AllocateResponse:
        """GetPreferredAllocation (when the plugin offers it) → Allocate,
        the kubelet's pod-admission sequence.

        ``pod`` (optional, requires an attached registry): a mapping with
        ``uid`` (ledger key) and optionally ``namespace``/``name``; the
        admitted chips are recorded under it, held chips leave the offer,
        and two races fail *cleanly*: a plugin re-registration mid-flight
        raises :class:`StaleGenerationError` with nothing recorded (no
        chip may be marked held under a plugin generation that no longer
        exists), and a pod deleted mid-allocation raises
        :class:`PodGoneError` with its chips already released."""
        with self._admission_lock:
            resp = self._allocate_locked(resource, count, must_include, pod)
        # the pod-gone probe is apiserver I/O: OUTSIDE the admission
        # lock (same reasoning as the churn HostAgent) so one slow GET
        # can't serialize every admission on this node behind it
        self._probe_pod_gone(pod)
        return resp

    def _allocate_locked(self, resource, count, must_include, pod):
        with self._lock:
            channel = self._channels.get(resource)
            devices = dict(self.resources.get(resource, {}))
            gen = self._generations.get(resource)
        if channel is None:
            raise RuntimeError(f"no registered plugin for {resource}")
        stub = grpc_glue.DevicePluginStub(channel)
        healthy = sorted(
            (i for i, h in devices.items() if h == HEALTHY), key=str
        )
        if self.registry is not None:
            held = self.registry.held_ids(self.node_name, resource)
            healthy = [i for i in healthy if i not in held]
        if len(healthy) < count:
            raise RuntimeError(
                f"{resource}: want {count}, only {len(healthy)} allocatable"
            )
        # caller contract first (the kubelet guarantees the plugin
        # must ⊆ available and |must| ≤ size): a bad must_include is the
        # CALLER's bug and must not be misattributed to the plugin by the
        # preference checks below
        must = [str(m) for m in must_include]
        not_healthy = [m for m in must if m not in healthy]
        if not_healthy:
            raise RuntimeError(
                f"{resource}: must_include device(s) {not_healthy} are not "
                f"allocatable (healthy: {healthy})"
            )
        if len(must) > count:
            raise RuntimeError(
                f"{resource}: must_include lists {len(must)} device(s) "
                f"but only {count} requested"
            )
        try:
            chosen, resp = admit_and_allocate(
                stub, resource, healthy, count, must
            )
        except ValueError as e:
            # grpc raises ValueError (not RpcError) when a re-registration
            # closed this channel between our snapshot and the call: the
            # generation we admitted against is gone — same clean-failure
            # contract as the post-allocate fence below
            raise StaleGenerationError(
                f"{resource}: plugin channel closed mid-allocation ({e})"
            ) from e
        self._record_allocation(resource, chosen, gen, pod)
        return resp

    def _record_allocation(self, resource, chosen, gen, pod) -> None:
        if self.registry is None or pod is None:
            return
        pod_key = pod["uid"]
        with self._lock:
            if self._generations.get(resource) != gen:
                # the plugin re-registered while this allocation was in
                # flight: the Allocate answer came from a generation
                # that no longer exists — recording it would mark chips
                # held on a dead plugin. Fail cleanly instead.
                raise StaleGenerationError(
                    f"{resource}: plugin re-registered mid-allocation "
                    f"(generation {gen} superseded); not recorded"
                )
            self.registry.hold(
                self.node_name,
                resource,
                pod_key,
                chosen,
                gang_id=pod.get("gang_id") if hasattr(pod, "get") else None,
                generation=gen,
            )

    def _probe_pod_gone(self, pod) -> None:
        """Pod deleted mid-allocation: a dead pod must not leak its
        reservation through a churn wave — release on detection. A
        FAILED probe reads as alive (the hold stands; the normal
        termination path releases it)."""
        if self.registry is None or pod is None:
            return
        name = pod.get("name") if hasattr(pod, "get") else None
        if not name:
            return
        try:
            gone = (
                self.client.get_or_none(
                    "v1", "Pod", name, pod.get("namespace", "")
                )
                is None
            )
        except Exception:
            return
        if gone:
            freed = self.registry.release_pod(pod["uid"])
            raise PodGoneError(
                f"pod {pod.get('namespace', '')}/{name} deleted "
                f"mid-allocation; released {freed} chip(s)"
            )

    def release_pod(self, pod_key: str) -> int:
        """Pod-termination hook: free the pod's chips from the ledger
        (idempotent; 0 when nothing was held)."""
        if self.registry is None:
            return 0
        return self.registry.release_pod(pod_key)
