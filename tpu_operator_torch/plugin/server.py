"""The GPU device plugin.

    python -m tpu_operator_torch.plugin [--node-name N] [--strategy single|mixed]

The counterpart of ``tpu_operator/plugin/server.py``, the kubelet-facing
operand (NVIDIA's ``k8s-device-plugin`` slot): it serves the DevicePlugin
``v1beta1`` API on a unix socket, registers with the kubelet and
advertises ``nvidia.com/gpu`` (or ``nvidia.com/mig-<shape>`` under the
``mixed`` strategy, ``manager.py``).

* A device is a card of the chip table (``native/gpuinfo.py``), named by
  its id, the minor number of ``/dev/nvidiaN``: the ids may be 1, 3, 5, 7.
  Every choice works over the ids that were advertised.
* ``GetPreferredAllocation`` keeps a request inside one NVLink domain and
  on shared NUMA nodes (``workloads/topology.pick_chips``).
* ``Allocate`` returns the CDI names ``nvidia.com/gpu=<id>`` where CDI is
  on, else the card nodes, the driver's control nodes and its libraries
  as ``DeviceSpec``s and mounts. Its env names the cards by UUID in
  ``NVIDIA_VISIBLE_DEVICES`` and, for a process without the container
  runtime, ``CUDA_VISIBLE_DEVICES``: CUDA's ordinals follow its
  ``FASTEST_FIRST`` order, not the minor numbers. The multi-host
  coordination env comes from the node's feature-discovery labels.
* Health flips Unhealthy when an open probe of the card's node fails.

The choice and the content of each answer live in methods that take and
return plain lists and dicts (``watch``, ``preferred``,
``allocate_container``); the RPC methods wrap them in the generated
messages. grpc and protobuf are imported only by the RPC methods and the
server.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.plugin import cdi, grpc_glue
from tpu_operator_torch.workloads import topology as topo

log = logging.getLogger("gpu-device-plugin")

KUBELET_SOCKET_DIR = consts.KUBELET_SOCKET_DIR
PLUGIN_SOCKET_NAME = consts.PLUGIN_SOCKET_NAME
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


def _chip_id_sort_key(dev_id: str):
    """Order device ids numerically when they are numbers, lexically
    after them otherwise: a total order that never raises."""
    try:
        return (0, int(dev_id), "")
    except (TypeError, ValueError):
        return (1, 0, str(dev_id))


class GPUDevicePluginServicer:
    """DevicePlugin service implementation."""

    def __init__(
        self,
        dev_root: str = "/dev",
        resource_name: str = consts.GPU_RESOURCE,
        generation: str = "",
        cdi_enabled: bool = True,
        driver_root: str = consts.DRIVER_ROOT,
        slice_env: Optional[Dict[str, str]] = None,
        poll_interval_s: float = 5.0,
        health_probe_interval_s: float = 30.0,
    ):
        self.dev_root = dev_root
        self.resource_name = resource_name
        self.generation = generation
        self.cdi_enabled = cdi_enabled
        self.driver_root = driver_root
        self.slice_env = slice_env or {}
        self.poll_interval_s = poll_interval_s
        self.health_probe_interval_s = health_probe_interval_s
        self._stop = threading.Event()
        # Condition + version counter (not a shared Event): every watch
        # stream must see every change; an Event consumed by one stream
        # would starve concurrent or zombie streams of wakeups
        self._cond = threading.Condition()
        # serializes re-enumeration (discover + publish) so a slow refresh
        # cannot publish a stale snapshot over a newer one
        self._refresh_lock = threading.Lock()
        self._version = 0
        # device id -> {"ID", "health", "numa"}
        self._devices: Dict[str, dict] = {}
        # ids forced Unhealthy by an external prober (health loop); sticky
        # across re-enumeration until mark_healthy clears them
        self._forced_unhealthy: set = set()
        # device id -> node path recorded at discovery; probes use these,
        # never a fresh positional enumeration
        self._device_paths: Dict[str, str] = {}
        # the discovered entries by index, for placement and UUIDs
        self._cards: Dict[int, dict] = {}
        self._poller: Optional[threading.Thread] = None
        self.refresh_devices()

    # ------------------------------------------------------------------
    def discover(self) -> List[dict]:
        return gpuinfo.chip_summary(self.dev_root)

    def refresh_devices(self) -> bool:
        """Re-enumerate the cards; True when the set or a health changed."""
        with self._refresh_lock:
            return self._refresh_devices_locked()

    def _refresh_devices_locked(self) -> bool:
        chips = self.discover()
        new: Dict[str, dict] = {}
        paths: Dict[str, str] = {}
        for chip in chips:
            dev_id = str(chip["index"])
            numa = chip.get("numa_node")
            new[dev_id] = {
                "ID": dev_id,
                "health": HEALTHY,
                "numa": numa if numa is not None and numa >= 0 else None,
            }
            paths[dev_id] = chip.get("path", "")
        with self._cond:
            for dev_id in self._forced_unhealthy:
                if dev_id in new:
                    new[dev_id]["health"] = UNHEALTHY
            changed = set(new) != set(self._devices) or any(
                new[k]["health"] != self._devices[k]["health"] for k in new
            )
            self._devices = new
            self._device_paths = paths
            self._cards = {c["index"]: c for c in chips}
            if changed:
                self._version += 1
                self._cond.notify_all()
        return changed

    def _set_health_locked(self, dev_id: str, health: str) -> None:
        dev = self._devices.get(dev_id)
        if dev is not None and dev["health"] != health:
            dev["health"] = health
            self._version += 1
            self._cond.notify_all()

    def mark_unhealthy(self, dev_id: str) -> None:
        """Flip one device to Unhealthy (sticky across re-enumeration: an
        external health prober owns the flag) and wake every stream."""
        dev_id = str(dev_id)
        with self._cond:
            self._forced_unhealthy.add(dev_id)
            self._set_health_locked(dev_id, UNHEALTHY)

    def mark_healthy(self, dev_id: str) -> None:
        """Clear a forced-Unhealthy flag (the device passed a probe again)."""
        dev_id = str(dev_id)
        with self._cond:
            self._forced_unhealthy.discard(dev_id)
            self._set_health_locked(dev_id, HEALTHY)

    def stop(self, timeout_s: float = 10.0) -> None:
        """End every watch stream and the poller; joins the poller."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
            poller = self._poller
        if poller is not None and poller is not threading.current_thread():
            poller.join(timeout_s)

    # -- background polling --------------------------------------------
    def _ensure_poller(self):
        """One shared poller re-enumerates devices; watch streams only
        wait on the Condition (N zombie streams must not mean N scans)."""
        with self._cond:
            if self._poller is None or not self._poller.is_alive():
                self._poller = threading.Thread(
                    target=self._poll_loop, daemon=True, name="device-plugin-poller"
                )
                self._poller.start()

    def _poll_loop(self):
        # start the probe clock now: monotonic() is large, so a 0.0 seed
        # would fire the first probe on the first tick whatever
        # health_probe_interval_s says, overriding an external prober
        last_probe = time.monotonic()
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.refresh_devices()
                now = time.monotonic()
                if now - last_probe >= self.health_probe_interval_s:
                    last_probe = now
                    self.probe_health()
            except Exception:
                log.exception("device re-enumeration failed")

    def snapshot(self) -> Dict[str, str]:
        """The advertisement ``{device_id: health}``."""
        with self._cond:
            return {i: d["health"] for i, d in self._devices.items()}

    def device_probe(self, dev_id: str) -> bool:
        """Open-probe one advertised device at the path recorded when it
        was discovered: existence is not liveness, and a fresh positional
        enumeration could give health to the wrong card."""
        with self._cond:
            path = self._device_paths.get(str(dev_id), "")
        return gpuinfo.device_probe_path(path)

    def probe_health(self) -> None:
        """Open-probe every advertised device and flip its health, so a
        wedged card whose node still exists goes Unhealthy and the kubelet
        stops placing pods on it."""
        for dev_id in list(self.snapshot()):
            try:
                ok = self.device_probe(dev_id)
            except Exception:
                log.exception("health probe failed for device %s", dev_id)
                continue
            if ok:
                self.mark_healthy(dev_id)
            else:
                with self._cond:
                    already = dev_id in self._forced_unhealthy
                if not already:  # warn on the transition, not every cycle
                    log.warning("device %s failed open-probe; marking Unhealthy", dev_id)
                self.mark_unhealthy(dev_id)

    # -- the answers, as plain data --------------------------------------
    def watch(self, is_active: Optional[Callable[[], bool]] = None) -> Iterator[List[dict]]:
        """The device list now, then again only on a change (the kubelet
        holds this stream for the plugin's lifetime). Each stream tracks
        the version it last sent, so concurrent streams cannot steal each
        other's wakeups. Ends on ``stop`` or, after a quiet wait, when
        ``is_active()`` says the peer is gone."""
        self._ensure_poller()
        last_sent = None
        while not self._stop.is_set():
            with self._cond:
                if last_sent is not None and self._version == last_sent:
                    self._cond.wait(self.poll_interval_s)
                    if self._version == last_sent:
                        if is_active is not None and not is_active():
                            # dead peer (the kubelet redialed): free the
                            # worker thread instead of pinning it forever
                            return
                        continue
                ver = self._version
                devices = [dict(d) for d in self._devices.values()]
            if self._stop.is_set():
                return
            yield devices
            last_sent = ver

    def preferred(self, available: List[str], must_include: List[str], size: int) -> List[str]:
        """The preference for one container request. This sits on the
        kubelet's pod-admission path, so a malformed or stale request gets
        a well-formed, possibly partial or empty, answer and never an
        exception: a size of zero or less answers nothing; ids that are
        not numbers take the naive must-first fill; a size nothing can
        cover returns the honest short answer; must-include ids that have
        vanished from the offer are dropped."""
        try:
            return self._preferred_one(available, must_include, size)
        except Exception:
            log.exception("GetPreferredAllocation degraded to naive selection")
            return self._naive_fill(available, must_include, size)

    @staticmethod
    def _naive_fill(available: List[str], must_include: List[str], size: int) -> List[str]:
        """Must-first best fill on raw string ids: the selection that
        cannot fail."""
        size = max(size, 0)
        offered = list(dict.fromkeys(str(i) for i in available))
        offered_set = set(offered)
        must = [i for i in dict.fromkeys(str(i) for i in must_include) if i in offered_set]
        if len(must) > size:
            # contract violation (must > size): a preferred set must hold
            # every must id, so return them all rather than truncate
            return must
        must_set = set(must)
        return (must + [i for i in offered if i not in must_set])[:size]

    def _preferred_one(self, available: List[str], must_include: List[str], size: int) -> List[str]:
        size = max(size, 0)
        try:
            avail_set = {int(i) for i in available}
            # the kubelet guarantees must ⊆ available; enforce it: never
            # recommend a device that was not offered
            must = [i for i in (int(i) for i in must_include) if i in avail_set]
        except ValueError:
            # ids that are not numbers name devices, not cards
            return self._naive_fill(available, must_include, size)
        if size == 0 and not must:
            return []
        with self._cond:
            cards = dict(self._cards)
        chosen = topo.pick_chips(size, sorted(avail_set), must, cards) if size > 0 else None
        if chosen is None:
            must_set = set(must)
            if len(must_set) > size:
                chosen = sorted(must_set)  # contract violation: see _naive_fill
            else:
                pool = sorted(must_set) + [i for i in sorted(avail_set) if i not in must_set]
                chosen = pool[:size]
        return [str(i) for i in sorted(chosen)]

    def visible_name(self, dev_id: str) -> str:
        """How the container's env names a card: ``GPU-<uuid>`` from the
        chip table, the id where the table gives no UUID."""
        with self._cond:
            try:
                card = self._cards.get(int(dev_id), {})
            except ValueError:
                card = {}
        return card.get("uuid") or str(dev_id)

    def _device_specs(self, paths: List[str]) -> List[dict]:
        """``DeviceSpec``s of ``paths`` and the driver's control nodes, each
        at its path under ``/dev`` in the container (a VFIO group keeps its
        ``/dev/vfio/<group>`` shape)."""
        specs = []
        for host_path in paths + cdi.control_nodes(self.dev_root):
            rel = os.path.relpath(host_path, self.dev_root)
            if rel.startswith(".."):
                rel = os.path.basename(host_path)
            specs.append(
                {"host_path": host_path, "container_path": os.path.join("/dev", rel), "permissions": "rw"}
            )
        return specs

    def allocate_container(self, ids: List[str]) -> dict:
        """The content of one container's Allocate answer:
        ``{cdi_devices, devices, mounts, envs}``."""
        out = {"cdi_devices": [], "devices": [], "mounts": [], "envs": {}}
        if self.cdi_enabled:
            out["cdi_devices"] = [f"{consts.CDI_KIND}={dev_id}" for dev_id in ids]
        else:
            paths = []
            for dev_id in ids:
                # the path recorded at discovery, not a reconstructed guess
                with self._cond:
                    host_path = self._device_paths.get(str(dev_id), "")
                paths.append(host_path or os.path.join(self.dev_root, f"nvidia{dev_id}"))
            out["devices"] = self._device_specs(paths)
            out["mounts"] = [
                {"host_path": m["hostPath"], "container_path": m["containerPath"], "read_only": True}
                for m in cdi.driver_library_mounts(self.driver_root)
            ]
        # numeric ids sort numerically, others after them lexically
        names = [self.visible_name(i) for i in sorted(ids, key=_chip_id_sort_key)]
        env = {**self.slice_env, **visible_env(names)}
        if self.generation:
            env["TPU_ACCELERATOR_GENERATION"] = self.generation
        out["envs"] = env
        return out

    # -- RPCs ------------------------------------------------------------
    def GetDevicePluginOptions(self, request, context):
        return grpc_glue.pb2().DevicePluginOptions(
            pre_start_required=False, get_preferred_allocation_available=True
        )

    def ListAndWatch(self, request, context):
        m = grpc_glue.pb2()
        for devices in self.watch(context.is_active if context is not None else None):
            resp = m.ListAndWatchResponse()
            for d in devices:
                dev = resp.devices.add(ID=d["ID"], health=d["health"])
                if d["numa"] is not None:
                    dev.topology.nodes.add().ID = d["numa"]
            yield resp

    def GetPreferredAllocation(self, request, context):
        resp = grpc_glue.pb2().GetPreferredAllocationResponse()
        for creq in request.container_requests:
            resp.container_responses.add().deviceIDs.extend(
                self.preferred(
                    list(creq.available_deviceIDs),
                    list(creq.must_include_deviceIDs),
                    creq.allocation_size,
                )
            )
        return resp

    def Allocate(self, request, context):
        resp = grpc_glue.pb2().AllocateResponse()
        for creq in request.container_requests:
            content = self.allocate_container(list(creq.devicesIDs))
            content_to_response(resp.container_responses.add(), content)
        return resp

    def PreStartContainer(self, request, context):
        return grpc_glue.pb2().PreStartContainerResponse()


def visible_env(names) -> Dict[str, str]:
    """The env that shows a container its cards: the container runtime
    reads ``NVIDIA_VISIBLE_DEVICES``, a process without it
    ``CUDA_VISIBLE_DEVICES``."""
    visible = ",".join(names)
    return {"NVIDIA_VISIBLE_DEVICES": visible, "CUDA_VISIBLE_DEVICES": visible}


def content_to_response(cresp, content: dict) -> None:
    """Fill a ``ContainerAllocateResponse`` from ``allocate_container``'s
    dict."""
    for name in content["cdi_devices"]:
        cresp.cdi_devices.add().name = name
    for spec in content["devices"]:
        cresp.devices.add(**spec)
    for mount in content["mounts"]:
        cresp.mounts.add(**mount)
    for k, v in sorted(content["envs"].items()):
        cresp.envs[k] = v


def slice_env_from_node_labels(labels: Dict[str, str]) -> Dict[str, str]:
    """Multi-host coordination env from the node's feature-discovery
    labels: the slice topology, this host's worker id, the slice's host
    count and the card's product."""
    env = {}
    topology = labels.get(consts.TFD_TOPOLOGY_LABEL)
    if topology:
        env["TPU_TOPOLOGY"] = topology
    worker_id = labels.get(consts.TFD_WORKER_ID_LABEL)
    if worker_id is not None and worker_id != "":
        env["TPU_WORKER_ID"] = str(worker_id)
    hosts = labels.get(consts.TFD_SLICE_HOSTS_LABEL)
    if hosts:
        env["TPU_SLICE_HOSTS"] = str(hosts)
    product = labels.get(consts.GPU_PRODUCT_LABEL)
    if product:
        env["TPU_ACCELERATOR_TYPE"] = product
    return env


class DevicePluginServer:
    """Owns the gRPC server, the kubelet registration and the socket."""

    def __init__(
        self,
        servicer: GPUDevicePluginServicer,
        socket_dir: str = KUBELET_SOCKET_DIR,
        socket_name: str = PLUGIN_SOCKET_NAME,
    ):
        self.servicer = servicer
        self.socket_dir = socket_dir
        self.socket_path = os.path.join(socket_dir, socket_name)
        self.socket_name = socket_name
        self.server = None
        self._bound_ino: Optional[int] = None

    def start(self) -> str:
        import grpc
        from concurrent import futures

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        os.makedirs(self.socket_dir, exist_ok=True)
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((grpc_glue.device_plugin_handler(self.servicer),))
        addr = f"unix://{self.socket_path}"
        self.server.add_insecure_port(addr)
        self.server.start()
        try:
            self._bound_ino = os.stat(self.socket_path).st_ino
        except OSError:
            self._bound_ino = None
        log.info("device plugin serving %s on %s", self.servicer.resource_name, self.socket_path)
        return addr

    def register_with_kubelet(self, kubelet_socket: str = "") -> None:
        import grpc

        m = grpc_glue.pb2()
        kubelet_socket = kubelet_socket or os.path.join(self.socket_dir, "kubelet.sock")
        with grpc.insecure_channel(f"unix://{kubelet_socket}") as channel:
            grpc_glue.RegistrationStub(channel).Register(
                m.RegisterRequest(
                    version=grpc_glue.API_VERSION,
                    endpoint=self.socket_name,
                    resource_name=self.servicer.resource_name,
                    options=m.DevicePluginOptions(get_preferred_allocation_available=True),
                )
            )
        log.info("registered with kubelet at %s", kubelet_socket)

    def stop(self):
        self.servicer.stop()
        if self.server is None:
            return
        # grpc unlinks the unix socket PATH at shutdown even when a newer
        # server (a plugin restart on the fixed socket name) has re-bound
        # it since, deleting the successor's socket and breaking every
        # later kubelet re-dial. If the path's inode is no longer ours,
        # shield the successor's file across the shutdown.
        guard = None
        try:
            if self._bound_ino is not None and os.stat(self.socket_path).st_ino != self._bound_ino:
                guard = self.socket_path + ".shutdown-guard"
                os.rename(self.socket_path, guard)
        except OSError:
            pass
        stopped = False
        done = None
        try:
            done = self.server.stop(grace=1)
            stopped = done.wait(timeout=5)
        finally:
            # restore the successor's socket only once shutdown has
            # confirmed: a timed-out stop may still unlink the path after
            # the real file was put back, deleting the very socket the
            # guard exists to protect
            if guard is not None:
                if stopped:
                    try:
                        os.replace(guard, self.socket_path)
                    except OSError:
                        pass
                else:
                    log.warning(
                        "grpc shutdown did not confirm within 5s; holding socket guard %s "
                        "until it does",
                        guard,
                    )
                    if done is not None:
                        # once the late shutdown (and its unlink) completes,
                        # put the successor's socket back for the re-dial
                        def _restore(ev=done, g=guard, path=self.socket_path):
                            ev.wait()
                            try:
                                os.replace(g, path)
                            except OSError:
                                pass

                        threading.Thread(
                            target=_restore, daemon=True, name="socket-guard-restore"
                        ).start()


def main(argv=None) -> int:
    import argparse

    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-device-plugin")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--driver-root", default=os.environ.get("DRIVER_ROOT", consts.DRIVER_ROOT))
    p.add_argument("--socket-dir", default=KUBELET_SOCKET_DIR)
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument(
        "--cdi", default=os.environ.get("CDI_ENABLED", "true"), choices=("true", "false")
    )
    p.add_argument(
        "--strategy", default=os.environ.get("SLICE_STRATEGY", "single"), choices=("single", "mixed")
    )
    args = p.parse_args(argv)

    node = {"metadata": {"labels": {}}}
    if args.node_name:
        try:
            from tpu_operator_torch.kube.incluster import InClusterClient

            node = InClusterClient().get("v1", "Node", args.node_name)
        except Exception:
            log.warning("could not read node labels; slice env disabled")
    labels = node["metadata"].get("labels", {}) or {}

    from tpu_operator_torch.controllers.state_manager import node_generation
    from tpu_operator_torch.plugin.manager import PluginManager

    mgr = PluginManager(
        strategy=args.strategy,
        socket_dir=args.socket_dir,
        servicer_kw=dict(
            dev_root=args.dev_root,
            driver_root=args.driver_root,
            generation=node_generation(node) or "",
            cdi_enabled=args.cdi == "true",
            slice_env=slice_env_from_node_labels(labels),
        ),
    )
    try:
        mgr.run(register=True, block=True)
    except KeyboardInterrupt:
        mgr.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
