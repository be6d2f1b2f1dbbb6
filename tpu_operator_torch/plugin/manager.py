"""Plugin manager: one DevicePlugin server a resource it advertises.

    python -m tpu_operator_torch.plugin.manager   # the sandbox plugin

The counterpart of ``tpu_operator/plugin/manager.py``, the MIG strategy's
plumbing:

* ``single`` strategy, or an unpartitioned host: one ``nvidia.com/gpu``
  plugin over whole cards;
* ``mixed`` strategy with a partition file (the slice manager's): one
  ``nvidia.com/mig-<shape>`` plugin a shape, each slice one schedulable
  device whose Allocate expands to its member cards;
* sandbox mode: an ``nvidia.com/gpu-vm`` plugin advertising the vfio
  groups of the vm-device state file.

It restarts its servers when the partition file changes, and restarts and
re-registers them when the kubelet's socket changes (a kubelet restart
wipes the plugin directory and forgets every registration).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.plugin import grpc_glue
from tpu_operator_torch.plugin.server import (
    KUBELET_SOCKET_DIR,
    DevicePluginServer,
    GPUDevicePluginServicer,
    content_to_response,
    visible_env,
)

log = logging.getLogger("gpu-device-plugin")


class SubslicePluginServicer(GPUDevicePluginServicer):
    """Advertises one device a subslice; Allocate expands to its member
    cards. Subslice ids are not card ids, so no card's NUMA node or domain
    applies to them and the preference is the must-first fill."""

    def __init__(self, subslices: List[dict], resource_name: str, **kw):
        self.subslices = {str(s["id"]): s for s in subslices}
        super().__init__(resource_name=resource_name, **kw)

    def discover(self):
        return [{"index": int(i)} for i in sorted(self.subslices, key=int)]

    def device_probe(self, dev_id: str) -> bool:
        """A subslice is alive only when every member card open-probes.
        Member card N is ``/dev/nvidiaN``, as Allocate names it."""
        sub = self.subslices.get(str(dev_id))
        if sub is None:
            return False
        return all(
            gpuinfo.device_probe_path(os.path.join(self.dev_root, f"nvidia{int(c)}"))
            for c in sub["chips"]
        )

    def allocate_container(self, ids: List[str]) -> dict:
        chips: List[int] = []
        for sub_id in ids:
            chips.extend(self.subslices[str(sub_id)]["chips"])
        out = {"cdi_devices": [], "devices": [], "mounts": [], "envs": {}}
        if self.cdi_enabled:
            for sub_id in ids:
                sub = self.subslices[str(sub_id)]
                out["cdi_devices"].append(f"{consts.CDI_KIND}=subslice-{sub['id']}-{sub['shape']}")
        else:
            out["devices"] = self._device_specs(
                [os.path.join(self.dev_root, f"nvidia{c}") for c in sorted(chips)]
            )
        uuids = {c["index"]: c.get("uuid") for c in gpuinfo.chip_summary(self.dev_root)}
        env = {**self.slice_env, **visible_env(uuids.get(c) or str(c) for c in sorted(chips))}
        env["TPU_SUBSLICE_SHAPE"] = self.subslices[str(ids[0])]["shape"] if ids else ""
        out["envs"] = env
        return out


class VfioPluginServicer(GPUDevicePluginServicer):
    """The sandbox device plugin: advertises vfio groups for VM
    workloads. Group numbers are the kernel's, not card ids."""

    def __init__(self, vm_state_file: str, **kw):
        self.vm_state_file = vm_state_file
        kw.setdefault("resource_name", consts.GPU_VM_RESOURCE)
        super().__init__(**kw)

    def _state_devices(self) -> Dict[str, dict]:
        """id -> device of the vm-device state file; raises OSError or
        ValueError where it does not read."""
        with open(self.vm_state_file) as f:
            return {str(d["id"]): d for d in json.load(f).get("devices", [])}

    def discover(self):
        try:
            devices = self._state_devices()
        except (OSError, ValueError):
            return []
        return [{"index": d["id"], "path": d["vfio_group"]} for d in devices.values()]

    def device_probe(self, dev_id: str) -> bool:
        """stat only, never open: every device here is a VFIO group (one
        open file a group is a kernel invariant), wherever the state file
        placed it."""
        with self._cond:
            path = self._device_paths.get(str(dev_id), "")
        return bool(path) and gpuinfo.device_probe_path(path, stat_only=True)

    def allocate_container(self, ids: List[str]) -> dict:
        """Each group at its own path, and the vfio control node. Raises
        ``LookupError`` for an id the state file does not hold and
        ``OSError``/``ValueError`` where it does not read."""
        devices = self._state_devices()
        specs = []
        for dev_id in ids:
            dev = devices.get(str(dev_id))
            if dev is None:
                raise LookupError(
                    f"stale allocation: vfio device {dev_id!r} no longer in vm device state "
                    "(repartitioned?)"
                )
            specs.append({"host_path": dev["vfio_group"], "container_path": dev["vfio_group"],
                          "permissions": "rw"})
        specs.append({"host_path": "/dev/vfio/vfio", "container_path": "/dev/vfio/vfio",
                      "permissions": "rw"})
        return {"cdi_devices": [], "devices": specs, "mounts": [], "envs": {}}

    def Allocate(self, request, context):
        import grpc

        resp = grpc_glue.pb2().AllocateResponse()
        for creq in request.container_requests:
            try:
                content = self.allocate_container(list(creq.devicesIDs))
            except LookupError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except (OSError, ValueError) as e:
                context.abort(
                    grpc.StatusCode.UNAVAILABLE,
                    f"vm device state unreadable ({e}); retry after the vm-device manager "
                    "rewrites it",
                )
            content_to_response(resp.container_responses.add(), content)
        return resp


def kubelet_socket_id(socket_dir: str):
    """Identity of the kubelet's registration socket. A change means the
    kubelet restarted: it wiped the device-plugin directory (the serving
    sockets are gone) and forgot every registration, so the plugins must
    restart and re-register or the node's capacity drops to zero. ctime is
    part of the key because a freed inode number is often reused at once,
    while recreation always moves ctime."""
    try:
        st = os.stat(os.path.join(socket_dir, "kubelet.sock"))
        return (st.st_dev, st.st_ino, st.st_ctime_ns)
    except OSError:
        return None


class PluginManager:
    def __init__(
        self,
        strategy: str = "single",
        partition_file: str = consts.PARTITION_FILE,
        socket_dir: str = KUBELET_SOCKET_DIR,
        servicer_kw: Optional[dict] = None,
        poll_interval_s: float = 10.0,
    ):
        self.strategy = strategy
        self.partition_file = partition_file
        self.socket_dir = socket_dir
        self.servicer_kw = servicer_kw or {}
        self.poll_interval_s = poll_interval_s
        self.servers: Dict[str, DevicePluginServer] = {}
        self._stop = threading.Event()
        self._last_sig = None
        self._kubelet_id = kubelet_socket_id(self.socket_dir)

    # ------------------------------------------------------------------
    def _partition_state(self) -> Optional[dict]:
        try:
            with open(self.partition_file) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def desired_resources(self) -> Dict[str, dict]:
        """resource name -> the servicer factory's config (the MIG
        single/mixed strategy)."""
        state = self._partition_state()
        partitioned = bool(state and state.get("partitioned") and state.get("subslices"))
        if partitioned and self.strategy == "mixed":
            by_shape: Dict[str, List[dict]] = {}
            for sub in state["subslices"]:
                by_shape.setdefault(sub["shape"], []).append(sub)
            return {
                consts.MIG_RESOURCE_PREFIX + shape: {"kind": "subslice", "subslices": subs}
                for shape, subs in by_shape.items()
            }
        if partitioned and self.strategy == "single":
            # a uniform partition under the plain resource name: each
            # schedulable unit is one slice (the MIG single strategy)
            return {consts.GPU_RESOURCE: {"kind": "subslice", "subslices": state["subslices"]}}
        return {consts.GPU_RESOURCE: {"kind": "chips"}}

    def _make_server(self, resource: str, cfg: dict) -> DevicePluginServer:
        if cfg["kind"] == "subslice":
            servicer = SubslicePluginServicer(cfg["subslices"], resource_name=resource, **self.servicer_kw)
        else:
            servicer = GPUDevicePluginServicer(resource_name=resource, **self.servicer_kw)
        sock = "nvidia-" + resource.split("/")[-1] + ".sock"
        return DevicePluginServer(servicer, socket_dir=self.socket_dir, socket_name=sock)

    def sync(self, register: bool = False) -> bool:
        """Reconcile the running servers against the desired resources;
        True when the server set changed."""
        kubelet_id = kubelet_socket_id(self.socket_dir)
        if kubelet_id != self._kubelet_id:
            self._kubelet_id = kubelet_id
            if kubelet_id is not None:
                log.info("kubelet socket changed; restarting + re-registering")
                self._last_sig = None  # force a full restart below
        desired = self.desired_resources()
        sig = json.dumps(desired, sort_keys=True)
        if sig == self._last_sig:
            return False
        for resource, server in list(self.servers.items()):
            server.stop()
            del self.servers[resource]
        all_registered = True
        for resource, cfg in desired.items():
            server = self._make_server(resource, cfg)
            server.start()
            if register:
                try:
                    server.register_with_kubelet()
                except Exception:
                    all_registered = False
                    log.exception("kubelet registration failed for %s", resource)
            self.servers[resource] = server
        # keep the signature only when every server started and
        # registered: a failure leaves it stale so the next sync retries
        if all_registered:
            self._last_sig = sig
        log.info(
            "serving resources: %s%s",
            sorted(self.servers),
            "" if all_registered else " (registration pending retry)",
        )
        return True

    def run(self, register: bool = True, block: bool = True):
        self.sync(register=register)

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.sync(register=register)
                except Exception:
                    log.exception("plugin sync failed")

        threading.Thread(target=loop, daemon=True, name="plugin-manager").start()
        if block:
            self._stop.wait()

    def stop(self):
        self._stop.set()
        for server in self.servers.values():
            server.stop()


def sandbox_main(argv=None) -> int:
    """The sandbox device plugin: vfio groups for VM workloads."""
    import argparse

    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-sandbox-device-plugin")
    p.add_argument(
        "--vm-state-file", default=os.environ.get("VM_STATE_FILE", consts.VM_DEVICE_STATE_FILE)
    )
    p.add_argument("--socket-dir", default=KUBELET_SOCKET_DIR)
    p.add_argument("--dev-root", default="/dev")
    args = p.parse_args(argv)

    def make_server():
        servicer = VfioPluginServicer(args.vm_state_file, dev_root=args.dev_root, cdi_enabled=False)
        server = DevicePluginServer(servicer, socket_dir=args.socket_dir, socket_name="nvidia-vm.sock")
        server.start()
        registered = False
        try:
            server.register_with_kubelet()
            registered = True
        except Exception:
            log.exception("kubelet registration failed; will retry")
        return server, registered

    server, registered = make_server()
    last_id = kubelet_socket_id(args.socket_dir)
    try:
        while True:
            time.sleep(5)
            now_id = kubelet_socket_id(args.socket_dir)
            if now_id != last_id:
                last_id = now_id
                registered = True  # no socket yet: nothing to register with
                if now_id is not None:
                    # the kubelet restarted: it wiped the socket and forgot
                    # the registration (as PluginManager.sync)
                    log.info("kubelet socket changed; re-registering")
                    server.stop()
                    server, registered = make_server()
            elif not registered and now_id is not None:
                # a registration that failed (the kubelet's plugin manager
                # still starting) keeps retrying, or the node's capacity
                # stays at zero until the next kubelet restart
                try:
                    server.register_with_kubelet()
                    registered = True
                except Exception:
                    log.exception("kubelet registration retry failed")
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(sandbox_main())
