"""The sandbox-workload operands: vm-manager, vm-device-manager and
kata-manager.

    python -m tpu_operator_torch.operands.vm_manager

The counterpart of ``tpu_operator/operands/vm_manager.py`` (the
reference's vgpu-manager, vgpu-device-manager and kata-manager slots):

* vm-manager: checks the vfio stack of a VM-passthrough host and
  publishes ``vm-manager-ready``;
* vm-device-manager: turns the host's vfio groups into VM-attachable
  devices of a named config, in the state file the sandbox device plugin
  advertises ``nvidia.com/gpu-vm`` from;
* kata-manager: installs kata's artifacts and the containerd snippet of
  the ``kata-qemu-nvidia-gpu`` runtime class.

PyYAML is imported only by the function that reads a device config.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import sys
import time
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.validator.components import StatusFiles

log = logging.getLogger("gpu-vm-manager")


# ---------------------------------------------------------------------------
# vm-manager
# ---------------------------------------------------------------------------


def vfio_iommu_groups(dev_root: str = "/dev") -> list:
    """Sorted VM-attachable IOMMU group nodes under ``dev_root``/vfio:
    everything except the ``vfio`` control node. The one scan the
    operand, the device-config applier and the validator share."""
    return sorted(
        g
        for g in glob.glob(os.path.join(dev_root, "vfio", "*"))
        if os.path.basename(g) != "vfio"
    )


def vm_manager_ready(dev_root: str = "/dev", status: Optional[StatusFiles] = None) -> int:
    groups = vfio_iommu_groups(dev_root)
    control = os.path.join(dev_root, "vfio", "vfio")
    if not os.path.exists(control):
        log.error("vfio control node missing at %s (vfio modules loaded?)", control)
        return 1
    if status is not None:
        status.write(consts.STATUS_FILE_VM_MANAGER, {"groups": groups})
    log.info("vm host ready: %d vfio groups", len(groups))
    return 0


# ---------------------------------------------------------------------------
# vm-device-manager
# ---------------------------------------------------------------------------

DEFAULT_VM_STATE_FILE = consts.VM_DEVICE_STATE_FILE


def apply_vm_device_config(
    config_file: str,
    config_name: str,
    dev_root: str = "/dev",
    state_file: str = DEFAULT_VM_STATE_FILE,
) -> dict:
    import yaml

    with open(config_file) as f:
        doc = yaml.safe_load(f) or {}
    configs = doc.get("vm-device-configs", {})
    if config_name not in configs:
        raise ValueError(f"unknown vm-device config {config_name!r}")
    devices = [
        {"id": i, "vfio_group": g, "resource": consts.GPU_VM_RESOURCE}
        for i, g in enumerate(vfio_iommu_groups(dev_root))
    ]
    state = {"config": config_name, "devices": devices}
    os.makedirs(os.path.dirname(state_file), exist_ok=True)
    tmp = state_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, state_file)
    return state


# ---------------------------------------------------------------------------
# kata-manager
# ---------------------------------------------------------------------------

KATA_CONFIG = f"configuration-{consts.KATA_RUNTIME_CLASS.removeprefix('kata-')}.toml"
KATA_SNIPPET = f"""\
# Installed by tpu-operator (gpu-kata-manager).
[plugins."io.containerd.grpc.v1.cri".containerd.runtimes.{consts.KATA_RUNTIME_CLASS}]
  runtime_type = "io.containerd.kata.v2"
  [plugins."io.containerd.grpc.v1.cri".containerd.runtimes.{consts.KATA_RUNTIME_CLASS}.options]
    ConfigPath = "/opt/kata/{KATA_CONFIG}"
"""


def install_kata(
    artifacts_src: str = "/opt/kata-artifacts",
    artifacts_dst: str = "/opt/kata",
    containerd_conf_dir: str = "/etc/containerd/conf.d",
) -> int:
    if os.path.isdir(artifacts_src):
        os.makedirs(artifacts_dst, exist_ok=True)
        for name in os.listdir(artifacts_src):
            src = os.path.join(artifacts_src, name)
            dst = os.path.join(artifacts_dst, name)
            if os.path.isfile(src) and not os.path.exists(dst):
                shutil.copyfile(src, dst)
    os.makedirs(containerd_conf_dir, exist_ok=True)
    snippet = os.path.join(containerd_conf_dir, f"{consts.KATA_RUNTIME_CLASS}.toml")
    if not os.path.exists(snippet):
        with open(snippet, "w") as f:
            f.write(KATA_SNIPPET)
        log.info("wrote kata containerd snippet %s", snippet)
    return 0


# ---------------------------------------------------------------------------
# entrypoints
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-vm-manager")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument(
        "--output-dir", default=os.environ.get("VALIDATION_OUTPUT_DIR", consts.VALIDATION_DIR)
    )
    args = p.parse_args(argv)
    rc = vm_manager_ready(args.dev_root, StatusFiles(args.output_dir))
    if rc:
        return rc
    while True:
        time.sleep(60)


def vm_device_main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-vm-device-manager")
    p.add_argument(
        "--config-file",
        default=os.environ.get("VM_DEVICE_CONFIG_FILE", "/vm-device-config/config.yaml"),
    )
    p.add_argument("--config", default=os.environ.get("DEFAULT_VM_DEVICE_CONFIG", "default"))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--state-file", default=DEFAULT_VM_STATE_FILE)
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)
    try:
        state = apply_vm_device_config(args.config_file, args.config, args.dev_root, args.state_file)
        log.info("materialized %d vm devices", len(state["devices"]))
    except Exception:
        log.exception("vm-device config failed")
        return 1
    if args.once:
        return 0
    while True:
        time.sleep(60)


def kata_main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-kata-manager")
    p.add_argument("--artifacts-src", default="/opt/kata-artifacts")
    p.add_argument("--artifacts-dst", default="/opt/kata")
    p.add_argument(
        "--containerd-conf-dir",
        default=os.environ.get("CONTAINERD_CONF_DIR", "/etc/containerd/conf.d"),
    )
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)
    rc = install_kata(args.artifacts_src, args.artifacts_dst, args.containerd_conf_dir)
    if rc or args.once:
        return rc
    while True:
        time.sleep(60)


if __name__ == "__main__":
    sys.exit(main())
