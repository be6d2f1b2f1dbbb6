"""The vfio manager: bind the cards' PCI functions to vfio-pci.

    python -m tpu_operator_torch.operands.vfio_manager bind-all|unbind-all

The counterpart of ``tpu_operator/operands/vfio_manager.py``, the
sandbox-workload operand: on a VM-passthrough node every card function must
be driven by vfio-pci before a VM can claim it. It uses the sysfs flow
``driver_override`` → unbind the current driver → ``drivers_probe``.

NVIDIA's vendor id also covers the NVSwitch bridges (class 0x0680) and each
card's audio function, so functions are chosen by vendor and class
(``gpuinfo.is_card_function``), the filter the ``vfio-pci`` component
checks, never by vendor alone. Pointed at a host's real ``/sys/bus/pci``
it unbinds the cards from their driver.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.validator.components import StatusFiles

log = logging.getLogger("gpu-vfio-manager")

SYSFS_PCI = "/sys/bus/pci"


def _write(path: str, value: str) -> None:
    with open(path, "w") as f:
        f.write(value)


def card_functions(sysfs_pci: str = SYSFS_PCI) -> List[str]:
    """The PCI addresses of the card functions under ``sysfs_pci``."""
    return gpuinfo.card_functions(os.path.join(sysfs_pci, "devices"))


def current_driver(addr: str, sysfs_pci: str = SYSFS_PCI) -> str:
    link = os.path.join(sysfs_pci, "devices", addr, "driver")
    return os.path.basename(os.readlink(link)) if os.path.islink(link) else ""


def bind_one(addr: str, sysfs_pci: str = SYSFS_PCI) -> bool:
    dev_dir = os.path.join(sysfs_pci, "devices", addr)
    drv = current_driver(addr, sysfs_pci)
    if drv == "vfio-pci":
        return False
    _write(os.path.join(dev_dir, "driver_override"), "vfio-pci")
    if drv:
        _write(os.path.join(dev_dir, "driver", "unbind"), addr)
    probe = os.path.join(sysfs_pci, "drivers_probe")
    if os.path.exists(probe):
        _write(probe, addr)
    else:  # older kernels: bind directly
        _write(os.path.join(sysfs_pci, "drivers", "vfio-pci", "bind"), addr)
    log.info("bound %s to vfio-pci (was %r)", addr, drv)
    return True


def unbind_one(addr: str, sysfs_pci: str = SYSFS_PCI) -> bool:
    dev_dir = os.path.join(sysfs_pci, "devices", addr)
    if current_driver(addr, sysfs_pci) != "vfio-pci":
        return False
    # a bare newline clears driver_override; a zero-byte write never
    # reaches the kernel's store callback
    _write(os.path.join(dev_dir, "driver_override"), "\n")
    _write(os.path.join(dev_dir, "driver", "unbind"), addr)
    probe = os.path.join(sysfs_pci, "drivers_probe")
    if os.path.exists(probe):
        _write(probe, addr)
    log.info("released %s from vfio-pci", addr)
    return True


def bind_all(sysfs_pci: str = SYSFS_PCI, status: Optional[StatusFiles] = None) -> int:
    funcs = card_functions(sysfs_pci)
    if not funcs:
        log.error("no NVIDIA card functions found")
        return 1
    for addr in funcs:
        bind_one(addr, sysfs_pci)
    bad = [a for a in funcs if current_driver(a, sysfs_pci) != "vfio-pci"]
    if bad:
        log.error("functions not bound after probe: %s", bad)
        return 1
    if status is not None:
        status.write(consts.STATUS_FILE_VFIO_PCI, {"bound": funcs})
    return 0


def unbind_all(sysfs_pci: str = SYSFS_PCI, status: Optional[StatusFiles] = None) -> int:
    for addr in card_functions(sysfs_pci):
        unbind_one(addr, sysfs_pci)
    if status is not None:
        status.remove(consts.STATUS_FILE_VFIO_PCI)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-vfio-manager")
    p.add_argument("command", choices=["bind-all", "unbind-all"])
    p.add_argument("--sysfs-pci", default=SYSFS_PCI)
    p.add_argument(
        "--output-dir", default=os.environ.get("VALIDATION_OUTPUT_DIR", consts.VALIDATION_DIR)
    )
    args = p.parse_args(argv)
    status = StatusFiles(args.output_dir)
    if args.command == "bind-all":
        rc = bind_all(args.sysfs_pci, status)
        if rc == 0:
            # stay resident: the DaemonSet restarts (and re-binds) when the
            # node reboots or devices reappear
            import time

            while True:
                time.sleep(60)
        return rc
    return unbind_all(args.sysfs_pci, status)


if __name__ == "__main__":
    sys.exit(main())
