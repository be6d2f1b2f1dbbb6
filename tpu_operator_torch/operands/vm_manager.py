"""The VFIO group scan of the vm-manager operand.

The port's copy of ``vfio_iommu_groups`` (``tpu_operator/operands/
vm_manager.py:40``); the operand itself waits for the control plane's
port.
"""

from __future__ import annotations

import glob
import os


def vfio_iommu_groups(dev_root: str = "/dev") -> list:
    """Sorted VM-attachable IOMMU group nodes under ``dev_root``/vfio:
    everything except the ``vfio`` control node."""
    return sorted(
        g
        for g in glob.glob(os.path.join(dev_root, "vfio", "*"))
        if os.path.basename(g) != "vfio"
    )
