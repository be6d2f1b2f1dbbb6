"""CDI spec generation: the container toolkit's core.

The counterpart of ``tpu_operator/plugin/cdi.py``. Every card becomes a
named Container Device Interface device of kind ``nvidia.com/gpu`` carrying
its device node, so a runtime with CDI support injects it with no hook
binary. The spec-level edits every device shares are the driver's control
nodes (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``, where they
exist) and its user-space libraries, mounted read-only at the path they
have under the driver root. An ``all`` device names every card, and a
partitioned host (the slice manager's partition file) adds one composite
device a subslice, so the device plugin's ``nvidia.com/gpu=subslice-<id>-
<shape>`` names resolve whichever operand wrote the spec last.

The spec is written as JSON where the path ends in ``.json`` (no PyYAML
needed) and as YAML otherwise; the reference always writes YAML.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.validator.components import find_driver_libraries

CDI_VERSION = "0.6.0"
CDI_KIND = consts.CDI_KIND
DEFAULT_SPEC_PATH = consts.CDI_SPEC_PATH
DEFAULT_PARTITION_FILE = consts.PARTITION_FILE
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


def _load_partitions(partition_file: str) -> Optional[dict]:
    try:
        with open(partition_file) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def control_nodes(dev_root: str = "/dev") -> List[str]:
    """The driver's control nodes under ``dev_root`` that exist."""
    return [p for p in (os.path.join(dev_root, n) for n in CONTROL_NODES) if os.path.exists(p)]


def driver_library_mounts(driver_root: str = consts.DRIVER_ROOT) -> List[dict]:
    """``libcuda.so*`` and ``libnvidia-ml.so*`` under the driver root, each
    mounted read-only at its path relative to that root."""
    libs = find_driver_libraries(driver_root)
    return [
        {
            "hostPath": path,
            "containerPath": "/" + os.path.relpath(path, driver_root),
            "options": ["ro", "nosuid", "nodev", "bind"],
        }
        for path in libs["libcuda"] + libs["libnvidia_ml"]
    ]


def build_spec(
    dev_root: str = "/dev",
    driver_root: str = consts.DRIVER_ROOT,
    chips: Optional[List[dict]] = None,
    partition_file: str = DEFAULT_PARTITION_FILE,
) -> dict:
    """The spec for ``chips`` (the chip table by default)."""
    chips = chips if chips is not None else gpuinfo.chip_summary(dev_root)
    devices = []
    nodes = {}
    for chip in chips:
        path = chip.get("path", os.path.join(dev_root, f"nvidia{chip['index']}"))
        nodes[chip["index"]] = {"path": path, "permissions": "rw"}
        devices.append(
            {
                "name": str(chip["index"]),
                "containerEdits": {"deviceNodes": [dict(nodes[chip["index"]])]},
            }
        )
    # the "all" composite device, as nvidia.com/gpu=all
    devices.append(
        {"name": "all", "containerEdits": {"deviceNodes": [dict(n) for n in nodes.values()]}}
    )
    partitions = _load_partitions(partition_file)
    if partitions and partitions.get("partitioned"):
        for sub in partitions.get("subslices", []):
            devices.append(
                {
                    "name": f"subslice-{sub['id']}-{sub['shape']}",
                    "containerEdits": {
                        "deviceNodes": [dict(nodes[c]) for c in sub["chips"] if c in nodes]
                    },
                }
            )
    return {
        "cdiVersion": CDI_VERSION,
        "kind": CDI_KIND,
        "containerEdits": {
            "deviceNodes": [{"path": p, "permissions": "rw"} for p in control_nodes(dev_root)],
            "mounts": driver_library_mounts(driver_root),
        },
        "devices": devices,
    }


def write_spec(
    output_path: str = DEFAULT_SPEC_PATH,
    dev_root: str = "/dev",
    driver_root: str = consts.DRIVER_ROOT,
    chips: Optional[List[dict]] = None,
    partition_file: str = DEFAULT_PARTITION_FILE,
) -> dict:
    """Build the spec and replace ``output_path`` with it atomically:
    runtimes watch the spec directory."""
    spec = build_spec(
        dev_root=dev_root, driver_root=driver_root, chips=chips, partition_file=partition_file
    )
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    tmp = output_path + ".tmp"
    with open(tmp, "w") as f:
        if output_path.endswith(".json"):
            json.dump(spec, f, indent=1)
        else:
            import yaml

            yaml.safe_dump(spec, f, sort_keys=False)
    os.replace(tmp, output_path)
    return spec
