"""GPU feature discovery: the node labels that describe the cards.

The counterpart of ``tpu_operator/discovery/tfd.py`` (the GFD slot). It
publishes, from the chip table (``native/gpuinfo.py``), the environment and
the driver:

* the card's product (``nvidia.com/gpu.product``: NVML's name with spaces
  as ``-``, as GFD spells it) where the reference publishes the chip type;
* the card count (``nvidia.com/gpu.count``);
* device memory in MiB from NVML (``nvidia.com/gpu.memory``) where the
  reference publishes HBM GB from a table;
* the driver's version (``nvidia.com/cuda.driver-version.full``) where the
  reference publishes libtpu's;
* under the reference's ``tpu.k8s.io/tpu.*`` names, which the port's
  validator reads: the topology (the slice's from ``TPU_TOPOLOGY``, else
  the host's NVLink domains, ``topology.domain_topology``), the slice's
  host count, this host's worker id and the slice id.

NVSwitch has no wraparound links, so nothing stands for the reference's
ICI-wraparound label. Labels are applied to the node (stale ones pruned)
and optionally written as an NFD feature file.
"""

from __future__ import annotations

import glob
import logging
import os
import re
import time
from typing import Dict, List, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.validator.components import DRIVER_LIB_DIRS
from tpu_operator_torch.workloads import topology as topo

log = logging.getLogger("gpu-feature-discovery")

# every label this agent owns: one no longer gathered is pruned
MANAGED_LABELS = (
    consts.GPU_PRODUCT_LABEL,
    consts.GPU_COUNT_LABEL,
    consts.GPU_MEMORY_LABEL,
    consts.DRIVER_VERSION_LABEL,
    consts.TFD_TOPOLOGY_LABEL,
    consts.TFD_SLICE_HOSTS_LABEL,
    consts.TFD_WORKER_ID_LABEL,
    consts.TFD_SLICE_ID_LABEL,
)
# a driver library's versioned name: libcuda.so.550.54.15
_VERSIONED_LIB = re.compile(r"lib(?:cuda|nvidia-ml)\.so\.(\d+\.\d+(?:\.\d+)*)$")


def gather_features(
    node: dict,
    dev_root: str = "/dev",
    driver_root: str = consts.DRIVER_ROOT,
    env: Optional[Dict[str, str]] = None,
    chips: Optional[List[dict]] = None,
) -> Dict[str, str]:
    """The label set for a node (pure: no API writes)."""
    env = env if env is not None else dict(os.environ)
    labels = node.get("metadata", {}).get("labels", {}) or {}
    chips = chips if chips is not None else gpuinfo.chip_summary(dev_root)
    features: Dict[str, str] = {}

    name = chips[0].get("name", "") if chips else ""
    if name:
        features[consts.GPU_PRODUCT_LABEL] = name.replace(" ", "-")
    generation = topo.device_generation(name) or ""
    if chips:
        features[consts.GPU_COUNT_LABEL] = str(len(chips))
    if chips and "memory_total_bytes" in chips[0]:
        features[consts.GPU_MEMORY_LABEL] = str(chips[0]["memory_total_bytes"] // 2**20)

    topology = env.get("TPU_TOPOLOGY", "") or topo.domain_topology({c["index"]: c for c in chips})
    if topology:
        features[consts.TFD_TOPOLOGY_LABEL] = topology
        if generation:
            features[consts.TFD_SLICE_HOSTS_LABEL] = str(topo.host_count(topology, generation))

    worker_id = env.get("TPU_WORKER_ID", "")
    if worker_id != "":
        features[consts.TFD_WORKER_ID_LABEL] = worker_id

    # slice identity for the slice-scoped readiness aggregate: explicit env
    # wins; multi-host slices fall back to the node pool (all hosts of one
    # multi-host slice live in one pool)
    slice_id = env.get("TPU_SLICE_ID", "") or env.get("TPU_SLICE_NAME", "")
    if not slice_id:
        hosts = features.get(consts.TFD_SLICE_HOSTS_LABEL, "1")
        if hosts.isdigit() and int(hosts) > 1:
            slice_id = labels.get(consts.GKE_NODEPOOL_LABEL, "")
    if slice_id:
        features[consts.TFD_SLICE_ID_LABEL] = slice_id

    version = driver_version(driver_root)
    if version:
        features[consts.DRIVER_VERSION_LABEL] = version
    return features


def driver_version(driver_root: str = consts.DRIVER_ROOT) -> str:
    """The driver's version from NVML, else from the versioned name of
    ``libcuda.so.<version>`` or ``libnvidia-ml.so.<version>`` under the
    driver root: first the file ``libcuda.so.1`` or ``libnvidia-ml.so.1``
    resolves to (a host may keep an older driver's library beside it),
    then any versioned name; ``""`` where none gives one."""
    version = gpuinfo.driver_version()
    if version:
        return version
    dirs = [os.path.join(driver_root, d) for d in DRIVER_LIB_DIRS]
    linked = [os.path.realpath(os.path.join(d, n)) for d in dirs
              for n in ("libcuda.so.1", "libnvidia-ml.so.1")]
    named = [so for d in dirs for so in sorted(glob.glob(os.path.join(d, "lib*.so.*")))]
    for so in linked + named:
        m = _VERSIONED_LIB.search(os.path.basename(so))
        if m:
            return m.group(1)
    return ""


def apply_features(client, node_name: str, features: Dict[str, str]) -> bool:
    """Write the labels to the node and prune the managed ones no longer
    gathered, conflict-retried: the Node is shared with other writers.
    True when anything changed."""
    from tpu_operator_torch.kube.client import mutate_with_retry

    result = {"changed": False}

    def mutate(node):
        labels = node["metadata"].setdefault("labels", {})
        changed = False
        for key in MANAGED_LABELS:
            want = features.get(key)
            if want is None and key in labels:
                del labels[key]
                changed = True
            elif want is not None and labels.get(key) != want:
                labels[key] = want
                changed = True
        result["changed"] = changed
        return changed

    mutate_with_retry(client, "v1", "Node", node_name, mutate=mutate)
    return result["changed"]


def write_nfd_feature_file(features: Dict[str, str], path: str = consts.NFD_FEATURE_FILE) -> None:
    """NFD sidecar-style feature file (``label=value`` lines)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for k, v in sorted(features.items()):
            f.write(f"{k}={v}\n")


def run_loop(
    client,
    node_name: str,
    interval_s: float = 60.0,
    once: bool = False,
    dev_root: str = "/dev",
    driver_root: str = consts.DRIVER_ROOT,
) -> None:
    while True:
        try:
            node = client.get("v1", "Node", node_name)
            features = gather_features(node, dev_root=dev_root, driver_root=driver_root)
            if apply_features(client, node_name, features):
                log.info("updated %d feature labels on %s", len(features), node_name)
        except Exception:
            log.exception("feature discovery pass failed")
        if once:
            return
        time.sleep(interval_s)


def main(argv=None) -> int:
    import argparse

    logging.basicConfig(level="INFO")
    p = argparse.ArgumentParser("gpu-feature-discovery")
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--interval", type=float, default=60.0)
    p.add_argument("--once", action="store_true")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--driver-root", default=os.environ.get("DRIVER_ROOT", consts.DRIVER_ROOT))
    args = p.parse_args(argv)
    if not args.node_name:
        log.error("NODE_NAME required")
        return 1
    from tpu_operator_torch.kube.incluster import InClusterClient

    run_loop(
        InClusterClient(),
        args.node_name,
        interval_s=args.interval,
        once=args.once,
        dev_root=args.dev_root,
        driver_root=args.driver_root,
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
