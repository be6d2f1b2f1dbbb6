"""Node builders for KubeSim and the tests.

The port's copy of ``make_tpu_node`` and ``make_cpu_node``
(``tpu_operator/kube/testing.py:198-241``). A GPU node carries the labels
the port's feature discovery (``discovery/tfd.py``) publishes for one HGX
H100 board of ``CARDS_PER_HOST`` cards in one NVLink domain, the NFD
labels and the NFD fallback ``pci-10de.present``. The kubelet and operand
simulators of the reference's module belong to later control-plane steps.
"""

from __future__ import annotations

from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import Obj
from tpu_operator_torch.workloads import topology as topo

DEFAULT_VARIANT = "h100-sxm"
DEFAULT_PRODUCT = "NVIDIA-H100-80GB-HBM3"  # feature discovery's product label
DEFAULT_MEMORY_MIB = 81559  # NVML's memory total of one H100 80GB HBM3
DEFAULT_DRIVER_VERSION = "550.90.07"


def make_gpu_node(
    name: str,
    variant: str = DEFAULT_VARIANT,
    product: str = DEFAULT_PRODUCT,
    extra_labels: dict | None = None,
) -> Obj:
    """A GPU node of one board: ``CARDS_PER_HOST[variant]`` cards in one
    NVLink domain (capacity is the kubelet's to write)."""
    cards = topo.CARDS_PER_HOST[variant]
    topology = topo.format_topology((1, cards))
    labels = {
        "kubernetes.io/hostname": name,
        consts.GPU_PRODUCT_LABEL: product,
        consts.GPU_COUNT_LABEL: str(cards),
        consts.GPU_MEMORY_LABEL: str(DEFAULT_MEMORY_MIB),
        consts.TFD_TOPOLOGY_LABEL: topology,
        consts.TFD_SLICE_HOSTS_LABEL: str(topo.host_count(topology, variant)),
        consts.DRIVER_VERSION_LABEL: DEFAULT_DRIVER_VERSION,
        consts.NFD_GPU_PCI_LABEL: "true",
        consts.NFD_KERNEL_LABEL: "6.1.0",
        consts.NFD_OS_LABEL: "ubuntu",
        consts.NFD_OS_VERSION_LABEL: "22.04",
    }
    labels.update(extra_labels or {})
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels, "annotations": {}},
        "status": {
            "capacity": {},
            "allocatable": {},
            "nodeInfo": {
                "containerRuntimeVersion": "containerd://1.7.0",
                "kernelVersion": "6.1.0",
                "osImage": "Ubuntu 22.04",
            },
        },
    }


def make_cpu_node(name: str) -> Obj:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {
            "capacity": {},
            "allocatable": {},
            "nodeInfo": {"containerRuntimeVersion": "containerd://1.7.0"},
        },
    }
