"""Names, labels and host paths the port's validator and node agents use.

The barrier directory and file-name convention are the same as the JAX
package's (``tpu_operator/consts.py``); the port keeps its own copy so it
imports nothing from there. The API group and the node labels are the
reference's own (``consts.py:40``, ``:112-114``, ``:229``, ``:253-268``):
the control plane that writes them is not ported yet, so the node agents
read the labels it writes. The resource names and the driver's paths are
the card's (``nvidia.com/gpu``, ``/run/nvidia/driver``).
"""

# --- API group and node labels (reference consts.py) -------------------
GROUP = "tpu.k8s.io"
WORKLOAD_CONFIG_LABEL = f"{GROUP}/tpu.workload.config"
WORKLOAD_CONTAINER = "container"
WORKLOAD_VM_PASSTHROUGH = "vm-passthrough"
TFD_LABEL_PREFIX = f"{GROUP}/tpu."
TFD_TOPOLOGY_LABEL = f"{TFD_LABEL_PREFIX}topology"  # the NVLink-domain string
TFD_SLICE_HOSTS_LABEL = f"{TFD_LABEL_PREFIX}slice-hosts"
TFD_WORKER_ID_LABEL = f"{TFD_LABEL_PREFIX}worker-id"
TFD_SLICE_ID_LABEL = f"{TFD_LABEL_PREFIX}slice-id"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
SLICE_READY_LABEL = f"{GROUP}/tpu.slice.ready"
# the slice manager's desired layout and its state (pending|success|failed),
# written by the control plane's repartition controller (:166-167)
SLICE_CONFIG_LABEL = f"{GROUP}/tpu.slice.config"
SLICE_CONFIG_STATE_LABEL = f"{GROUP}/tpu.slice.config.state"
# an operand's deploy label, as the chip-clients file lists them (:68)
DEPLOY_LABEL_PREFIX = f"{GROUP}/tpu.deploy."
VALIDATOR_PERF_ANNOTATION = f"{GROUP}/validator-perf"
# the driver version that tags the validator-perf readings, as GPU feature
# discovery publishes it (stands in for TFD_LIBTPU_VERSION_LABEL, :256)
DRIVER_VERSION_LABEL = "nvidia.com/cuda.driver-version.full"
# the labels GPU feature discovery publishes beside it (stand in for
# TFD_CHIP_TYPE_LABEL, TFD_CHIP_COUNT_LABEL and TFD_HBM_GB_LABEL, :249-251)
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
GPU_COUNT_LABEL = "nvidia.com/gpu.count"
GPU_MEMORY_LABEL = "nvidia.com/gpu.memory"  # MiB
OPERATOR_NAMESPACE_ENV = "OPERATOR_NAMESPACE"

# --- resource names (stand in for TPU_RESOURCE and
#     TPU_SUBSLICE_RESOURCE_PREFIX, :46-47) -------------------------------
GPU_RESOURCE = "nvidia.com/gpu"  # what the device plugin advertises
MIG_RESOURCE_PREFIX = "nvidia.com/mig-"  # mixed-strategy MIG slices
GPU_VM_RESOURCE = "nvidia.com/gpu-vm"  # the sandbox plugin's vfio groups
CDI_KIND = GPU_RESOURCE  # the CDI spec's kind: devices are nvidia.com/gpu=<id>

# the image the workload pods run (stands in for DEFAULT_JAX_WORKLOAD_IMAGE,
# :35); the CUDA_WORKLOAD_IMAGE environment variable overrides it
DEFAULT_CUDA_WORKLOAD_IMAGE = "gcr.io/tpu-operator/tpu-operator-cuda-validator:0.2.0"

# --- host paths ----------------------------------------------------------
# status-file barrier directory
VALIDATION_DIR = "/run/tpu/validations"
# the driver container's root on the host (stands in for LIBTPU_HOST_DIR, :294)
DRIVER_ROOT = "/run/nvidia/driver"
# the CDI spec the container toolkit (operands/runtime_wire.py) writes and
# the toolkit component reads
CDI_SPEC_PATH = "/var/run/cdi/nvidia.yaml"
# the slice manager's partition state (the reference's, cdi.py:24)
PARTITION_FILE = "/run/tpu/partitions.json"
# the kubelet's device-plugin directory and the plugin's socket in it
KUBELET_SOCKET_DIR = "/var/lib/kubelet/device-plugins"
PLUGIN_SOCKET_NAME = "nvidia-gpu.sock"
# GPU feature discovery's NFD feature file
NFD_FEATURE_FILE = "/etc/kubernetes/node-feature-discovery/features.d/gpu"
VM_DEVICE_STATE_FILE = "/run/tpu/vm-devices.json"
# the kata runtime class for sandboxed GPU pods (stands in for kata-tpu)
KATA_RUNTIME_CLASS = "kata-qemu-nvidia-gpu"

# the barrier chain that admits a node (stand in for :274-292)
STATUS_FILE_DRIVER = "driver-ready"
STATUS_FILE_TOOLKIT = "toolkit-ready"  # the reference's runtime-ready (:275)
STATUS_FILE_PLUGIN = "plugin-ready"
STATUS_FILE_DRIVER_CTR = ".driver-ctr-ready"  # the driver container's startupProbe barrier
STATUS_FILE_CUDA = "cuda-ready"
STATUS_FILE_MEMBW = "membw-ready"
STATUS_FILE_FLASHATTN = "flashattn-ready"
STATUS_FILE_SLICE = "slice-ready"
STATUS_FILE_SLICE_WORKLOAD = "slice-workload-ready"
STATUS_FILE_ICI = "ici-ready"
STATUS_FILE_RINGATTN = "ringattn-ready"
STATUS_FILE_PIPELINE = "pipeline-ready"
STATUS_FILE_MOE = "moe-ready"
STATUS_FILE_VFIO_PCI = "vfio-pci-ready"
STATUS_FILE_VM_MANAGER = "vm-manager-ready"
STATUS_FILE_VM_DEVICES = "vm-devices-ready"
# diagnostic probes (opt-in / on-demand): surfaced by the node-status
# exporter as gpu_validator_probe_ready{probe=...}
PROBE_STATUS_FILES = (
    "slice-ready",
    "slice-workload-ready",
    "ici-ready",
    "ringattn-ready",
    "pipeline-ready",
    "moe-ready",
    "membw-ready",
    "flashattn-ready",
)
