"""Names, labels and host paths the port's control plane, validator and
node agents use.

The barrier directory and file-name convention are the same as the JAX
package's (``tpu_operator/consts.py``); the port keeps its own copy so it
imports nothing from there. The API group and the node labels are the
reference's own (``consts.py:40``, ``:112-114``, ``:229``, ``:253-268``):
the control plane writes the same label bus the node agents read, so one
group serves both halves, and ``nvidia.com`` would collide with NVIDIA's
own ``clusterpolicies.nvidia.com`` CRD. The resource names, the NFD
fallback and the driver's paths are the card's (``nvidia.com/gpu``,
``pci-10de``, ``/run/nvidia/driver``); a label or component name that
embeds ``libtpu`` takes ``driver``.
"""

# --- Version (single source: versions.mk; reference consts.py:14-36) ----


def _read_version() -> str:
    """The release version lives in the repo's ``versions.mk`` (the pin the
    chart, the CSV generator and the workload image share); an installed
    package without the file falls back to the last released value."""
    import os
    import re

    path = os.path.join(os.path.dirname(__file__), "..", "versions.mk")
    try:
        with open(path) as f:
            for line in f:
                m = re.match(r"VERSION \?=\s*(\S+)", line)
                if m:
                    return m.group(1)
    except OSError:
        pass
    return "0.2.0"


VERSION = _read_version()
DEFAULT_REGISTRY = "gcr.io/tpu-operator"

# --- API group, the CRD and node labels (reference consts.py) ----------
GROUP = "tpu.k8s.io"
API_VERSION = f"{GROUP}/v1"
CLUSTER_POLICY_KIND = "ClusterPolicy"
CRD_NAME = f"clusterpolicies.{GROUP}"
DEFAULT_NAMESPACE = "tpu-operator"
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
# --- operator-managed labels (reference :64-106) ------------------------
TPU_PRESENT_LABEL = f"{GROUP}/tpu.present"
# the card variant a node's driver DaemonSet selects (the reference's
# per-generation label, ``object_controls.py:463``); values from
# ``workloads/topology.device_generation``
GENERATION_LABEL = f"{GROUP}/tpu.generation"
# a node's consistent-hash shard, stamped by a sharded operator (:263)
SHARD_LABEL = f"{GROUP}/shard"
# a node inside an announced host-maintenance window (:118)
MAINTENANCE_STATE_LABEL = f"{GROUP}/maintenance"
# whether the node was already cordoned when the window began, so the
# all-clear restores it (:121; names no accelerator, so it stays)
MAINTENANCE_INITIAL_STATE_ANNOTATION = f"{GROUP}/maintenance-initial-unschedulable"
# an operand's deploy label = its DaemonSet's nodeSelector (:68)
DEPLOY_LABEL_PREFIX = f"{GROUP}/tpu.deploy."
COMPONENT_DRIVER = "driver"  # the reference's COMPONENT_LIBTPU
COMPONENT_RUNTIME = "tpu-runtime"
COMPONENT_DEVICE_PLUGIN = "device-plugin"
COMPONENT_METRICSD = "metricsd"
COMPONENT_METRICS_EXPORTER = "metrics-exporter"
COMPONENT_TFD = "tpu-feature-discovery"
COMPONENT_SLICE_MANAGER = "slice-manager"
COMPONENT_OPERATOR_VALIDATOR = "operator-validator"
COMPONENT_NODE_STATUS_EXPORTER = "node-status-exporter"
COMPONENT_VM_MANAGER = "vm-manager"
COMPONENT_VM_DEVICE_MANAGER = "vm-device-manager"
COMPONENT_VFIO_MANAGER = "vfio-manager"
COMPONENT_SANDBOX_DEVICE_PLUGIN = "sandbox-device-plugin"
COMPONENT_SANDBOX_VALIDATOR = "sandbox-validator"
COMPONENT_KATA_MANAGER = "kata-manager"
COMPONENT_MAINTENANCE_HANDLER = "maintenance-handler"
CONTAINER_WORKLOAD_COMPONENTS = [
    COMPONENT_DRIVER,
    COMPONENT_RUNTIME,
    COMPONENT_DEVICE_PLUGIN,
    COMPONENT_METRICSD,
    COMPONENT_METRICS_EXPORTER,
    COMPONENT_TFD,
    COMPONENT_SLICE_MANAGER,
    COMPONENT_OPERATOR_VALIDATOR,
    COMPONENT_NODE_STATUS_EXPORTER,
    COMPONENT_MAINTENANCE_HANDLER,
]
VM_WORKLOAD_COMPONENTS = [
    COMPONENT_VM_MANAGER,
    COMPONENT_VM_DEVICE_MANAGER,
    COMPONENT_VFIO_MANAGER,
    COMPONENT_SANDBOX_DEVICE_PLUGIN,
    COMPONENT_SANDBOX_VALIDATOR,
    COMPONENT_KATA_MANAGER,
]
# NFD fallback: NVIDIA's PCI vendor id 10de present on the node (stands in
# for NFD_TPU_PCI_LABEL, :51)
NFD_GPU_PCI_LABEL = "feature.node.kubernetes.io/pci-10de.present"
# emitted by the port's own NodeFeatureRule (vendor 10de, display class
# 0302) where NFD's PCI labels are off; stands in for NFD_RULE_TPU_PCI_LABEL
# (:59), and differs from it so a TPU node never reads as a GPU node
NFD_RULE_GPU_PCI_LABEL = f"{GROUP}/gpu.pci.present"
NFD_KERNEL_LABEL = "feature.node.kubernetes.io/kernel-version.full"
NFD_OS_LABEL = "feature.node.kubernetes.io/system-os_release.ID"
NFD_OS_VERSION_LABEL = "feature.node.kubernetes.io/system-os_release.VERSION_ID"

# --- the disruption owners' state labels (reference :122-200): the
#     upgrade FSM's, remediation's and the re-partition roll's, whose
#     values kube/disruption.py reads ---------------------------------
UPGRADE_STATE_LABEL = f"{GROUP}/driver-upgrade-state"  # the reference's libtpu-upgrade-state
UPGRADE_STATE_UNKNOWN = ""
UPGRADE_STATE_UPGRADE_REQUIRED = "upgrade-required"
UPGRADE_STATE_CORDON_REQUIRED = "cordon-required"
UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED = "wait-for-jobs-required"
UPGRADE_STATE_POD_DELETION_REQUIRED = "pod-deletion-required"
UPGRADE_STATE_DRAIN_REQUIRED = "drain-required"
UPGRADE_STATE_POD_RESTART_REQUIRED = "pod-restart-required"
UPGRADE_STATE_VALIDATION_REQUIRED = "validation-required"
UPGRADE_STATE_UNCORDON_REQUIRED = "uncordon-required"
UPGRADE_STATE_DONE = "upgrade-done"
UPGRADE_STATE_FAILED = "upgrade-failed"
# states that hold a node disrupted for the shared budget
UPGRADE_ACTIVE_STATES = (
    UPGRADE_STATE_CORDON_REQUIRED,
    UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED,
    UPGRADE_STATE_POD_DELETION_REQUIRED,
    UPGRADE_STATE_DRAIN_REQUIRED,
    UPGRADE_STATE_POD_RESTART_REQUIRED,
    UPGRADE_STATE_VALIDATION_REQUIRED,
    UPGRADE_STATE_UNCORDON_REQUIRED,
)
REMEDIATION_STATE_LABEL = f"{GROUP}/remediation-state"
REMEDIATION_STATE_SINCE_ANNOTATION = f"{GROUP}/remediation-state-since"
# remediation's quarantine taint (:145-147), which every operand tolerates
REPAIR_TAINT_KEY = f"{GROUP}/repair"
REPAIR_PENDING = "pending"
REMEDIATION_STATE_OBSERVED = "observed"
REMEDIATION_STATE_RESTART = "restart-operands"
REMEDIATION_STATE_REVALIDATE = "revalidate"
REMEDIATION_STATE_CORDON_DRAIN = "cordon-drain"
REMEDIATION_STATE_QUARANTINED = "quarantined"
REMEDIATION_STATE_RECOVERED = "recovered"
REMEDIATION_STATE_EXHAUSTED = "exhausted"
REMEDIATION_DISRUPTED_STATES = (
    REMEDIATION_STATE_CORDON_DRAIN,
    REMEDIATION_STATE_QUARANTINED,
    REMEDIATION_STATE_EXHAUSTED,
)
# remediation's bookkeeping (:135-146): the attempts record, the node's
# cordon before quarantine, the escape hatch and the quarantine label
REMEDIATION_ATTEMPTS_ANNOTATION = f"{GROUP}/remediation-attempts"
REMEDIATION_INITIAL_STATE_ANNOTATION = f"{GROUP}/remediation.node-initial-state.unschedulable"
REMEDIATION_SKIP_LABEL = f"{GROUP}/remediation.skip"
REPAIR_LABEL = f"{GROUP}/repair"
REPARTITION_STATE_LABEL = f"{GROUP}/repartition-state"
REPARTITION_STATE_ROLLING = "rolling"
VALIDATOR_PERF_ANNOTATION = f"{GROUP}/validator-perf"
VALIDATOR_PERF_BASELINE_ANNOTATION = f"{GROUP}/validator-perf-baseline"
# the upgrade FSM's annotations (:218, :236, :245), ``libtpu`` -> ``driver``
UPGRADE_ENABLED_ANNOTATION = f"{GROUP}/driver-upgrade-enabled"
UPGRADE_PREVIOUS_VERSION_ANNOTATION = f"{GROUP}/driver-previous-version"
UPGRADE_STATE_SINCE_ANNOTATION = f"{GROUP}/driver-upgrade-state-since"
# the upgrade FSM's retry record, skip labels and the node's cordon before
# the roll (:213, :237-243), ``libtpu`` -> ``driver``
UPGRADE_RETRY_ANNOTATION = f"{GROUP}/driver-upgrade-retries"
UPGRADE_SKIP_LABEL = f"{GROUP}/driver-upgrade.skip"
UPGRADE_SKIP_DRAIN_LABEL = f"{GROUP}/driver-upgrade-drain.skip"
UPGRADE_INITIAL_STATE_ANNOTATION = f"{GROUP}/driver-upgrade.node-initial-state.unschedulable"
# the rollout ledger on the ClusterPolicy (:224)
ROLLOUT_STATE_ANNOTATION = f"{GROUP}/rollout-state"
# the driver version that tags the validator-perf readings, as GPU feature
# discovery publishes it (stands in for TFD_LIBTPU_VERSION_LABEL, :256)
DRIVER_VERSION_LABEL = "nvidia.com/cuda.driver-version.full"
# the labels GPU feature discovery publishes beside it (stand in for
# TFD_CHIP_TYPE_LABEL, TFD_CHIP_COUNT_LABEL and TFD_HBM_GB_LABEL, :249-251)
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
GPU_COUNT_LABEL = "nvidia.com/gpu.count"
GPU_MEMORY_LABEL = "nvidia.com/gpu.memory"  # MiB
OPERATOR_NAMESPACE_ENV = "OPERATOR_NAMESPACE"
PSA_LABEL_PREFIX = "pod-security.kubernetes.io/"
# where the operator reads its operand manifests (stands in for
# TPU_OPERATOR_ASSETS, ``state_manager.py:58``); without the directory the
# package's own ``assets/`` serve
ASSETS_ENV = "GPU_OPERATOR_ASSETS"
DEFAULT_ASSETS_DIR = "/opt/gpu-operator"
# the hash of the last-applied spec, on operand objects and the pods the
# kubelet stamps from a DaemonSet template (reference :308)
LAST_APPLIED_HASH_ANNOTATION = f"{GROUP}/last-applied-hash"

# --- the control plane's own names (reference events.py:36, warm.py:39,
#     operator_metrics.py:86) -------------------------------------------
EVENT_COMPONENT = "gpu-operator"  # an Event's source.component, the SSA field manager's name
WARM_STATE_ENV = "GPU_OPERATOR_WARM_STATE"  # the warm journal's path
# the operator's Prometheus namespace; differs from the reference's so the
# two packages' series can share one registry
METRICS_NAMESPACE = "gpu_operator"

# --- operand DaemonSets' ``app`` labels: the reference's
#     (``assets/state-*/``) to the port's. ``tpu-`` becomes ``gpu-``,
#     ``libtpu`` ``driver`` and ``runtime`` ``toolkit``; a per-variant
#     driver DaemonSet appends ``-<variant>`` to its app ------------------
OPERAND_APPS = {
    "tpu-libtpu-daemonset": "gpu-driver-daemonset",
    "tpu-runtime-daemonset": "gpu-toolkit-daemonset",
    "tpu-device-plugin-daemonset": "gpu-device-plugin-daemonset",
    "tpu-metricsd": "gpu-metricsd",
    "tpu-metrics-exporter": "gpu-metrics-exporter",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-slice-manager": "gpu-slice-manager",
    "tpu-operator-validator": "gpu-operator-validator",
    "tpu-node-status-exporter": "gpu-node-status-exporter",
    "tpu-maintenance-handler": "gpu-maintenance-handler",
    "tpu-vm-manager-daemonset": "gpu-vm-manager-daemonset",
    "tpu-vm-device-manager": "gpu-vm-device-manager",
    "tpu-vfio-manager-daemonset": "gpu-vfio-manager-daemonset",
    "tpu-sandbox-device-plugin-daemonset": "gpu-sandbox-device-plugin-daemonset",
    "tpu-sandbox-validator": "gpu-sandbox-validator",
    "tpu-kata-manager-daemonset": "gpu-kata-manager-daemonset",
}
# what every operand app starts with: the remediation FSM's operand filter
# (the reference's ``startswith("tpu-")``)
OPERAND_APP_PREFIX = "gpu-"
DRIVER_APP = OPERAND_APPS["tpu-libtpu-daemonset"]
VALIDATOR_APP = OPERAND_APPS["tpu-operator-validator"]

# --- resource names (stand in for TPU_RESOURCE and
#     TPU_SUBSLICE_RESOURCE_PREFIX, :46-47) -------------------------------
GPU_RESOURCE = "nvidia.com/gpu"  # what the device plugin advertises
MIG_RESOURCE_PREFIX = "nvidia.com/mig-"  # mixed-strategy MIG slices
GPU_VM_RESOURCE = "nvidia.com/gpu-vm"  # the sandbox plugin's vfio groups
CDI_KIND = GPU_RESOURCE  # the CDI spec's kind: devices are nvidia.com/gpu=<id>

# the image the workload pods run (stands in for DEFAULT_JAX_WORKLOAD_IMAGE,
# :35); the CUDA_WORKLOAD_IMAGE environment variable overrides it
# (the tag the release publishes, following VERSION)
DEFAULT_CUDA_WORKLOAD_IMAGE = f"{DEFAULT_REGISTRY}/tpu-operator-cuda-validator:{VERSION}"

# --- host paths ----------------------------------------------------------
# status-file barrier directory
VALIDATION_DIR = "/run/tpu/validations"
# the driver container's root on the host (stands in for LIBTPU_HOST_DIR, :294)
DRIVER_ROOT = "/run/nvidia/driver"
# the CDI spec the container toolkit (operands/runtime_wire.py) writes and
# the toolkit component reads
CDI_SPEC_PATH = "/var/run/cdi/nvidia.yaml"
# the proxy's trusted-CA bundle and the driver's artifact-source mounts
# (stand in for TRUSTED_CA_MOUNT_DIR, LIBTPU_REPO_CONFIG_DIR and
# LIBTPU_CERT_CONFIG_DIR, :301-303)
TRUSTED_CA_MOUNT_DIR = "/etc/pki/gpu-operator/trusted-ca"
DRIVER_REPO_CONFIG_DIR = "/etc/nvidia/driver/repo.d"
DRIVER_CERT_CONFIG_DIR = "/etc/nvidia/driver/certs.d"
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
