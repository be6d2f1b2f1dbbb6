"""ClusterPolicy CRD types for the GPU port.

The port's copy of ``tpu_operator/api/v1/clusterpolicy_types.py``: a
cluster-scoped ``ClusterPolicy`` whose spec carries one sub-spec per
operand, per-spec ``is_enabled`` semantics via optional booleans, image
path resolution with environment-variable fallback and sha256 digest
handling, and a ``State`` enum ready/notReady/ignored/disabled. The
dataclass decoder (``_from_dict``, ``_coerce``, ``_to_jsonable``) is the
reference's as it is.

The CRD group stays ``tpu.k8s.io`` (``consts.GROUP``): the port's node
agents read ``tpu.k8s.io/...`` labels and the control plane writes the
same bus, and ``nvidia.com`` would collide with NVIDIA's own
``clusterpolicies.nvidia.com`` CRD in a cluster that has it. The
accelerator surfaces become the card's and nothing else is renamed:

* the sub-spec ``libtpu`` is ``driver`` (``DriverSpec``: install dir
  ``/run/nvidia/driver``, ``generation_configs`` keyed by the card variants
  of ``workloads/topology.py``) and ``runtime`` is ``toolkit``
  (``ToolkitSpec``), the names the port's validator took;
* the validator's sub-specs ``libtpu``/``runtime``/``jax`` are
  ``driver``/``toolkit``/``cuda``;
* ``operator.runtimeClass`` defaults to ``nvidia``;
* default image names and their environment variables are the port's
  own (``gpu-...``, ``GPU_...``);
* values that name the accelerator (``google.com/tpu``, its subslices,
  the NFD PCI label) take the card's.

Every other field keeps the reference's name and default. The rename
tables at the end of this module are the one table between the two
packages' CRs; ``convert.py`` applies them both ways and the tests hold
every module through them.

Objects are plain dataclasses; the wire format is camelCase dicts produced by
``to_dict``/consumed by ``from_dict`` so CRs round-trip losslessly through
YAML/JSON.
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from functools import lru_cache as _functools_lru_cache
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Serialization machinery
# ---------------------------------------------------------------------------

_SNAKE_RE = re.compile(r"_([a-z0-9])")


def _snake_to_camel(name: str) -> str:
    return _SNAKE_RE.sub(lambda m: m.group(1).upper(), name)


def _field_key(f: dataclasses.Field) -> str:
    return f.metadata.get("json", _snake_to_camel(f.name))


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(tp, value):
    """Coerce a decoded JSON value into the annotated field type."""
    if value is None:
        return None
    tp = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if origin in (list, List):
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [_coerce(item_tp, v) for v in value]
    if origin in (dict, Dict):
        return dict(value)
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return _from_dict(tp, value)
    return value


@_functools_lru_cache(maxsize=None)
def _class_hints(cls):
    return typing.get_type_hints(cls)


def _from_dict(cls, data: Dict[str, Any]):
    kwargs = {}
    hints = _class_hints(cls)
    for f in dataclasses.fields(cls):
        key = _field_key(f)
        if key in data:
            kwargs[f.name] = _coerce(hints[f.name], data[key])
    return cls(**kwargs)


def _to_jsonable(value):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {}
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            if v is None:
                continue
            if v == [] or v == {}:
                continue
            out[_field_key(f)] = _to_jsonable(v)
        return out
    if isinstance(value, list):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_jsonable(v) for k, v in value.items()}
    return value


class SpecBase:
    """Mixin providing dict round-tripping for all spec dataclasses."""

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]):
        return _from_dict(cls, data or {})

    def to_dict(self) -> Dict[str, Any]:
        return _to_jsonable(self)


# ---------------------------------------------------------------------------
# State enum (reference api/v1/clusterpolicy_types.go:1496-1507)
# ---------------------------------------------------------------------------


class State:
    IGNORED = "ignored"
    READY = "ready"
    NOT_READY = "notReady"
    DISABLED = "disabled"


# ---------------------------------------------------------------------------
# Image spec helpers (reference api/v1/clusterpolicy_types.go:1552-1641)
# ---------------------------------------------------------------------------


class _ImageSpec(SpecBase):
    """Shared image-resolution behaviour for operand specs.

    ``image_path`` resolves ``repository + image + version`` with a
    per-component environment fallback and sha256 digest support.
    """

    ENV_VAR: str = ""

    def image_path(self) -> str:
        repository = getattr(self, "repository", "") or ""
        image = getattr(self, "image", "") or ""
        version = getattr(self, "version", "") or ""
        if image and version:
            prefix = f"{repository}/{image}" if repository else image
            if version.startswith("sha256:"):
                return f"{prefix}@{version}"
            return f"{prefix}:{version}"
        if self.ENV_VAR:
            env = os.environ.get(self.ENV_VAR, "")
            if env:
                return env
        if image and not version:
            prefix = f"{repository}/{image}" if repository else image
            return prefix
        return ""

    def pull_policy(self) -> str:
        return image_pull_policy(getattr(self, "image_pull_policy", None))

    def is_enabled(self) -> bool:
        enabled = getattr(self, "enabled", None)
        if enabled is None:
            return True
        return bool(enabled)


def image_pull_policy(policy: Optional[str]) -> str:
    """Normalize an imagePullPolicy value (reference ``ImagePullPolicy`` helper)."""
    return policy if policy in ("Always", "Never", "IfNotPresent") else "IfNotPresent"


# ---------------------------------------------------------------------------
# Common nested specs
# ---------------------------------------------------------------------------


@dataclass
class EnvVar(SpecBase):
    name: str = ""
    value: str = ""


@dataclass
class ResourceRequirements(SpecBase):
    limits: Dict[str, str] = field(default_factory=dict)
    requests: Dict[str, str] = field(default_factory=dict)


@dataclass
class RollingUpdateSpec(SpecBase):
    max_unavailable: str = "1"


@dataclass
class InitContainerSpec(_ImageSpec):
    repository: str = ""
    image: str = "busybox"  # minimal init image used for host-prep chores
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)

    ENV_VAR = "GPU_OPERATOR_INIT_CONTAINER_IMAGE"


# ---------------------------------------------------------------------------
# Operator / Daemonsets
# ---------------------------------------------------------------------------


@dataclass
class ProxySpec(SpecBase):
    """Cluster-wide egress proxy for operands that reach the network
    (reference ``applyOCPProxySpec``, ``controllers/object_controls.go:907-960``
    — there read from the OpenShift ``Proxy`` cluster object; here declared
    on the CR directly since GKE has no such object)."""

    http_proxy: str = ""
    https_proxy: str = ""
    no_proxy: str = ""
    # ConfigMap (operator namespace) holding ``ca-bundle.crt`` with the
    # proxy's trusted CA chain (reference trusted-CA mount,
    # ``controllers/object_controls.go:962-1050``)
    trusted_ca_config_map: str = ""


@dataclass
class OperatorSpec(SpecBase):
    """Operator-level knobs (reference ``OperatorSpec``)."""

    default_runtime: str = "containerd"
    runtime_class: str = "nvidia"
    init_container: InitContainerSpec = field(default_factory=InitContainerSpec)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    proxy: Optional[ProxySpec] = None


@dataclass
class DaemonsetsSpec(SpecBase):
    """Settings applied to every operand DaemonSet (reference ``DaemonsetsSpec``)."""

    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Dict[str, Any]] = field(default_factory=list)
    priority_class_name: str = "system-node-critical"
    update_strategy: str = "RollingUpdate"
    rolling_update: Optional[RollingUpdateSpec] = None


# ---------------------------------------------------------------------------
# Upgrade policy (reference DriverUpgradePolicySpec via k8s-operator-libs)
# ---------------------------------------------------------------------------


@dataclass
class PodDeletionSpec(SpecBase):
    force: Optional[bool] = None
    timeout_seconds: int = 300
    delete_emptydir_data: Optional[bool] = None


@dataclass
class DrainSpec(SpecBase):
    enable: Optional[bool] = None
    force: Optional[bool] = None
    pod_selector: str = ""
    timeout_seconds: int = 300
    delete_emptydir_data: Optional[bool] = None


@dataclass
class UpgradePolicySpec(SpecBase):
    """Safe rolling driver upgrades (``v1alpha1.DriverUpgradePolicySpec``)."""

    auto_upgrade: Optional[bool] = None
    max_parallel_upgrades: int = 1
    max_unavailable: str = "25%"
    wait_for_completion: Optional[Dict[str, Any]] = None
    pod_deletion: Optional[PodDeletionSpec] = None
    drain: Optional[DrainSpec] = None

    def is_auto_upgrade_enabled(self) -> bool:
        return bool(self.auto_upgrade)


# ---------------------------------------------------------------------------
# Operand specs
# ---------------------------------------------------------------------------


@dataclass
class DriverSpec(_ImageSpec):
    """The driver installer (the reference's ``LibtpuSpec``): the operand
    (``operands/driver_installer.py``) puts the driver's user-space
    libraries under ``install_dir`` and probes ``/dev/nvidia*``. The image
    fans out per card variant (``h100-sxm``, ``h100-pcie``, ``h100-nvl``,
    ``workloads/topology.py``) via ``generation_configs``.
    """

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-driver-installer"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    install_dir: str = "/run/nvidia/driver"
    # map of card variant (h100-sxm, h100-pcie, h100-nvl) -> image version
    # override; drives one DaemonSet per variant (the per-kernel fan-out).
    generation_configs: Dict[str, str] = field(default_factory=dict)
    # custom artifact-source config mounted into the installer (driver
    # ``repoConfig`` {configMapName}: mirror/endpoint config)
    repo_config: Dict[str, str] = field(default_factory=dict)
    # extra CA certificates for the installer's download endpoint (driver
    # ``certConfig`` {name})
    cert_config: Dict[str, str] = field(default_factory=dict)
    upgrade_policy: Optional[UpgradePolicySpec] = None
    rolling_update: Optional[RollingUpdateSpec] = None
    startup_probe: Optional[Dict[str, Any]] = None
    liveness_probe: Optional[Dict[str, Any]] = None
    readiness_probe: Optional[Dict[str, Any]] = None

    ENV_VAR = "GPU_DRIVER_INSTALLER_IMAGE"


@dataclass
class ToolkitSpec(_ImageSpec):
    """The container toolkit's runtime wiring (the reference's
    ``RuntimeSpec``): the operand (``operands/runtime_wire.py``) writes a
    CDI spec exposing ``/dev/nvidia*``, the driver's control nodes and its
    libraries.
    """

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-runtime-wire"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    install_dir: str = "/usr/local/nvidia"

    ENV_VAR = "GPU_RUNTIME_WIRE_IMAGE"


@dataclass
class DevicePluginConfig(SpecBase):
    """Custom plugin config via ConfigMap (reference ``DevicePluginConfig``)."""

    name: str = ""
    default: str = ""


@dataclass
class DevicePluginSpec(_ImageSpec):
    """The device plugin advertising ``nvidia.com/gpu`` with NVLink-aware
    allocation (``plugin/``)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-device-plugin"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    config: Optional[DevicePluginConfig] = None

    ENV_VAR = "GPU_DEVICE_PLUGIN_IMAGE"


@dataclass
class MetricsdSpec(_ImageSpec):
    """The standalone metrics daemon (``metricsd/``, the DCGM hostengine
    slot)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-metricsd"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    host_port: int = 5555
    env: List[EnvVar] = field(default_factory=list)
    # run the card-owning sampler sidecar next to the native hostengine
    # (only enable on nodes the daemon may own)
    sample_on_chip: Optional[bool] = None

    ENV_VAR = "GPU_METRICSD_IMAGE"


@dataclass
class MetricsConfig(SpecBase):
    name: str = ""


@dataclass
class MetricsExporterSpec(_ImageSpec):
    """The Prometheus metrics exporter (``exporter/``, the DCGM exporter
    slot)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-metrics-exporter"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    metrics_config: Optional[MetricsConfig] = None
    service_monitor: Optional[Dict[str, Any]] = None

    ENV_VAR = "GPU_METRICS_EXPORTER_IMAGE"


@dataclass
class NodeStatusExporterSpec(_ImageSpec):
    """Validator image in metrics mode (``validator/metrics.py``)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-operator-validator"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)

    ENV_VAR = "GPU_VALIDATOR_IMAGE"


@dataclass
class TFDSpec(_ImageSpec):
    """Feature discovery (``discovery/``): product, count, memory, driver
    version, NVLink topology and slice labels."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-feature-discovery"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None

    ENV_VAR = "GPU_FEATURE_DISCOVERY_IMAGE"


@dataclass
class MaintenanceHandlerSpec(_ImageSpec):
    """Host-maintenance watcher: cordons, labels and evicts GPU workloads
    ahead of a maintenance window. Opt-in: absent or ``enabled: false``
    deploys nothing."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-operator"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    # metadata poll cadence; GCE gives >= 60 s of notice
    poll_interval_seconds: int = 10
    # also delete unmanaged (ownerless) GPU pods when a window opens
    force_evict: Optional[bool] = None
    # cordon/label only; leave workloads to ride out the window
    evict_workloads: Optional[bool] = None

    ENV_VAR = "GPU_OPERATOR_IMAGE"

    def is_enabled(self) -> bool:
        # opt-in, unlike most operands: maintenance eviction is a policy
        # decision (it kills running training pods on purpose)
        return bool(self.enabled)


@dataclass
class RemediationSpec(SpecBase):
    """Node-health remediation FSM knobs. Opt-in like the maintenance
    handler: remediation cordons, taints and drains nodes on purpose.

    ``maxUnavailable`` is the fleet-wide disruption budget SHARED with
    rolling driver upgrades: both admissions count the same JOINT set of
    disrupted slices (upgrade-active/failed + remediation-quarantined,
    ``upgrade_state.slice_budget``), each against its own cap — with this
    knob equal to ``upgradePolicy.maxUnavailable`` (both default "25%")
    that is exactly one pool; if they differ, the tighter cap governs new
    disruptions on its own side.
    ``maxAttempts`` caps escalation steps per node before ``exhausted``;
    ``backoffSeconds`` is the jittered-exponential base between steps.
    ``systemicThreshold`` is the systemic-failure breaker: when at least
    that fraction of GPU nodes turns unhealthy in one pass, remediation
    halts with zero drains (a bad driver push must not drain the fleet).
    """

    enabled: Optional[bool] = None
    max_unavailable: str = "25%"
    max_attempts: int = 5
    backoff_seconds: int = 30
    systemic_threshold: str = "50%"

    def is_enabled(self) -> bool:
        # opt-in: remediation issues disruptions (cordon/taint/drain)
        return bool(self.enabled)


@dataclass
class RolloutSpec(SpecBase):
    """Health-gated progressive rollouts. When enabled, any fleet-wide
    version/layout change (``driver.version`` through the upgrade FSM,
    ``sliceManager.config.default`` through the re-partition roller) is
    staged through **canary → wave(s) → fleet** slice cohorts
    (``controllers/rollout.py``), with a live health gate between stages:
    validator TFLOPS/membw deltas vs the pre-roll per-node baseline, new
    remediation quarantines, upgrade failures, operand crashloops,
    Degraded conditions, and alloc-latency regression. A regressing
    canary pauses the roll and — with ``autoRollback`` (default on) —
    re-rolls the cohort to the recorded previous version.

    ``canary``/``waves`` are int-or-percent of the fleet's SLICES (the
    disruption unit): canary defaults to 1 slice, then one 25% wave,
    then the rest of the fleet. ``observeSeconds`` is the per-stage soak
    after the cohort finishes rolling before promotion. The degraded-
    percent knobs are regression thresholds vs the recorded baseline."""

    enabled: Optional[bool] = None
    canary: str = "1"
    waves: List[str] = field(default_factory=lambda: ["25%"])
    observe_seconds: int = 60
    tflops_degraded_pct: int = 10
    membw_degraded_pct: int = 10
    alloc_p99_degraded_pct: int = 100
    auto_rollback: Optional[bool] = None

    def is_enabled(self) -> bool:
        # opt-in: staged rolls deliberately slow fleet-wide changes down
        return bool(self.enabled)

    def rollback_enabled(self) -> bool:
        # default ON: a staged roll without automatic rollback only
        # contains the blast radius, it doesn't undo it
        return True if self.auto_rollback is None else bool(self.auto_rollback)


@dataclass
class SliceSpec(SpecBase):
    """Subslice exposure strategy — the reference's ``MIGSpec``.

    ``strategy`` is ``none`` | ``single`` | ``mixed``: whether partitioned
    subslices are advertised as uniform ``nvidia.com/gpu`` or as
    ``nvidia.com/mig-<shape>`` resources.
    """

    strategy: str = "single"


@dataclass
class SliceManagerSpec(_ImageSpec):
    """Slice/partition manager (``sliceman/``) — the ``MIGManagerSpec`` slot
    (``assets/state-mig-manager/``, named layouts ConfigMap, node-label FSM).

    ``config.default`` (the reference's ``mig.config`` default profile)
    doubles as the FLEET-WIDE desired layout: when set, the live
    re-partition controller (``controllers/repartition.py``) rolls every
    GPU node whose applied layout differs, slice-by-slice, through the
    shared disruption budget. ``maxUnavailable`` is that roll's cap over
    the JOINT disrupted set (upgrades + remediation + re-partition draw
    on one pool; with the three knobs equal — all default "25%" — it is
    exactly one budget)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-slice-manager"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    config: Optional[DevicePluginConfig] = None
    chip_clients_config: Optional[MetricsConfig] = None
    max_unavailable: str = "25%"

    ENV_VAR = "GPU_SLICE_MANAGER_IMAGE"


@dataclass
class ValidatorSpec(_ImageSpec):
    """Validation harness (``validator/``). Components: driver, toolkit,
    plugin, cuda, slice, nodestatus (metrics mode)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-operator-validator"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    plugin: Optional[Dict[str, Any]] = None
    cuda: Optional[Dict[str, Any]] = None
    driver: Optional[Dict[str, Any]] = None
    toolkit: Optional[Dict[str, Any]] = None
    # optional deep diagnostic: HBM bandwidth probe ({"enabled": true,
    # "env": [...]}) appended to the validation chain — the reference's
    # ``dcgmi diag`` memory-bandwidth analogue, off by default because it
    # holds the chip for a few extra seconds per validation pass
    membw: Optional[Dict[str, Any]] = None
    # optional long-context probe: blockwise ring attention over an ``sp``
    # mesh axis checked against full attention ({"enabled": true, "env":
    # [...]}); proves the context-parallel path on multi-chip hosts, off by
    # default for the same chip-holding reason as membw
    ringattn: Optional[Dict[str, Any]] = None
    # optional ICI ring probe: per-link integrity + bandwidth via ppermute
    ici: Optional[Dict[str, Any]] = None
    # optional pipeline-parallel probe: GPipe microbatch schedule over pp
    pipeline: Optional[Dict[str, Any]] = None
    # optional expert-parallel probe: MoE all_to_all dispatch/combine
    moe: Optional[Dict[str, Any]] = None
    # optional hot-op probe: single-card flash attention with
    # online softmax checked against full attention (see
    # workloads/flashattn.py); off by default (chip-holding)
    flashattn: Optional[Dict[str, Any]] = None

    ENV_VAR = "GPU_VALIDATOR_IMAGE"


@dataclass
class DirectStorageSpec(_ImageSpec):
    """High-bandwidth storage path — the reference's ``GPUDirectStorageSpec``
    (GDS / nvidia-fs) slot; disabled by default."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-direct-storage"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)

    ENV_VAR = "GPU_DIRECT_STORAGE_IMAGE"

    def is_enabled(self) -> bool:
        # storage fast-path defaults OFF, like the reference's GDS
        return bool(self.enabled)


@dataclass
class SandboxWorkloadsSpec(SpecBase):
    """Sandbox (VM-passthrough) workload gating — reference
    ``SandboxWorkloadsSpec``. ``default_workload``: container | vm-passthrough."""

    enabled: Optional[bool] = None
    default_workload: str = "container"

    def is_enabled(self) -> bool:
        return bool(self.enabled)


@dataclass
class VFIOManagerSpec(_ImageSpec):
    """Binds the cards' PCI functions to vfio-pci for VM passthrough — reference
    ``VFIOManagerSpec`` slot."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-vfio-manager"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)

    ENV_VAR = "GPU_VFIO_MANAGER_IMAGE"


@dataclass
class SandboxDevicePluginSpec(_ImageSpec):
    """Device plugin for VM workloads (kubevirt style) — reference
    ``SandboxDevicePluginSpec`` slot."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-sandbox-device-plugin"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    args: List[str] = field(default_factory=list)

    ENV_VAR = "GPU_SANDBOX_DEVICE_PLUGIN_IMAGE"


@dataclass
class VMManagerSpec(_ImageSpec):
    """VM passthrough host manager — reference ``VGPUManagerSpec`` slot."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-vm-manager"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)

    ENV_VAR = "GPU_VM_MANAGER_IMAGE"


@dataclass
class VMDeviceManagerSpec(_ImageSpec):
    """Creates passthrough GPU devices per named config — reference
    ``VGPUDeviceManagerSpec`` slot."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-vm-device-manager"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    config: Optional[DevicePluginConfig] = None

    ENV_VAR = "GPU_VM_DEVICE_MANAGER_IMAGE"


@dataclass
class CDISpec(SpecBase):
    """Container Device Interface knobs (reference ``CDIConfigSpec``,
    ``controllers/object_controls.go:125-138``). Here CDI is the default
    device-injection path."""

    enabled: Optional[bool] = None
    default: Optional[bool] = None

    def is_enabled(self) -> bool:
        # CDI defaults ON (modern path).
        if self.enabled is None:
            return True
        return bool(self.enabled)

    def is_default(self) -> bool:
        if self.default is None:
            return True
        return bool(self.default)


@dataclass
class KataManagerSpec(_ImageSpec):
    """Kata runtime artifacts — reference ``KataManagerSpec`` slot
    (``controllers/object_controls.go:4336-4428``)."""

    enabled: Optional[bool] = None
    repository: str = ""
    image: str = "gpu-kata-manager"
    version: str = ""
    image_pull_policy: Optional[str] = None
    image_pull_secrets: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    config: Optional[Dict[str, Any]] = None

    ENV_VAR = "GPU_KATA_MANAGER_IMAGE"


@dataclass
class PSPSpec(SpecBase):
    enabled: Optional[bool] = None

    def is_enabled(self) -> bool:
        return bool(self.enabled)


@dataclass
class PSASpec(SpecBase):
    enabled: Optional[bool] = None

    def is_enabled(self) -> bool:
        return bool(self.enabled)


# ---------------------------------------------------------------------------
# ClusterPolicy
# ---------------------------------------------------------------------------


@dataclass
class ClusterPolicySpec(SpecBase):
    """Spec with one sub-spec per operand (reference
    ``api/v1/clusterpolicy_types.go:36-84`` — 23 sub-specs)."""

    operator: OperatorSpec = field(default_factory=OperatorSpec)
    daemonsets: DaemonsetsSpec = field(default_factory=DaemonsetsSpec)
    driver: DriverSpec = field(default_factory=DriverSpec)
    toolkit: ToolkitSpec = field(default_factory=ToolkitSpec)
    device_plugin: DevicePluginSpec = field(default_factory=DevicePluginSpec)
    direct_storage: DirectStorageSpec = field(default_factory=DirectStorageSpec)
    metricsd: MetricsdSpec = field(default_factory=MetricsdSpec)
    metrics_exporter: MetricsExporterSpec = field(default_factory=MetricsExporterSpec)
    node_status_exporter: NodeStatusExporterSpec = field(
        default_factory=NodeStatusExporterSpec
    )
    tfd: TFDSpec = field(default_factory=TFDSpec)
    maintenance_handler: MaintenanceHandlerSpec = field(
        default_factory=MaintenanceHandlerSpec
    )
    remediation: RemediationSpec = field(default_factory=RemediationSpec)
    rollout: RolloutSpec = field(default_factory=RolloutSpec)
    slice: SliceSpec = field(default_factory=SliceSpec)
    slice_manager: SliceManagerSpec = field(default_factory=SliceManagerSpec)
    validator: ValidatorSpec = field(default_factory=ValidatorSpec)
    sandbox_workloads: SandboxWorkloadsSpec = field(
        default_factory=SandboxWorkloadsSpec
    )
    vfio_manager: VFIOManagerSpec = field(default_factory=VFIOManagerSpec)
    sandbox_device_plugin: SandboxDevicePluginSpec = field(
        default_factory=SandboxDevicePluginSpec
    )
    vm_manager: VMManagerSpec = field(default_factory=VMManagerSpec)
    vm_device_manager: VMDeviceManagerSpec = field(default_factory=VMDeviceManagerSpec)
    cdi: CDISpec = field(default_factory=CDISpec)
    kata_manager: KataManagerSpec = field(default_factory=KataManagerSpec)
    psp: PSPSpec = field(default_factory=PSPSpec)
    psa: PSASpec = field(default_factory=PSASpec)

    def sandbox_enabled(self) -> bool:
        return self.sandbox_workloads.is_enabled()


@dataclass
class ClusterPolicyStatus(SpecBase):
    """Status (reference ``api/v1/clusterpolicy_types.go:1509-1523``)."""

    state: str = ""
    namespace: str = ""
    conditions: List[Dict[str, Any]] = field(default_factory=list)
    # slice-scoped readiness aggregate: {"total": N, "ready": M,
    # "degraded": [ids]}
    slices: Dict[str, Any] = field(default_factory=dict)
    # per-state error isolation: states whose step() raised this pass,
    # [{"state": name, "error": "Type: message"}]; the pass continues to
    # independent states and a Degraded condition summarizes this block
    errored_states: List[Dict[str, Any]] = field(default_factory=list)
    # node-health remediation counts: {"unhealthy": N, "quarantined": N,
    # "exhausted": N, "breakerOpen": bool} — the fleet-repair truth at a
    # glance; breakerOpen mirrors the Degraded/SystemicNodeFailure
    # condition
    remediation: Dict[str, Any] = field(default_factory=dict)
    # health-gated rollout progress: {"kind": "driver"|"layout",
    # "target": v, "state": "rolling"|"paused"|"rolledBack"|"complete",
    # "stage": "k/n", "evidence": [...]} — mirrors the durable rollout
    # ledger annotation (controllers/rollout.py)
    rollout: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ClusterPolicy(SpecBase):
    """The single cluster-scoped CR (reference ``ClusterPolicy`` ``:1525``)."""

    api_version: str = "tpu.k8s.io/v1"
    kind: str = "ClusterPolicy"
    metadata: Dict[str, Any] = field(default_factory=dict)
    spec: ClusterPolicySpec = field(default_factory=ClusterPolicySpec)
    status: ClusterPolicyStatus = field(default_factory=ClusterPolicyStatus)

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    def set_status(self, state: str, namespace: str) -> None:
        """reference ``SetStatus`` (``api/v1/clusterpolicy_types.go:1547``)."""
        self.status.state = state
        self.status.namespace = namespace

def clusterpolicy_from_obj(obj: Dict[str, Any]) -> ClusterPolicy:
    """Decode a raw dict (as stored in the API server) into a ClusterPolicy."""
    cp = ClusterPolicy(
        api_version=obj.get("apiVersion", "tpu.k8s.io/v1"),
        kind=obj.get("kind", "ClusterPolicy"),
        metadata=dict(obj.get("metadata", {})),
        spec=ClusterPolicySpec.from_dict(obj.get("spec", {})),
        status=ClusterPolicyStatus.from_dict(obj.get("status", {})),
    )
    return cp


def clusterpolicy_to_obj(cp: ClusterPolicy) -> Dict[str, Any]:
    obj = {
        "apiVersion": cp.api_version,
        "kind": cp.kind,
        "metadata": cp.metadata,
        "spec": cp.spec.to_dict(),
    }
    status = cp.status.to_dict()
    if status:
        obj["status"] = status
    return obj


# ---------------------------------------------------------------------------
# The rename table between the JAX package's ClusterPolicy and the port's
# ---------------------------------------------------------------------------

#: a key renamed at one path of the CR (reference path -> port key)
KEY_RENAMES: Dict[tuple, str] = {
    ("spec", "libtpu"): "driver",
    ("spec", "runtime"): "toolkit",
    ("spec", "validator", "libtpu"): "driver",
    ("spec", "validator", "runtime"): "toolkit",
    ("spec", "validator", "jax"): "cuda",
}

#: a string renamed wherever it stands in the CR, as a value or a map key:
#: the accelerator's names, the default images and the driver's paths
VALUE_RENAMES: Dict[str, str] = {
    "google.com/tpu": "nvidia.com/gpu",
    "feature.node.kubernetes.io/pci-1ae0.present": "feature.node.kubernetes.io/pci-10de.present",
    "tpu.k8s.io/libtpu-upgrade-state": "tpu.k8s.io/driver-upgrade-state",
    "libtpu-installer": "gpu-driver-installer",
    "/home/kubernetes/lib/tpu": "/run/nvidia/driver",
    "tpu-runtime": "gpu-runtime-wire",
    "/usr/local/tpu": "/usr/local/nvidia",
    "tpu-device-plugin": "gpu-device-plugin",
    "tpu-metricsd": "gpu-metricsd",
    "tpu-metrics-exporter": "gpu-metrics-exporter",
    "tpu-operator-validator": "gpu-operator-validator",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-operator": "gpu-operator",
    "tpu-slice-manager": "gpu-slice-manager",
    "tpu-direct-storage": "gpu-direct-storage",
    "tpu-vfio-manager": "gpu-vfio-manager",
    "tpu-sandbox-device-plugin": "gpu-sandbox-device-plugin",
    "tpu-vm-manager": "gpu-vm-manager",
    "tpu-vm-device-manager": "gpu-vm-device-manager",
    "tpu-kata-manager": "gpu-kata-manager",
}

#: a string renamed at one path only: too short to rename everywhere
PATH_VALUE_RENAMES: Dict[tuple, Dict[str, str]] = {
    ("spec", "operator", "runtimeClass"): {"tpu": "nvidia"},
}

#: a prefix renamed wherever a string starts with it (subslice resources)
PREFIX_RENAMES: Dict[str, str] = {"google.com/tpu-": "nvidia.com/mig-"}

#: the environment variables that override each default image
ENV_VAR_RENAMES: Dict[str, str] = {
    "TPU_OPERATOR_INIT_CONTAINER_IMAGE": "GPU_OPERATOR_INIT_CONTAINER_IMAGE",
    "LIBTPU_INSTALLER_IMAGE": "GPU_DRIVER_INSTALLER_IMAGE",
    "TPU_RUNTIME_IMAGE": "GPU_RUNTIME_WIRE_IMAGE",
    "TPU_DEVICE_PLUGIN_IMAGE": "GPU_DEVICE_PLUGIN_IMAGE",
    "TPU_METRICSD_IMAGE": "GPU_METRICSD_IMAGE",
    "TPU_METRICS_EXPORTER_IMAGE": "GPU_METRICS_EXPORTER_IMAGE",
    "TPU_VALIDATOR_IMAGE": "GPU_VALIDATOR_IMAGE",
    "TPU_FEATURE_DISCOVERY_IMAGE": "GPU_FEATURE_DISCOVERY_IMAGE",
    "TPU_OPERATOR_IMAGE": "GPU_OPERATOR_IMAGE",
    "TPU_SLICE_MANAGER_IMAGE": "GPU_SLICE_MANAGER_IMAGE",
    "TPU_DIRECT_STORAGE_IMAGE": "GPU_DIRECT_STORAGE_IMAGE",
    "TPU_VFIO_MANAGER_IMAGE": "GPU_VFIO_MANAGER_IMAGE",
    "TPU_SANDBOX_DEVICE_PLUGIN_IMAGE": "GPU_SANDBOX_DEVICE_PLUGIN_IMAGE",
    "TPU_VM_MANAGER_IMAGE": "GPU_VM_MANAGER_IMAGE",
    "TPU_VM_DEVICE_MANAGER_IMAGE": "GPU_VM_DEVICE_MANAGER_IMAGE",
    "TPU_KATA_MANAGER_IMAGE": "GPU_KATA_MANAGER_IMAGE",
}

#: the accelerator's words in free text (a CRD's descriptions), longest first
TEXT_RENAMES = (
    ("google.com/tpu", "nvidia.com/gpu"),
    ("libtpu", "driver"),
    ("TPU", "GPU"),
)
