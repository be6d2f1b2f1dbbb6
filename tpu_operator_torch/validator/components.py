"""Validator components of the port.

Each component checks one layer of the node and drops a status file into
the validation directory, the host-local barrier the operand DaemonSets
wait on (the reference's ``validator/main.go:123-157``). Payloads keep the
JAX package's flat schema: ``tflops`` and ``gbps`` at the top level.

The host checks read files, as the reference's do, and import no
``torch``:

  driver   → card nodes, ``nvidiactl``, ``libcuda``/``libnvidia-ml`` under
             the driver root, /dev/char links, the chip table (``driver-ready``)
  toolkit  → a CDI spec lists ``nvidia.com/gpu`` devices (``toolkit-ready``)
  plugin   → node capacity advertises ``nvidia.com/gpu`` and some is
             allocatable; optional one-card pod (``plugin-ready``)
  slice-workload → one gang pod per member host of the node's slice
  vfio-pci, vm-manager, vm-devices → the sandbox (VM-passthrough) checks

The compute components need a card:

  cuda      → bf16 matmul chain in-process, with TFLOPS, or the matmul pod
              (``cuda-ready``)
  membw     → device-memory bandwidth probe (``membw-ready``)
  flashattn → flash-attention probe (``flashattn-ready``)
  slice     → dp × tp burn-in across the cards (``slice-ready``)
  ici       → ring probe: per-link health + bandwidth (``ici-ready``)
  ringattn  → ring-attention context-parallel probe (``ringattn-ready``)
  pipeline  → GPipe pipeline-parallel probe (``pipeline-ready``)
  moe       → expert-parallel all_to_all probe (``moe-ready``)

``expect_gpu=True`` (the default) requires a CUDA card; ``False`` accepts
the CPU when no card is visible (the CLI's ``--allow-cpu``). The last five
run a world of ranks (``workloads/mesh.py``): ``expect_devices=None``
means every card on ``cuda`` and one rank on the CPU.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import time
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.native.gpuinfo import find_gpu_devices

log = logging.getLogger("tpu-validator")

WAIT_RETRIES = 60  # reference validator/main.go:158-161 (60x5s)
WAIT_SLEEP_S = 5
PLUGIN_RETRIES = 30  # reference :162-165 (30x5s)
# where a driver root keeps its user-space libraries
DRIVER_LIB_DIRS = (
    "usr/lib64",
    "usr/lib/x86_64-linux-gnu",
    "usr/lib/aarch64-linux-gnu",
    "usr/lib",
    "lib64",
    "lib/x86_64-linux-gnu",
    "lib/aarch64-linux-gnu",
    "usr/local/nvidia/lib64",
)


class ValidationError(RuntimeError):
    pass


class StatusFiles:
    def __init__(self, output_dir: str = consts.VALIDATION_DIR):
        self.dir = output_dir

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def write(self, name: str, payload: Optional[dict] = None) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with open(self.path(name), "w") as f:
            if payload is not None:
                json.dump(payload, f)

    def remove(self, name: str) -> None:
        try:
            os.unlink(self.path(name))
        except FileNotFoundError:
            pass

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def wait_for(self, name: str, retries: int = WAIT_RETRIES) -> None:
        for _ in range(retries):
            if self.exists(name):
                return
            log.info("waiting for %s", self.path(name))
            time.sleep(WAIT_SLEEP_S)
        raise ValidationError(f"timed out waiting for {self.path(name)}")


# ---------------------------------------------------------------------------
# driver component (reference validator/main.go:607-679; libtpu at :95)
# ---------------------------------------------------------------------------


def find_driver_libraries(driver_root: str) -> dict:
    """``libcuda.so*`` and ``libnvidia-ml.so*`` under the driver root's
    library directories, each a sorted list."""
    found = {"libcuda": [], "libnvidia_ml": []}
    for d in DRIVER_LIB_DIRS:
        base = os.path.join(driver_root, d)
        found["libcuda"] += glob.glob(os.path.join(base, "libcuda.so*"))
        found["libnvidia_ml"] += glob.glob(os.path.join(base, "libnvidia-ml.so*"))
    return {k: sorted(set(v)) for k, v in found.items()}


def validate_driver(
    status: StatusFiles,
    driver_root: str = consts.DRIVER_ROOT,
    dev_root: str = "/dev",
    with_wait: bool = False,
) -> dict:
    """Card nodes and ``nvidiactl`` present, the driver's user-space
    libraries installed, the /dev/char links made, and the chip table in
    the payload (the reference's chroot ``nvidia-smi``)."""
    if with_wait:
        status.wait_for(consts.STATUS_FILE_DRIVER_CTR)
    devices = find_gpu_devices(dev_root)
    if not devices:
        raise ValidationError(f"no GPU devices under {dev_root} (nvidia[0-9]*/vfio)")
    card_nodes = any(os.path.basename(p).startswith("nvidia") for p in devices)
    ctl = os.path.join(dev_root, "nvidiactl")
    if card_nodes and not os.path.exists(ctl):
        raise ValidationError(f"{ctl} missing: the driver's control node is not there")
    libs = find_driver_libraries(driver_root)
    for key, name in (("libcuda", "libcuda.so"), ("libnvidia_ml", "libnvidia-ml.so")):
        if not libs[key]:
            raise ValidationError(f"{name} not found under {driver_root} ({', '.join(DRIVER_LIB_DIRS)})")
    info = {"devices": devices, **libs}
    from tpu_operator_torch.operands import devchar

    if os.environ.get(devchar.DISABLE_ENV) != "true":
        # systemd cgroup device-filter workaround (reference
        # createDevCharSymlinks, validator/main.go:681-708)
        created = devchar.create_dev_char_symlinks(dev_root)
        if created:
            info["devCharSymlinks"] = len(created)
    info["chips"] = gpuinfo.chip_summary(dev_root)
    status.write(consts.STATUS_FILE_DRIVER, info)
    return info


# ---------------------------------------------------------------------------
# toolkit component (reference validator/main.go:775-801; runtime at :141)
# ---------------------------------------------------------------------------


def _read_cdi_spec(path: str) -> dict:
    """A CDI spec is JSON (``.json``) or YAML; PyYAML only for the latter."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f) or {}
        import yaml

        return yaml.safe_load(f) or {}


def validate_toolkit(
    status: StatusFiles,
    cdi_spec_path: str = consts.CDI_SPEC_PATH,
    with_wait: bool = False,
) -> dict:
    """Device wiring present: the CDI spec exists and lists devices of
    kind ``nvidia.com/gpu``."""
    if with_wait:
        status.wait_for(consts.STATUS_FILE_DRIVER)
    if not os.path.exists(cdi_spec_path):
        raise ValidationError(f"CDI spec missing at {cdi_spec_path}")
    spec = _read_cdi_spec(cdi_spec_path)
    devices = spec.get("devices", [])
    if not devices:
        raise ValidationError(f"CDI spec at {cdi_spec_path} lists no devices")
    if spec.get("kind") != consts.GPU_RESOURCE:
        raise ValidationError(
            f"CDI spec at {cdi_spec_path} is of kind {spec.get('kind')!r}, not {consts.GPU_RESOURCE}"
        )
    info = {"cdiSpec": cdi_spec_path, "devices": [d.get("name") for d in devices]}
    status.write(consts.STATUS_FILE_TOOLKIT, info)
    return info


# ---------------------------------------------------------------------------
# plugin component (reference validator/main.go:931-1161)
# ---------------------------------------------------------------------------


def node_gpu_capacity(node: dict, field: str = "capacity") -> int:
    cap = node.get("status", {}).get(field, {}) or {}
    total = 0
    for key, val in cap.items():
        if key == consts.GPU_RESOURCE or key.startswith(consts.MIG_RESOURCE_PREFIX):
            try:
                total += int(val)
            except (TypeError, ValueError):
                pass
    return total


def node_gpu_allocatable(node: dict) -> int:
    """Healthy (schedulable) cards: the kubelet's device manager writes
    ``allocatable = capacity - unhealthy``, so a node whose cards all
    failed their health check advertises capacity N / allocatable 0."""
    status = node.get("status", {})
    if not status.get("allocatable"):
        # no kubelet allocatable accounting: fall back to capacity
        return node_gpu_capacity(node)
    return node_gpu_capacity(node, field="allocatable")


def validate_plugin(
    status: StatusFiles,
    client,
    node_name: str,
    with_wait: bool = False,
    with_workload: bool = False,
    namespace: str = "",
    retries: int = PLUGIN_RETRIES,
    sleep_s: float = WAIT_SLEEP_S,
) -> dict:
    """Node capacity advertises cards (reference ``:1083-1161``) AND at
    least one is allocatable, then optionally proves schedulability with a
    one-card pod (``:931-1015``)."""
    if with_wait:
        status.wait_for(consts.STATUS_FILE_TOOLKIT)
    count = allocatable = 0
    for attempt in range(retries):
        node = client.get("v1", "Node", node_name)
        count = node_gpu_capacity(node)
        allocatable = node_gpu_allocatable(node)
        if count > 0 and allocatable > 0:
            break
        log.info(
            "node %s reports no allocatable %s yet (attempt %d)",
            node_name,
            consts.GPU_RESOURCE,
            attempt,
        )
        time.sleep(sleep_s)
    if count <= 0:
        raise ValidationError(f"node {node_name} never advertised {consts.GPU_RESOURCE}")
    if allocatable <= 0:
        raise ValidationError(
            f"node {node_name} advertises {count} {consts.GPU_RESOURCE} "
            "but none are allocatable (all cards Unhealthy)"
        )
    info = {"node": node_name, "capacity": count, "allocatable": allocatable}
    if with_workload:
        from tpu_operator_torch.validator import workload_pods

        pod = workload_pods.plugin_workload_pod(node_name, namespace)
        workload_pods.run_to_completion(client, pod)
        info["workload"] = pod["metadata"]["name"]
    status.write(consts.STATUS_FILE_PLUGIN, info)
    return info


# ---------------------------------------------------------------------------
# the compute components
# ---------------------------------------------------------------------------


def _device(expect_gpu: bool) -> Optional[str]:
    # None asks the workload for cuda and makes it raise without a GPU
    if expect_gpu:
        return None
    from tpu_operator_torch.device import available_device

    return available_device()


def validate_cuda(
    status: StatusFiles,
    expect_gpu: bool = True,
    size: int = 4096,
    client=None,
    node_name: str = "",
    namespace: str = "",
    with_workload: bool = False,
) -> dict:
    """End-to-end card proof (reference ``validate_jax``, :250-279).

    ``with_workload`` spawns the matmul pod (crossing the API server) and
    records the pod's outcome only, no perf fields; otherwise the matmul
    chain runs in-process and the status file records achieved TFLOPS."""
    from tpu_operator_torch.workloads.timing import span

    with span("validator.cuda", size=size):
        if with_workload:
            if client is None:
                raise ValidationError("cuda workload validation needs a k8s client")
            from tpu_operator_torch.validator import workload_pods

            pod = workload_pods.cuda_workload_pod(node_name, namespace)
            result = workload_pods.run_to_completion(client, pod)
            info = {"workload": pod["metadata"]["name"], "result": result}
        else:
            from tpu_operator_torch.workloads.matmul import run_matmul_validation

            res = run_matmul_validation(size=size, device=_device(expect_gpu))
            if not res.ok:
                raise ValidationError(f"cuda matmul failed: {res.error}")
            info = res.to_dict()
        status.write(consts.STATUS_FILE_CUDA, info)
    return info


def validate_flashattn(
    status: StatusFiles,
    seq: int = 2048,
    heads: int = 4,
    expect_gpu: bool = True,
) -> dict:
    """Single-card hot-op probe: flash attention with online softmax
    (running max + denominator in f32, bf16 tensor-core tiles), checked
    against naive full attention in f32."""
    from tpu_operator_torch.workloads.flashattn import run_flashattn_probe
    from tpu_operator_torch.workloads.timing import span

    with span("validator.flashattn", seq=seq, heads=heads):
        res = run_flashattn_probe(seq=seq, heads=heads, device=_device(expect_gpu))
        if not res.ok:
            raise ValidationError(
                f"flash-attention probe failed: {res.error or 'divergence'}"
            )
        status.write(consts.STATUS_FILE_FLASHATTN, res.to_dict())
        return res.to_dict()


def validate_membw(
    status: StatusFiles,
    expect_gpu: bool = True,
    min_utilization: float = 0.5,
    size_mb: int = 0,
) -> dict:
    """Deep hardware diagnostic: achieved device-memory bandwidth via the
    bulk-copy kernel and the elementwise stream (``workloads/membw.py``),
    gated against the card's datasheet rate."""
    from tpu_operator_torch.workloads.membw import run_membw_probe
    from tpu_operator_torch.workloads.timing import span

    if size_mb <= 0:
        # the CPU path only checks semantics: keep its buffer tiny
        size_mb = 2048 if expect_gpu else 8
    with span("validator.membw", size_mb=size_mb):
        res = run_membw_probe(size_mb=size_mb, device=_device(expect_gpu))
        if not res.ok:
            raise ValidationError(f"membw probe failed: {res.error}")
        info = res.to_dict()
        if expect_gpu and res.utilization is None:
            # unknown card: no spec number to gate against — record loudly
            # rather than silently passing a possibly-sick stack
            info["utilization_gate"] = "skipped: unknown generation"
            log.warning(
                "membw: no HBM spec for device_kind=%r; %.0f GB/s NOT gated",
                res.device_kind,
                res.gbps,
            )
        elif expect_gpu and res.utilization < min_utilization:
            raise ValidationError(
                f"HBM bandwidth {res.gbps:.0f} GB/s is below "
                f"{min_utilization:.0%} of the {res.peak_gbps:.0f} GB/s spec "
                f"for {res.device_kind}"
            )
        status.write(consts.STATUS_FILE_MEMBW, info)
    return info


# ---------------------------------------------------------------------------
# the multi-device components: one world of ranks each
# ---------------------------------------------------------------------------


def validate_slice(
    status: StatusFiles,
    steps: int = 10,
    expect_devices: Optional[int] = None,
    expect_gpu: bool = True,
) -> dict:
    """Multi-card burn-in: a dp × tp train step exercising every link."""
    from tpu_operator_torch.workloads.burnin import run_burnin

    res = run_burnin(n_devices=expect_devices, steps=steps, device=_device(expect_gpu))
    if not res.ok:
        raise ValidationError(f"slice burn-in failed: {res.error or 'loss did not decrease'}")
    status.write(consts.STATUS_FILE_SLICE, res.to_dict())
    return res.to_dict()


def validate_ici(
    status: StatusFiles,
    expect_devices: Optional[int] = None,
    payload_mb: float = 4.0,
    expect_gpu: bool = True,
) -> dict:
    """Rotate a payload around the full ring of cards via ppermute; every
    shard must return bit-exact (isolates individual links, unlike the
    aggregate burn-in)."""
    from tpu_operator_torch.workloads.ring import run_ring_probe

    res = run_ring_probe(
        n_devices=expect_devices, payload_mb=payload_mb, device=_device(expect_gpu)
    )
    if not res.ok:
        raise ValidationError(
            f"ICI ring probe failed: {res.error or 'integrity mismatch'}"
        )
    status.write(consts.STATUS_FILE_ICI, res.to_dict())
    return res.to_dict()


def validate_ringattn(
    status: StatusFiles,
    expect_devices: Optional[int] = None,
    seq_len: int = 2048,
    expect_gpu: bool = True,
) -> dict:
    """Long-context readiness: blockwise ring attention over an ``sp`` axis
    (K/V blocks rotated via ppermute, online-softmax accumulation), checked
    against single-pass full attention."""
    from tpu_operator_torch.workloads.ringattn import run_ringattn

    res = run_ringattn(n_devices=expect_devices, seq_len=seq_len, device=_device(expect_gpu))
    if not res.ok:
        raise ValidationError(
            f"ring-attention probe failed: {res.error or 'divergence'}"
        )
    status.write(consts.STATUS_FILE_RINGATTN, res.to_dict())
    return res.to_dict()


def validate_pipeline(
    status: StatusFiles, expect_devices: Optional[int] = None, expect_gpu: bool = True
) -> dict:
    """Pipeline-parallel readiness: a GPipe micro-batch pipeline (one stage
    a rank, activations streamed stage to stage via ppermute), checked
    against the stages applied in order on one device."""
    from tpu_operator_torch.workloads.pipeline import run_pipeline

    res = run_pipeline(n_devices=expect_devices, device=_device(expect_gpu))
    if not res.ok:
        raise ValidationError(
            f"pipeline probe failed: {res.error or 'divergence'}"
        )
    status.write(consts.STATUS_FILE_PIPELINE, res.to_dict())
    return res.to_dict()


def validate_moe(
    status: StatusFiles, expect_devices: Optional[int] = None, expect_gpu: bool = True
) -> dict:
    """Expert-parallel readiness: a top-1-gated MoE layer with all_to_all
    token dispatch and combine, checked against dense per-token expert
    application; capacity overflow fails loudly."""
    from tpu_operator_torch.workloads.moe import run_moe

    res = run_moe(n_devices=expect_devices, device=_device(expect_gpu))
    if not res.ok:
        raise ValidationError(f"moe probe failed: {res.error or 'divergence'}")
    status.write(consts.STATUS_FILE_MOE, res.to_dict())
    return res.to_dict()


# ---------------------------------------------------------------------------
# slice-workload component (N-pod gang acceptance across member hosts)
# ---------------------------------------------------------------------------


def validate_slice_workload(
    status: StatusFiles,
    client,
    node_name: str,
    namespace: str,
    retries: int = 60,
    sleep_s: float = 5.0,
) -> dict:
    """Coordinated multi-host acceptance: ONE pod per member host of this
    node's slice, gated on ``tpu.slice.ready``, with the worker ordinal and
    the process group's env injected; all N must succeed before the
    slice-scoped status file is written (reference ``:314``).

    Worker 0 (lowest worker-id label, name-ordered fallback) spawns the
    gang; every other member WAITS on the same pods, so all N validators
    converge on one verdict instead of racing N gangs. Single-host slices
    degenerate to a gang of one."""
    if client is None:
        raise ValidationError("slice-workload validation needs a k8s client")
    from tpu_operator_torch.controllers.slice_status import slice_id_for_node
    from tpu_operator_torch.validator import workload_pods

    node = client.get("v1", "Node", node_name)
    sid = slice_id_for_node(node)
    members_nodes = [n for n in client.list("v1", "Node") if slice_id_for_node(n) == sid]

    def ordinal(n):
        labels = n["metadata"].get("labels", {}) or {}
        wid = labels.get(consts.TFD_WORKER_ID_LABEL, "")
        try:
            return (0, int(wid), n["metadata"]["name"])
        except (TypeError, ValueError):
            return (1, 0, n["metadata"]["name"])

    members_nodes.sort(key=ordinal)
    members = []
    for n in members_nodes:
        chips = (n.get("status", {}).get("capacity", {}) or {}).get(consts.GPU_RESOURCE, "1")
        members.append((n["metadata"]["name"], str(chips or "1")))
    if not members:
        raise ValidationError(f"node {node_name}: no member nodes found for slice {sid}")
    leader = members[0][0] == node_name
    try:
        info = workload_pods.run_slice_gang(
            client, namespace, sid, members, spawn=leader, retries=retries, sleep_s=sleep_s
        )
    except RuntimeError as e:
        raise ValidationError(str(e))
    info["role"] = "leader" if leader else "follower"
    status.write(consts.STATUS_FILE_SLICE_WORKLOAD, info)
    return info


# ---------------------------------------------------------------------------
# vfio-pci component (reference validator/main.go:1301-1501, go-nvlib PCI)
# ---------------------------------------------------------------------------


def validate_vfio_pci(
    status: StatusFiles,
    sysfs: str = gpuinfo.SYSFS_PCI,
    client=None,
    node_name: str = "",
) -> dict:
    """Every NVIDIA card function (vendor 0x10de, display or 3D class;
    NVSwitch bridges are not cards) must be bound to vfio-pci. With a
    client, nodes not configured for vm-passthrough skip the check
    (reference ``VfioPCI.validate``, ``validator/main.go:1301-1340``)."""
    skipped = workload_config_gate(status, client, node_name)
    if skipped is not None:
        return skipped
    # clear any stale barrier first: on revalidation failure the sandbox
    # device plugin's wait gate must re-block rather than ride a ready file
    # from a previous (since-invalidated) pass
    status.remove(consts.STATUS_FILE_VFIO_PCI)
    bound, unbound = [], []
    if not os.path.isdir(sysfs):
        raise ValidationError(f"no sysfs PCI tree at {sysfs}")
    for addr in gpuinfo.card_functions(sysfs):
        driver = os.path.join(sysfs, addr, "driver")
        target = os.path.basename(os.readlink(driver)) if os.path.islink(driver) else ""
        (bound if target == "vfio-pci" else unbound).append(addr)
    if unbound:
        raise ValidationError(f"GPU functions not bound to vfio-pci: {unbound}")
    if not bound:
        raise ValidationError("no NVIDIA GPU functions found")
    info = {"bound": bound}
    status.write(consts.STATUS_FILE_VFIO_PCI, info)
    return info


# ---------------------------------------------------------------------------
# sandbox workload-config gate + vm-manager / vm-devices components
# (reference validator/main.go:1301-1501: each sandbox component reads the
# node's workload config, records it in a status file, and no-ops on nodes
# configured for a different workload)
# ---------------------------------------------------------------------------

WORKLOAD_TYPE_STATUS_FILE = "workload-type"


def workload_config_gate(status: StatusFiles, client, node_name: str) -> Optional[dict]:
    """Record the node's workload config; return a skip-info dict when the
    node is not a vm-passthrough host (sandbox components then succeed as
    no-ops, reference ``:601``)."""
    if client is None or not node_name:
        # no API access (dev run outside a pod): gate disabled, validate
        return None
    node = None
    err = None
    attempts = 3
    for i in range(attempts):
        # freshly-applied RBAC may still be propagating when the first
        # initContainer starts: a bounded retry, then the structured failure
        try:
            node = client.get("v1", "Node", node_name)
            break
        except Exception as e:  # noqa: BLE001 - any API failure retries
            err = e
            if i < attempts - 1:
                time.sleep(WAIT_SLEEP_S)
    if node is None:
        raise ValidationError(f"cannot read node {node_name}: {err}")
    from tpu_operator_torch.controllers.state_manager import node_workload_config

    cfg = node_workload_config(node)
    status.write(WORKLOAD_TYPE_STATUS_FILE, {"config": cfg})
    if cfg != consts.WORKLOAD_VM_PASSTHROUGH:
        log.info("workload config %r: sandbox validation not required", cfg)
        return {"skipped": True, "workload_config": cfg}
    return None


def validate_vm_manager(
    status: StatusFiles,
    client=None,
    node_name: str = "",
    dev_root: str = "/dev",
) -> dict:
    """The vm-manager operand prepared a usable passthrough host: vfio
    control node present plus at least one IOMMU group (reference
    ``:638``)."""
    skipped = workload_config_gate(status, client, node_name)
    if skipped is not None:
        return skipped
    status.remove(consts.STATUS_FILE_VM_MANAGER)
    control = os.path.join(dev_root, "vfio", "vfio")
    if not os.path.exists(control):
        raise ValidationError(f"vfio control node missing at {control} (vfio modules loaded?)")
    from tpu_operator_torch.operands.vm_manager import vfio_iommu_groups

    groups = vfio_iommu_groups(dev_root)
    if not groups:
        raise ValidationError(f"no vfio IOMMU groups under {dev_root}/vfio")
    info = {"groups": groups}
    status.write(consts.STATUS_FILE_VM_MANAGER, info)
    return info


def validate_vm_devices(
    status: StatusFiles,
    client=None,
    node_name: str = "",
    dev_root: str = "/dev",
    state_file: str = consts.VM_DEVICE_STATE_FILE,
    retries: int = WAIT_RETRIES,
) -> dict:
    """The vm-device-manager materialized VM-attachable devices: its state
    file lists at least one device and every recorded vfio group node
    exists (reference ``:666``)."""
    skipped = workload_config_gate(status, client, node_name)
    if skipped is not None:
        return skipped
    status.remove(consts.STATUS_FILE_VM_DEVICES)
    state = None
    for _ in range(retries):
        try:
            with open(state_file) as f:
                state = json.load(f)
            break
        except (OSError, ValueError):
            log.info("waiting for vm device state file %s", state_file)
            time.sleep(WAIT_SLEEP_S)
    if state is None:
        raise ValidationError(f"no vm device state at {state_file}")
    devices = state.get("devices") or []
    if not devices:
        raise ValidationError(f"{state_file} lists no VM devices")
    missing = [
        d.get("vfio_group", "") for d in devices if not os.path.exists(d.get("vfio_group", ""))
    ]
    if missing:
        raise ValidationError(f"vfio groups missing for VM devices: {missing}")
    info = {"config": state.get("config", ""), "devices": len(devices)}
    status.write(consts.STATUS_FILE_VM_DEVICES, info)
    return info
