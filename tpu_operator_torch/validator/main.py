"""Validator CLI of the port: ``python -m tpu_operator_torch.validator
--component X``, a counterpart of each of the JAX package's
``tpu-validator`` components (``tpu_operator/validator/main.py:20-37``):
``driver`` (for ``libtpu``), ``toolkit`` (``runtime``), ``plugin``,
``cuda`` (``jax``), the probes, the sandbox checks and ``nodestatus``, the
long-running node-status exporter.

The same flags and environment defaults as the reference, with the card's
names (``--driver-root``/``DRIVER_ROOT`` for ``--libtpu-install-dir``).
Exit 0 when the component passed and wrote its status file, 1 when it
failed. The host checks read files and import no ``torch``; ``--allow-cpu``
concerns only the compute components.

``--trace-out PATH`` enables the tracer (``obs/trace.py``) and writes its
span buffer to ``PATH`` as Chrome trace-event JSON (Perfetto loads it) when
the component ends, passed or failed: a compute component's spans show its
probe's phases (inputs, build, check, the timed chains and each timed
round), as an init container ran them.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from tpu_operator_torch import consts
from tpu_operator_torch.obs import trace
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.validator.components import StatusFiles

COMPONENTS = (
    "driver",
    "toolkit",
    "plugin",
    "cuda",
    "slice",
    "slice-workload",
    "ici",
    "ringattn",
    "pipeline",
    "moe",
    "membw",
    "flashattn",
    "vfio-pci",
    "vm-manager",
    "vm-devices",
    "nodestatus",
)


def _env_int(name: str, default: int) -> int:
    """Env-backed int flag default; a malformed value (e.g. an unresolved
    Helm template rendering to "") falls back instead of crashing before
    argparse can print usage."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        logging.getLogger("tpu-validator").warning(
            "ignoring non-integer %s=%r", name, os.environ.get(name)
        )
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        logging.getLogger("tpu-validator").warning(
            "ignoring non-numeric %s=%r", name, os.environ.get(name)
        )
        return default


def build_parser():
    p = argparse.ArgumentParser("tpu-validator-torch")
    p.add_argument(
        "--component",
        "-c",
        required=True,
        choices=COMPONENTS,
        help="which layer to validate",
    )
    p.add_argument(
        "--output-dir",
        default=os.environ.get("VALIDATION_OUTPUT_DIR", consts.VALIDATION_DIR),
    )
    p.add_argument(
        "--with-wait",
        action="store_true",
        default=os.environ.get("WITH_WAIT", "") == "true",
        help="block on the previous barrier's status file first",
    )
    p.add_argument(
        "--with-workload",
        action="store_true",
        default=os.environ.get("WITH_WORKLOAD", "") == "true",
        help="spawn a workload pod instead of validating in-process",
    )
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--namespace", default=os.environ.get(consts.OPERATOR_NAMESPACE_ENV, ""))
    p.add_argument(
        "--driver-root",
        default=os.environ.get("DRIVER_ROOT", consts.DRIVER_ROOT),
        help="the driver's root on the host (its libraries under usr/lib*, lib*)",
    )
    p.add_argument("--cdi-spec", default=os.environ.get("CDI_SPEC_PATH", consts.CDI_SPEC_PATH))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--sysfs", default="/sys/bus/pci/devices")
    p.add_argument(
        "--vm-state-file",
        default=os.environ.get("VM_DEVICE_STATE_FILE", consts.VM_DEVICE_STATE_FILE),
    )
    p.add_argument("--metrics-port", type=int, default=8000)
    p.add_argument("--matmul-size", type=int, default=4096)
    p.add_argument(
        "--ringattn-seq-len",
        type=int,
        default=_env_int("RINGATTN_SEQ_LEN", 2048),
        help="total sequence length for the context-parallel probe",
    )
    p.add_argument(
        "--flashattn-seq",
        type=int,
        default=_env_int("FLASHATTN_SEQ", 8192),
        help="flash-attention probe sequence length (shrink for CPU/dev)",
    )
    p.add_argument(
        "--flashattn-heads",
        type=int,
        default=_env_int("FLASHATTN_HEADS", 8),
        help="flash-attention probe head count",
    )
    p.add_argument(
        "--membw-min-utilization",
        type=float,
        default=_env_float("MEMBW_MIN_UTILIZATION", 0.5),
        help="fail membw validation below this fraction of spec HBM bandwidth",
    )
    p.add_argument(
        "--membw-size-mb",
        type=int,
        default=_env_int("MEMBW_SIZE_MB", 0),
        help="probe buffer MiB (0 = auto: 2048 on the GPU, tiny on the CPU)",
    )
    p.add_argument(
        "--expect-devices",
        type=int,
        default=_env_int("EXPECT_GPU_DEVICES", 0) or None,
        help="ranks of the multi-device components (default: every card; "
        "one rank on the CPU)",
    )
    p.add_argument(
        "--allow-cpu",
        action="store_true",
        help="dev mode: run the compute components on the CPU when no GPU is visible",
    )
    p.add_argument(
        "--trace-out",
        default=None,
        metavar="PATH",
        help="enable tracing (obs/trace.py) and write the span buffer as Chrome "
        "trace-event JSON (Perfetto-loadable) to PATH when the component ends: "
        "the probes' phases and timed rounds",
    )
    return p


def make_client():
    from tpu_operator_torch.kube.incluster import InClusterClient

    return InClusterClient()


def _client_or_none(log):
    """Sandbox components and the exporter go without the API when no
    in-cluster client can be made (dev runs outside a pod)."""
    try:
        return make_client()
    except Exception:
        log.warning("no in-cluster client; workload-config gate and capacity gauge disabled")
        return None


def main(argv=None) -> int:
    logging.basicConfig(
        level="INFO", format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    log = logging.getLogger("tpu-validator")
    args = build_parser().parse_args(argv)
    if args.trace_out:
        trace.enable()
    try:
        return _run(args, log)
    finally:
        if args.trace_out:
            try:
                n = trace.TRACER.export_chrome(args.trace_out)
                log.info("trace exported: %d span(s) -> %s", n, args.trace_out)
            except OSError:
                log.exception("trace export failed")


def _run(args, log) -> int:
    """The component ``args`` names; 0 when it passed, 1 when it failed."""
    status = StatusFiles(args.output_dir)
    expect_gpu = not args.allow_cpu
    try:
        if args.component == "driver":
            info = comp.validate_driver(
                status,
                driver_root=args.driver_root,
                dev_root=args.dev_root,
                with_wait=args.with_wait,
            )
        elif args.component == "toolkit":
            info = comp.validate_toolkit(
                status, cdi_spec_path=args.cdi_spec, with_wait=args.with_wait
            )
        elif args.component == "plugin":
            info = comp.validate_plugin(
                status,
                make_client(),
                args.node_name,
                with_wait=args.with_wait,
                with_workload=args.with_workload,
                namespace=args.namespace,
            )
        elif args.component == "cuda":
            info = comp.validate_cuda(
                status,
                expect_gpu=expect_gpu,
                size=args.matmul_size,
                client=make_client() if args.with_workload else None,
                node_name=args.node_name,
                namespace=args.namespace,
                with_workload=args.with_workload,
            )
        elif args.component == "slice-workload":
            info = comp.validate_slice_workload(
                status, make_client(), args.node_name, namespace=args.namespace
            )
        elif args.component == "vfio-pci":
            info = comp.validate_vfio_pci(
                status,
                sysfs=args.sysfs,
                client=_client_or_none(log),
                node_name=args.node_name,
            )
        elif args.component == "vm-manager":
            info = comp.validate_vm_manager(
                status,
                client=_client_or_none(log),
                node_name=args.node_name,
                dev_root=args.dev_root,
            )
        elif args.component == "vm-devices":
            info = comp.validate_vm_devices(
                status,
                client=_client_or_none(log),
                node_name=args.node_name,
                dev_root=args.dev_root,
                state_file=args.vm_state_file,
            )
        elif args.component == "nodestatus":
            from tpu_operator_torch.validator.metrics import NodeMetrics

            NodeMetrics(
                client=_client_or_none(log),
                node_name=args.node_name,
                status=status,
                port=args.metrics_port,
                driver_root=args.driver_root,
                dev_root=args.dev_root,
            ).run()
            return 0
        elif args.component == "flashattn":
            info = comp.validate_flashattn(
                status,
                seq=args.flashattn_seq,
                heads=args.flashattn_heads,
                expect_gpu=expect_gpu,
            )
        elif args.component == "membw":
            info = comp.validate_membw(
                status,
                expect_gpu=expect_gpu,
                min_utilization=args.membw_min_utilization,
                size_mb=args.membw_size_mb,
            )
        elif args.component == "slice":
            info = comp.validate_slice(
                status, expect_devices=args.expect_devices, expect_gpu=expect_gpu
            )
        elif args.component == "ici":
            info = comp.validate_ici(
                status, expect_devices=args.expect_devices, expect_gpu=expect_gpu
            )
        elif args.component == "ringattn":
            info = comp.validate_ringattn(
                status,
                expect_devices=args.expect_devices,
                seq_len=args.ringattn_seq_len,
                expect_gpu=expect_gpu,
            )
        elif args.component == "pipeline":
            info = comp.validate_pipeline(
                status, expect_devices=args.expect_devices, expect_gpu=expect_gpu
            )
        else:
            info = comp.validate_moe(
                status, expect_devices=args.expect_devices, expect_gpu=expect_gpu
            )
        log.info("%s validation OK: %s", args.component, json.dumps(info)[:400])
        return 0
    except RuntimeError as e:  # ValidationError, or no GPU without --allow-cpu
        log.error("%s validation FAILED: %s", args.component, e)
        return 1
