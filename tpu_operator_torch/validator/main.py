"""Validator CLI of the port: ``python -m tpu_operator_torch.validator
--component cuda|membw|flashattn|slice|ici|ringattn|pipeline|moe``.

The same flags and environment defaults as the JAX package's
``tpu-validator`` for these components. Exit 0 when the component passed
and wrote its status file, 1 when it failed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from tpu_operator_torch import consts
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.validator.components import StatusFiles

COMPONENTS = ("cuda", "membw", "flashattn", "slice", "ici", "ringattn", "pipeline", "moe")


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
        help="dev mode: run on the CPU when no GPU is visible",
    )
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level="INFO", format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    log = logging.getLogger("tpu-validator")
    args = build_parser().parse_args(argv)
    status = StatusFiles(args.output_dir)
    expect_gpu = not args.allow_cpu
    try:
        if args.component == "cuda":
            info = comp.validate_cuda(
                status, expect_gpu=expect_gpu, size=args.matmul_size
            )
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
