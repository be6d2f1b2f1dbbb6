"""Validator components of the port's compute chain.

Each component checks one layer on the card and drops a status file into
the validation directory, the host-local barrier the operand DaemonSets
wait on. Payloads keep the JAX package's flat schema: ``tflops`` and
``gbps`` at the top level.

  cuda      → bf16 matmul chain in-process, with TFLOPS (``cuda-ready``)
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

import json
import logging
import os
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.device import available_device

log = logging.getLogger("tpu-validator")


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

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))


def _device(expect_gpu: bool) -> Optional[str]:
    # None asks the workload for cuda and makes it raise without a GPU
    return None if expect_gpu else available_device()


def validate_cuda(status: StatusFiles, expect_gpu: bool = True, size: int = 4096) -> dict:
    """End-to-end card proof: the matmul chain runs in-process and the
    status file records achieved TFLOPS."""
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

    if size_mb <= 0:
        # the CPU path only checks semantics: keep its buffer tiny
        size_mb = 2048 if expect_gpu else 8
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
