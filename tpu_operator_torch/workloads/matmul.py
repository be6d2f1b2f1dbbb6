"""bf16 matmul validation chain — proves the card and measures it.

The counterpart of the JAX package's ``workloads/matmul.py``: a chain of
``depth`` bf16 products with f32 accumulation, each scaled by ``1/size``
and rounded once to bf16, timed as a serial chain (each step feeds the
next) with the fixed launch/sync overhead cancelled (``workloads/timing.py``).
The product is a plain dense GEMM, which the reference left to XLA; here it
goes to ``torch.addmm`` (cuBLAS), whose ``alpha`` applies the scale to the
f32 sum before the one rounding, as the reference's ``(x * (1/size))
.astype(bf16)`` does; no kernel of this package replaces it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_operator_torch.device import device_kind, resolve_device
from tpu_operator_torch.workloads.timing import chain_per_iter_seconds, span
from tpu_operator_torch.workloads.topology import PEAK_BF16_TFLOPS, device_generation


@dataclass
class MatmulResult:
    ok: bool
    device_kind: str
    platform: str
    n_devices: int
    size: int
    iters: int
    elapsed_s: float
    tflops: float
    peak_tflops: Optional[float]
    utilization: Optional[float]
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "device_kind": self.device_kind,
            "platform": self.platform,
            "n_devices": self.n_devices,
            "size": self.size,
            "iters": self.iters,
            "elapsed_s": round(self.elapsed_s, 6),
            "tflops": round(self.tflops, 3),
            "peak_tflops": self.peak_tflops,
            "utilization": round(self.utilization, 4)
            if self.utilization is not None
            else None,
            "error": self.error,
        }


def make_matmul_step(size: int = 4096, depth: int = 8, device=None):
    """Build the validation step: a chain of ``depth`` products with a
    cheap rescale, so one call keeps the tensor cores busy. Returns
    ``(fn, (a, b))`` with ``a`` and ``b`` normal bf16 from seed 0."""
    dev = resolve_device(device)
    scale = 1.0 / size
    # addmm's input, ignored at beta=0
    zeros = torch.zeros((size, size), device=dev, dtype=torch.bfloat16)

    def step(a, b):
        x = a
        for _ in range(depth):
            # bf16 x bf16 with f32 accumulation in cuBLAS, scaled in f32
            # and rounded to bf16 once
            x = torch.addmm(zeros, x, b, beta=0, alpha=scale)
        return x

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=dev, dtype=torch.bfloat16)
    b = torch.randn((size, size), generator=gen, device=dev, dtype=torch.bfloat16)
    return step, (a, b)


def run_matmul_validation(
    size: int = 4096,
    depth: int = 8,
    iters: int = 10,
    device: Optional[str] = None,
) -> MatmulResult:
    """Validate card access and measure achieved TFLOPS on one device.

    Runs on ``cuda`` unless ``device`` says otherwise; without a GPU the
    default raises rather than measuring the CPU."""
    dev = resolve_device(device)
    try:
        # the correctness slice compares with an f32 product: keep TF32 out
        torch.backends.cuda.matmul.allow_tf32 = False
        with span("probe.matmul.inputs", size=size):
            fn, (a, b) = make_matmul_step(size=size, depth=depth, device=dev)
        small = 256
        with span("probe.matmul.check", size=size):
            sa, sb = a[:small, :small], b[:small, :small]
            want = torch.matmul(sa.float(), sb.float())
            got = torch.matmul(sa, sb).float()
            rel = (got - want).abs() / (want.abs() + 1.0)
            if float(rel.mean()) > 0.02:
                raise RuntimeError(f"matmul numerics off: mean rel err {float(rel.mean()):.4f}")

        def force(x):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return float(x.float().sum())

        with span("probe.matmul.chain", size=size):
            per_iter = chain_per_iter_seconds(lambda v: fn(v, b), a, force, iters)
        elapsed = per_iter * iters
        flops = 2.0 * size * size * size * depth * iters
        tflops = flops / elapsed / 1e12
        kind = device_kind(dev)
        gen = device_generation(kind)
        peak = PEAK_BF16_TFLOPS.get(gen) if gen else None
        util = tflops / peak if peak else None
        return MatmulResult(
            ok=True,
            device_kind=kind,
            platform=dev.type,
            n_devices=torch.cuda.device_count() if dev.type == "cuda" else 1,
            size=size,
            iters=iters,
            elapsed_s=elapsed,
            tflops=tflops,
            peak_tflops=peak,
            utilization=util,
        )
    except Exception as e:
        return MatmulResult(
            False, "", "", 0, size, iters, 0.0, 0.0, None, None, error=str(e)
        )
