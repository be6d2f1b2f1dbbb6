"""Flash-attention forward — the hot-op depth probe, as a CUDA kernel.

The counterpart of the JAX package's ``workloads/flashattn.py``: blockwise
attention with ONLINE softmax (running max and denominator in f32 across
K/V blocks, bf16 tiles into the tensor cores) over ``(H, S, 128)`` bf16,
checked against naive full attention in f32. Throughput is reported over
the FLOPs the causal tiling performs (``tflops``) and over the exact causal
triangle (``tflops_effective``).

K3, ``csrc/flash.cu::flash_fwd_bf16``, is the kernel; ``plain_flash`` below
is the same block recurrence in torch ops (f32 ``m``, ``l`` and
accumulator, bf16 ``p`` into PV). ``flash_attention`` takes the plain
version only for CPU tensors; for CUDA tensors it launches K3 or raises.
Only the ``full`` variant is ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_operator_torch import _build
from tpu_operator_torch.device import device_kind, resolve_device
from tpu_operator_torch.workloads.matmul import device_generation
from tpu_operator_torch.workloads.timing import chain_per_iter_seconds
from tpu_operator_torch.workloads.topology import PEAK_BF16_TFLOPS

LANES = 128  # head_dim the kernel takes

# The port's default tile caps. K3 runs block_q/16 warps of 16 query rows
# (at most 8 warps, so block_q <= 128) and streams keys in 64-row sub-tiles
# (block_k a multiple of 64); 128/128 keeps the masked diagonal tail to one
# 128-key block per q-block. The reference's 256/1024 are TPU VMEM tiles.
BLOCK_Q_CAP = 128
BLOCK_K_CAP = 128
KERNEL_KEY_TILE = 64
KERNEL_MAX_BLOCK_Q = 128

PORTED_VARIANTS = ("full",)
REFERENCE_VARIANTS = ("full", "pipelined", "softmax_stub", "qk_only", "bf16exp")


def diag_stop(i, block_q: int, block_k: int):
    """K-blocks a causal q-block ``i`` must process: through the block
    containing its last row. The single source for the loop bound of the
    plain version, the kernel's (``csrc/flash.cu`` computes the same) and
    the FLOPs accounting."""
    return ((i + 1) * block_q + block_k - 1) // block_k


@dataclass
class FlashAttnResult:
    ok: bool
    platform: str = ""
    device_kind: str = ""
    seq: int = 0
    heads: int = 0
    head_dim: int = 0
    causal: bool = True
    max_err: float = 0.0
    tflops: float = 0.0
    tflops_effective: float = 0.0
    elapsed_s: float = 0.0
    error: str = ""

    def to_dict(self):
        return {
            "ok": self.ok,
            "platform": self.platform,
            "device_kind": self.device_kind,
            "seq": self.seq,
            "heads": self.heads,
            "head_dim": self.head_dim,
            "causal": self.causal,
            "max_err": round(self.max_err, 6),
            "tflops": round(self.tflops, 2),
            "tflops_effective": round(self.tflops_effective, 2),
            "elapsed_s": round(self.elapsed_s, 4),
        }


def plain_flash(q, k, v, block_q: int, block_k: int, causal: bool = True):
    """K3's plain version: the flash block recurrence in torch ops, all
    heads at once. Products of bf16 values summed in f32, f32 ``m``/``l``/
    accumulator, ``p`` rounded to bf16 before PV, output ``acc/l`` in bf16."""
    heads, seq, head_dim = q.shape
    scale = 1.0 / (head_dim**0.5)
    n_k = seq // block_k
    out = torch.empty_like(q)
    for i in range(seq // block_q):
        qb = q[:, i * block_q:(i + 1) * block_q].float()
        hi = diag_stop(i, block_q, block_k) if causal else n_k
        n_full = (i * block_q) // block_k if causal else n_k
        m = torch.full((heads, block_q, 1), float("-inf"), device=q.device)
        l = torch.zeros((heads, block_q, 1), device=q.device)
        acc = torch.zeros((heads, block_q, head_dim), device=q.device)
        qpos = i * block_q + torch.arange(block_q, device=q.device)[:, None]
        for j in range(hi):
            kb = k[:, j * block_k:(j + 1) * block_k].float()
            vb = v[:, j * block_k:(j + 1) * block_k].float()
            s = torch.matmul(qb, kb.transpose(1, 2)) * scale
            if j >= n_full:  # only the diagonal tail is masked
                kpos = j * block_k + torch.arange(block_k, device=q.device)[None, :]
                s = s.masked_fill(qpos < kpos, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.bfloat16().float(), vb)
            m = m_new
        out[:, i * block_q:(i + 1) * block_q] = (acc / l).to(q.dtype)
    return out


def _check_qkv(q, k, v, block_q: int, block_k: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.dim() != 3:
            raise ValueError(f"{name} must be (H, S, D) bf16, got {tuple(t.shape)} {t.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError("q, k and v must share shape and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    seq = q.shape[1]
    if seq % block_q or seq % block_k:
        raise ValueError(f"seq={seq} must tile by {block_q}/{block_k}")


def flash_attention(q, k, v, block_q: int, block_k: int, causal: bool = True):
    """K3: attention forward over ``(H, S, 128)`` bf16 on the logical
    ``(block_q, block_k)`` tiling."""
    _check_qkv(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return plain_flash(q, k, v, block_q, block_k, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    heads, seq, head_dim = q.shape
    if head_dim != LANES:
        raise ValueError(f"the kernel takes head_dim {LANES}, got {head_dim}")
    if block_q % 16 or block_q > KERNEL_MAX_BLOCK_Q or block_k % KERNEL_KEY_TILE:
        raise ValueError(
            f"the kernel takes block_q a multiple of 16 up to {KERNEL_MAX_BLOCK_Q} "
            f"and block_k a multiple of {KERNEL_KEY_TILE}, got {block_q}/{block_k}"
        )
    lib = _build.library()
    out = torch.empty_like(q)
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        heads, seq, block_q, block_k, int(causal), _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_fwd")
    _build.count_launch("flash_fwd")
    return out


def make_flash_fn(
    seq: int,
    heads: int,
    head_dim: int = LANES,
    block_q: int = BLOCK_Q_CAP,
    block_k: int = BLOCK_K_CAP,
    causal: bool = True,
    variant: str = "full",
):
    """The flash-attention forward over ``(heads, seq, head_dim)`` bf16
    Q/K/V: ``fn(q, k, v) -> out``. Only ``variant="full"`` is ported."""
    if seq % block_q or seq % block_k:
        raise ValueError(f"seq={seq} must tile by {block_q}/{block_k}")
    if variant not in REFERENCE_VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r}")
    if variant not in PORTED_VARIANTS:
        raise ValueError(f"flash variant {variant!r} is not ported yet")

    def flash(q, k, v):
        if tuple(q.shape) != (heads, seq, head_dim):
            raise ValueError(
                f"flash built for {(heads, seq, head_dim)}, got {tuple(q.shape)}"
            )
        return flash_attention(q, k, v, block_q, block_k, causal)

    return flash


def reference_attention(q, k, v, causal: bool = True):
    """Naive full attention in f32 — the numerics oracle."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("hqd,hkd->hqk", qf, kf) * scale
    if causal:
        seq = q.shape[1]
        mask = torch.tril(torch.ones((seq, seq), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("hqk,hkd->hqd", p, vf)


def causal_flops(seq: int, heads: int, head_dim: int, block_q: int, block_k: int) -> float:
    """Exact FLOPs the causal tiling performs: two bf16 matmuls per
    processed (q-block, k-block) pair, skipped blocks not counted."""
    n_q = seq // block_q
    total_blocks = sum(diag_stop(i, block_q, block_k) for i in range(n_q))
    return 4.0 * heads * total_blocks * block_q * block_k * head_dim


def _default_block(seq: int, cap: int) -> int:
    """Largest divisor of ``seq`` at or below ``cap`` that is a multiple of
    8; with none, ``min(cap, seq)``. So a prime ``seq`` at or below the cap
    gets one whole-seq block, and one above it a block that does not tile,
    which ``make_flash_fn`` refuses."""
    return next(
        (d for d in range(min(cap, seq), 7, -1) if seq % d == 0 and d % 8 == 0),
        min(cap, seq),
    )


def run_flashattn_probe(
    seq: int = 2048,
    heads: int = 8,
    head_dim: int = LANES,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    causal: bool = True,
    iters: int = 64,
    device: Optional[str] = None,
    tol: float = 2e-2,
    variant: str = "full",
) -> FlashAttnResult:
    """Correctness against the f32 oracle, then throughput on the card
    (fixed-overhead-cancelling chain timing, like the matmul and membw
    probes). A rate above 1.05x the card's bf16 peak is a broken
    measurement and fails the probe. On the CPU the plain version checks
    numerics only. On ``cuda`` unless ``device`` says otherwise; without a
    GPU the default raises."""
    dev = resolve_device(device)
    try:
        on_gpu = dev.type == "cuda"
        bq = block_q if block_q is not None else _default_block(seq, BLOCK_Q_CAP)
        bk = block_k if block_k is not None else _default_block(seq, BLOCK_K_CAP)

        gen = torch.Generator(device=dev).manual_seed(11)
        shape = (heads, seq, head_dim)
        q, k, v = (
            torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(3)
        )

        flash = make_flash_fn(seq, heads, head_dim, bq, bk, causal, variant=variant)
        out = flash(q, k, v)
        ref = reference_attention(q, k, v, causal)
        max_err = float((out.float() - ref).abs().max())
        del ref
        if not max_err < tol:
            raise RuntimeError(
                f"flash attention diverged from the oracle: max_err={max_err}"
            )

        flops = (
            causal_flops(seq, heads, head_dim, bq, bk)
            if causal
            else 4.0 * heads * seq * seq * head_dim
        )
        # tiling-INDEPENDENT useful work: the exact causal triangle (each
        # query attends to q+1 keys), no credit for masked-region compute
        flops_effective = (
            4.0 * heads * head_dim * seq * (seq + 1) / 2.0
            if causal
            else 4.0 * heads * seq * seq * head_dim
        )
        if on_gpu:
            # chain through q so iterations can't overlap on the device
            def step(x):
                return flash(x, k, v)

            def force(x):
                torch.cuda.synchronize(dev)
                return float(x[0, 0, :8].float().sum())

            per_iter = chain_per_iter_seconds(step, q, force, iters)
            tflops = flops / per_iter / 1e12
            tflops_effective = flops_effective / per_iter / 1e12
            elapsed = per_iter * iters
            gen_tag = device_generation(device_kind(dev))
            peak = PEAK_BF16_TFLOPS.get(gen_tag) if gen_tag else None
            if peak and tflops > peak * 1.05:
                raise RuntimeError(
                    f"implausible flash-attention rate ({tflops:.0f} TFLOPS "
                    f"vs peak {peak}); timing sync failure — rerun"
                )
        else:
            tflops = 0.0  # plain version on the CPU: numerics only
            tflops_effective = 0.0
            elapsed = 0.0
        return FlashAttnResult(
            ok=True,
            platform=dev.type,
            device_kind=device_kind(dev),
            seq=seq,
            heads=heads,
            head_dim=head_dim,
            causal=causal,
            max_err=max_err,
            tflops=tflops,
            tflops_effective=tflops_effective,
            elapsed_s=elapsed,
        )
    except Exception as e:
        return FlashAttnResult(False, error=str(e))
