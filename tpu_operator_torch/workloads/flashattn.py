"""Flash-attention forward — the hot-op depth probe, as CUDA kernels.

The counterpart of the JAX package's ``workloads/flashattn.py``: blockwise
attention with ONLINE softmax (running max and denominator in f32 across
K/V blocks, bf16 tiles into the tensor cores) over ``(H, S, 128)`` bf16,
checked against naive full attention in f32. Throughput is reported over
the FLOPs the causal tiling performs (``tflops``) and over the exact causal
triangle (``tflops_effective``).

All five variants of the reference are ported, each to a kernel in
``csrc/flash.cu``: ``full`` (K3), ``pipelined`` (K4, the same function
with the next scores issued before the current softmax), ``bf16exp`` (K5,
``exp`` of a bf16 difference), and the attribution instruments
``softmax_stub`` and ``qk_only`` (K6a, K6b), whose numerics are wrong by
design. All five are instances of one Hopper kernel: K/V stream through a
TMA ring and the products run on ``wgmma``, one warpgroup per 64 query
rows, so they take ``block_q`` 64 or 128; K4 keeps the next scores in
flight on the tensor cores while the current softmax runs. The stubs are
K3's structure minus a phase: K6a without the softmax, K6b also without
PV and V. Each has a plain version below in torch ops that follows the
reference per ``block_k`` block.

Every kernel takes any ``seq`` the reference's probe takes
(``seq % 8 == 0`` or ``seq <= 256``), also where the blocks do not divide
it: the last q-block and k-block are then partial. The kernels fill rows
past ``seq`` with zeros and store no row past it; a causal run needs no
more (every key past ``seq`` lies above a real row's diagonal), a
non-causal one masks the keys past ``seq - 1`` in its last k-block. The
plain versions take the same tiling by clipped slices.
``flash_attention`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the variant's kernel or raises. ``run_flashattn_breakdown``
times the instruments and attributes K3's time to the matmuls, the softmax,
PV and pipelining. All four variants it times share K3's structure, so
each term reads one phase of K3 itself.
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

# The port's default tile caps. K3 runs one warpgroup (wgmma's 64 rows) per
# 64 query rows, at most two, so block_q is 64 or 128, and streams keys in
# 64-row sub-tiles (block_k a multiple of 64); 128/128 keeps the masked
# diagonal tail to one 128-key block per q-block and two warpgroups per
# block. The reference's 256/1024 are TPU VMEM tiles.
BLOCK_Q_CAP = 128
BLOCK_K_CAP = 128
KERNEL_KEY_TILE = 64
WGMMA_BLOCK_Q = (64, 128)  # the Hopper kernel's: whole warpgroups
# the launch counters of the kernels that run on the Hopper kernel: every
# flash kernel
WGMMA_KERNELS = (
    "flash_fwd", "flash_fwd_pipelined", "flash_fwd_bf16exp", "flash_softmax_stub",
    "flash_qk_only", "flash_fwd_paired", "flash_fwd_bf16s", "flash_fwd_paired16",
)
# The reference's probe (``_default_block`` with caps 256/1024) tiles every
# seq that is a multiple of 8, and every seq up to its block cap with one
# whole-seq block; at any other seq it raises its must-tile error.
REFERENCE_WHOLE_SEQ_CAP = 256

REFERENCE_VARIANTS = ("full", "pipelined", "softmax_stub", "qk_only", "bf16exp")
PORTED_VARIANTS = REFERENCE_VARIANTS

# variant -> (launch counter in _build.launches, C entry in csrc/flash.cu)
VARIANT_KERNELS = {
    "full": ("flash_fwd", "flash_fwd_bf16"),
    "pipelined": ("flash_fwd_pipelined", "flash_fwd_pipelined"),
    "bf16exp": ("flash_fwd_bf16exp", "flash_fwd_bf16exp"),
    "softmax_stub": ("flash_softmax_stub", "flash_softmax_stub"),
    "qk_only": ("flash_qk_only", "flash_qk_only"),
}
# the variants the breakdown times, in the reference's order
BREAKDOWN_VARIANTS = ("full", "pipelined", "softmax_stub", "qk_only")
STUB_SCALE = 0.001  # softmax_stub's stand-in for the softmax: p = bf16(s * 0.001)
# The breakdown's microsecond figures keep 5 decimals where the reference
# keeps 3: a (128, 128) pair costs ~0.08 us on an H100, so 3 decimals
# would blur the attribution by several percent.
PAIR_US_DIGITS = 5


def diag_stop(i, block_q: int, block_k: int):
    """K-blocks a causal q-block ``i`` must process: through the block
    containing its last row, as the reference computes it."""
    return ((i + 1) * block_q + block_k - 1) // block_k


def n_blocks(seq: int, block: int) -> int:
    """Blocks of ``block`` rows that cover ``seq``, the last one partial
    where ``block`` does not divide it."""
    return -(-seq // block)


def k_range(i: int, seq: int, block_q: int, block_k: int, causal: bool):
    """``(hi, n_full)`` of q-block ``i``: it processes k-blocks ``[0, hi)``,
    the first ``n_full`` without a mask. Causal: ``diag_stop(i)`` cut at the
    last k-block, and the blocks below the diagonal of the q-block's first
    row; otherwise every k-block, with a partial last one masked. The
    single source for the plain versions' loops, the kernels' (``k_range``
    in ``csrc/flash.cu`` computes the same) and the FLOPs accounting."""
    n_k = n_blocks(seq, block_k)
    if not causal:
        return n_k, seq // block_k
    return min(diag_stop(i, block_q, block_k), n_k), (i * block_q) // block_k


def tiling_ok(seq: int, block_q: int, block_k: int) -> bool:
    """Whether the port takes ``(block_q, block_k)`` at ``seq``: every
    tiling that divides ``seq``, and a partial last q-block and k-block at
    a ``seq`` the reference's probe takes."""
    divides = seq % block_q == 0 and seq % block_k == 0
    return divides or seq % 8 == 0 or seq <= REFERENCE_WHOLE_SEQ_CAP


def check_tiling(seq: int, block_q: int, block_k: int) -> None:
    """``tiling_ok`` or the reference's must-tile ``ValueError``."""
    if not tiling_ok(seq, block_q, block_k):
        raise ValueError(f"seq={seq} must tile by {block_q}/{block_k}")


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
    # the tiling the probe ran; kept out of the payload, whose keys are the
    # reference's
    block_q: int = 0
    block_k: int = 0

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


def plain_flash(
    q, k, v, block_q: int, block_k: int, causal: bool = True, bf16exp: bool = False,
    bf16s: bool = False,
):
    """The plain version of K3 (``full``) and of K4 (``pipelined``, which
    computes the same function; only the kernel's instruction order
    differs): the flash block recurrence in torch ops, all heads at once.
    Products of bf16 values summed in f32, f32 ``m``/``l``/accumulator,
    ``p`` rounded to bf16 before PV, output ``acc/l`` in bf16.

    ``bf16exp=True`` is K5's plain version: ``p = exp(bf16(s - m_new))``
    rounded to bf16 (the difference taken in f32, natural-log units), ``l``
    sums that bf16 ``p`` in f32, and the same ``p`` goes into PV.

    ``bf16s=True`` is the plain version of the structural variants K7b and
    K7c (the reference's ``soft_b``): the scores rounded once,
    ``s_b = bf16(s)`` (bf16 -inf where masked), ``m_new = max(m, f32(rowmax
    s_b))``, ``p = exp(s_b - bf16(m_new))`` in bf16, ``l`` sums that ``p``
    in f32, and the same ``p`` goes into PV.

    Where the blocks do not divide ``seq`` the last q-block and k-block are
    the clipped slices that end at ``seq``, as the kernels' zero-filled
    rows compute them."""
    if bf16exp and bf16s:
        raise ValueError("bf16exp and bf16s are two softmaxes; pick one")
    heads, seq, head_dim = q.shape
    scale = 1.0 / (head_dim**0.5)
    out = torch.empty_like(q)
    for i in range(n_blocks(seq, block_q)):
        qb = q[:, i * block_q:(i + 1) * block_q].float()
        rows = qb.shape[1]  # block_q, or fewer in a partial last q-block
        hi, n_full = k_range(i, seq, block_q, block_k, causal)
        m = torch.full((heads, rows, 1), float("-inf"), device=q.device)
        l = torch.zeros((heads, rows, 1), device=q.device)
        acc = torch.zeros((heads, rows, head_dim), device=q.device)
        qpos = i * block_q + torch.arange(rows, device=q.device)[:, None]
        for j in range(hi):
            kb = k[:, j * block_k:(j + 1) * block_k].float()
            vb = v[:, j * block_k:(j + 1) * block_k].float()
            s = torch.matmul(qb, kb.transpose(1, 2)) * scale
            if bf16s:
                s = s.bfloat16()
            # only the diagonal tail is masked; the slice already ends at
            # seq, so a non-causal partial last block needs no mask
            if causal and j >= n_full:
                kpos = j * block_k + torch.arange(kb.shape[1], device=q.device)[None, :]
                s = s.masked_fill(qpos < kpos, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True).float())
            alpha = torch.exp(m - m_new)
            if bf16exp:
                p = torch.exp((s - m_new).bfloat16().float()).bfloat16().float()
                pv = p
            elif bf16s:
                p = pv = torch.exp(s - m_new.bfloat16()).float()
            else:
                p = torch.exp(s - m_new)
                pv = p.bfloat16().float()
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(pv, vb)
            m = m_new
        out[:, i * block_q:(i + 1) * block_q] = (acc / l).to(q.dtype)
    return out


def _plain_unmasked(q, k, block_q: int, block_k: int, causal: bool, step):
    """The stubs' shared loop: for every k-block ``j < hi``, with NO mask
    (as the reference's stubs run), ``acc = step(acc, s, j)`` with ``s``
    the f32 scores ``q.k^T * scale``; output ``bf16(acc)``, no ``/l``. A
    partial last block is its clipped slice: the kernels' zero keys add
    nothing."""
    heads, seq, head_dim = q.shape
    scale = 1.0 / (head_dim**0.5)
    out = torch.empty_like(q)
    for i in range(n_blocks(seq, block_q)):
        qb = q[:, i * block_q:(i + 1) * block_q].float()
        hi = k_range(i, seq, block_q, block_k, causal)[0]
        acc = torch.zeros((heads, qb.shape[1], head_dim), device=q.device)
        for j in range(hi):
            kb = k[:, j * block_k:(j + 1) * block_k].float()
            acc = step(acc, torch.matmul(qb, kb.transpose(1, 2)) * scale, j)
        out[:, i * block_q:(i + 1) * block_q] = acc.to(q.dtype)
    return out


def plain_softmax_stub(q, k, v, block_q: int, block_k: int, causal: bool = True):
    """K6a's plain version: both matmuls, the softmax replaced by a cast,
    ``acc += bf16((q.k^T * scale) * 0.001) . v`` over every ``j < hi``."""

    def step(acc, s, j):
        vb = v[:, j * block_k:(j + 1) * block_k].float()
        return acc + torch.matmul((s * STUB_SCALE).bfloat16().float(), vb)

    return _plain_unmasked(q, k, block_q, block_k, causal, step)


def plain_qk_only(q, k, block_q: int, block_k: int, causal: bool = True):
    """K6b's plain version: QK^T alone, ``acc += (q.k^T * scale)[:, :D]``
    (the first ``head_dim`` keys of each block, so ``block_k >= head_dim``)
    over every ``j < hi``; V is never read."""
    head_dim = q.shape[-1]

    def step(acc, s, j):
        first = s[..., :head_dim]  # a partial last block may hold fewer keys
        return acc + torch.nn.functional.pad(first, (0, head_dim - first.shape[-1]))

    return _plain_unmasked(q, k, block_q, block_k, causal, step)


def _check_qkv(q, k, v, block_q: int, block_k: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.dim() != 3:
            raise ValueError(f"{name} must be (H, S, D) bf16, got {tuple(t.shape)} {t.dtype}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError("q, k and v must share shape and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_tiling(q.shape[1], block_q, block_k)


def plain_variant(q, k, v, block_q: int, block_k: int, causal: bool, variant: str):
    """``variant``'s plain version (``qk_only`` ignores ``v``)."""
    if variant == "softmax_stub":
        return plain_softmax_stub(q, k, v, block_q, block_k, causal)
    if variant == "qk_only":
        return plain_qk_only(q, k, block_q, block_k, causal)
    return plain_flash(q, k, v, block_q, block_k, causal, bf16exp=variant == "bf16exp")


def flash_attention(
    q, k, v, block_q: int, block_k: int, causal: bool = True, variant: str = "full"
):
    """Attention forward over ``(H, S, 128)`` bf16 on the logical
    ``(block_q, block_k)`` tiling, by ``variant``'s kernel (K3-K6b)."""
    if variant not in VARIANT_KERNELS:
        raise ValueError(f"unknown flash variant {variant!r}")
    _check_qkv(q, k, v, block_q, block_k)
    if variant == "qk_only" and block_k < q.shape[-1]:
        raise ValueError(f"qk_only takes block_k >= head_dim, got {block_k}")
    if q.device.type == "cpu":
        return plain_variant(q, k, v, block_q, block_k, causal, variant)
    name, entry = VARIANT_KERNELS[variant]
    inputs = (q, k) if variant == "qk_only" else (q, k, v)  # qk_only never reads V
    return _launch(name, entry, inputs, block_q, block_k, causal)


def check_kernel_tiling(name: str, block_q: int, block_k: int) -> None:
    """Raise ``ValueError`` unless the kernel counted as ``name`` takes
    ``(block_q, block_k)`` on the card: every flash kernel runs on the
    Hopper kernel (``WGMMA_KERNELS``), which takes ``block_q`` 64 or 128
    and ``block_k`` a multiple of 64. ``_launch`` calls it before any CUDA
    call."""
    if block_q not in WGMMA_BLOCK_Q or block_k <= 0 or block_k % KERNEL_KEY_TILE:
        raise ValueError(
            f"{name} takes block_q 64 or 128 and block_k a multiple of {KERNEL_KEY_TILE}, "
            f"got {block_q}/{block_k}"
        )


def _launch(name: str, entry: str, inputs, block_q: int, block_k: int, causal: bool):
    """Launch the flash kernel ``entry`` of ``csrc/flash.cu`` on CUDA
    inputs ``(q, k[, v])`` already checked by ``_check_qkv``, count one
    launch of ``name``, return the output; raises on a shape the kernel
    does not take and on any CUDA error."""
    q = inputs[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    heads, seq, head_dim = q.shape
    if head_dim != LANES:
        raise ValueError(f"the kernel takes head_dim {LANES}, got {head_dim}")
    check_kernel_tiling(name, block_q, block_k)
    lib = _build.library()
    out = torch.empty_like(q)
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in (*inputs, out)),
        heads, seq, block_q, block_k, int(causal), _build.stream_ptr(q),
    )
    _build.check(lib, err, name)
    _build.count_launch(name)
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
    Q/K/V: ``fn(q, k, v) -> out``, by any of the reference's five variants
    (``qk_only`` takes ``v`` and never reads it). ``check_tiling`` says
    which ``seq`` the blocks may leave a partial last block at."""
    check_tiling(seq, block_q, block_k)
    if variant not in REFERENCE_VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r}")

    def flash(q, k, v):
        if tuple(q.shape) != (heads, seq, head_dim):
            raise ValueError(
                f"flash built for {(heads, seq, head_dim)}, got {tuple(q.shape)}"
            )
        return flash_attention(q, k, v, block_q, block_k, causal, variant)

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


def causal_pairs(seq: int, block_q: int, block_k: int) -> int:
    """(q-block, k-block) pairs a causal run of one head processes."""
    return sum(k_range(i, seq, block_q, block_k, True)[0] for i in range(n_blocks(seq, block_q)))


def causal_flops(seq: int, heads: int, head_dim: int, block_q: int, block_k: int) -> float:
    """Exact FLOPs the causal tiling performs: two bf16 matmuls per
    processed (q-block, k-block) pair, whole blocks (a partial one's zero
    rows included, as the kernels compute them), skipped blocks not
    counted."""
    return 4.0 * heads * causal_pairs(seq, block_q, block_k) * block_q * block_k * head_dim


def _default_block(seq: int, cap: int) -> int:
    """The reference's rule, which the CPU path keeps: the largest divisor
    of ``seq`` at or below ``cap`` that is a multiple of 8; with none,
    ``min(cap, seq)``. So a prime ``seq`` at or below the cap
    gets one whole-seq block, and one above it a block that does not tile,
    which ``make_flash_fn`` refuses."""
    return next(
        (d for d in range(min(cap, seq), 7, -1) if seq % d == 0 and d % 8 == 0),
        min(cap, seq),
    )


def card_blocks(seq: int) -> tuple[int, int]:
    """The default ``(block_q, block_k)`` on the card, which every kernel
    takes (``check_kernel_tiling``). At a multiple of 64: the largest
    ``block_q`` of ``WGMMA_BLOCK_Q`` and the largest multiple of 64 at most
    ``BLOCK_K_CAP`` that divide ``seq`` (the reference's rule,
    ``_default_block``, may pick blocks the kernels refuse, 104/104 at seq
    4160). At any other ``seq`` the reference takes: 128/128, or 64/64
    below seq 128, with a partial last block. So on ``cuda`` the probe and
    the breakdown take this one. Elsewhere it raises the reference's
    must-tile ``ValueError``."""
    if seq % KERNEL_KEY_TILE:
        blocks = (BLOCK_Q_CAP, BLOCK_K_CAP) if seq >= BLOCK_Q_CAP else (64, 64)
        check_tiling(seq, *blocks)
        return blocks
    bq = next(b for b in sorted(WGMMA_BLOCK_Q, reverse=True) if seq % b == 0)
    bk = next(b for b in range(BLOCK_K_CAP - BLOCK_K_CAP % KERNEL_KEY_TILE, 0,
                               -KERNEL_KEY_TILE) if seq % b == 0)
    return bq, bk


def default_blocks(seq: int, device: torch.device, block_q=None, block_k=None):
    """``(block_q, block_k)``: each given one as it is, the others by
    ``card_blocks`` on ``cuda`` and by the reference's ``_default_block``
    elsewhere."""
    if block_q is not None and block_k is not None:
        return block_q, block_k
    if device.type == "cuda":
        dq, dk = card_blocks(seq)
    else:
        dq, dk = _default_block(seq, BLOCK_Q_CAP), _default_block(seq, BLOCK_K_CAP)
    return (dq if block_q is None else block_q), (dk if block_k is None else block_k)


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
    GPU the default raises. Blocks not given are ``default_blocks``'s."""
    dev = resolve_device(device)
    try:
        on_gpu = dev.type == "cuda"
        bq, bk = default_blocks(seq, dev, block_q, block_k)

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
            block_q=bq,
            block_k=bk,
        )
    except Exception as e:
        return FlashAttnResult(False, error=str(e))


def _pick_reading(readings, flops: float, peak: Optional[float]):
    """``(per_iter_seconds, implausible)`` from a variant's readings, as
    the reference picks them: the fastest reading whose rate stays within
    1.05x the card's bf16 peak; when none does, the SLOWEST reading (the
    fastest is the most corrupted by a timing-sync failure) and
    ``implausible`` True. With no known peak every reading is plausible."""
    sane = [r for r in readings if peak is None or flops / r / 1e12 <= peak * 1.05]
    return (min(sane), False) if sane else (max(readings), True)


def _attribution(variants: dict) -> dict:
    """One block pair's cost split, in microseconds, from the variants'
    ``per_pair_us`` (the reference's formulas)."""
    t_full = variants["full"]["per_pair_us"]
    t_pipe = variants["pipelined"]["per_pair_us"]
    t_stub = variants["softmax_stub"]["per_pair_us"]
    t_qk = variants["qk_only"]["per_pair_us"]
    return {
        # both matmuls and the K/V streaming, no softmax
        "matmuls_us": t_stub,
        # what the online softmax adds on top of the matmuls, serialized
        "softmax_added_us": round(t_full - t_stub, PAIR_US_DIGITS),
        "softmax_fraction_of_full": round(max(0.0, t_full - t_stub) / t_full, 4),
        # the second matmul's (and V's streaming) cost over QK^T alone
        "pv_added_us": round(t_stub - t_qk, PAIR_US_DIGITS),
        # what issuing the next scores before the softmax recovers
        "pipeline_recovered_us": round(t_full - t_pipe, PAIR_US_DIGITS),
    }


def run_flashattn_breakdown(
    seq: int = 8192,
    heads: int = 8,
    head_dim: int = LANES,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    iters: int = 32,
    device: Optional[str] = None,
) -> dict:
    """Measured phase attribution of K3's time: time ``full``,
    ``pipelined``, ``softmax_stub`` and ``qk_only`` at one causal shape
    and split one block pair's cost into the matmuls, the softmax, PV and
    what pipelining recovers (``_attribution``). All four run on K3's
    Hopper structure (the stubs on its body, ring depth and warpgroups,
    each minus one phase), so ``softmax_added_us`` (K3 - K6a) is the
    softmax's cost in K3 and ``pv_added_us`` (K6a - K6b) that of PV and
    V's streaming.

    Each variant's ``tflops`` is over the work IT does (``qk_only`` does
    half the matmul FLOPs); ``per_pair_us``, microseconds per processed
    (q-block, k-block) pair, compares across variants. Each reading is the
    best of 2 with up to 2 more against the plausibility limit
    (``_pick_reading``). On ``cuda`` unless ``device`` says otherwise;
    without a GPU the default raises, and ``device="cpu"`` returns
    ``{"ok": False}``: there is nothing to time there. Blocks not given
    are ``default_blocks``'s."""
    dev = resolve_device(device)
    bq, bk = default_blocks(seq, dev, block_q, block_k)
    out = {"ok": False, "seq": seq, "heads": heads, "block_q": bq, "block_k": bk}
    if dev.type != "cuda":
        out["error"] = "breakdown requires the GPU"
        return out

    gen = torch.Generator(device=dev).manual_seed(13)
    shape = (heads, seq, head_dim)
    q, k, v = (
        torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        for _ in range(3)
    )
    pairs = heads * causal_pairs(seq, bq, bk)
    flops_full = causal_flops(seq, heads, head_dim, bq, bk)
    gen_tag = device_generation(device_kind(dev))
    peak = PEAK_BF16_TFLOPS.get(gen_tag) if gen_tag else None

    def force(x):
        torch.cuda.synchronize(dev)
        return float(x[0, 0, :8].float().sum())

    variants = {}
    for name in BREAKDOWN_VARIANTS:
        fn = make_flash_fn(seq, heads, head_dim, bq, bk, causal=True, variant=name)

        def step(x, fn=fn):
            return fn(x, k, v)

        flops = flops_full / 2 if name == "qk_only" else flops_full
        readings = [chain_per_iter_seconds(step, q, force, iters) for _ in range(2)]
        while True:
            per_iter, implausible = _pick_reading(readings, flops, peak)
            if not implausible or len(readings) >= 4:
                break
            readings.append(chain_per_iter_seconds(step, q, force, iters))
        variants[name] = {
            "tflops": round(flops / per_iter / 1e12, 1),
            "per_pair_us": round(per_iter / pairs * 1e6, PAIR_US_DIGITS),
            "per_iter_ms": round(per_iter * 1e3, 3),
            **({"implausible": True} if implausible else {}),
        }
    out["variants"] = variants
    out["attribution"] = _attribution(variants)
    out["measurement_clean"] = not any(v.get("implausible") for v in variants.values())
    out["ok"] = True
    return out


if __name__ == "__main__":
    # python -m tpu_operator_torch.workloads.flashattn [repeats]: the card's
    # name, then the breakdown at the bench's shape as one JSON line per repeat
    import json
    import sys

    print(device_kind(resolve_device()), flush=True)
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 1):
        print(json.dumps(run_flashattn_breakdown()), flush=True)
