#!/usr/bin/env python3
"""Drive the PyTorch port's compute chain on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one H100 and the
CUDA toolkit (``nvcc``). Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), torch and nvcc
   versions, build the kernels from ``tpu_operator_torch/csrc`` (ptxas's
   registers and spills printed; a ``wgmma`` serialization note, C7515 or
   C7519, fails), and count ``HGMMA``, ``UTMALDG`` and ``HMMA`` in the SASS
   of each of the eight instances of the Hopper kernel, K3, K4, K5, K6a,
   K6b, K7a, K7b and K7c (``cuobjdump``; a missing instance, no HGMMA or
   UTMALDG, any HMMA in any function of the library, or a ``MUFU.EX2`` in
   K6a or K6b, whose softmax is gone, fails);
2. first, under a watchdog of ``PARTIAL_TILE_TIMEOUT_S`` (a wrong TMA
   transaction count on a box that reaches past seq would hang a kernel),
   every flash kernel at ``PARTIAL_TILE_SHAPES``, seqs its blocks do not
   divide, against its plain version at the same tiling (K6b only where
   ``block_k`` >= 128, the structural modes only causal), with the bit
   identities K4 == K3, K7a == K3 and K7c == K7b; then hold each kernel
   against its plain PyTorch version on the card (the
   copies bit-exact, and K1's tried Hopper design, ``tiled_copy_tma``,
   timed beside K1; flash attention K3 and the variants K4 ``pipelined``
   and K5 ``bf16exp`` within 1e-2 of their plain versions and within 2e-2
   of the f32 oracle, also at the edges of the Hopper kernel
   (``K3_EDGE_SHAPES``) and, for K4 and K5, at 1 x 512 with 64/64 blocks,
   where some q-blocks have an odd number (3, 5, 7) of unmasked
   sub-tiles, K4 equal to K3 bit for bit at every shape; the
   instruments K6a ``softmax_stub`` within 1e-2 and K6b ``qk_only``
   within one bf16 ulp of theirs, also at those edges, K6b where
   ``block_k`` >= 128), check that all eight Hopper instances refuse
   ``block_q`` 32 with ``ValueError`` and launch nothing and that the host
   cost per call of each stays within ``K3_HOST_LIMIT_US`` of a launch that
   encodes no tensor map (K1 on a small buffer), and time kernel, plain
   version and one library call at the main path's shapes;
3. hold one step of the matmul chain at size 1000, where ``1/size`` is no
   power of two, against the host's f32 product, scaled and then rounded
   to bf16 once (each element within one bf16 ulp and the f32 sum's
   reordering, at most ``MATMUL_MISS_SHARE`` of them off); run the main path in-process at its
   full operating points (matmul 8192, membw 2 GiB, flash attention 8192 x
   8 heads) with the launch counts set to 0 just before and read just
   after; then, each counted apart, the
   flash probe with the card's default blocks at seq 4160, which must run
   64/64, and at seq 8200, which must run 128/128 with a partial last
   block, each launching K3 and passing the oracle;
3b. run the flash-attention attribution path the same way: the bench's
   ``run_flashattn_breakdown(seq=8192, heads=8, iters=16)`` and the
   ``bf16exp`` probe at 8192 x 8 heads, each of K3-K6b launched; then,
   counted apart, ``fa_variant_check`` (K3 against K4, each launched, its
   median ratio and IQR logged, no limit);
3c. the structural-variant path: hold K7a ``paired``, K7b ``bf16s`` and
   K7c ``paired16`` against their plain versions (within 1e-2, and nearer
   in mean-abs to their own softmax's plain version than to the other's;
   K7b and K7c never equal to K3) and the f32 oracle (2e-2) at the
   variants' causal shapes, at the causal edges of the Hopper kernel, at
   1 x 512 with 64/64 blocks and at 8 x 8192, K7a equal to K3 and K7c
   equal to K7b bit for bit; then, with the launch counts set to 0 just
   before and read
   just after, run ``run_experiment`` with all three modes at 8192 x 8
   heads, each of K7a-c launched; then time K7a-c;
5. (after 3c, before 4) the multi-device path on every card
   (``torch.cuda.device_count()`` ranks, NCCL, one process a card):
   ``run_burnin`` (10 steps), ``run_ring_probe``, ``run_ringattn``,
   ``run_pipeline`` and ``run_moe`` at the validator's full widths, each
   of which must be ``ok``, in one JSON line with each result and its wall
   time, then the burn-in's seconds a step, the card's name and power
   limit and ``entry.dryrun_multichip``; this path launches none of
   K1-K7c;
4. run the validator CLI for the same three components and the five
   multi-device ones as subprocesses, each writing its status file into a
   temporary directory.

Then it prints one ``kernels`` JSON line, each kernel's launches read from
the path that runs it (K1-K3 phase 3, K4-K6b phase 3b, K7a-c phase 3c).

The last line of standard output is one JSON object naming the device.
Without a CUDA device, or without the ``tpu_operator_torch`` package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

COPY_REPLACES = "tpu_operator/workloads/membw.py"
FLASH_FILE = "tpu_operator/workloads/flashattn.py"
FLASH_REPLACES = f"{FLASH_FILE}:112"
FLASH_TOL_PLAIN = 1e-2  # same function, f32 sums in another order, p rounded per sub-tile
FLASH_TOL_ORACLE = 2e-2  # the reference's oracle tolerance
# (heads, seq, block_q, block_k, causal) where the blocks do not divide seq:
# a partial last q-block whose second warpgroup lies wholly past seq, and a
# k-block cut at seq (520 at 128/128); a single partial q-block and k-block
# (72 at 64/64; 100 at 64/64, a seq the reference tiles 100/100); no mask
# but the last k-block's bound (200 at 64/128)
PARTIAL_TILE_SHAPES = [
    (2, 520, 128, 128, True),
    (1, 72, 64, 64, True),
    (2, 200, 64, 128, False),
    (1, 100, 64, 64, True),
]
# seconds the partial-tile checks may take before the watchdog ends the run
PARTIAL_TILE_TIMEOUT_S = 120

# (heads, seq, block_q, block_k, causal): the CPU tests' shapes
FLASH_TEST_SHAPES = [
    (2, 256, 128, 128, True),
    (2, 256, 128, 128, False),
    (1, 512, 128, 256, True),
]
# K3's Hopper kernel at its edges: one warpgroup and a q-block with a
# single sub-tile (64/64), one warpgroup (64/128), eight sub-tiles per
# k-block so the ring wraps inside a block (128/512), and no mask
K3_EDGE_SHAPES = [
    (1, 128, 64, 64, True),
    (2, 256, 64, 128, True),
    (2, 1024, 128, 512, True),
    (2, 1024, 128, 128, False),
]
WGMMA_KERNEL = "flash_fwd_wgmma_kernel"  # the Hopper kernel's __global__ in csrc/flash.cu
# its instances by (Step, Body) as the mangled name spells them:
# flash_fwd_wgmma_kernel<Step, Body, int STAGES> gives ...LNS_4StepE<s>ELNS_4BodyE<b>E...,
# Step::kFull = 0, kBf16Exp = 1, kStub = 2, kQkOnly = 3, kBf16S = 4; Body::kOne = 0,
# kPair = 1, kPipe = 2
WGMMA_INSTANCES = {
    ("0", "0"): "K3", ("0", "1"): "K7a", ("0", "2"): "K4", ("1", "0"): "K5", ("2", "0"): "K6a",
    ("3", "0"): "K6b", ("4", "0"): "K7b", ("4", "1"): "K7c",
}
# the stubs, whose SASS must hold no exp: their softmax is gone
NO_SOFTMAX = ("K6a", "K6b")
WGMMA_NAME_ARGS = re.compile(r"StepE(\d+)E.*?BodyE(\d+)E")
# the softmax's instruction mix, logged per instance (static counts in its
# SASS, every copy of the loop body): exp, f32->bf16x2 packs, f32 and
# packed bf16 max, packed bf16 fma
SOFTMAX_OPS = ("MUFU.EX2", "F2FP", "FMNMX", "HMNMX2", "HFMA2")
# host microseconds a call of the Hopper kernel may spend beyond a launch
# that encodes no tensor map (K1 on a small buffer), its tensor maps: 5% of
# K3's ~0.39 ms at the main path's shape, where the host would start to set
# the pace of a chain of launches
K3_HOST_LIMIT_US = 20.0
# the variants' shapes: the reference's seq-1024 test at the port's blocks
VARIANT_TEST_SHAPES = FLASH_TEST_SHAPES + [
    (2, 1024, 128, 128, True),
    (2, 1024, 128, 256, True),
]
# (variant, kernel, line of the TPU kernel it replaces), on the attribution path
VARIANTS = [
    ("pipelined", "flash_fwd_pipelined", 209),
    ("bf16exp", "flash_fwd_bf16exp", 153),
    ("softmax_stub", "flash_softmax_stub", 192),
    ("qk_only", "flash_qk_only", 181),
]
ATTRIBUTION_KERNELS = ["flash_fwd"] + [name for _, name, _ in VARIANTS]
EXPERIMENT_FILE = "scripts/fa_experiment.py"
# (mode, kernel, line of the mode's branch of build(), the TPU kernel it
# replaces), on the structural-variant path
MODES = [
    ("paired", "flash_fwd_paired", 90),
    ("bf16s", "flash_fwd_bf16s", 109),
    ("paired16", "flash_fwd_paired16", 69),
]
# 1 x 512 at 64/64: q-block i has i unmasked sub-tiles, so the odd counts
# 3, 5 and 7 leave K7a and K7c one to run alone and K4 its loop's second
# exit (the drain's S carried in from the last pipelined step)
ODD_UNMASKED_SHAPE = (1, 512, 64, 64, True)
# the variants' causal shapes, the odd-count shape, and the causal edges
# of the Hopper kernel, among them 128/512, where the ring wraps inside a
# k-block
STRUCTURAL_TEST_SHAPES = [s for s in VARIANT_TEST_SHAPES if s[4]] + [
    ODD_UNMASKED_SHAPE,
] + [s for s in K3_EDGE_SHAPES if s[4]]
# where the attribution variants K4-K6b also run (K6b where block_k >= 128)
HOPPER_VARIANT_SHAPES = K3_EDGE_SHAPES + [ODD_UNMASKED_SHAPE]
# (seq, the card's default blocks there) of the probes counted apart from
# the main path: 4160, which the reference's block rule tiles 104/104 and
# no kernel takes; 8200 (8192 + 8), which 128 does not divide
PROBE_EDGES = [(4160, (64, 64)), (8200, (128, 128))]
BF16_ULP = 2.0**-7  # bf16 keeps 8 significant bits: one ulp is at most 2^-7 of |x|
# the matmul step against the host's product: a sum in another order lands
# on the other side of a bf16 rounding boundary at a few elements; rounding
# the sum before the scale as well moves most of them (70% on the CPU)
MATMUL_CHECK_SIZE = 1000
MATMUL_MISS_SHARE = 0.01
CLI_CHAIN = [
    ("cuda", ["--matmul-size", "8192"], "cuda-ready"),
    ("membw", ["--membw-size-mb", "2048"], "membw-ready"),
    ("flashattn", ["--flashattn-seq", "8192", "--flashattn-heads", "8"], "flashattn-ready"),
]
# the multi-device components at their defaults: every card, full widths
MULTIDEVICE_CLI = [
    ("slice", [], "slice-ready"),
    ("ici", [], "ici-ready"),
    ("ringattn", [], "ringattn-ready"),
    ("pipeline", [], "pipeline-ready"),
    ("moe", [], "moe-ready"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    from CUDA events."""
    from tpu_operator_torch.workloads.timing import event_ms

    return event_ms(fn, reps, warmup)


def phase_setup():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from tpu_operator_torch import _build

    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60
    )
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    _build.library()
    info = _build.build_info
    log(f"kernels built={info['built']} in {info['seconds']:.1f} s: {info['path']}")
    ptxas = os.path.join(os.path.dirname(info["path"]), "ptxas.log")
    serialized = []
    if os.path.exists(ptxas):
        with open(ptxas) as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "Compiling", "wgmma", "C75")):
                    log("  ptxas " + line.strip())
                # C7515 serializes a wgmma chain; C7519 injects a
                # warpgroup.arrive where a register in use by one is touched
                if "(C7515)" in line or "(C7519)" in line or (
                        "wgmma" in line and "serializ" in line):
                    serialized.append(line.strip())
    if serialized:
        raise RuntimeError(f"ptxas serialized wgmma: {serialized}")
    wgmma_sass()


def peaks():
    from tpu_operator_torch.workloads.matmul import device_generation
    from tpu_operator_torch.workloads.topology import PEAK_BF16_TFLOPS, PEAK_HBM_GBPS

    gen = device_generation(torch.cuda.get_device_name(0))
    if gen is None:
        log("unknown card: bounds use the H100 SXM datasheet rates")
        gen = "h100-sxm"
    return PEAK_BF16_TFLOPS[gen] * 1e12, PEAK_HBM_GBPS[gen] * 1e9


def check_partial_tiles(fa, qkv) -> dict:
    """Every flash kernel at PARTIAL_TILE_SHAPES against its plain version
    (check_variant, check_modes), under a watchdog that ends the run with
    a traceback after PARTIAL_TILE_TIMEOUT_S; returns each kernel's worst
    |kernel - plain| by launch counter."""
    from tpu_operator_torch.workloads import fa_experiment as fx

    worst = {}
    faulthandler.dump_traceback_later(PARTIAL_TILE_TIMEOUT_S, exit=True)
    try:
        for h, s, bq, bk, causal in PARTIAL_TILE_SHAPES:
            q, k, v = qkv(h, s)
            variants = ["full", "pipelined", "bf16exp", "softmax_stub"]
            if bk >= fa.LANES:
                variants.append("qk_only")
            errs = {fa.VARIANT_KERNELS[variant][0]: check_variant(fa, variant, q, k, v, bq, bk,
                                                                  causal)
                    for variant in variants}
            if causal:
                errs.update((fx.MODE_KERNELS[mode], err)
                            for mode, err in check_modes(fa, fx, q, k, v, bq, bk).items())
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0.0), err)
        torch.cuda.synchronize()
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"partial tiles: every flash kernel within its tolerance at {PARTIAL_TILE_SHAPES}")
    return worst


def phase_kernels() -> tuple:
    from tpu_operator_torch.workloads import flashattn as fa
    from tpu_operator_torch.workloads import membw as mb

    dev = torch.device("cuda")
    peak_flops, peak_bytes = peaks()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = mb.probe_rows(2048)
    kernels = []

    # K1 and K2: bit-exact at a small shape and at the probe's 2 GiB
    small = torch.arange(8 * mb.LANES, device=dev, dtype=torch.float32).reshape(8, mb.LANES)
    big = torch.randn((rows, mb.LANES), generator=gen, device=dev, dtype=torch.float32)
    dst = torch.empty_like(big)

    def bit_exact(name, wrapper) -> float:
        err = 0.0
        for x in (small, big):
            got, plain = wrapper(x), mb.plain_copy(x)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise RuntimeError(f"{name} is not bit-exact at {tuple(x.shape)}")
            err = max(err, float((got - plain).abs().max()))
            del got, plain
        return err

    for name, wrapper, line in (
        ("tiled_copy", mb.tiled_copy, 86),
        ("bulk_copy", mb.bulk_copy, 116),
    ):
        err = bit_exact(name, wrapper)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_operator_torch/csrc/copy.cu",
            "replaces": f"{COPY_REPLACES}:{line}",
            "shape": list(big.shape),
            "max_abs_err": err,
            "ms": time_ms(lambda: wrapper(big), 20),
            "plain_ms": time_ms(lambda: mb.plain_copy(big), 20),
            "bound_ms": 2.0 * big.numel() * 4 / peak_bytes * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(lambda: dst.copy_(big), 20),
        })
        log(f"{name}: bit-exact at (8, {mb.LANES}) and {tuple(big.shape)}")
    # K1's tried Hopper design (TMA ring, persistent grid), on no path:
    # checked as K1 is and timed beside it in this run
    bit_exact("tiled_copy_tma", mb.tiled_copy_tma)
    k1 = kernels[0]
    log(f"K1's tried Hopper design (tiled_copy_tma): bit-exact, "
        f"{time_ms(lambda: mb.tiled_copy_tma(big), 20):.4f} ms against K1 {k1['ms']:.4f}, "
        f"Tensor.copy_ {k1['library_ms']:.4f}, bound {k1['bound_ms']:.4f}")
    del big, small, dst
    torch.cuda.empty_cache()

    def qkv(heads, seq):
        return [
            torch.randn((heads, seq, fa.LANES), generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for _ in range(3)
        ]

    partial = check_partial_tiles(fa, qkv)
    torch.cuda.empty_cache()
    # K3: the CPU tests' shapes, then the probe's shape
    heads, seq = 8, 8192
    bq, bk = fa.card_blocks(seq)
    worst = 0.0
    for h, s, bq_, bk_, causal in FLASH_TEST_SHAPES + K3_EDGE_SHAPES + [(heads, seq, bq, bk, True)]:
        q, k, v = qkv(h, s)
        got = fa.flash_attention(q, k, v, bq_, bk_, causal).float()
        plain = fa.plain_flash(q, k, v, bq_, bk_, causal).float()
        ref = fa.reference_attention(q, k, v, causal)
        err_plain = float((got - plain).abs().max())
        err_ref = float((got - ref).abs().max())
        plain_ref = float((plain - ref).abs().max())
        log(f"flash_fwd H={h} S={s} {bq_}/{bk_} causal={causal}: "
            f"|kernel-plain|={err_plain:.3e} |kernel-oracle|={err_ref:.3e} "
            f"|plain-oracle|={plain_ref:.3e}")
        if not torch.isfinite(got).all():
            raise RuntimeError("flash_fwd produced non-finite values")
        if not (err_plain <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE):
            raise RuntimeError(f"flash_fwd disagrees at H={h} S={s} causal={causal}")
        worst = max(worst, err_plain)
        del got, plain, ref
    torch.cuda.empty_cache()
    wgmma_refuse_block_q_32(fa, q, k, v)
    wgmma_host_cost(fa, mb, qkv)
    useful = 4.0 * heads * fa.LANES * seq * (seq + 1) / 2.0
    io_bytes = 4.0 * heads * seq * fa.LANES * 2
    bound_flops, bound_io = useful / peak_flops, io_bytes / peak_bytes
    kernels.append({
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_operator_torch/csrc/flash.cu",
        "replaces": FLASH_REPLACES,
        "shape": [heads, seq, fa.LANES, bq, bk],
        "max_abs_err": worst,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, bq, bk, True), 20),
        "plain_ms": time_ms(lambda: fa.plain_flash(q, k, v, bq, bk, True), 2, warmup=1),
        "bound_ms": max(bound_flops, bound_io) * 1e3,
        "bound_by": "operations" if bound_flops >= bound_io else "bytes",
        # (1, H, S, D): a batch dimension lets PyTorch pick its fused kernel
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), 20),
    })
    del q, k, v
    torch.cuda.empty_cache()
    kernels += variant_rows(fa, qkv, peak_flops, peak_bytes)
    for row in kernels:
        row["max_abs_err"] = max(row["max_abs_err"], partial.get(row["name"], 0.0))
    return kernels, partial


def wgmma_callers(fa):
    """(label, launch counter, fn(q, k, v, block_q, block_k)) of the eight
    kernels that run on the Hopper kernel, through their wrappers."""
    from tpu_operator_torch.workloads import fa_experiment as fx

    def variant(name):
        return lambda q, k, v, bq, bk: fa.flash_attention(q, k, v, bq, bk, True, name)

    def mode(name):
        return lambda q, k, v, bq, bk: fx.experiment_flash(q, k, v, bq, bk, name)

    return [
        ("K3", "flash_fwd", variant("full")),
        ("K4", "flash_fwd_pipelined", variant("pipelined")),
        ("K5", "flash_fwd_bf16exp", variant("bf16exp")),
        ("K6a", "flash_softmax_stub", variant("softmax_stub")),
        ("K6b", "flash_qk_only", variant("qk_only")),
        ("K7a", "flash_fwd_paired", mode("paired")),
        ("K7b", "flash_fwd_bf16s", mode("bf16s")),
        ("K7c", "flash_fwd_paired16", mode("paired16")),
    ]


def wgmma_refuse_block_q_32(fa, q, k, v) -> None:
    """The Hopper kernel runs whole warpgroups: each of its eight instances
    must raise ValueError at block_q 32 on the card before any launch."""
    from tpu_operator_torch import _build

    for label, name, run in wgmma_callers(fa):
        before = _build.launches[name]
        try:
            run(q, k, v, 32, 128)
        except ValueError as e:
            log(f"{label} at 32/128 refused: {e}")
        else:
            raise RuntimeError(f"{label} took block_q 32")
        if _build.launches[name] != before:
            raise RuntimeError(f"{label} launched at block_q 32")


def wgmma_host_cost(fa, mb, qkv) -> None:
    """Host microseconds a call of each Hopper instance (each encodes two
    or three tensor maps per call) and of K1 on an (8, LANES) f32 buffer (a
    launch through the same kind of wrapper that encodes no map) take at
    shapes whose kernels are shorter than their enqueue, so the host sets
    the pace; the least of three readings each. Fails when the maps cost
    more than K3_HOST_LIMIT_US a call: then they must be cached."""
    q, k, v = qkv(1, 128)
    buf = torch.zeros((8, mb.LANES), device=q.device, dtype=torch.float32)

    def host_us(run):
        for _ in range(10):
            run(q, k, v, 64, 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            run(q, k, v, 64, 128)
        us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        return us

    base = min(host_us(lambda *_: mb.tiled_copy(buf)) for _ in range(3))
    costs = {label: min(host_us(run) for _ in range(3)) for label, _, run in wgmma_callers(fa)}
    log(f"host us per call: K1 at (8, {mb.LANES}) {base:.2f}; at 1 x 128, 64/128: "
        + ", ".join(f"{label} {us:.2f}" for label, us in costs.items()))
    for label, us in costs.items():
        if us - base > K3_HOST_LIMIT_US:
            raise RuntimeError(f"{label}'s tensor maps cost {us - base:.1f} us a call, "
                               f"above {K3_HOST_LIMIT_US} us")


def wgmma_sass() -> None:
    """Count HGMMA (wgmma), UTMALDG (TMA loads) and HMMA (the warp-level
    MMA) in each instance of the Hopper kernel in the built library's SASS;
    fail unless the eight of WGMMA_INSTANCES are all there, each with HGMMA
    and UTMALDG, K6a and K6b with no MUFU.EX2 (no softmax), and no function
    of the library has HMMA. The softmax's instruction mix (SOFTMAX_OPS) is
    logged."""
    from tpu_operator_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", _build.build_info["path"]], capture_output=True, text=True,
        timeout=120,
    ).stdout
    found, hmma = {}, []
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0]
        if " HMMA" in body:
            hmma.append(name.strip())
        if WGMMA_KERNEL not in name:
            continue
        args = WGMMA_NAME_ARGS.search(name)
        label = WGMMA_INSTANCES.get(args.groups() if args else None, name.strip())
        found[label] = (body.count("HGMMA"), body.count("UTMALDG"), body.count("MUFU.EX2"))
        log(f"{WGMMA_KERNEL} {label} SASS: HGMMA {found[label][0]}, "
            f"UTMALDG {found[label][1]}, HMMA {body.count(' HMMA')}; "
            + ", ".join(f"{op} {body.count(op)}" for op in SOFTMAX_OPS))
    if sorted(found) != sorted(WGMMA_INSTANCES.values()):
        raise RuntimeError(f"{WGMMA_KERNEL} instances in the SASS: {sorted(found)}, "
                           f"expected {sorted(WGMMA_INSTANCES.values())}")
    if hmma:
        raise RuntimeError(f"HMMA in the library's SASS: {hmma}")
    for label, (hgmma, utmaldg, ex2) in found.items():
        if hgmma == 0 or utmaldg == 0 or (label in NO_SOFTMAX and ex2):
            raise RuntimeError(f"{label} has HGMMA {hgmma}, UTMALDG {utmaldg}, MUFU.EX2 {ex2}")


def check_variant(fa, variant, q, k, v, bq, bk, causal) -> float:
    """One variant's kernel against its plain version (and, for the three
    that compute attention, the f32 oracle; K4 must equal K3 bit for bit);
    raises on a miss."""
    got = fa.flash_attention(q, k, v, bq, bk, causal, variant)
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{variant} produced non-finite values")
    plain = fa.plain_variant(q, k, v, bq, bk, causal, variant).float()
    diff = (got.float() - plain).abs()
    err = float(diff.max())
    where = f"{variant} H={q.shape[0]} S={q.shape[1]} {bq}/{bk} causal={causal}"
    if variant in ("full", "pipelined", "bf16exp"):
        err_ref = float((got.float() - fa.reference_attention(q, k, v, causal)).abs().max())
        note = f"|kernel-oracle|={err_ref:.3e}"
        ok = err <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE
        if variant == "pipelined":
            full = fa.flash_attention(q, k, v, bq, bk, causal)
            same = torch.equal(got, full)
            err_k3 = float((got.float() - full.float()).abs().max())
            note += f" bit-exact-vs-K3={same} |kernel-K3|={err_k3:.3e}"
            ok = ok and same
    elif variant == "qk_only":
        ok = bool((diff <= BF16_ULP * plain.abs() + 1e-3).all())
        note = "within one bf16 ulp" if ok else "beyond one bf16 ulp"
    else:
        ok = err <= FLASH_TOL_PLAIN
        note = ""
    log(f"{where}: |kernel-plain|={err:.3e} {note}")
    if not ok:
        raise RuntimeError(f"{where} disagrees with its reference")
    return err


def variant_rows(fa, qkv, peak_flops, peak_bytes) -> list:
    """K4-K6b: checked at the variants' test shapes, at
    ``HOPPER_VARIANT_SHAPES`` (K6b where ``block_k`` >= 128) and at the
    breakdown's (8, 8192, 128/128, causal), then timed at the breakdown's
    shape."""
    heads, seq = 8, 8192
    bq, bk = fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP
    worst = {variant: 0.0 for variant, _, _ in VARIANTS}
    shapes = [(shape, tuple(worst)) for shape in VARIANT_TEST_SHAPES]
    shapes += [(shape, tuple(v for v in worst if v != "qk_only" or shape[3] >= fa.LANES))
               for shape in HOPPER_VARIANT_SHAPES]
    shapes.append(((heads, seq, bq, bk, True), tuple(worst)))
    for (h, s, bq_, bk_, causal), variants in shapes:
        q, k, v = qkv(h, s)
        for variant in variants:
            err = check_variant(fa, variant, q, k, v, bq_, bk_, causal)
            worst[variant] = max(worst[variant], err)
        torch.cuda.empty_cache()
    performed = fa.causal_flops(seq, heads, fa.LANES, bq, bk)
    useful = 4.0 * heads * fa.LANES * seq * (seq + 1) / 2.0
    tensor_bytes = heads * seq * fa.LANES * 2
    rows = []
    for variant, name, line in VARIANTS:
        # operations and bytes each variant must do: the two attention
        # variants the useful triangle; the instruments what they perform
        flops = {"softmax_stub": performed, "qk_only": performed / 2}.get(variant, useful)
        io_bytes = (3 if variant == "qk_only" else 4) * tensor_bytes
        bound_flops, bound_io = flops / peak_flops, io_bytes / peak_bytes
        library_ms = None
        if variant in ("pipelined", "bf16exp"):
            # (1, H, S, D): a batch dimension lets PyTorch pick its fused kernel
            library_ms = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True), 20)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_operator_torch/csrc/flash.cu",
            "replaces": f"{FLASH_FILE}:{line}",
            "shape": [heads, seq, fa.LANES, bq, bk],
            "max_abs_err": worst[variant],
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, bq, bk, True, variant), 20),
            "plain_ms": time_ms(
                lambda: fa.plain_variant(q, k, v, bq, bk, True, variant), 2, warmup=1),
            "bound_ms": max(bound_flops, bound_io) * 1e3,
            "bound_by": "operations" if bound_flops >= bound_io else "bytes",
            "library_ms": library_ms,
        })
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def check_matmul_rounding() -> None:
    """One step of the chain on the card against the host's f32 product,
    scaled by ``1/size`` and then rounded to bf16 once, as the reference
    does."""
    from tpu_operator_torch.workloads.matmul import make_matmul_step

    size = MATMUL_CHECK_SIZE
    fn, (a, b) = make_matmul_step(size=size, depth=1)
    got = fn(a, b).cpu().float()
    a32, b32 = a.cpu().float(), b.cpu().float()
    want = ((a32 @ b32) * (1.0 / size)).to(torch.bfloat16).float()
    off = got != want
    share = float(off.float().mean())
    # one bf16 ulp, plus what summing in another order may move an f32 sum
    # (size * 2^-24 * sum |a b|) where cancellation leaves a tiny value
    order = size * 2.0**-24 * (a32.abs() @ b32.abs()) * (1.0 / size)
    bound = BF16_ULP * torch.maximum(got.abs(), want.abs()) + order
    beyond = int(((got - want).abs() > bound).sum())
    log(f"matmul step at {size}: {int(off.sum())} of {got.numel()} elements off the host's "
        f"once-rounded product ({share:.2e}), {beyond} beyond one bf16 ulp")
    if beyond or share > MATMUL_MISS_SHARE:
        raise RuntimeError(f"the matmul step does not round once like the reference at {size}")


def phase_main_path() -> dict:
    from tpu_operator_torch import _build
    from tpu_operator_torch.entry import entry
    from tpu_operator_torch.workloads.flashattn import run_flashattn_probe
    from tpu_operator_torch.workloads.matmul import run_matmul_validation
    from tpu_operator_torch.workloads.membw import run_membw_probe

    _build.reset_launches()
    fn, (a, b) = entry()
    out = fn(a, b)
    if out.shape != (1024, 1024) or not torch.isfinite(out.float()).all():
        raise RuntimeError("entry() chain gave a wrong shape or non-finite values")
    check_matmul_rounding()
    mm = run_matmul_validation(size=8192)
    bw = run_membw_probe(size_mb=2048)
    fl = run_flashattn_probe(seq=8192, heads=8)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    # the card's default blocks at the edge seqs, each counted apart from
    # the main path
    edges = []
    for seq, blocks in PROBE_EDGES:
        _build.reset_launches()
        edge = run_flashattn_probe(seq=seq, heads=8)
        torch.cuda.synchronize()
        edge_launches = _build.launches["flash_fwd"]
        log(f"flash probe at seq {seq}: blocks {edge.block_q}/{edge.block_k}, "
            f"{edge_launches} flash_fwd launches")
        if edge.ok and (edge.block_q, edge.block_k) != blocks:
            raise RuntimeError(f"the probe at seq {seq} ran {edge.block_q}/{edge.block_k}, "
                               f"expected {blocks}")
        if edge.ok and edge_launches <= 0:
            raise RuntimeError(f"the probe at seq {seq} never launched flash_fwd")
        edges.append((f"flashattn seq {seq}", edge))
    for name, res in [("matmul", mm), ("membw", bw), ("flashattn", fl), *edges]:
        log(f"{name}: {json.dumps(res.to_dict())}")
        if not res.ok:
            raise RuntimeError(f"{name} failed: {res.error}")
    if not bw.integrity:
        raise RuntimeError("membw copy integrity failed")
    log(f"launches on the main path: {launches}")
    for name in ("bulk_copy", "flash_fwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    return launches


def phase_attribution() -> dict:
    from tpu_operator_torch import _build
    from tpu_operator_torch.workloads.fa_variant_check import run_variant_check
    from tpu_operator_torch.workloads.flashattn import (
        run_flashattn_breakdown,
        run_flashattn_probe,
    )

    _build.reset_launches()
    breakdown = run_flashattn_breakdown(seq=8192, heads=8, iters=16)
    # at full width: the plain K5 passes the oracle at 8 x 8192 on the CPU too
    probe = run_flashattn_probe(seq=8192, heads=8, variant="bf16exp")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    # K3 against K4, counted apart from the attribution path
    _build.reset_launches()
    check = run_variant_check()
    torch.cuda.synchronize()
    check_launches = {name: _build.launches[name] for name in ("flash_fwd", "flash_fwd_pipelined")}
    log(f"breakdown: {json.dumps(breakdown)}")
    log(f"bf16exp probe: {json.dumps(probe.to_dict())}")
    log(f"fa_variant_check: {json.dumps(check)}")
    ratio = check["wall_speedup"]["pipelined"]
    log(f"K3/K4 wall-time ratio (full/pipelined, >1 = K4 faster): median "
        f"{ratio['median']}, IQR {ratio['iqr']}")
    if not breakdown["ok"]:
        raise RuntimeError(f"breakdown failed: {breakdown.get('error')}")
    if not probe.ok:
        raise RuntimeError(f"bf16exp probe failed: {probe.error}")
    for name, err in check["max_err"].items():
        if not err < FLASH_TOL_ORACLE:
            raise RuntimeError(f"fa_variant_check: {name} diverged from the oracle: {err}")
    log(f"launches on the attribution path: {launches}")
    for name in ATTRIBUTION_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"the attribution path never launched {name}")
    log(f"launches in fa_variant_check: {check_launches}")
    for name, n in check_launches.items():
        if n <= 0:
            raise RuntimeError(f"fa_variant_check never launched {name}")
    return launches


def check_modes(fa, fx, q, k, v, bq, bk) -> dict:
    """K7a-c against their plain versions and the f32 oracle, K7a equal to
    K3 and K7c equal to K7b bit for bit, at one causal shape; raises on a
    miss and returns each mode's |kernel - plain|.

    The two softmaxes (f32 for K7a, half width for K7b/K7c) differ by less
    than the plain tolerance, so each kernel must also sit nearer, in
    mean-abs, to its own softmax's plain version than to the other's, and
    K7b/K7c must not equal K3: a kernel running the wrong softmax fails."""
    ref = fa.reference_attention(q, k, v)
    plain = {mode: fx.plain_mode(q, k, v, bq, bk, mode).float() for mode, _, _ in MODES}
    other = {"paired": plain["bf16s"], "bf16s": plain["paired"], "paired16": plain["paired"]}
    k3 = fa.flash_attention(q, k, v, bq, bk, True)
    where = f"H={q.shape[0]} S={q.shape[1]} {bq}/{bk} causal"
    outs, errs, ok = {}, {}, True
    for mode, _, _ in MODES:
        got = outs[mode] = fx.experiment_flash(q, k, v, bq, bk, mode)
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{mode} produced non-finite values at {where}")
        diff = (got.float() - plain[mode]).abs()
        errs[mode] = float(diff.max())
        err_ref = float((got.float() - ref).abs().max())
        mean_own = float(diff.mean())
        mean_other = float((got.float() - other[mode]).abs().mean())
        log(f"{mode} {where}: |kernel-plain|={errs[mode]:.3e} |kernel-oracle|={err_ref:.3e} "
            f"mean|kernel-plain|={mean_own:.3e} mean|kernel-other softmax's plain|="
            f"{mean_other:.3e}")
        ok = (ok and errs[mode] <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE
              and mean_own < mean_other)
        if mode != "paired" and torch.equal(got, k3):
            log(f"{mode} {where}: equals K3, so it did not run the half-width softmax")
            ok = False
    for paired, single, base in (("paired", "K3", k3), ("paired16", "K7b", outs["bf16s"])):
        err = float((outs[paired].float() - base.float()).abs().max())
        same = torch.equal(outs[paired], base)
        log(f"{paired} {where}: bit-exact-vs-{single}={same} |kernel-{single}|={err:.3e}")
        ok = ok and err <= FLASH_TOL_PLAIN and same
    if not ok:
        raise RuntimeError(f"a structural variant disagrees with its reference at {where}")
    return errs


def phase_structural(partial: dict) -> list:
    """K7a-c: checked, driven through ``run_experiment`` with the launch
    counts read just after, then timed; ``partial`` is
    ``check_partial_tiles``'s worst errors, which their rows take in."""
    from tpu_operator_torch import _build
    from tpu_operator_torch.workloads import fa_experiment as fx
    from tpu_operator_torch.workloads import flashattn as fa

    dev = torch.device("cuda")
    peak_flops, peak_bytes = peaks()
    gen = torch.Generator(device=dev).manual_seed(0)
    heads, seq = 8, 8192
    bq, bk = fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP

    def qkv(h, s):
        return [torch.randn((h, s, fa.LANES), generator=gen, device=dev, dtype=torch.bfloat16)
                for _ in range(3)]

    worst = {mode: 0.0 for mode, _, _ in MODES}
    for h, s, bq_, bk_, _ in STRUCTURAL_TEST_SHAPES + [(heads, seq, bq, bk, True)]:
        for mode, err in check_modes(fa, fx, *qkv(h, s), bq_, bk_).items():
            worst[mode] = max(worst[mode], err)
        torch.cuda.empty_cache()

    _build.reset_launches()
    experiment = fx.run_experiment(fx.MODES, seq=seq, heads=heads, reps=7)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"fa_experiment: {json.dumps(experiment)}")
    log(f"launches on the structural-variant path: {launches}")
    for name, err in experiment["max_err"].items():
        if not err < FLASH_TOL_ORACLE:
            raise RuntimeError(f"{name} diverged from the oracle on the path: {err}")
    for _, name, _ in MODES:
        if launches[name] <= 0:
            raise RuntimeError(f"the structural-variant path never launched {name}")

    q, k, v = qkv(heads, seq)
    useful = 4.0 * heads * fa.LANES * seq * (seq + 1) / 2.0
    bound_flops, bound_io = useful / peak_flops, 4.0 * heads * seq * fa.LANES * 2 / peak_bytes
    # (1, H, S, D): a batch dimension lets PyTorch pick its fused kernel
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), 20)
    rows = []
    for mode, name, line in MODES:
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_operator_torch/csrc/flash.cu",
            "replaces": f"{EXPERIMENT_FILE}:{line}",
            "shape": [heads, seq, fa.LANES, bq, bk],
            "launches": launches[name],
            "max_abs_err": max(worst[mode], partial.get(name, 0.0)),
            "ms": time_ms(lambda: fx.experiment_flash(q, k, v, bq, bk, mode), 20),
            "plain_ms": time_ms(lambda: fx.plain_mode(q, k, v, bq, bk, mode), 2, warmup=1),
            "bound_ms": max(bound_flops, bound_io) * 1e3,
            "bound_by": "operations" if bound_flops >= bound_io else "bytes",
            "library_ms": library_ms,
        })
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def burnin_step_seconds(world, steps: int) -> float:
    """Seconds a burn-in train step takes at the validator's widths, the
    slowest rank's, after one warm-up step (a rank function)."""
    import torch.distributed as dist

    from tpu_operator_torch.workloads.burnin import build_burnin
    from tpu_operator_torch.workloads.mesh import all_reduce_scalar

    _, train_step, params, (x, y) = build_burnin(world)
    params, _ = train_step(params, x, y)
    world.sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, loss = train_step(params, x, y)
    world.sync()
    return all_reduce_scalar((time.perf_counter() - t0) / steps, dist.ReduceOp.MAX, world.device)


def phase_multidevice() -> None:
    """The five probes and the dryrun on every card over NCCL; fails unless
    each is ok."""
    from tpu_operator_torch.entry import dryrun_multichip
    from tpu_operator_torch.workloads.burnin import run_burnin
    from tpu_operator_torch.workloads.mesh import spawn_world
    from tpu_operator_torch.workloads.moe import run_moe
    from tpu_operator_torch.workloads.pipeline import run_pipeline
    from tpu_operator_torch.workloads.ring import run_ring_probe
    from tpu_operator_torch.workloads.ringattn import run_ringattn

    n = torch.cuda.device_count()
    probes = [
        ("burnin", lambda: run_burnin(n, steps=10)),
        ("ring", lambda: run_ring_probe(n)),
        ("ringattn", lambda: run_ringattn(n)),
        ("pipeline", lambda: run_pipeline(n)),
        ("moe", lambda: run_moe(n)),
    ]
    results, failed = {}, []
    for name, run in probes:
        t0 = time.perf_counter()
        res = run()
        results[name] = {**res.to_dict(), "wall_s": time.perf_counter() - t0}
        if not res.ok:
            failed.append(f"{name}: {res.error}")
    step_s = spawn_world(burnin_step_seconds, n, "cuda", 10)[0]
    log(json.dumps({"multidevice": {"n_devices": n, "backend": "nccl", **results,
                                    "burnin_step_s": step_s}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"multi-device path on: {smi.stdout.strip() or smi.stderr.strip()}")
    if failed:
        raise RuntimeError(f"the multi-device path failed on {n} cards: {failed}")
    t0 = time.perf_counter()
    dryrun_multichip(n)
    log(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s")


def phase_cli(chain) -> None:
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as status_dir:
        for component, args, status_file in chain:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.validator",
                 "--component", component, *args, "--output-dir", status_dir],
                capture_output=True, text=True, timeout=400,
            )
            path = os.path.join(status_dir, status_file)
            if proc.returncode != 0 or not os.path.exists(path):
                raise RuntimeError(
                    f"CLI {component} failed rc={proc.returncode}:\n{proc.stderr[-3000:]}"
                )
            with open(path) as f:
                payload = json.load(f)
            if payload.get("ok") is not True:
                raise RuntimeError(f"CLI {component} wrote {status_file} without ok: {payload}")
            log(f"cli {component}: rc=0 {time.perf_counter() - t0:.1f} s "
                f"{status_file}={json.dumps(payload)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_setup()
    kernels, partial = phase_kernels()
    launches = phase_main_path()
    attribution = phase_attribution()
    variant_kernels = {name for _, name, _ in VARIANTS}
    for k in kernels:
        k["launches"] = (attribution if k["name"] in variant_kernels else launches)[k["name"]]
    kernels += phase_structural(partial)
    phase_multidevice()
    phase_cli(CLI_CHAIN + MULTIDEVICE_CLI)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
