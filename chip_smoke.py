#!/usr/bin/env python3
"""Drive the PyTorch port's compute chain on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one H100 and the
CUDA toolkit (``nvcc``). Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), torch and nvcc
   versions, build the kernels from ``tpu_operator_torch/csrc`` (ptxas's
   registers and spills printed; a ``wgmma`` serialization note, C7515 or
   C7519, fails), and count ``HGMMA``, ``UTMALDG`` and ``HMMA`` in the SASS
   of each of the three instances of the Hopper kernel, K3, K5 and K7c
   (``cuobjdump``; a missing instance, no HGMMA or UTMALDG, or any HMMA
   fails);
2. hold each kernel against its plain PyTorch version on the card (the
   copies bit-exact; flash attention K3 and the variants K4 ``pipelined``
   and K5 ``bf16exp`` within 1e-2 of their plain versions and within 2e-2
   of the f32 oracle, K3 and K5 also at the edges of the Hopper kernel
   (``K3_EDGE_SHAPES``), K4 also against K3 (whether bit for bit is
   logged, within 1e-2 required); the instruments K6a ``softmax_stub``
   within 1e-2 and K6b ``qk_only`` within one bf16 ulp of theirs), check
   that K3, K5 and K7c refuse ``block_q`` 32 with ``ValueError`` and
   launch nothing and that the host cost per call of each stays within
   ``K3_HOST_LIMIT_US`` of K4's (their tensor maps; K4 encodes none), and
   time kernel, plain version and one library call at the main path's
   shapes;
3. run the main path in-process at its full operating points (matmul 8192,
   membw 2 GiB, flash attention 8192 x 8 heads) with the launch counts set
   to 0 just before and read just after;
3b. run the flash-attention attribution path the same way: the bench's
   ``run_flashattn_breakdown(seq=8192, heads=8, iters=16)`` and the
   ``bf16exp`` probe at 8192 x 8 heads, each of K3-K6b launched;
3c. the structural-variant path: hold K7a ``paired``, K7b ``bf16s`` and
   K7c ``paired16`` against their plain versions (within 1e-2, and nearer
   in mean-abs to their own softmax's plain version than to the other's;
   K7b and K7c never equal to K3) and the f32 oracle (2e-2) at the
   variants' causal shapes, at 1 x 512 with 64/64 blocks, at 2 x 1024
   with 128/512 blocks and at 8 x 8192,
   K7a against K3 and K7c against K7b (whether bit for bit is logged,
   within 1e-2 required); then, with the launch counts set to 0 just
   before and read just after, run ``run_experiment`` with all three
   modes at 8192 x 8 heads, each of K7a-c launched; then time K7a-c;
4. run the validator CLI for the same three components as subprocesses,
   each writing its status file into a temporary directory.

Then it prints one ``kernels`` JSON line, each kernel's launches read from
the path that runs it (K1-K3 phase 3, K4-K6b phase 3b, K7a-c phase 3c).

The last line of standard output is one JSON object naming the device.
Without a CUDA device, or without the ``tpu_operator_torch`` package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

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
# its instances by (Step, PAIRED) as the mangled name spells them:
# flash_fwd_wgmma_kernel<Step, bool PAIRED, int STAGES>, Step::kFull = 0,
# kBf16Exp = 1, kBf16S = 4
WGMMA_INSTANCES = {("0", "0"): "K3", ("1", "0"): "K5", ("4", "1"): "K7c"}
# host microseconds a call of the Hopper kernel may spend beyond K4's
# (its tensor maps): 5% of K3's ~0.39 ms at the main path's shape, where
# the host would start to set the pace of a chain of launches
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
# the variants' causal shapes, and 64/64, where an odd number of unmasked
# sub-tiles leaves K7a and K7c one to run alone, and 128/512, where K7c's
# ring wraps inside a k-block
STRUCTURAL_TEST_SHAPES = [s for s in VARIANT_TEST_SHAPES if s[4]] + [
    (1, 512, 64, 64, True),
    (2, 1024, 128, 512, True),
]
BF16_ULP = 2.0**-7  # bf16 keeps 8 significant bits: one ulp is at most 2^-7 of |x|


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_kernels() -> list:
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
    for name, wrapper, line in (
        ("tiled_copy", mb.tiled_copy, 86),
        ("bulk_copy", mb.bulk_copy, 116),
    ):
        err = 0.0
        for x in (small, big):
            got, plain = wrapper(x), mb.plain_copy(x)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise RuntimeError(f"{name} is not bit-exact at {tuple(x.shape)}")
            err = max(err, float((got - plain).abs().max()))
            del got, plain
        dst = torch.empty_like(big)
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
    del big, small, dst
    torch.cuda.empty_cache()

    # K3: the CPU tests' shapes, then the probe's shape
    def qkv(heads, seq):
        return [
            torch.randn((heads, seq, fa.LANES), generator=gen, device=dev,
                        dtype=torch.bfloat16)
            for _ in range(3)
        ]

    heads, seq = 8, 8192
    bq, bk = fa._default_block(seq, fa.BLOCK_Q_CAP), fa._default_block(seq, fa.BLOCK_K_CAP)
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
    wgmma_host_cost(fa, qkv)
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
    return kernels


def wgmma_callers(fa):
    """(label, launch counter, fn(q, k, v, block_q, block_k)) of the three
    kernels that run on the Hopper kernel, through their wrappers."""
    from tpu_operator_torch.workloads import fa_experiment as fx

    return [
        ("K3", "flash_fwd", lambda q, k, v, bq, bk: fa.flash_attention(q, k, v, bq, bk, True)),
        ("K5", "flash_fwd_bf16exp",
         lambda q, k, v, bq, bk: fa.flash_attention(q, k, v, bq, bk, True, "bf16exp")),
        ("K7c", "flash_fwd_paired16",
         lambda q, k, v, bq, bk: fx.experiment_flash(q, k, v, bq, bk, "paired16")),
    ]


def wgmma_refuse_block_q_32(fa, q, k, v) -> None:
    """The Hopper kernel runs whole warpgroups: K3, K5 and K7c must each
    raise ValueError at block_q 32 on the card before any launch."""
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


def wgmma_host_cost(fa, qkv) -> None:
    """Host microseconds a call of K3, K5 and K7c (each encodes three
    tensor maps per call) and of K4 (no tensor maps) take at a shape whose
    kernels are shorter than their enqueue, so the host sets the pace; the
    least of three readings each. Fails when the maps cost more than
    K3_HOST_LIMIT_US a call: then they must be cached."""
    q, k, v = qkv(1, 128)

    def host_us(run):
        for _ in range(10):
            run(q, k, v, 64, 64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            run(q, k, v, 64, 64)
        us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        return us

    def k4(q, k, v, bq, bk):
        return fa.flash_attention(q, k, v, bq, bk, True, "pipelined")

    base = min(host_us(k4) for _ in range(3))
    costs = {label: min(host_us(run) for _ in range(3)) for label, _, run in wgmma_callers(fa)}
    log(f"host us per call at 1 x 128, 64/64: K4 {base:.2f}, "
        + ", ".join(f"{label} {us:.2f}" for label, us in costs.items()))
    for label, us in costs.items():
        if us - base > K3_HOST_LIMIT_US:
            raise RuntimeError(f"{label}'s tensor maps cost {us - base:.1f} us a call, "
                               f"above {K3_HOST_LIMIT_US} us")


def wgmma_sass() -> None:
    """Count HGMMA (wgmma), UTMALDG (TMA loads) and HMMA (mma.sync) in each
    instance of the Hopper kernel in the built library's SASS; fail unless
    K3, K5 and K7c are all there, each with HGMMA and UTMALDG and no HMMA."""
    from tpu_operator_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", _build.build_info["path"]], capture_output=True, text=True,
        timeout=120,
    ).stdout
    found = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0]
        if WGMMA_KERNEL not in name:
            continue
        args = re.search(r"StepE(\d+)ELb([01])E", name)
        label = WGMMA_INSTANCES.get(args.groups() if args else None, name.strip())
        found[label] = (body.count("HGMMA"), body.count("UTMALDG"), body.count(" HMMA"))
        log(f"{WGMMA_KERNEL} {label} SASS: HGMMA {found[label][0]}, "
            f"UTMALDG {found[label][1]}, HMMA {found[label][2]}")
    if sorted(found) != sorted(WGMMA_INSTANCES.values()):
        raise RuntimeError(f"{WGMMA_KERNEL} instances in the SASS: {sorted(found)}, "
                           f"expected {sorted(WGMMA_INSTANCES.values())}")
    for label, (hgmma, utmaldg, hmma) in found.items():
        if hgmma == 0 or utmaldg == 0 or hmma:
            raise RuntimeError(f"{label} has HGMMA {hgmma}, UTMALDG {utmaldg}, HMMA {hmma}")


def check_variant(fa, variant, q, k, v, bq, bk, causal) -> float:
    """One variant's kernel against its plain version (and, for the two
    that compute attention, the f32 oracle and K3); raises on a miss."""
    got = fa.flash_attention(q, k, v, bq, bk, causal, variant)
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{variant} produced non-finite values")
    plain = fa.plain_variant(q, k, v, bq, bk, causal, variant).float()
    diff = (got.float() - plain).abs()
    err = float(diff.max())
    where = f"{variant} H={q.shape[0]} S={q.shape[1]} {bq}/{bk} causal={causal}"
    if variant in ("pipelined", "bf16exp"):
        err_ref = float((got.float() - fa.reference_attention(q, k, v, causal)).abs().max())
        note = f"|kernel-oracle|={err_ref:.3e}"
        ok = err <= FLASH_TOL_PLAIN and err_ref < FLASH_TOL_ORACLE
        if variant == "pipelined":
            full = fa.flash_attention(q, k, v, bq, bk, causal)
            err_k3 = float((got.float() - full.float()).abs().max())
            note += f" bit-exact-vs-K3={torch.equal(got, full)} |kernel-K3|={err_k3:.3e}"
            ok = ok and err_k3 <= FLASH_TOL_PLAIN
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
    """K4-K6b: checked at the variants' test shapes and at the breakdown's
    (8, 8192, 128/128, causal), K5 also at the Hopper kernel's edges
    (``K3_EDGE_SHAPES``), then timed at the breakdown's shape."""
    heads, seq = 8, 8192
    bq, bk = fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP
    worst = {variant: 0.0 for variant, _, _ in VARIANTS}
    shapes = [(shape, tuple(worst)) for shape in VARIANT_TEST_SHAPES]
    shapes += [(shape, ("bf16exp",)) for shape in K3_EDGE_SHAPES]
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
    mm = run_matmul_validation(size=8192)
    bw = run_membw_probe(size_mb=2048)
    fl = run_flashattn_probe(seq=8192, heads=8)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    for name, res in (("matmul", mm), ("membw", bw), ("flashattn", fl)):
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
    log(f"breakdown: {json.dumps(breakdown)}")
    log(f"bf16exp probe: {json.dumps(probe.to_dict())}")
    if not breakdown["ok"]:
        raise RuntimeError(f"breakdown failed: {breakdown.get('error')}")
    if not probe.ok:
        raise RuntimeError(f"bf16exp probe failed: {probe.error}")
    log(f"launches on the attribution path: {launches}")
    for name in ATTRIBUTION_KERNELS:
        if launches[name] <= 0:
            raise RuntimeError(f"the attribution path never launched {name}")
    return launches


def check_modes(fa, fx, q, k, v, bq, bk) -> dict:
    """K7a-c against their plain versions and the f32 oracle, K7a against
    K3 and K7c against K7b, at one causal shape; raises on a miss and
    returns each mode's |kernel - plain|.

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
        log(f"{paired} {where}: bit-exact-vs-{single}={torch.equal(outs[paired], base)} "
            f"|kernel-{single}|={err:.3e}")
        ok = ok and err <= FLASH_TOL_PLAIN
    if not ok:
        raise RuntimeError(f"a structural variant disagrees with its reference at {where}")
    return errs


def phase_structural() -> list:
    """K7a-c: checked, driven through ``run_experiment`` with the launch
    counts read just after, then timed."""
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
            "max_abs_err": worst[mode],
            "ms": time_ms(lambda: fx.experiment_flash(q, k, v, bq, bk, mode), 20),
            "plain_ms": time_ms(lambda: fx.plain_mode(q, k, v, bq, bk, mode), 2, warmup=1),
            "bound_ms": max(bound_flops, bound_io) * 1e3,
            "bound_by": "operations" if bound_flops >= bound_io else "bytes",
            "library_ms": library_ms,
        })
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def phase_cli() -> None:
    chain = [
        ("cuda", ["--matmul-size", "8192"], "cuda-ready"),
        ("membw", ["--membw-size-mb", "2048"], "membw-ready"),
        ("flashattn", ["--flashattn-seq", "8192", "--flashattn-heads", "8"], "flashattn-ready"),
    ]
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
            log(f"cli {component}: rc=0 {time.perf_counter() - t0:.1f} s "
                f"{status_file}={json.dumps(payload)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_setup()
    kernels = phase_kernels()
    launches = phase_main_path()
    attribution = phase_attribution()
    variant_kernels = {name for _, name, _ in VARIANTS}
    for k in kernels:
        k["launches"] = (attribution if k["name"] in variant_kernels else launches)[k["name"]]
    kernels += phase_structural()
    phase_cli()
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
