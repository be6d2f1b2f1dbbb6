#!/usr/bin/env python3
"""Drive the PyTorch port's compute chain on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one H100 and the
CUDA toolkit (``nvcc``). Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), torch and nvcc
   versions, and build the kernels from ``tpu_operator_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card (the
   copies bit-exact, flash attention within 1e-2 of its plain version and
   within 2e-2 of the f32 oracle), time kernel, plain version and one
   library call at the main path's shapes, and print one ``kernels`` JSON
   line;
3. run the main path in-process at its full operating points (matmul 8192,
   membw 2 GiB, flash attention 8192 x 8 heads) with the launch counts set
   to 0 just before and read just after;
4. run the validator CLI for the same three components as subprocesses,
   each writing its status file into a temporary directory.

The last line of standard output is one JSON object naming the device.
Without a CUDA device, or without the ``tpu_operator_torch`` package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

COPY_REPLACES = "tpu_operator/workloads/membw.py"
FLASH_REPLACES = "tpu_operator/workloads/flashattn.py:112"
FLASH_TOL_PLAIN = 1e-2  # same function, f32 sums in another order, p rounded per sub-tile
FLASH_TOL_ORACLE = 2e-2  # the reference's oracle tolerance

# (heads, seq, block_q, block_k, causal): the CPU tests' shapes
FLASH_TEST_SHAPES = [
    (2, 256, 128, 128, True),
    (2, 256, 128, 128, False),
    (1, 512, 128, 256, True),
]


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
    if os.path.exists(ptxas):
        with open(ptxas) as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log("  ptxas " + line.strip())


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
    for h, s, bq_, bk_, causal in FLASH_TEST_SHAPES + [(heads, seq, bq, bk, True)]:
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
    return kernels


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
    for k in kernels:
        k["launches"] = launches[k["name"]]
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
