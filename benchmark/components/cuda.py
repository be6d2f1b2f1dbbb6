"""The validator's ``cuda`` component: the bf16 matmul chain (cuBLAS ``addmm``)."""

from __future__ import annotations

import inspect

import torch

from benchmark import record
from benchmark.reference import matmul as ref

BUILDERS = [("tpu_operator_torch.workloads.matmul", "make_matmul_step")]


def prepare(run, w) -> dict:
    from tpu_operator_torch.workloads.matmul import run_matmul_validation

    params = inspect.signature(run_matmul_validation).parameters
    for key in ("depth", "iters"):
        if params[key].default != w[key]:
            raise ValueError(f"cuda: the program runs {key}={params[key].default}, "
                             f"the configuration says {w[key]}")
    return {}


def call(run, w) -> dict:
    from tpu_operator_torch.validator import components as comp

    return comp.validate_cuda(run.status, expect_gpu=run.expect_gpu, size=w["size"])


def numbers(payload, run, w) -> dict:
    peak = run.peak
    share = payload["tflops"] * 1e12 / peak["bf16_flops_per_s"] if peak else None
    return {"cuda_rate_share": share}


def compare(run, w, gen, control: bool = False) -> dict:
    size, depth = w["size"], w["depth"]
    a, b = (torch.randn((size, size), generator=gen, device=run.device, dtype=torch.bfloat16)
            for _ in range(2))
    if control:
        out = ref.chain(a, b, depth, lower=True)
    else:
        from tpu_operator_torch.workloads.matmul import make_matmul_step

        step, _ = make_matmul_step(size=size, depth=depth, device=run.device)
        out = step(a, b)
        del step
    return {"mm_err": ref.rel_gap(out, ref.chain(a, b, depth))}


def held(run, w, builds, control: bool = False) -> dict:
    """The matmul step one entry call built must run at the configuration's
    size and depth (``mm_off_widths``); its first call's output is held to
    the reference chain on its own operands (``mm_entry_err``), or with
    ``control`` the fp8 chain in its place."""
    builds = [b for b in builds if b.builder == "make_matmul_step"]
    off = record.off_widths(builds, 1, lambda _, a: (a["size"], a["depth"]) == (w["size"], w["depth"]))
    gaps = []
    for b in builds:
        if b.first is not None:
            (x, y), out = b.first
            depth = b.args["depth"]
            if control:
                out = ref.chain(x, y, depth, lower=True)
            gaps.append(ref.rel_gap(out, ref.chain(x, y, depth)))
    return {"mm_off_widths": float(off), "mm_entry_err": max(gaps) if gaps else None}
