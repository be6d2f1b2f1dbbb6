"""The validator's ``membw`` component: K2's bulk copy and the ``x + 1.0`` stream."""

from __future__ import annotations

import torch

from benchmark import record
from benchmark.reference import copy as ref

# K2, the copy the probe runs on the card; the tiled copy is its path off the card
BUILDERS = [("tpu_operator_torch.workloads.membw", "make_dma_copy_fn"),
            ("tpu_operator_torch.workloads.membw", "make_copy_fn")]


def prepare(run, w) -> dict:
    from tpu_operator_torch.workloads.membw import LANES, probe_rows

    rows = probe_rows(w["size_mb"])
    if (rows, LANES) != (w["rows"], w["lanes"]):
        raise ValueError(f"membw: the program's buffer is {rows} x {LANES}, "
                         f"the configuration says {w['rows']} x {w['lanes']}")
    return {"k2": {"rows": rows, "lanes": LANES}}


def call(run, w) -> dict:
    from tpu_operator_torch.validator import components as comp

    return comp.validate_membw(run.status, expect_gpu=run.expect_gpu,
                               min_utilization=w["min_utilization"], size_mb=w["size_mb"])


def numbers(payload, run, w) -> dict:
    peak = run.peak
    share = payload["gbps"] * 1e9 / peak["hbm_bytes_per_s"] if peak else None
    return {"membw_rate_share": share}


def compare(run, w, gen, control: bool = False) -> dict:
    x = torch.randn((w["rows"], w["lanes"]), generator=gen, device=run.device,
                    dtype=torch.float32)
    if control:
        out = ref.control(x)
    else:
        from tpu_operator_torch.workloads.membw import make_dma_copy_fn

        out = make_dma_copy_fn(w["rows"])(x)
    return {"copy_bits_differ": float(ref.bits_differ(out, x))}


def held(run, w, builds, control: bool = False) -> dict:
    """The copy one entry call built must be K2 on the card, over the
    configuration's rows (``copy_off_widths``); its first call's output is
    held bit for bit to its own input (``copy_entry_bits_differ``), or with
    ``control`` the bf16 copy in its place."""
    on_card = run.device.type == "cuda"

    def wanted(builder, a):
        return a["rows"] == w["rows"] and (builder == "make_dma_copy_fn" or not on_card)

    differ = []
    for b in builds:
        if b.first is not None:
            (x,), out = b.first
            differ.append(float(ref.bits_differ(ref.control(x) if control else out, x)))
    return {"copy_off_widths": float(record.off_widths(builds, 1, wanted)),
            "copy_entry_bits_differ": max(differ) if differ else None}
