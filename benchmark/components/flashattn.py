"""The validator's ``flashattn`` component: K3 at the card's default blocks,
checked by the probe against its f32 oracle."""

from __future__ import annotations

import torch

from benchmark import record
from benchmark.reference import attention as ref

BUILDERS = [("tpu_operator_torch.workloads.flashattn", "make_flash_fn")]


def blocks(run, seq: int):
    from tpu_operator_torch.workloads.flashattn import default_blocks

    return default_blocks(seq, run.device)


def check_widths(run, w) -> dict:
    """The K3 shape of widths ``w``; on the card the blocks the program
    picks must be the configuration's."""
    if run.device.type == "cuda" and list(blocks(run, w["seq"])) != list(w["blocks"]):
        raise ValueError(f"flashattn: the program's blocks at seq {w['seq']} are "
                         f"{blocks(run, w['seq'])}, the configuration says {w['blocks']}")
    return {"heads": w["heads"], "seq": w["seq"], "head_dim": w["head_dim"]}


def prepare(run, w) -> dict:
    return {"k3": check_widths(run, w)}


def call(run, w) -> dict:
    from tpu_operator_torch.validator import components as comp

    return comp.validate_flashattn(run.status, seq=w["seq"], heads=w["heads"],
                                   expect_gpu=run.expect_gpu)


def numbers(payload, run, w) -> dict:
    peak = run.peak
    share = payload["tflops"] * 1e12 / peak["bf16_flops_per_s"] if peak else None
    return {"flash_payload_err": payload["max_err"], "flash_rate_share": share}


def _gap(q, k, v, causal: bool, out, control: bool) -> float:
    """The largest absolute gap of ``out`` (with ``control``, of the fp8
    reference put in its place) to the f32 reference on q, k, v."""
    if control:
        out = ref.attention(q, k, v, causal=causal, lower=True).bfloat16()
    return ref.max_gap(out, ref.attention(q, k, v, causal=causal))


def attention_gap(run, w, gen, control: bool = False, bq_bk=None) -> float:
    """K3 (or the fp8 control) on seeded q, k, v at widths ``w`` and blocks
    ``bq_bk`` (the program's default where not given), against the f32
    reference: the largest absolute gap."""
    from tpu_operator_torch.workloads.flashattn import make_flash_fn

    shape = (w["heads"], w["seq"], w["head_dim"])
    q, k, v = (torch.randn(shape, generator=gen, device=run.device, dtype=torch.bfloat16)
               for _ in range(3))
    out = None
    if not control:
        bq, bk = bq_bk or blocks(run, w["seq"])
        out = make_flash_fn(w["seq"], w["heads"], w["head_dim"], bq, bk, causal=w["causal"])(q, k, v)
    return _gap(q, k, v, w["causal"], out, control)


def compare(run, w, gen, control: bool = False) -> dict:
    return {"attn_err": attention_gap(run, w, gen, control)}


def held_flash(run, w, builds, expected: int, control: bool = False) -> dict:
    """The flash functions one entry call built: each must be K3 (variant
    ``full``) at widths ``w`` and, on the card, the configuration's blocks,
    and ``expected`` of them must have run. Returns how many did not
    (``flash_off_widths``) and the largest gap of a first call's output to
    the f32 reference on its own q, k, v (``flash_entry_err``); with
    ``control`` the fp8 reference stands in for each output."""
    builds = [b for b in builds if b.builder == "make_flash_fn"]

    def wanted(_, a):
        shape = (a["seq"], a["heads"], a["head_dim"], a["causal"], a["variant"])
        on_card = run.device.type != "cuda" or [a["block_q"], a["block_k"]] == list(w["blocks"])
        return on_card and shape == (w["seq"], w["heads"], w["head_dim"], w["causal"], "full")

    gaps = []
    for b in builds:
        if b.first is not None:
            (q, k, v), out = b.first
            gaps.append(_gap(q, k, v, b.args["causal"], out, control))
    return {"flash_off_widths": float(record.off_widths(builds, expected, wanted)),
            "flash_entry_err": max(gaps) if gaps else None}


def held(run, w, builds, control: bool = False) -> dict:
    return held_flash(run, w, builds, expected=1, control=control)
