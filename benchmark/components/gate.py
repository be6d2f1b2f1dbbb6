"""The flash gate: one ``fa_gate.measure_vs_matmul`` reading at the
configuration's blocks (the best of three K3 probes over one matmul chain)."""

from __future__ import annotations

from benchmark.components import cuda, flashattn

BUILDERS = flashattn.BUILDERS + cuda.BUILDERS


def prepare(run, w) -> dict:
    from tpu_operator_torch.workloads import fa_gate

    program = {"seq": fa_gate.SEQ, "heads": fa_gate.HEADS, "probe_runs": fa_gate.PROBE_RUNS,
               "matmul": [fa_gate.MATMUL_SIZE, fa_gate.MATMUL_DEPTH, fa_gate.MATMUL_ITERS]}
    stated = {"seq": w["flash"]["seq"], "heads": w["flash"]["heads"],
              "probe_runs": w["probe_runs"],
              "matmul": [w["matmul"]["size"], w["matmul"]["depth"], w["matmul"]["iters"]]}
    if program != stated:
        raise ValueError(f"gate: the program runs {program}, the configuration says {stated}")
    f = w["flash"]
    return {"k3": {"heads": f["heads"], "seq": f["seq"], "head_dim": f["head_dim"]}}


def call(run, w) -> dict:
    from tpu_operator_torch.workloads.fa_gate import measure_vs_matmul

    return measure_vs_matmul(*w["flash"]["blocks"], device=str(run.device))


def verdict(payload, run, w):
    ratio = payload["vs_matmul"]
    if ratio is None:
        return f"no reading: {payload['fa_error'] or payload['mm_error']}"
    if run.device.type == "cuda" and ratio < w["floor"]:
        return f"vs_matmul {ratio} under the floor {w['floor']}"
    return None


def numbers(payload, run, w) -> dict:
    peak = run.peak
    rates = [payload[key] for key in ("fa_tflops_performed", "mm_tflops") if payload[key]]
    share = max(rates) * 1e12 / peak["bf16_flops_per_s"] if peak and rates else None
    return {"gate_rate_share": share}


def compare(run, w, gen, control: bool = False) -> dict:
    return {"attn_err": flashattn.attention_gap(run, w["flash"], gen, control,
                                                tuple(w["flash"]["blocks"])),
            **cuda.compare(run, w["matmul"], gen, control)}


def held(run, w, builds, control: bool = False) -> dict:
    """Each of the reading's flash probes held as the ``flashattn``
    component holds its one, and its matmul chain as ``cuda`` does."""
    return {**flashattn.held_flash(run, w["flash"], builds, w["probe_runs"], control),
            **cuda.held(run, w["matmul"], builds, control)}
