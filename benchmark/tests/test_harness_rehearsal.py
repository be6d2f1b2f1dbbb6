"""A whole run on the CPU at the tiny widths: the result line's shape, and
the trace's reduction to busy time, idle gaps and kernel shares."""

import io
import json
from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny.chain", "tiny.attn"])
def test_last_line_of_a_cpu_rehearsal(tiny_bench, cell):
    result = harness.run_cell(tiny_bench, cell, 2**31 + 17, 0.3, False, "cpu", 0.0)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"validation_s", "validation_p90_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"] == "s"
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    assert json.loads(out.getvalue().splitlines()[-1]) == json.loads(json.dumps(result))
    lines = err.getvalue().splitlines()
    assert lines[0] == "correct True" and len(lines) == 1 + len(result["checks"])
    assert all(line.startswith("check ") for line in lines[1:])


def test_gate_rehearsal_at_the_tiny_widths(tiny_bench, monkeypatch):
    from benchmark.conftest import TINY_GATE
    from tpu_operator_torch.workloads import fa_gate

    monkeypatch.setattr(fa_gate, "SEQ", TINY_GATE["flash"]["seq"])
    monkeypatch.setattr(fa_gate, "HEADS", TINY_GATE["flash"]["heads"])
    monkeypatch.setattr(fa_gate, "MATMUL_SIZE", TINY_GATE["matmul"]["size"])
    result = harness.run_cell(tiny_bench, "tiny.gate", 9, 0.3, False, "cpu", 0.0)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {"attn_err", "flash_entry_err", "flash_off_widths", "mm_err",
                                     "mm_entry_err", "mm_off_widths", "gate_rate_share"}
    assert set(result["metrics"]) == {"gate_reading_s", "gate_reading_p90_s", "setup_s"}
    assert result["checks"]["flash_off_widths"]["value"] == 0


def test_gate_refuses_a_configuration_the_program_does_not_run(tiny_bench):
    with pytest.raises(ValueError, match="gate: the program runs"):
        harness.run_cell(tiny_bench, "tiny.gate", 9, 0.1, False, "cpu", 0.0)


def test_traced_rehearsal_reports_per_layer_metrics_and_breakdown(tiny_bench):
    tiny_bench.spec["per_layer"] = [dict(m, workloads=["tiny.chain"])
                                    for m in tiny_bench.spec["per_layer"]]
    result = harness.run_cell(tiny_bench, "tiny.chain", 5, 0.3, True, "cpu", 0.0)
    assert result["correct"] is True
    # host spans are read on the CPU too; nothing ran on a card to share a roofline
    assert {"validator.flashattn_ms", "validator.membw_ms"} <= set(result["metrics"])
    assert not {"kernel.k3_roofline", "kernel.k2_roofline", "device.idle"} & set(result["metrics"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_seed_gives_the_same_inputs(tiny_bench):
    a = harness.run_cell(tiny_bench, "tiny.attn", 2**33 + 1, 0.1, False, "cpu", 0.0)
    b = harness.run_cell(tiny_bench, "tiny.attn", 2**33 + 1, 0.1, False, "cpu", 0.0)
    c = harness.run_cell(tiny_bench, "tiny.attn", 2**33 + 2, 0.1, False, "cpu", 0.0)
    assert a["checks"]["attn_err"] == b["checks"]["attn_err"] != c["checks"]["attn_err"]


def _trace():
    k3 = "void flash_fwd_wgmma_kernel<(Step)0, (Body)0, 2>(CUtensorMap_st, int)"
    k2 = "void bulk_copy_kernel(char const*, char*, long long)"
    ms = 1_000_000
    return devtrace.Trace(
        device_ops=[(k3, 1 * ms, 3 * ms), (k3, 3 * ms, 5 * ms), (k2, 7 * ms, 8 * ms),
                    ("Memcpy DtoH (Device -> Pinned)", 9 * ms, 10 * ms)],
        host_ops=[("aten::item", 5 * ms, 7 * ms), ("cudaLaunchKernel", 8 * ms, 9 * ms)],
        spans=[("pass", 0, 10 * ms), ("flashattn", 0, 6 * ms), ("membw", 6 * ms, 10 * ms)])


def test_trace_busy_gaps_and_breakdown():
    t = _trace()
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.006)
    assert t.gaps() == [(0, 1_000_000), (5_000_000, 7_000_000), (8_000_000, 9_000_000)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["flash_fwd_wgmma_kernel<(Step)0, (Body)0, 2>", 0.004]
    assert ["membw: cudaLaunchKernel", 0.001] in b["idle_gaps"]
    assert ["flashattn: python", 0.001] in b["idle_gaps"]
    assert len(b["idle_gaps"]) == 3


def test_kernel_readers_on_a_synthetic_trace():
    bench = harness.Bench()
    peak = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    run = SimpleNamespace(trace=_trace(), peak=peak,
                          shapes={"k3": {"heads": 8, "seq": 8192, "head_dim": 128},
                                  "k2": {"rows": 32768, "lanes": 16384}})
    k3 = bench.reader("metrics", "kernel.k3_roofline").read(run)
    assert k3 == pytest.approx(100 * 1.3744e11 / 989e12 / 0.002, rel=1e-3)
    k2 = bench.reader("metrics", "kernel.k2_roofline").read(run)
    assert k2 == pytest.approx(100 * 4 * 2**30 / 3.35e12 / 0.001, rel=1e-6)
    assert bench.reader("metrics", "device.idle").read(run) == pytest.approx(40.0)
    run.trace = devtrace.Trace(spans=[("pass", 0, 10)])  # nothing ran on the card
    for name in ("kernel.k3_roofline", "kernel.k2_roofline", "device.idle"):
        assert bench.reader("metrics", name).read(run) is None


K3_NAMES = [
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<((anonymous namespace)::Step)0, "
    "((anonymous namespace)::Body)0, 2>(CUtensorMap_st, CUtensorMap_st)",
    "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILNS_4StepE0ELNS_4BodyE0ELi2EEEvv",
    "void flash_fwd_wgmma_kernel<(Step)0, (Body)0, 2>(CUtensorMap_st, CUtensorMap_st)",
    "void flash_fwd_wgmma_kernel<Step::kFull, Body::kOne, 2>(CUtensorMap_st)",
    "_Z22flash_fwd_wgmma_kernelIL4Step0EL4Body0ELi2EEv14CUtensorMap_st",
]
OTHER_FLASH = [  # K4, K5, K7a as the same spellings name them
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<((anonymous namespace)::Step)0, "
    "((anonymous namespace)::Body)2, 3>(CUtensorMap_st, CUtensorMap_st)",
    "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILNS_4StepE1ELNS_4BodyE0ELi2EEEvv",
    "void flash_fwd_wgmma_kernel<(Step)0, (Body)2, 3>(CUtensorMap_st, CUtensorMap_st)",
    "void flash_fwd_wgmma_kernel<Step::kBf16Exp, Body::kOne, 2>(CUtensorMap_st)",
    "_Z22flash_fwd_wgmma_kernelIL4Step0EL4Body1ELi4EEv14CUtensorMap_st",
]


def test_k3_pattern_takes_k3_alone():
    pattern = harness.Bench().reader("metrics", "kernel.k3_roofline").KERNEL
    assert all(pattern.search(name) for name in K3_NAMES)
    assert not any(pattern.search(name) for name in OTHER_FLASH)


def test_p90_is_nearest_rank_over_every_pass():
    read = harness.Bench().reader("e2e", "validation_p90_s").read
    assert read(SimpleNamespace(durations=[float(i) for i in range(1, 101)])) == 90.0
    assert read(SimpleNamespace(durations=[3.0])) == 3.0
