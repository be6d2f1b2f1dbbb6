"""The program's spans mapped onto the device trace (``progtrace``): a
synthetic trace with a known clock offset, known gaps and nested spans gives
exact idle time by layer; the cases where the clocks cannot be matched read
nothing; a CPU rehearsal reads the flash check; on the card every cell reads
every metric that the spans feed.

``BENCHMARK.json`` does not list these metrics yet: a program without the
spans reads nothing for them, and ``harness.require_read`` would then stop a
card run of that program. The tests add ``ENTRIES``, the entries that a
later change lists once the program it is measured against has the spans.
"""

import threading
import time
from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness, progtrace
from tpu_operator_torch.obs import trace

US = 1000  # ns
OFFSET = 1_760_000_000_000_000_000  # the profiler's clock over the host's, ns
T0 = 2_000_000  # the first pass's start on the host clock, us

# (name, start us, end us) on the host clock, for each pass
PASSES = [(T0, T0 + 10_000), (T0 + 10_000, T0 + 20_000), (T0 + 20_000, T0 + 30_000)]
PROGRAM = [
    ("validator.flashattn", T0 + 500, T0 + 9_500),
    ("probe.flash.check", T0 + 1_000, T0 + 5_000),
    ("timing.round", T0 + 5_000, T0 + 9_500),
    ("validator.flashattn", T0 + 10_200, T0 + 19_500),
    ("probe.flash.check", T0 + 10_500, T0 + 12_000),
]
# busy on the card, profiler clock less OFFSET, us
BUSY = [(T0 + 1_000, T0 + 4_000), (T0 + 6_000, T0 + 9_000), (T0 + 11_000, T0 + 19_000),
        (T0 + 20_000, T0 + 30_000)]
# idle us by layer, worked out by hand from the gaps 0-1, 4-6, 9-11, 19-20 ms
IDLE_US = {None: 500 + 700 + 500, "validator": 500 + 300 + 500, "probe": 1_000 + 500,
           "timing": 1_000 + 500}


_ADMISSION = ["admission.chain", "admission.attn"]
_GATE = ["gate.shipped"]
ENTRIES = [
    {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "validator" if name.startswith("validator.") else "probes",
     "moves": "gate_reading_s" if name.endswith(".gate") else "validation_s",
     "workloads": _GATE if name.endswith(".gate") else _ADMISSION}
    for name in ("probe.flash_check_ms", "probe.flash_check_ms.gate", "timing.idle_ms",
                 "timing.idle_ms.gate", "probe.idle_ms", "probe.idle_ms.gate",
                 "validator.idle_ms")]


def with_entries(bench, cells=None):
    """``bench`` with ``ENTRIES`` appended to its per-layer metrics, each
    listing ``cells`` where given."""
    bench.spec["per_layer"] += [dict(m, workloads=cells) if cells else dict(m) for m in ENTRIES]
    return bench


def _record(name, start_us, end_us, tid):
    return {"name": name, "cat": name.split(".")[0], "ph": "X", "ts": start_us,
            "dur": end_us - start_us, "pid": 1, "tid": tid, "id": 0, "args": {}}


def _run(skews_ns=(800 * US, 0, 0), traced_passes=None):
    """A run whose passes start ``skews_ns`` earlier on the host than the
    profiler's clock, less ``OFFSET``, says."""
    passes = traced_passes if traced_passes is not None else [
        ("pass", s * US + OFFSET, e * US + OFFSET) for s, e in PASSES]
    ops = [("k", s * US + OFFSET, e * US + OFFSET) for s, e in BUSY]
    return SimpleNamespace(
        spans=[("pass", (s * US - k) / 1e9, e / 1e6) for (s, e), k in zip(PASSES, skews_ns)],
        trace=devtrace.Trace(device_ops=ops, spans=passes),
        counters={"passes": len(PASSES)})


@pytest.fixture
def program(monkeypatch):
    """The program's tracer read as a ring holding ``PROGRAM``; returns a
    setter for the ring's records and dropped count."""
    tid = threading.get_ident() & 0xFFFF
    state = {"records": [_record(n, s, e, tid) for n, s, e in PROGRAM], "dropped": 0}
    monkeypatch.setattr(progtrace, "snapshot",
                        lambda: trace.Snapshot(0, list(state["records"]), state["dropped"]))
    return state


def test_idle_splits_exactly_by_the_innermost_span(program):
    run = _run()
    assert progtrace.clock_offset(run) == (OFFSET, 0)
    idle = progtrace.idle_by_layer(run)
    assert idle == {k: v * US for k, v in IDLE_US.items()}
    assert sum(idle.values()) == sum(e - s for s, e in run.trace.gaps())
    bench = harness.Bench()
    for name, layer in (("timing.idle_ms", "timing"), ("probe.idle_ms", "probe"),
                        ("validator.idle_ms", "validator"), ("timing.idle_ms.gate", "timing"),
                        ("probe.idle_ms.gate", "probe")):
        got = bench.reader("metrics", name).read(run)
        assert got == pytest.approx(IDLE_US[layer] / 1e3 / len(PASSES), abs=1e-12)
    check = (4_000 + 1_500) / 1e3 / len(PASSES)
    for name in ("probe.flash_check_ms", "probe.flash_check_ms.gate"):
        assert bench.reader("metrics", name).read(run) == pytest.approx(check, abs=1e-12)


def test_a_child_past_its_parent_is_cut_to_it():
    pieces = progtrace.innermost([("a", 0, 10), ("b", 2, 4), ("c", 4, 11), ("d", 12, 13)])
    assert pieces == [(0, 2, "a"), (2, 4, "b"), (4, 10, "c"), (12, 13, "d")]


@pytest.mark.parametrize("case", ["unmatched", "residual", "dropped", "nothing_on_card"])
def test_what_cannot_be_matched_reads_nothing(program, case):
    run = _run()
    if case == "unmatched":
        run = _run(traced_passes=run.trace.spans[:-1])
    elif case == "residual":
        run = _run(skews_ns=(0, 0, progtrace.RESIDUAL_NS + 1))
    elif case == "dropped":
        program["dropped"] = 3  # and the oldest kept record ends inside the window
    else:
        run.trace.device_ops = []
    assert progtrace.idle_by_layer(run) is None
    for name in ("timing.idle_ms", "probe.idle_ms", "validator.idle_ms"):
        assert harness.Bench().reader("metrics", name).read(run) is None


@pytest.mark.parametrize("late", [1, 2, 3])
def test_a_pass_or_two_late_on_the_host_in_three_hundred_still_match(late):
    # 300 passes 1 ms apart, the host's clock 5 us behind, ``late`` of them
    # read 0.5 ms late on the host: the quantile leaves out two, not three
    ms = 1_000_000
    skew = {i: ms // 2 for i in range(50, 50 + late)}
    host = [("pass", (i * ms + 5_000 + skew.get(i, 0)) / 1e9, ((i + 1) * ms) / 1e9) for i in range(300)]
    traced = [("pass", i * ms + OFFSET, (i + 1) * ms + OFFSET) for i in range(300)]
    run = SimpleNamespace(spans=host, trace=devtrace.Trace(spans=traced))
    assert progtrace.clock_offset(run) == (None if late > 2 else (OFFSET - 5_000, 0))


def test_a_ring_that_dropped_only_before_the_window_still_reads(program):
    tid = threading.get_ident() & 0xFFFF
    program["records"].insert(0, _record("rest.request", T0 - 2_000, T0 - 1_000, tid))
    program["dropped"] = 7
    assert progtrace.idle_by_layer(_run()) == {k: v * US for k, v in IDLE_US.items()}


def test_a_program_without_the_read_or_the_spans_reads_nothing(program, monkeypatch):
    run = _run()
    program["records"] = []
    assert progtrace.records(run) is None
    assert harness.Bench().reader("metrics", "probe.flash_check_ms").read(run) is None
    monkeypatch.setattr(progtrace, "snapshot", lambda: None)
    assert progtrace.idle_by_layer(run) is None


def test_cpu_traced_rehearsal_reads_the_flash_check_and_no_idle(tiny_bench):
    tiny_bench.spec["per_layer"] = [dict(m, workloads=["tiny.attn"])
                                    for m in tiny_bench.spec["per_layer"]]
    with_entries(tiny_bench, ["tiny.attn"])
    result = harness.run_cell(tiny_bench, "tiny.attn", 2**31 + 29, 0.3, True, "cpu", 0.0)
    assert result["correct"] is True
    assert result["metrics"]["probe.flash_check_ms"]["value"] > 0
    # nothing ran on a card, so no idle time is put down to a span
    assert not {"timing.idle_ms", "probe.idle_ms", "validator.idle_ms"} & set(result["metrics"])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["admission.chain", "admission.attn", "gate.shipped"])
def test_a_short_traced_run_reads_every_span_metric(card, cell, monkeypatch, record_property):
    runs = []
    window = harness.window

    def kept(run, seconds, traced):
        window(run, seconds, traced)
        runs.append(run)

    monkeypatch.setattr(harness, "window", kept)
    bench = with_entries(harness.Bench())
    result = harness.run_cell(bench, cell, 2**31 + 11, 2.0, True, "cuda", time.perf_counter())
    assert result["correct"] is True
    listed = {m["name"] for m in bench.metrics_of(cell, True)}
    assert listed >= {m["name"] for m in ENTRIES if cell in m["workloads"]}
    assert listed <= set(result["metrics"])
    offset, residual = progtrace.clock_offset(runs[0])
    assert residual <= progtrace.RESIDUAL_NS
    idle = progtrace.idle_by_layer(runs[0])
    record_property("alignment_residual_us", residual / US)
    record_property("idle_ms_by_layer", {str(k): v / 1e6 for k, v in idle.items()})
    print(cell, "residual_us", residual / US,
          {str(k): round(v / 1e6, 3) for k, v in idle.items()})
