"""The spans of the port's validator card path (``workloads/timing.py::span``
over ``obs/trace.py``), on the CPU at tiny widths.

Each entry the benchmark calls (``validate_cuda``, ``validate_membw``,
``validate_flashattn``, ``fa_gate.measure_vs_matmul``) records exactly its
spans, each under its parent, a probe's phases disjoint and in order. With
the tracer off and no profiler a span is the shared no-op handle, nothing
is buffered, and the payloads and status files are those of a traced call
but for their timings. A torch profiler turns the spans on for as long as
it records. A phase that raises leaves ``error`` on its span and the probe
still returns ``ok=False``. The validator CLI's ``--trace-out`` writes the
spans as Chrome trace-event JSON. No duration is compared.
"""

import ast
import json
import sys
from pathlib import Path

import pytest
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.obs import trace
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.validator import main as cli
from tpu_operator_torch.workloads import fa_gate, flashattn, matmul, membw, timing

SEQ, HEADS, SIZE = 64, 2, 64
MEMBW_SIZE_MB = 8  # validate_membw's own size off the card


@pytest.fixture
def tracer():
    """The port's tracer emptied, and left as it was found."""
    was = trace.TRACER.enabled
    trace.TRACER.disable()
    trace.TRACER.reset()
    yield trace.TRACER
    trace.TRACER.enabled = was
    trace.TRACER.reset()


@pytest.fixture
def tiny_gate(monkeypatch):
    monkeypatch.setattr(fa_gate, "SEQ", SEQ)
    monkeypatch.setattr(fa_gate, "HEADS", HEADS)
    monkeypatch.setattr(fa_gate, "MATMUL_SIZE", SIZE)


def rounds(iters):
    """The timed rounds of ``chain_per_iter_seconds``: the warm-up, then
    ``n`` = 0, ``iters`` and ``max(1, iters // 4)``."""
    lo = max(1, iters // 4)
    return [("timing.round", {"n": 1, "warm": True}), ("timing.round", {"n": 0}),
            ("timing.round", {"n": iters})] + ([("timing.round", {"n": lo})] if iters > lo else [])


# each entry on its CPU path: the call, and its spans as (name, parent, attrs)
# in start order, the parent by name ("" at the top)
MATMUL_SPANS = [("probe.matmul.inputs", {"size": SIZE}), ("probe.matmul.check", {"size": SIZE}),
                ("probe.matmul.chain", {"size": SIZE})]
FLASH_ATTRS = {"seq": SEQ, "heads": HEADS, "block_q": SEQ, "block_k": SEQ}
FLASH_SPANS = [(f"probe.flash.{phase}", FLASH_ATTRS) for phase in ("inputs", "build", "check")]
MEMBW_SPANS = [(f"probe.membw.{phase}", {"size_mb": MEMBW_SIZE_MB})
               for phase in ("inputs", "integrity", "copy", "stream")]


def _tree(top, top_attrs, phases, chains):
    """``top`` over ``phases``, each phase in ``chains`` over its timed rounds."""
    out = [(top, "", top_attrs)]
    for name, attrs in phases:
        out.append((name, top, attrs))
        out += [(r, name, a) for r, a in chains.get(name, [])]
    return out


ENTRIES = {
    "cuda": (lambda status: comp.validate_cuda(status, expect_gpu=False, size=SIZE),
             _tree("validator.cuda", {"size": SIZE}, MATMUL_SPANS,
                   {"probe.matmul.chain": rounds(10)})),
    "membw": (lambda status: comp.validate_membw(status, expect_gpu=False),
              _tree("validator.membw", {"size_mb": MEMBW_SIZE_MB}, MEMBW_SPANS,
                    {"probe.membw.copy": rounds(16), "probe.membw.stream": rounds(16)})),
    "flashattn": (lambda status: comp.validate_flashattn(status, seq=SEQ, heads=HEADS,
                                                         expect_gpu=False),
                  _tree("validator.flashattn", {"seq": SEQ, "heads": HEADS}, FLASH_SPANS, {})),
    "gate": (lambda status: fa_gate.measure_vs_matmul(device="cpu"),
             _tree("gate.reading", {"seq": SEQ, "heads": HEADS, "block_q": None, "block_k": None},
                   FLASH_SPANS * 3 + MATMUL_SPANS[:2] + [("probe.matmul.chain", {"size": SIZE})],
                   {"probe.matmul.chain": rounds(fa_gate.MATMUL_ITERS)})),
}
# the payload keys that are timings (or rates from them), per entry
TIMED = {
    "cuda": ("elapsed_s", "tflops", "utilization"),
    "membw": ("elapsed_s", "gbps", "copy_gbps", "stream_gbps", "utilization"),
    "flashattn": ("elapsed_s", "tflops", "tflops_effective"),
    "gate": ("fa_tflops", "fa_tflops_performed", "mm_tflops", "vs_matmul", "vs_matmul_performed"),
}
STATUS_FILES = {"cuda": consts.STATUS_FILE_CUDA, "membw": consts.STATUS_FILE_MEMBW,
                "flashattn": consts.STATUS_FILE_FLASHATTN}


def recorded():
    """The buffered complete spans in start order."""
    return sorted((r for r in trace.TRACER.snapshot().records if r["ph"] == "X"),
                  key=lambda r: (r["ts"], -r["dur"], r["id"]))


def as_tree(records):
    """``(name, parent name, attrs without the parent link)`` of each record."""
    by_id = {r["id"]: r["name"] for r in records}
    return [(r["name"], by_id.get(r["args"].get("parent"), ""),
             {k: v for k, v in r["args"].items() if k != "parent"}) for r in records]


def untimed(payload, entry):
    return {k: v for k, v in payload.items() if k not in TIMED[entry]}


def call(entry, tmp_path):
    status = comp.StatusFiles(str(tmp_path))
    payload = ENTRIES[entry][0](status)
    name = STATUS_FILES.get(entry)
    written = json.loads(Path(status.path(name)).read_text()) if name else None
    return payload, written


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_each_entry_records_its_spans_under_their_parents(tracer, tiny_gate, tmp_path, entry):
    tracer.enable()
    call(entry, tmp_path)
    records = recorded()
    assert as_tree(records) == ENTRIES[entry][1]
    assert all("error" not in r["args"] for r in records)
    # siblings are disjoint and in order, and each child lies in its parent
    by_parent = {}
    for r in records:
        by_parent.setdefault(r["args"].get("parent", 0), []).append(r)
    by_id = {r["id"]: r for r in records}
    for parent, children in by_parent.items():
        for a, b in zip(children, children[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        if parent:
            p = by_id[parent]
            assert all(p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1
                       for c in children)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_off_the_spans_are_the_noop_and_change_no_payload(tracer, tiny_gate, tmp_path, entry):
    tracer.enable()
    traced, traced_file = call(entry, tmp_path / "on")
    tracer.disable()
    tracer.reset()
    assert timing.span("probe.flash.check", seq=SEQ) is trace.NOOP
    plain, plain_file = call(entry, tmp_path / "off")
    assert trace.TRACER.snapshot() == (trace.TRACER.snapshot().base_ns, [], 0)
    assert trace.TRACER.spans_total == 0
    assert untimed(plain, entry) == untimed(traced, entry)
    if traced_file is not None:
        assert untimed(plain_file, entry) == untimed(traced_file, entry)


def test_a_torch_profiler_turns_the_spans_on_while_it_records(tracer, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert not tracer.enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.span("timing.round", n=0) is not trace.NOOP
        call("flashattn", tmp_path)
    assert [name for name, _, _ in as_tree(recorded())] == [n for n, _, _ in ENTRIES["flashattn"][1]]
    tracer.reset()
    assert timing.span("timing.round", n=0) is trace.NOOP
    call("flashattn", tmp_path)
    assert recorded() == []


def _break_matmul_inputs(monkeypatch):
    def broken(**_):
        raise RuntimeError("no card memory")

    monkeypatch.setattr(matmul, "make_matmul_step", broken)
    return lambda: matmul.run_matmul_validation(size=SIZE, device="cpu")


def _break_membw_integrity(monkeypatch):
    monkeypatch.setattr(membw, "make_copy_fn", lambda rows, block_rows: lambda x: x + 1.0)
    return lambda: membw.run_membw_probe(size_mb=MEMBW_SIZE_MB, device="cpu")


def _break_flash_build(monkeypatch):
    def broken(*_, **__):
        raise ValueError("seq must tile")

    monkeypatch.setattr(flashattn, "make_flash_fn", broken)
    return lambda: flashattn.run_flashattn_probe(seq=SEQ, heads=HEADS, device="cpu")


def _break_flash_check(monkeypatch):
    monkeypatch.setattr(flashattn, "reference_attention",
                        lambda q, k, v, causal: torch.ones_like(q, dtype=torch.float32) * 9)
    return lambda: flashattn.run_flashattn_probe(seq=SEQ, heads=HEADS, device="cpu")


# the fault, the phase it raises in, the exception, the phases before it
FAULTS = {
    "matmul_inputs": (_break_matmul_inputs, "probe.matmul.inputs", "RuntimeError", []),
    "membw_integrity": (_break_membw_integrity, "probe.membw.integrity", "RuntimeError",
                        ["probe.membw.inputs"]),
    "flash_build": (_break_flash_build, "probe.flash.build", "ValueError",
                    ["probe.flash.inputs"]),
    "flash_check": (_break_flash_check, "probe.flash.check", "RuntimeError",
                    ["probe.flash.inputs", "probe.flash.build"]),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_phase_that_raises_leaves_its_error_and_the_probe_fails_as_before(
        tracer, monkeypatch, fault):
    breaker, phase, error, before = FAULTS[fault]
    probe = breaker(monkeypatch)
    tracer.enable()
    result = probe()
    assert result.ok is False and result.error
    records = recorded()
    assert [r["name"] for r in records] == before + [phase]
    assert records[-1]["args"]["error"] == error
    assert all("error" not in r["args"] for r in records[:-1])


@pytest.mark.parametrize("fails", [False, True], ids=["passes", "fails"])
def test_validator_cli_writes_the_spans_it_ran(tracer, monkeypatch, tmp_path, fails):
    if fails:
        _break_flash_check(monkeypatch)
    out = tmp_path / "spans.json"
    rc = cli.main(["--component", "flashattn", "--allow-cpu", "--flashattn-seq", str(SEQ),
                   "--flashattn-heads", str(HEADS), "--output-dir", str(tmp_path / "status"),
                   "--trace-out", str(out)])
    assert rc == (1 if fails else 0)
    events = json.loads(out.read_text())["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: (e["ts"], -e["dur"]))]
    want = [n for n, _, _ in ENTRIES["flashattn"][1]]
    assert names == want
    assert [("error" in e["args"]) for e in events if e["name"] == "probe.flash.check"] == [fails]


def test_the_tracer_imports_only_the_standard_library():
    source = Path(trace.__file__).read_text()
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops and tops <= set(sys.stdlib_module_names) | {"__future__"}


def test_snapshot_gives_the_time_base_and_what_the_ring_dropped():
    import time

    t = trace.Tracer(capacity=64)
    before = time.monotonic_ns()
    for i in range(70):
        with t.span("probe.flash.check", i=i):
            pass
    after = time.monotonic_ns()
    snap = t.snapshot()
    assert snap.dropped == 6 and len(snap.records) == 64
    assert [r["args"]["i"] for r in snap.records] == list(range(6, 70))
    starts = [snap.base_ns + 1000 * r["ts"] for r in snap.records]
    assert before - 1000 <= starts[0] <= starts[-1] <= after
