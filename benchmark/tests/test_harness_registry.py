"""Cells, configurations, mixes and metric readers are found by name, and a
later change's added files are taken without an edit to what is there."""

import hashlib
import json

import pytest

from benchmark import harness


def test_every_cell_names_files_that_load():
    bench = harness.Bench()
    for cell in bench.spec["workloads"]:
        cfg = bench.config(cell["config"])
        mix = bench.mix(cell["traffic"])
        for name in mix["components"]:
            assert name in cfg["components"]
            module = bench.component(name)
            for fn in ("prepare", "call", "numbers", "compare", "held"):
                assert callable(getattr(module, fn))
            assert module.BUILDERS
    for kind, entries in (("e2e", bench.spec["end_to_end"]), ("metrics", bench.spec["per_layer"])):
        for m in entries:
            assert callable(bench.reader(kind, m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    bench = harness.Bench()
    for cell in bench.spec["workloads"]:
        e2e = {m["name"] for m in bench.metrics_of(cell["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_of(cell["name"], trace=True)


def test_config_files_state_their_limits_for_every_number_compared():
    bench = harness.Bench()
    for entry in bench.spec["configs"]:
        cfg = bench.config(entry["name"])
        assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
        for w in cfg["components"].values():
            assert w["limits"]


def test_unknown_names_raise():
    bench = harness.Bench()
    with pytest.raises(KeyError):
        bench.cell("no.such.cell")
    with pytest.raises(KeyError):
        bench.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        bench.mix("no_such_mix")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_config_mix_and_metric_are_taken_without_edits(tiny_root):
    before = _digests(tiny_root)
    # a later change adds a configuration, a mix and a per-layer metric, as
    # files of their own, and entries in BENCHMARK.json
    cfg = json.loads((tiny_root / "benchmark/configs/cpu-tiny.json").read_text())
    cfg["name"] = "cpu-tiny-wide"
    cfg["components"]["flashattn"]["heads"] = 4
    (tiny_root / "benchmark/configs/cpu-tiny-wide.json").write_text(json.dumps(cfg))
    (tiny_root / "benchmark/mixes/attn_then_cuda.json").write_text(json.dumps(
        {"kind": "pass", "components": ["flashattn", "cuda"],
         "why": "added by a test"}))
    (tiny_root / "benchmark/metrics/probe.passes_counted.py").write_text(
        "def read(run):\n    return float(run.counters['passes'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cpu-tiny-wide", "source": "tests", "reduced": [],
                            "file": "benchmark/configs/cpu-tiny-wide.json", "why": "test"})
    spec["workloads"].append({"name": "tiny.added", "config": "cpu-tiny-wide",
                              "traffic": "attn_then_cuda", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "probe.passes_counted", "unit": "passes", "better": "higher",
                              "source": "program_counter", "layer": "probes",
                              "moves": "validation_s", "workloads": ["tiny.added"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(tiny_root)
    result = harness.run_cell(bench, "tiny.added", 7, 0.2, True, "cpu", 0.0)
    assert result["correct"] is True
    assert result["metrics"]["probe.passes_counted"]["value"] == result["attempted"]
    assert set(result["checks"]) >= {"attn_err", "mm_err"}
    after = _digests(tiny_root)
    assert {k: after[k] for k in before} == before  # nothing that was there changed
