"""On the card, at each cell's own widths: the program passes its check on
three seeds and the control fails it on the same three; a short traced run
of each cell is correct, holds the entry's own K3 at its widths where it
runs K3, and reads the card's kernels. A cell that needs more cards than the
machine shows skips.

    python -m pytest benchmark/tests -q -m card
"""

import json
import time

import pytest

from benchmark import harness

pytestmark = pytest.mark.card
CELLS = [c["name"] for c in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _cards_for(bench, cell):
    import torch

    chips = bench.cell(cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards, {torch.cuda.device_count()} visible")


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_cells_widths(card, cell, tmp_path):
    bench = harness.Bench()
    _cards_for(bench, cell)
    run = harness.setup(bench, cell, "cuda", str(tmp_path), False)
    try:
        for seed in SEEDS:
            assert harness.is_correct(harness.check(run, seed)), seed
            assert not harness.is_correct(harness.check(run, seed, control=True)), seed
    finally:
        harness.stop_world(run)


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_is_correct_and_reads_the_kernels(card, cell):
    bench = harness.Bench()
    _cards_for(bench, cell)
    result = harness.run_cell(bench, cell, 2**31 + 7, 2.0, True, "cuda", time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["device"]["count"] == bench.cell(cell)["chips"]
    listed = {m["name"].removesuffix(".gate") for m in bench.metrics_of(cell, True)}
    metrics = {name.removesuffix(".gate"): m["value"] for name, m in result["metrics"].items()}
    if "kernel.k3_roofline" in listed:
        assert 0 < metrics["kernel.k3_roofline"] <= 105
    if "probe.k3_launches" in listed:
        assert metrics["probe.k3_launches"] > 0
    if "flash_off_widths" in result["checks"]:
        assert result["checks"]["flash_off_widths"]["value"] == 0
