"""On the card, at each cell's own widths: the program passes its check on
three seeds and the control fails it on the same three; a short traced run
of each cell is correct, holds the entry's own K3 at its widths, and reads
the card's kernels.

    python -m pytest benchmark/tests -q -m card
"""

import json
import time

import pytest

from benchmark import harness

pytestmark = pytest.mark.card
CELLS = [c["name"] for c in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_the_cells_widths(card, cell, tmp_path):
    run = harness.setup(harness.Bench(), cell, "cuda", str(tmp_path), False)
    for seed in SEEDS:
        assert harness.is_correct(harness.check(run, seed)), seed
        assert not harness.is_correct(harness.check(run, seed, control=True)), seed


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_traced_run_is_correct_and_reads_the_kernels(card, cell):
    result = harness.run_cell(harness.Bench(), cell, 2**31 + 7, 2.0, True, "cuda",
                              time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    metrics = {name.removesuffix(".gate"): m["value"] for name, m in result["metrics"].items()}
    assert 0 < metrics["kernel.k3_roofline"] <= 105
    assert metrics["probe.k3_launches"] > 0
    assert result["checks"]["flash_off_widths"]["value"] == 0
