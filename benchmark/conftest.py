"""Tests of the benchmark's harness.

Tests marked ``card`` need a CUDA card; their fixture decides whether one
is present and skips without it. Everything else runs on the CPU at a
tiny size through the same harness, with the plain versions the program
takes off the card.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny widths the CPU rehearsals run at: one configuration file added
# to a copy of the benchmark, as a later change would add one
TINY = {"cuda": {"size": 256}, "membw": {"size_mb": 16, "rows": 256},
        "flashattn": {"seq": 256, "heads": 2}}
TINY_CELLS = {"tiny.chain": "chain", "tiny.attn": "attn"}
TINY_GATE = {"flash": {"seq": 256, "heads": 2}, "matmul": {"size": 128}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where this process sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")


def add_tiny(root: Path) -> None:
    """Add the tiny configuration and its cells to the benchmark under ``root``."""
    cfg = json.loads((root / "benchmark/configs/h100-admission.json").read_text())
    cfg["name"] = "cpu-tiny"
    for name, widths in TINY.items():
        cfg["components"][name].update(widths)
    (root / "benchmark/configs/cpu-tiny.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cpu-tiny", "source": "tests", "reduced": [],
                            "file": "benchmark/configs/cpu-tiny.json", "why": "CPU rehearsal"})
    for cell, mix in TINY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": "cpu-tiny", "traffic": mix,
                                  "chips": 1, "why": "CPU rehearsal"})
    gate = json.loads((root / "benchmark/configs/h100-flash-gate.json").read_text())
    gate["name"] = "cpu-tiny-gate"
    for part, widths in TINY_GATE.items():
        gate["components"]["gate"][part].update(widths)
    (root / "benchmark/configs/cpu-tiny-gate.json").write_text(json.dumps(gate))
    spec["configs"].append({"name": "cpu-tiny-gate", "source": "tests", "reduced": [],
                            "file": "benchmark/configs/cpu-tiny-gate.json", "why": "CPU rehearsal"})
    spec["workloads"].append({"name": "tiny.gate", "config": "cpu-tiny-gate", "traffic": "gate",
                              "chips": 1, "why": "CPU rehearsal"})
    for m in spec["end_to_end"]:  # each tiny cell reports what its cell on the card does
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS) if "admission.chain" in m["workloads"] else ["tiny.gate"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the tiny configuration added."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_tiny(tmp_path)
    return tmp_path


@pytest.fixture
def tiny_bench(tiny_root):
    from benchmark import harness

    return harness.Bench(tiny_root)
