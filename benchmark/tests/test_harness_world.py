"""A cell on more than one card: the harness's world (``world.py``).

On the CPU a four-rank cell runs on gloo, in a copy of the benchmark to
which ``add_world`` adds the cell, its configuration, its mix and the
test-only component ``world_ring`` (an ``all_reduce`` and a ring step a
pass): the line counts every rank, takes each number's largest over the
ranks, and a rank that raises, dies or hangs fails the run, named, within
the bound, with no process and no rendezvous left. A cell on one card
starts no world. On the card (``-m card``), the same on every card the
machine shows, with 256 MiB buffers over NCCL.
"""

import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(__file__).resolve().parent
CELL = "test.world"
MIB = 2**20
# test-only per-layer readers of every rank's trace, added as later changes add one
READERS = {
    "world.ranks_traced": "def read(run):\n"
                          "    return float(sum(t.window_s > 0 for t in run.rank_traces)) "
                          "if run.rank_traces else None\n",
    "world.nccl_ranks": "import re\n\nNCCL = re.compile('nccl', re.I)\n\n\n"
                        "def read(run):\n"
                        "    return float(sum(t.mean_seconds(NCCL) is not None "
                        "for t in run.rank_traces)) if run.rank_traces else None\n",
}


def add_world(root: Path, chips: int, readers=("world.ranks_traced",), **widths) -> None:
    """Add the cell ``test.world`` on ``chips`` ranks to the benchmark under
    ``root``: ``world_ring`` at ``widths`` (1 MiB buffers by default), and
    the per-layer ``readers`` of ``READERS``."""
    shutil.copy(HERE / "world_ring.py", root / "benchmark/components/world_ring.py")
    (root / "benchmark/mixes/world.json").write_text(json.dumps(
        {"kind": "pass", "components": ["world_ring"], "why": "the harness's world, tested"}))
    ring = {"mib": 1, "last_rank_only": 0.5,
            "limits": {"allreduce_gap": 0, "ring_gap": 0, "seeded_gap": 0, "rank": chips - 1,
                       "last_rank_only": 1.0}}
    ring.update(widths)
    cfg = {"name": "world-test", "chips": chips, "reduced": [], "components": {"world_ring": ring}}
    (root / "benchmark/configs/world-test.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # a second call replaces what the first added
    spec["configs"] = [c for c in spec["configs"] if c["name"] != "world-test"]
    spec["workloads"] = [c for c in spec["workloads"] if c["name"] != CELL]
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] not in READERS]
    spec["configs"].append({"name": "world-test", "source": "tests", "reduced": [],
                            "file": "benchmark/configs/world-test.json", "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "world-test", "traffic": "world",
                              "chips": chips, "why": "tests"})
    for m in spec["end_to_end"]:
        if "admission.chain" in m.get("workloads", []) and CELL not in m["workloads"]:
            m["workloads"].append(CELL)
    for name in readers:
        (root / "benchmark/metrics" / f"{name}.py").write_text(READERS[name])
        spec["per_layer"].append({"name": name, "unit": "ranks", "better": "higher",
                                  "source": "device_trace", "layer": "world",
                                  "moves": "validation_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def runs(tmp_path, monkeypatch):
    """The temporary directory the runs make theirs in."""
    where = tmp_path / "runs"
    where.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(where))
    return where


def nothing_left(runs: Path) -> None:
    assert multiprocessing.active_children() == []
    assert list(runs.glob("bench-status-*")) == []  # no status files and no rendezvous


def run_world(root: Path, trace: bool = False, device: str = "cpu", seconds: float = 1.0):
    return harness.run_cell(harness.Bench(root), CELL, 2**31 + 41, seconds, trace, device,
                            time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_a_four_rank_cell_counts_every_rank(tiny_root, runs, trace):
    add_world(tiny_root, 4, ballast={"rank": 2, "mib": 64})
    result = run_world(tiny_root, trace)
    dev = result["device"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert dev["count"] == 4 and len(dev["memory_peak_bytes_by_rank"]) == 4
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_rank"])
    assert dev["memory_peak_bytes_by_rank"][2] >= 64 * MIB
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert checks["rank"] == 3  # the largest over the ranks
    assert checks["last_rank_only"] == 0.5  # given by the last rank alone
    assert checks["allreduce_gap"] == checks["ring_gap"] == checks["seeded_gap"] == 0
    assert result["setup_parts"]["world"] > 0
    if trace:
        assert result["metrics"]["world.ranks_traced"]["value"] == 4
        assert 0 <= dev["busy_s"] <= dev["window_s"]
    else:
        assert {"validation_s", "setup_s"} <= set(result["metrics"])
    nothing_left(runs)


@pytest.mark.parametrize("kind, call, says", [("raise", 1, "failed:\nTraceback"),
                                              ("raise", 3, "failed:\nTraceback"),
                                              ("die", 3, "died")])
def test_a_rank_that_raises_or_dies_fails_the_run_by_name(tiny_root, runs, kind, call, says):
    add_world(tiny_root, 4, fault={"rank": 3, "call": call, "kind": kind})
    t0 = time.monotonic()
    with pytest.raises(harness.WorldError) as failed:
        run_world(tiny_root)
    assert time.monotonic() - t0 < 60
    assert f"rank 3 of 4 {says}" in str(failed.value)
    if kind == "raise":
        assert f"planted fault on rank 3, call {call}" in str(failed.value)
    nothing_left(runs)


def test_a_rank_that_hangs_fails_within_the_bound(tiny_root, runs, monkeypatch):
    from benchmark import world

    monkeypatch.setattr(world, "ANSWER_S", 6)
    add_world(tiny_root, 4, fault={"rank": 3, "call": 3, "kind": "hang"})
    t0 = time.monotonic()
    with pytest.raises(harness.WorldError) as failed:
        run_world(tiny_root)
    # set-up, two passes, the bound, the others' grace and the kill
    assert time.monotonic() - t0 < world.ANSWER_S + 30
    message = str(failed.value)
    assert "rank 3 failed first" in message and "rank 3 of 4 no answer to 'call 0 True'" in message
    nothing_left(runs)


def test_a_helper_that_loads_a_forbidden_module_fails_the_run(tiny_root, runs):
    add_world(tiny_root, 4, forbidden={"rank": 2})
    with pytest.raises(harness.ForbiddenModules, match="rank 2: jax"):
        run_world(tiny_root)
    nothing_left(runs)


def test_run_exits_3_when_a_helper_loaded_a_forbidden_module(monkeypatch, capsys):
    import torch

    run_script = harness.load_module(harness.HERE / "run.py", "benchmark_run_script_world")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def loaded(*a, **k):
        raise harness.ForbiddenModules("rank 2: jax")

    monkeypatch.setattr(harness, "run_cell", loaded)
    assert run_script.main(["--workload", "admission.attn", "--seed", "1", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "rank 2: jax" in err


def test_a_one_card_cell_starts_no_world(tiny_root):
    code = ("import multiprocessing, sys\n"
            "import torch.distributed as dist\n"
            "from benchmark import harness\n"
            f"r = harness.run_cell(harness.Bench({str(tiny_root)!r}), 'tiny.chain', 3, 0.2, True, "
            "'cpu', 0.0)\n"
            "print(r['device']['count'], 'memory_peak_bytes_by_rank' in r['device'], "
            "'benchmark.world' in sys.modules, dist.is_initialized(), "
            "len(multiprocessing.active_children()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=harness.ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "False", "False", "False", "0"]


def _marked(mark: str) -> list:
    """Processes whose environment holds ``mark``."""
    found = []
    for environ in Path("/proc").glob("[0-9]*/environ"):
        try:
            if mark.encode() in environ.read_bytes():
                found.append(environ.parent.name)
        except OSError:
            pass
    return found


@pytest.mark.card
def test_a_world_on_every_card(card, tiny_root, runs):
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"{n} CUDA card visible; a world needs two or more")
    add_world(tiny_root, n, readers=("world.ranks_traced", "world.nccl_ranks"), mib=256)
    result = run_world(tiny_root, trace=True, device="cuda", seconds=2.0)
    dev = result["device"]
    assert result["correct"] is True and result["failed"] == 0
    assert dev["count"] == n and dev["kind"] == torch.cuda.get_device_name(0)
    assert result["metrics"]["world.nccl_ranks"]["value"] == n  # an NCCL kernel on every card
    assert all(peak >= 256 * MIB for peak in dev["memory_peak_bytes_by_rank"])
    nothing_left(runs)

    # a rank that raises in the warm pass (the others' collectives left in
    # flight) or mid-window (rank 0 held in its own): the run ends non-zero,
    # names the rank with its traceback, and leaves nothing
    for call in (1, 3):
        add_world(tiny_root, n, mib=256, fault={"rank": n - 1, "call": call, "kind": "raise"})
        mark = uuid.uuid4().hex
        code = ("from benchmark import harness\n"
                f"harness.emit(harness.run_cell(harness.Bench({str(tiny_root)!r}), {CELL!r}, 7, "
                "2.0, False, 'cuda', 0.0))\n")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=harness.ROOT, timeout=600,
                              env={**os.environ, "BENCH_WORLD_TEST": mark})
        assert proc.returncode != 0, call
        assert not re.search(r"^\{", proc.stdout, re.M), call  # no result line
        assert f"rank {n - 1} of {n} failed:\nTraceback" in proc.stderr, call
        assert f"planted fault on rank {n - 1}, call {call}" in proc.stderr, call
        time.sleep(2.0)
        assert _marked(f"BENCH_WORLD_TEST={mark}") == [], call
