"""No module of JAX or of the JAX package in a run, by whole top-level name;
the references import nothing of the program; no card, no result."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent


@pytest.mark.parametrize("name, flagged", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("tpu_operator", ["tpu_operator"]),
    ("tpu_operator.workloads.flashattn", ["tpu_operator"]),
    ("tpu_operator_torch.workloads.flashattn", []), ("jaxtyping", []), ("flaxen", []),
    ("tpu_operator_x", []),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch, name, flagged):
    for loaded in list(sys.modules):
        if loaded.split(".")[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, loaded)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == flagged


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")) +
                         sorted((BENCH / "work").glob("*.py")), ids=lambda p: p.name)
def test_references_and_work_counts_import_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"tpu_operator_torch", "tpu_operator", "jax", "jaxlib", "flax"}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN_MODULES), path


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = ("from benchmark import harness\n"
            f"harness.run_cell(harness.Bench({str(tiny_root)!r}), 'tiny.chain', 3, 0.2, True, "
            "'cpu', 0.0)\n"
            "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=BENCH.parent, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_run_prints_no_result_and_fails_with_only_the_benchmark_and_no_card(tiny_root):
    # the copy holds BENCHMARK.json and the benchmark's folder alone
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "admission.attn",
                           "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tiny_root, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_run_refuses_to_print_when_a_forbidden_module_is_loaded(monkeypatch, capsys):
    import torch

    run_script = harness.load_module(BENCH / "run.py", "benchmark_run_script")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}, "correct": True})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run_script.main(["--workload", "admission.attn", "--seed", "1", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err
