"""The window's wall seconds over the gate readings it completed: read as
``e2e/validation_s.py`` reads passes."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("validation_s.py"), "benchmark_e2e_validation_s").read
