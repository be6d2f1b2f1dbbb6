"""The 90th percentile (nearest rank) of the wall seconds of every gate
reading in the window: read as ``e2e/validation_p90_s.py`` reads passes."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("validation_p90_s.py"),
                   "benchmark_e2e_validation_p90_s").read
