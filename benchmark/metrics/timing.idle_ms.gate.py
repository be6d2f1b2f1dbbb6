"""``timing.idle_ms`` in the gate's cells, where it moves ``gate_reading_s``:
read as ``metrics/timing.idle_ms.py`` reads it."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("timing.idle_ms.py"),
                   "benchmark_metrics_timing_idle_ms").read
