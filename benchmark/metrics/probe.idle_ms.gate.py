"""``probe.idle_ms`` in the gate's cells, where it moves ``gate_reading_s``:
read as ``metrics/probe.idle_ms.py`` reads it."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("probe.idle_ms.py"),
                   "benchmark_metrics_probe_idle_ms").read
