"""``probe.k3_launches`` in the gate's cells, where it moves ``gate_reading_s``:
read as ``metrics/probe.k3_launches.py`` reads it."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("probe.k3_launches.py"),
                   "benchmark_metrics_probe_k3_launches").read
