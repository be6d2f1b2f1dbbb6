"""``device.idle`` in the gate's cells, where it moves ``gate_reading_s``:
read as ``metrics/device.idle.py`` reads it."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("device.idle.py"),
                   "benchmark_metrics_device_idle").read
