"""``kernel.k3_roofline`` in the gate's cells, where it moves ``gate_reading_s``:
read as ``metrics/kernel.k3_roofline.py`` reads it."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("kernel.k3_roofline.py"),
                   "benchmark_metrics_kernel_k3_roofline").read
