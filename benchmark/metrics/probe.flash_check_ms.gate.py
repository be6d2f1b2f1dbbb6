"""``probe.flash_check_ms`` in the gate's cells, where it moves
``gate_reading_s`` (three probes a reading): read as
``metrics/probe.flash_check_ms.py`` reads it."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("probe.flash_check_ms.py"),
                   "benchmark_metrics_probe_flash_check_ms").read
