"""Project-native concurrency & contract analysis, the port's copy of
``tpu_operator/analysis``, in its two halves:

* **static** (``python -m tpu_operator_torch.analysis``): the
  dependency-free AST rule engine (``engine.py``) running the rule
  catalog under ``rules/`` (layering, guarded-by, lock-order,
  lock-blocking, frozen-view, metrics-fed) over ``tpu_operator_torch/``
  and ``chip_smoke.py``, with deterministic ``path:line: [rule] message``
  findings, per-line suppression comments (``# lint: ignore[rule-id]``),
  and a committed baseline (``analysis/baseline.json``, empty: the port's
  tree is clean) so the gate bites only on NEW findings. Configuration:
  the defaults in ``config.py``, or a ``[tool.gpu_analysis]`` section in
  the scanned root's ``pyproject.toml``;
* **dynamic** (``lockwatch.py``): the opt-in runtime watchdog that wraps
  ``threading.Lock``/``RLock`` creation, records the per-thread lock
  acquisition-order graph plus held-across-blocking events, detects
  order cycles that static nesting cannot see, and flight-records
  violations through ``obs/flight.py``. The port's chaos suites run under
  it (``GPU_LOCKWATCH=1``; the bad-version soak always) and fail on any
  cycle.

Layering note: nothing in ``tpu_operator_torch`` imports this package;
the static half imports only the stdlib, and ``lockwatch`` uses ``obs/``
and the write pipeline it watches.
"""

from tpu_operator_torch.analysis.engine import (  # noqa: F401
    Finding,
    load_baseline,
    run_analysis,
    write_baseline,
)
