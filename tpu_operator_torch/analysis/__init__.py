"""Project-native concurrency analysis, the port's copy of
``tpu_operator/analysis``.

Only the dynamic half is ported so far: ``lockwatch.py``, the opt-in
runtime watchdog that wraps ``threading.Lock``/``RLock`` creation,
records the per-thread lock acquisition-order graph plus
held-across-blocking events, detects order cycles that static nesting
cannot see, and flight-records violations through ``obs/flight.py``.
The port's chaos suites run under it (``GPU_LOCKWATCH=1``; the
bad-version soak always) and fail on any cycle.

The static half (the AST rule engine, its configuration, CLI and rule
catalog) is not ported yet, so this package exports nothing of it.

Layering note: nothing in ``tpu_operator_torch`` imports this package;
``lockwatch`` uses ``obs/`` and the write pipeline it watches.
"""
