"""One reader a per-layer metric: ``read(run) -> float or None``.

A reader that finds nothing to read returns ``None``, and the metric is
left out of the result; a share of a roofline is never returned as 0.
"""
