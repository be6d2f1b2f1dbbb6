"""Observability: reconcile tracing and the flight recorder.

The port's copy of ``tpu_operator/obs/``'s ``trace`` and ``flight``: two
dependency-free primitives the API-server client stack threads through
its hot path (``trace.span``, ``flight.record``). Importing the package
wires completed spans into the flight recorder's ring. It imports nothing
else of ``tpu_operator_torch``, so every layer may instrument through it.
"""

from tpu_operator_torch.obs import flight, trace  # noqa: F401  (wires span sink)
from tpu_operator_torch.obs.trace import instant, span  # noqa: F401
