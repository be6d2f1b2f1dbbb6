"""Observability: reconcile tracing, the flight recorder and log-once.

The port's copy of ``tpu_operator/obs/``'s ``trace``, ``flight`` and
``logonce``: dependency-free primitives the API-server client stack threads
through its hot path (``trace.span``, ``flight.record``), and the one
pruned-on-liveness log-once registry (``LogOnce``). Importing the package
wires completed spans into the flight recorder's ring. It imports nothing
else of ``tpu_operator_torch``, so every layer may instrument through it.
"""

from tpu_operator_torch.obs import flight, trace  # noqa: F401  (wires span sink)
from tpu_operator_torch.obs.logonce import LogOnce  # noqa: F401
from tpu_operator_torch.obs.trace import instant, span  # noqa: F401
