"""Scheduling-churn engine — allocation traffic through the device-plugin path.

The port's copy of ``tpu_operator/schedsim``: sustained foreground
*allocation* traffic (short-lived pods requesting ``nvidia.com/gpu``
cards) driven through the real device-plugin admission sequence, with
gang admission for multi-host slice jobs, NVLink-aware placement scoring,
and fleet fragmentation accounting over the cards' NVLink domains.

Layout:

* ``registry``  — fleet-wide card ledger (double-allocation detection,
  leak accounting, fragmentation math);
* ``gang``      — bounded hold-and-release gang admission coordinator;
* ``engine``    — the load generator: per-host agents over real plugin
  servicers, placement scoring, latency percentiles, reaper (it needs
  grpc, through ``kube/kubelet_sim.py``).
"""

from tpu_operator_torch.schedsim.registry import (  # noqa: F401
    AllocationRegistry,
    DoubleAllocationError,
)
