"""The port's end-to-end and fleet drivers, the counterparts of the
reference's ``tests/scripts/``:

* ``http_e2e`` (``tests/scripts/http_e2e.py``) drives the operator
  through the production ``RestClient`` against KubeSim over HTTP;
* ``fake_e2e`` (``tests/scripts/fake_e2e.py``) drives it over the
  in-memory ``FakeClient`` and runs the validator's four parallelism
  probes;
* ``fleet_converge`` (``tests/scripts/fleet_converge.py``) converges an
  N-node fleet against KubeSim with the whole operator and prints one
  JSON line: steady-state cost, warm restart, join storm, preemption,
  staged roll, churn storm, and sharded replicas with a leader kill;
* ``shard_replica`` (``tests/scripts/shard_replica.py``) is one sharded
  operator replica as a process, which ``fleet_converge --replicas``
  starts;
* ``alloc_churn`` (``tests/scripts/alloc_churn.py``) runs allocation
  churn through the device-plugin path beside convergence and a
  card-death wave, and prints one JSON line.

Each has ``main() -> int`` and runs as ``python -m
tpu_operator_torch.e2e.<name>``. They live in the package, not beside the
reference's scripts, so the port's analyser scans them with the rest of
the port.
"""
