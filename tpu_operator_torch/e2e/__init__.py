"""The port's end-to-end drivers, the counterparts of the reference's
``tests/scripts/http_e2e.py`` and ``tests/scripts/fake_e2e.py``.

``http_e2e`` drives the operator through the production ``RestClient``
against KubeSim over HTTP; ``fake_e2e`` drives it over the in-memory
``FakeClient`` and runs the validator's four parallelism probes. Each has
``main() -> int`` and runs as ``python -m tpu_operator_torch.e2e.<name>``.
They live in the package, not beside the reference's scripts, so the
port's analyser scans them with the rest of the port.
"""
