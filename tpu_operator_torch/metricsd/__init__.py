"""The port's metrics daemon: ``python -m tpu_operator_torch.metricsd``."""
