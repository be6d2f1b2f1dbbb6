"""Single-device validation workloads: matmul chain, HBM bandwidth probe,
flash-attention probe."""
