"""Validation workloads: on one device the matmul chain, HBM bandwidth
probe and flash-attention probe; across a world of ranks (``mesh.py``) the
burn-in, ring, ring-attention, pipeline and MoE probes."""
