"""PyTorch port of tpu-operator's single-device compute chain for one
NVIDIA H100 (sm_90a).

The validator's chain runs here as it does in ``tpu_operator``: the bf16
matmul chain (``workloads/matmul.py``), the HBM bandwidth probe
(``workloads/membw.py``) and the flash-attention probe
(``workloads/flashattn.py``), reached through ``validator/`` and the
``python -m tpu_operator_torch.validator`` CLI. The copy and attention
kernels are CUDA C++ under ``csrc/``, built at first use by ``_build.py``.

The package imports ``torch`` and never ``jax`` or ``tpu_operator``.
Entry points run on ``cuda`` unless the caller asks for the CPU, where each
kernel wrapper takes its plain PyTorch version.
"""
