"""PyTorch port of tpu-operator's compute chain for NVIDIA H100 cards
(sm_90a).

The validator's chain runs here as it does in ``tpu_operator``: the bf16
matmul chain (``workloads/matmul.py``), the HBM bandwidth probe
(``workloads/membw.py``) and the flash-attention probe
(``workloads/flashattn.py``), reached through ``validator/`` and the
``python -m tpu_operator_torch.validator`` CLI. The copy and attention
kernels are CUDA C++ under ``csrc/``, built at first use by ``_build.py``.
The multi-device path (``entry.dryrun_multichip`` and the validator's
``slice``, ``ici``, ``ringattn``, ``pipeline`` and ``moe`` components) runs
a world of processes over ``torch.distributed`` (``workloads/mesh.py``):
NCCL, one card a rank, or gloo on the CPU; it launches none of the
package's kernels.

The package imports ``torch`` and never ``jax`` or ``tpu_operator``.
Entry points run on ``cuda`` unless the caller asks for the CPU, where each
kernel wrapper takes its plain PyTorch version.
"""
