"""Entry point of the port's flagship compute path: the validator's bf16
matmul chain at size 1024, depth 2 (the counterpart of
``__graft_entry__.entry()``)."""

from __future__ import annotations

from typing import Optional

from tpu_operator_torch.workloads.matmul import make_matmul_step


def entry(device: Optional[str] = None):
    """``(fn, (a, b))``: call ``fn(a, b)`` to run the chain. On ``cuda``
    unless ``device`` says otherwise."""
    return make_matmul_step(size=1024, depth=2, device=device)
