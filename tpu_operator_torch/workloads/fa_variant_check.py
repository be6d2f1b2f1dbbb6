"""Drift-cancelled ``full`` against ``pipelined`` (K3 against K4).

    python -m tpu_operator_torch.workloads.fa_variant_check

The counterpart of the JAX package's ``scripts/fa_variant_check.py``, at
the port's default blocks 128/128 in place of the TPU's 256/1024:
``fa_experiment.run_experiment`` with the one candidate ``pipelined`` and
9 reps. Both kernels' ``max_err`` against the f32 oracle on the tensors of
``fa_common.setup`` (8 heads x 8192 x 128, causal; ``shipped`` is
``full``), then the median and interquartile range of 9 adjacent
wall-time ratios ``full/pipelined`` (>1 means ``pipelined`` is faster).
Both run on the Hopper kernel, K4 with the next S product on the tensor
cores while the current softmax runs, so the ratio reads what that
overlap buys over K3's serial loop. A single-shot comparison of two
variants on a card whose clocks wander is noise; this comparator is what
decides. Prints the card's name, then one JSON line.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

from tpu_operator_torch.device import device_kind, resolve_device
from tpu_operator_torch.workloads import fa_common
from tpu_operator_torch.workloads.fa_experiment import run_experiment

REPS, ITERS = 9, 32


def run_variant_check(
    seq: int = fa_common.SEQ, heads: int = fa_common.HEADS, device: Optional[str] = None
) -> dict:
    """``run_experiment(["pipelined"], reps=9)``: on the CPU the plain
    versions give the numerics only; on ``cuda`` unless ``device`` says
    otherwise; without a GPU the default raises."""
    return run_experiment(["pipelined"], seq, heads, reps=REPS, iters=ITERS, device=device)


def main() -> int:
    print(device_kind(resolve_device()), flush=True)
    print(json.dumps(run_variant_check()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
