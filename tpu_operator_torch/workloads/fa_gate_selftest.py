"""The flash gate's self-test on the card: a deliberately degraded probe
must trip it.

    python -m tpu_operator_torch.workloads.fa_gate_selftest

The counterpart of the JAX package's ``scripts/fa_gate_selftest.py``: runs
the shipped flash probe (K3) at ``fa_gate.DEGRADED_BLOCKS`` beside an
adjacent matmul, computes ``vs_matmul`` as the port's bench does
(``fa_gate.measure_vs_matmul``) and checks that ``flashattn_gate_ok``
fails it. Prints one line: the degraded and adjacent TFLOPS,
``vs_matmul``, the floor in force, ``gate_tripped`` and the launches of
the port's kernels in this process. Exit 0 only if the gate trips; 1 if
it does not, or a measurement failed; 2 with no GPU. There is no CPU
fallback.
"""

from __future__ import annotations

import json
import sys

import torch

from tpu_operator_torch import _build
from tpu_operator_torch.workloads import fa_gate


def main() -> int:
    if not torch.cuda.is_available():
        print("fa_gate_selftest: no CUDA device visible", file=sys.stderr)
        return 2
    bq, bk = fa_gate.DEGRADED_BLOCKS
    _build.reset_launches()
    r = fa_gate.measure_vs_matmul(bq, bk)
    launches = {name: n for name, n in _build.launches.items() if n}
    if r["vs_matmul"] is None:
        print(f"measurement failed: fa={r['fa_error']} mm={r['mm_error']}")
        return 1
    floor = fa_gate.gate_floor()
    tripped = not fa_gate.flashattn_gate_ok(r["vs_matmul"], True, floor)
    print(
        f"degraded {bq}/{bk}: fa={r['fa_tflops']:.1f} TFLOPS adjacent "
        f"mm={r['mm_tflops']:.1f} vs_matmul={r['vs_matmul']:.4f} "
        f"floor={floor} gate_tripped={tripped} launches={json.dumps(launches)}"
    )
    return 0 if tripped else 1


if __name__ == "__main__":
    sys.exit(main())
