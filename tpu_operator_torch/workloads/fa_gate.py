"""The flash-attention regression gate and one measurement of its ratio.

    python -m tpu_operator_torch.workloads.fa_gate [BQ/BK ...]

``vs_matmul`` is the flash probe's rate (K3 at 8 heads x 8192 x 128,
causal) over the ``tflops`` of a matmul chain measured right after it on
the same card. The card's state (clocks, power, neighbours) moves both
rates together, so the ratio moves when the kernel does; a kernel
regression pulls it under ``FLASHATTN_VS_MATMUL_FLOOR`` and
``flashattn_gate_ok`` fails. This is the port's counterpart of the JAX
package's bench gate (``bench.py:57-70``, ``:100-111``); the port's bench
imports it from here.

``measure_vs_matmul`` computes one reading as the reference's gate
self-test does (``scripts/fa_gate_selftest.py:17-28``): the best of
``PROBE_RUNS`` ``ok`` probes over one adjacent
``run_matmul_validation(size=8192, depth=8, iters=4)``, the reference's
denominator. A failed probe or matmul gives ``vs_matmul``
``None``, never 0.0. One adaptation to the card: the numerator is the
probe's ``tflops_effective`` (the causal triangle's FLOPs a second, the
same for every tiling), not its ``tflops`` (FLOPs performed, masked
blocks included). The Hopper kernel stages 64-key sub-tiles whatever the
blocks, so every pair it takes (64/64 to 64/8192) runs at 0.91-1.05x the
shipped rate per performed FLOP, and the matmul chain reads 677-832
TFLOPS from run to run: on the reference's numerator the two populations
overlap at every pair, with one matmul or the best of three (PERF.md
§6). What a tiling or a lost causal skip costs is masked work, which only
the effective rate sees. ``vs_matmul_performed``, the reference's ratio,
is kept beside it for the record. The rule for a card whose populations
overlap was to change only the denominator; the best of three matmul
chains did not part them either (PERF.md §6), so the numerator changed
instead, and the denominator is the reference's.

What the gate catches: a reading trips when the kernel's rate per
effective FLOP falls under ``floor / HEALTHY_LOWEST`` = 0.809 of its
healthy rate. So a K3 that does the same work 19.1% slower (23.6% more
time) trips it in the lowest healthy window recorded, and one 26.0%
slower (the floor over the highest healthy reading, 0.4716) in every
one; a smaller loss passes. A tiling or a lost causal skip that adds
masked work at the same rate counts in full: 64/8192 computes the whole
square of scores and reads 0.56x the healthy ratio.

The floor sits at the midpoint between two populations measured on the
card named by ``POPULATION_CARD`` at ``POPULATION_POWER_LIMIT``, each
reading from a separate process on a fresh machine (PERF.md §6): the
healthy runs at the shipped blocks (``flashattn.card_blocks(8192)``,
128/128), whose lowest ``vs_matmul`` is ``HEALTHY_LOWEST``, and the
degraded runs at ``DEGRADED_BLOCKS``, a whole-seq ``block_k`` that
computes the full square of scores, whose highest is
``DEGRADED_HIGHEST``. ``BENCH_FLASHATTN_VS_MATMUL_FLOOR`` overrides the
floor; it is read each time the floor is used.

With block pairs as arguments the module prints the card's name and power
limit, then one JSON line with a reading at each pair: the instrument the
populations were taken with.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Optional

from tpu_operator_torch.workloads.flashattn import card_blocks, run_flashattn_probe
from tpu_operator_torch.workloads.matmul import run_matmul_validation
from tpu_operator_torch.workloads.timing import span

FLOOR_ENV = "BENCH_FLASHATTN_VS_MATMUL_FLOOR"

SEQ, HEADS = 8192, 8  # the probe's operating point (bench.py)
MATMUL_SIZE, MATMUL_DEPTH, MATMUL_ITERS = 8192, 8, 4
PROBE_RUNS = 3  # probes a reading takes the best of

# the populations the floor was set from (PERF.md §6)
POPULATION_CARD = "NVIDIA H100 80GB HBM3"
POPULATION_POWER_LIMIT = "700.00 W"
SHIPPED_BLOCKS = card_blocks(SEQ)
DEGRADED_BLOCKS = (64, SEQ)
HEALTHY_LOWEST = 0.4317154735989049  # of 0.4317-0.4716, five runs
DEGRADED_HIGHEST = 0.26661541021448737  # of 0.2418-0.2666, five runs
FLASHATTN_VS_MATMUL_FLOOR = (HEALTHY_LOWEST + DEGRADED_HIGHEST) / 2


def gate_floor() -> float:
    """The floor in force: ``BENCH_FLASHATTN_VS_MATMUL_FLOOR`` where it is
    set, else ``FLASHATTN_VS_MATMUL_FLOOR``."""
    return float(os.environ.get(FLOOR_ENV, FLASHATTN_VS_MATMUL_FLOOR))


def flashattn_gate_ok(ratio, on_card: bool, floor: Optional[float] = None) -> bool:
    """On the card the ratio must exist (a failed probe or matmul is a
    failed measurement, not a pass) and reach the floor; off the card
    there is no hardware ratio to gate."""
    if not on_card:
        return True
    if floor is None:
        floor = gate_floor()
    return ratio is not None and ratio >= floor


def measure_vs_matmul(block_q: Optional[int] = None, block_k: Optional[int] = None,
                      device: Optional[str] = None) -> dict:
    """One reading: the best of ``PROBE_RUNS`` flash probes at
    ``(block_q, block_k)`` (the card's default blocks where not given) by
    effective rate, over one matmul chain measured after them. Returns the blocks the
    probes ran, the rates (``fa_tflops`` the best probe's effective rate,
    ``fa_tflops_performed`` its performed one), ``vs_matmul`` and
    ``vs_matmul_performed`` (``None`` where a probe or the matmul failed)
    and the best probe's and the matmul's errors."""
    with span("gate.reading", seq=SEQ, heads=HEADS, block_q=block_q, block_k=block_k):
        runs = [run_flashattn_probe(seq=SEQ, heads=HEADS, block_q=block_q, block_k=block_k,
                                    device=device)
                for _ in range(PROBE_RUNS)]
        fa = max(runs, key=lambda r: r.tflops_effective if r.ok else -1.0)
        mm = run_matmul_validation(size=MATMUL_SIZE, depth=MATMUL_DEPTH, iters=MATMUL_ITERS,
                                   device=device)
    ok = fa.ok and mm.ok and bool(mm.tflops)
    return {
        "block_q": fa.block_q if fa.ok else block_q,
        "block_k": fa.block_k if fa.ok else block_k,
        "fa_tflops": fa.tflops_effective if fa.ok else None,
        "fa_tflops_performed": fa.tflops if fa.ok else None,
        "mm_tflops": mm.tflops if mm.ok else None,
        "vs_matmul": fa.tflops_effective / mm.tflops if ok else None,
        "vs_matmul_performed": fa.tflops / mm.tflops if ok else None,
        "fa_error": fa.error,
        "mm_error": mm.error,
    }


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one a line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("fa_gate: no CUDA device visible", file=sys.stderr)
        return 2
    pairs = [tuple(int(b) for b in arg.split("/")) for arg in argv] or [SHIPPED_BLOCKS, DEGRADED_BLOCKS]
    print(card_line(), flush=True)
    readings = [measure_vs_matmul(*pair) for pair in pairs]
    floor = gate_floor()
    for r in readings:
        r["gate_ok"] = flashattn_gate_ok(r["vs_matmul"], True, floor)
    print(json.dumps({"seq": SEQ, "heads": HEADS, "floor": floor,
                      "readings": readings}), flush=True)
    return 0 if all(r["vs_matmul"] is not None for r in readings) else 1


if __name__ == "__main__":
    sys.exit(main())
