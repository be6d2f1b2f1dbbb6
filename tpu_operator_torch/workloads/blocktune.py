"""Block-size sweep for the flash-attention kernel on the card.

    python -m tpu_operator_torch.workloads.blocktune

Times K3 at the probe's shape (8 heads x 8192 x 128, causal) at each
(block_q, block_k) the kernel takes against the default 128/128, adjacent
in every rep (``timing.adjacent_ratio_stats``), and prints one JSON line:
per candidate the median wall-time ratio ``default/candidate`` (>1 means
the candidate is faster), its interquartile range, and the candidate's ms
and TFLOPS over the FLOPs it performs. Wall time is the comparison that
counts: a coarser tiling performs more masked work for the same attention.
"""

from __future__ import annotations

import json
import sys

import torch

from tpu_operator_torch.workloads import flashattn as fa
from tpu_operator_torch.workloads.timing import adjacent_ratio_stats, chain_per_iter_seconds

SEQ, HEADS, ITERS, REPS = 8192, 8, 16, 7
CANDIDATES = [(64, 64), (64, 128), (128, 64), (128, 256), (64, 256), (128, 512)]
DEFAULT = (fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP)


def main() -> int:
    if not torch.cuda.is_available():
        print("blocktune: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (
        torch.randn((HEADS, SEQ, fa.LANES), generator=gen, device=dev, dtype=torch.bfloat16)
        for _ in range(3)
    )

    def force(x):
        torch.cuda.synchronize(dev)
        return float(x[0, 0, :8].float().sum())

    def measure(blocks):
        bq, bk = blocks
        return chain_per_iter_seconds(
            lambda x: fa.flash_attention(x, k, v, bq, bk, True), q, force, ITERS
        )

    cands = {f"{bq}/{bk}": (bq, bk) for bq, bk in CANDIDATES}
    stats = adjacent_ratio_stats(measure, DEFAULT, cands, reps=REPS)
    out = {"seq": SEQ, "heads": HEADS, "default": "%d/%d" % DEFAULT,
           "device": torch.cuda.get_device_name(0), "candidates": {}}
    for name, (bq, bk) in [("%d/%d" % DEFAULT, DEFAULT), *cands.items()]:
        sec = measure((bq, bk))
        flops = fa.causal_flops(SEQ, HEADS, fa.LANES, bq, bk)
        entry = {"ms": sec * 1e3, "tflops_performed": flops / sec / 1e12}
        if name in stats:
            med, lo, hi, _ = stats[name]
            entry.update(ratio_median=med, ratio_iqr=[lo, hi])
        out["candidates"][name] = entry
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
