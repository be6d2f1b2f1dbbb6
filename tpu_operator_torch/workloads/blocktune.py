"""Block-size sweep for the flash-attention kernel on the card.

    python -m tpu_operator_torch.workloads.blocktune

The port's counterpart of the JAX package's ``scripts/fa_walltune.py``: a
wall-time sweep against the default. Times K3 at the probe's shape (8
heads x 8192 x 128, causal, on the tensors of ``fa_common.setup``) at
each (block_q, block_k) the kernel takes against the default 128/128,
adjacent in every rep (``timing.adjacent_ratio_stats``), and prints one
JSON line: per candidate the median wall-time ratio ``default/candidate``
(>1 means the candidate is faster), its interquartile range, the
candidate's ms and TFLOPS over the FLOPs it performs, and, from a second
sweep, the median and interquartile range of the per-performed-FLOP ratio
the reference's ``scripts/fa_blocktune.py`` reads (``per_flop_transform``).

CAUTION: the per-performed-FLOP ratio rewards tilings that do more
masked-region work (a coarse k-block performs more FLOPs for the same
attention). Wall time is the comparison that counts; the other is kept
beside it as the measured demonstration of that trap.
"""

from __future__ import annotations

import json
import sys

import torch

from tpu_operator_torch.workloads import fa_common
from tpu_operator_torch.workloads import flashattn as fa
from tpu_operator_torch.workloads.timing import adjacent_ratio_stats

SEQ, HEADS, ITERS, REPS = 8192, 8, 16, 7
CANDIDATES = [(64, 64), (64, 128), (128, 64), (128, 256), (64, 256), (128, 512)]
DEFAULT = (fa.BLOCK_Q_CAP, fa.BLOCK_K_CAP)


def per_flop_transform(seq: int, heads: int, blocks: dict, default: tuple):
    """``adjacent_ratio_stats``'s ``transform`` for the per-performed-FLOP
    ratio: the candidate's performed FLOPs a second over the default's
    (``scripts/fa_blocktune.py:33-38``). ``blocks`` maps a candidate's key
    to its ``(block_q, block_k)``."""
    base_flops = fa.causal_flops(seq, heads, fa.LANES, *default)

    def ratio(key, base_s: float, cand_s: float) -> float:
        return (fa.causal_flops(seq, heads, fa.LANES, *blocks[key]) / cand_s) / (base_flops / base_s)

    return ratio


def main() -> int:
    if not torch.cuda.is_available():
        print("blocktune: no CUDA device visible", file=sys.stderr)
        return 2
    q, k, v, _ = fa_common.setup(SEQ, HEADS, fa.LANES, with_ref=False)
    measure = fa_common.make_measure(q, k, v, ITERS)
    blocks = {"%d/%d" % b: b for b in [DEFAULT, *CANDIDATES]}
    fns = {name: fa.make_flash_fn(SEQ, HEADS, fa.LANES, *b) for name, b in blocks.items()}
    default = "%d/%d" % DEFAULT
    cands = {name: fn for name, fn in fns.items() if name != default}
    stats = adjacent_ratio_stats(measure, fns[default], cands, reps=REPS)
    per_flop = adjacent_ratio_stats(
        measure, fns[default], cands, reps=REPS,
        transform=per_flop_transform(SEQ, HEADS, blocks, DEFAULT),
    )
    out = {"seq": SEQ, "heads": HEADS, "default": default,
           "device": torch.cuda.get_device_name(0), "candidates": {}}
    for name, fn in fns.items():
        sec = measure(fn)
        flops = fa.causal_flops(SEQ, HEADS, fa.LANES, *blocks[name])
        entry = {"ms": sec * 1e3, "tflops_performed": flops / sec / 1e12}
        if name in stats:
            med, lo, hi, _ = stats[name]
            entry.update(ratio_median=med, ratio_iqr=[lo, hi])
            med, lo, hi, _ = per_flop[name]
            entry.update(perflop_ratio_median=med, perflop_ratio_iqr=[lo, hi])
        out["candidates"][name] = entry
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
