"""Block-size sweep for the flash-attention kernel on the card.

    python -m tpu_operator_torch.workloads.blocktune

The port's counterpart of the JAX package's ``scripts/fa_walltune.py``: a
wall-time sweep against the default. Times K3 at the probe's shape (8
heads x 8192 x 128, causal, on the tensors of ``fa_common.setup``) at
each (block_q, block_k) the kernel takes against the default 128/128,
adjacent in every rep (``timing.adjacent_ratio_stats``), and prints one
JSON line: per candidate the median wall-time ratio ``default/candidate``
(>1 means the candidate is faster), its interquartile range, and the
candidate's ms and TFLOPS over the FLOPs it performs. Wall time is the
comparison that counts: a coarser tiling performs more masked work for
the same attention.
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
    out = {"seq": SEQ, "heads": HEADS, "default": default,
           "device": torch.cuda.get_device_name(0), "candidates": {}}
    for name, fn in fns.items():
        sec = measure(fn)
        flops = fa.causal_flops(SEQ, HEADS, fa.LANES, *blocks[name])
        entry = {"ms": sec * 1e3, "tflops_performed": flops / sec / 1e12}
        if name in stats:
            med, lo, hi, _ = stats[name]
            entry.update(ratio_median=med, ratio_iqr=[lo, hi])
        out["candidates"][name] = entry
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
