"""Structural-variant instrument for the flash-attention kernel (K7).

    python -m tpu_operator_torch.workloads.fa_experiment [paired bf16s paired16]

The counterpart of the JAX package's ``scripts/fa_experiment.py``: candidate
structures of the causal flash kernel, each measured against the shipped
kernel (K3, ``flashattn.make_flash_fn``) with the drift-cancelled
adjacent-ratio comparator (``timing.adjacent_ratio_stats``), on the tensors
of ``fa_common.setup``. The modes, each a kernel in ``csrc/flash.cu``:

* ``paired`` (K7a): K3's function, bit for bit, on K3's Hopper kernel
  (TMA ring, ``wgmma``) with K7c's pair loop: two 64-key sub-tiles a
  body, the second S product on the tensor cores while the first
  softmax runs. Its ratio reads pairing alone on K3's structure.
* ``bf16s`` (K7b): the scores rounded to bf16 once and the whole softmax
  run at half width (the reference's ``scores_b``/``soft_b``). It runs on
  K3's Hopper kernel with K3's loop (``block_q`` 64 or 128), so its ratio
  reads the half-width softmax alone on K3's structure.
* ``paired16`` (K7c): both; K7b's function, bit for bit. It runs on K3's
  Hopper kernel with two S sets in flight, so its ratio reads pairing and
  the half-width softmax on K3's own structure.

``experiment_flash`` takes a mode's plain version only for CPU tensors
(``flashattn.plain_flash``, with ``bf16s=True`` for the two half-width
modes); for CUDA tensors it launches the mode's kernel or raises. It
takes the tilings ``flashattn`` takes (a partial last block at a ``seq``
the reference's probe takes); ``build``, as the reference instrument's
own, takes only tilings that divide ``seq``. The
reference's 512/2048 blocks are TPU VMEM tiles; the port runs at its own
default 128/128. Seq 8192, 8 heads and head_dim 128 are the reference's.
Prints the card's name, then one JSON line: each candidate's ``max_err``
against the f32 oracle and each mode's median wall-time ratio
``shipped/mode`` with its interquartile range (>1 means the mode is
faster).
"""

from __future__ import annotations

import json
import sys
from typing import Optional

from tpu_operator_torch.device import device_kind, resolve_device
from tpu_operator_torch.workloads import fa_common
from tpu_operator_torch.workloads import flashattn as fa
from tpu_operator_torch.workloads.timing import adjacent_ratio_stats

# mode -> its kernel: the launch counter in _build.launches and the C entry
MODE_KERNELS = {
    "paired": "flash_fwd_paired",
    "bf16s": "flash_fwd_bf16s",
    "paired16": "flash_fwd_paired16",
}
MODES = tuple(MODE_KERNELS)
DEFAULT_MODES = ("paired", "bf16s")  # the reference's when none is named


def plain_mode(q, k, v, block_q: int, block_k: int, mode: str):
    """``mode``'s plain version, causal: ``paired`` computes K3's function,
    ``bf16s`` and ``paired16`` the reference's ``soft_b`` recurrence
    (``flashattn.plain_flash(..., bf16s=True)``)."""
    return fa.plain_flash(q, k, v, block_q, block_k, causal=True, bf16s=mode != "paired")


def _check_mode(mode: str, candidates=MODES) -> None:
    if mode not in candidates:
        raise ValueError(f"unknown experiment mode {mode!r}; the modes are {candidates}")


def experiment_flash(q, k, v, block_q: int, block_k: int, mode: str):
    """Causal attention over ``(H, S, 128)`` bf16 on the logical
    ``(block_q, block_k)`` tiling, by ``mode``'s kernel (K7a-c)."""
    _check_mode(mode)
    fa._check_qkv(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return plain_mode(q, k, v, block_q, block_k, mode)
    name = MODE_KERNELS[mode]
    return fa._launch(name, name, (q, k, v), block_q, block_k, causal=True)


def build(
    mode: str,
    seq: int,
    heads: int,
    head_dim: int = fa.LANES,
    block_q: int = fa.BLOCK_Q_CAP,
    block_k: int = fa.BLOCK_K_CAP,
):
    """``fn(q, k, v) -> out``, ``mode``'s causal attention over
    ``(heads, seq, head_dim)`` bf16."""
    _check_mode(mode)
    if seq % block_q or seq % block_k:
        raise ValueError(f"seq={seq} must tile by {block_q}/{block_k}")

    def flash(q, k, v):
        if tuple(q.shape) != (heads, seq, head_dim):
            raise ValueError(f"{mode} built for {(heads, seq, head_dim)}, got {tuple(q.shape)}")
        return experiment_flash(q, k, v, block_q, block_k, mode)

    return flash


def run_experiment(
    modes=DEFAULT_MODES,
    seq: int = fa_common.SEQ,
    heads: int = fa_common.HEADS,
    block_q: int = fa.BLOCK_Q_CAP,
    block_k: int = fa.BLOCK_K_CAP,
    reps: int = 7,
    iters: int = 32,
    device: Optional[str] = None,
) -> dict:
    """``max_err`` against the f32 oracle of ``"shipped"`` (K3) and of
    each candidate, and on the card each candidate's ``wall_speedup``
    against K3: the median and interquartile range of ``reps`` adjacent
    ratios ``shipped/candidate`` (>1 means the candidate is faster). A
    candidate is a mode of ``MODES`` or a variant of
    ``flashattn.make_flash_fn`` (``fa_variant_check`` runs ``pipelined``).
    On the CPU the plain versions give the numerics only. On ``cuda``
    unless ``device`` says otherwise; without a GPU the default raises."""
    for mode in modes:
        _check_mode(mode, MODES + fa.REFERENCE_VARIANTS)
    dev = resolve_device(device)
    q, k, v, ref = fa_common.setup(seq, heads, fa.LANES, device=dev)
    shipped = fa.make_flash_fn(seq, heads, fa.LANES, block_q, block_k, causal=True)
    cands = {
        mode: build(mode, seq, heads, fa.LANES, block_q, block_k) if mode in MODES
        else fa.make_flash_fn(seq, heads, fa.LANES, block_q, block_k, causal=True, variant=mode)
        for mode in modes
    }
    errs = {"shipped": fa_common.max_err(shipped, q, k, v, ref)}
    errs.update((mode, fa_common.max_err(fn, q, k, v, ref)) for mode, fn in cands.items())
    del ref
    out = {
        "device": device_kind(dev), "seq": seq, "heads": heads, "head_dim": fa.LANES,
        "block_q": block_q, "block_k": block_k, "max_err": errs,
    }
    if dev.type == "cuda":
        measure = fa_common.make_measure(q, k, v, iters)
        stats = adjacent_ratio_stats(measure, shipped, cands, reps=reps)
        out["wall_speedup"] = fa_common.ratio_summary(stats)
    return out


def main() -> int:
    print(device_kind(resolve_device()), flush=True)
    print(json.dumps(run_experiment(sys.argv[1:] or DEFAULT_MODES)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
