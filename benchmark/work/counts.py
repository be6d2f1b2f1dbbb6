"""Operations and bytes that the validator's kernels need, from their shapes.

A frozen copy of the arithmetic the rooflines use: each input byte is
counted read once and each output byte written once, whatever a kernel
reads again, and the causal triangle's operations are counted whatever
blocks a kernel computes.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

BF16_BYTES = 2
F32_BYTES = 4


def causal_attention_flops(heads: int, seq: int, head_dim: int) -> float:
    """Two products over the causal triangle: query ``i`` meets ``i + 1`` keys,
    ``4 * heads * head_dim * seq * (seq + 1) / 2``."""
    return 4.0 * heads * head_dim * seq * (seq + 1) / 2.0


def attention_bytes(heads: int, seq: int, head_dim: int) -> float:
    """q, k and v read once and o written once, in bf16."""
    return 4.0 * heads * seq * head_dim * BF16_BYTES


def copy_bytes(rows: int, lanes: int) -> float:
    """An f32 buffer read once and written once."""
    return 2.0 * rows * lanes * F32_BYTES


def matmul_chain_flops(size: int, depth: int) -> float:
    """``depth`` square products of ``size``."""
    return 2.0 * size**3 * depth


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the operations over
    its bf16 rate and the bytes over its memory bandwidth."""
    return max(flops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])


def peaks() -> dict:
    """The table of datasheet peaks, by the name ``torch.cuda.get_device_name`` gives."""
    return json.loads(PEAKS_FILE.read_text())["cards"]


def card_peak(kind: str):
    """The peaks of the card named ``kind``, or ``None`` for a card the table lacks."""
    return peaks().get(kind)
