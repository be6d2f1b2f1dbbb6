"""The port's flash attention against the JAX package's, on the CPU: the
plain version of the CUDA kernel against the interpreted Pallas kernel and
both oracles, and the tiling arithmetic (diag_stop, causal_flops, default
blocks) shape for shape."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_operator.workloads import flashattn as ref
from tpu_operator_torch import _build, convert
from tpu_operator_torch.workloads import flashattn as port


def bf16_qkv(heads, seq, seed, dim=128):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((heads, seq, dim), dtype=np.float32).astype(jnp.bfloat16)
        for _ in range(3)
    ]


# (seq, heads, block_q, block_k, causal): the shapes of tests/test_flashattn.py
SHAPES = [
    (256, 2, 128, 128, True),
    (256, 2, 128, 128, False),
    (512, 1, 128, 256, True),
]


@pytest.mark.parametrize("seq,heads,bq,bk,causal", SHAPES)
def test_plain_matches_jax_kernel(seq, heads, bq, bk, causal):
    """Port against JAX: max-abs <= 1e-2 in f32 (both round an f32 result
    to bf16 and p to bf16 before PV, with sums taken in another order).
    Each side against the f32 oracle: < 2e-2, the reference's tolerance."""
    q, k, v = bf16_qkv(heads, seq, seed=seq + heads)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(
        ref.make_flash_fn(seq, heads, block_q=bq, block_k=bk, causal=causal,
                          interpret=True)(jq, jk, jv)
    ).astype(np.float32)
    tq, tk, tv = (convert.to_torch(a) for a in (q, k, v))
    out = port.make_flash_fn(seq, heads, block_q=bq, block_k=bk, causal=causal)(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (heads, seq, 128)
    got = convert.to_numpy(out, jnp.bfloat16).astype(np.float32)
    oracle = np.asarray(ref.reference_attention(jq, jk, jv, causal))
    assert float(np.abs(got - want).max()) <= 1e-2
    assert float(np.abs(got - oracle).max()) < 2e-2
    assert float(np.abs(want - oracle).max()) < 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    """Both compute in f32 from the same bf16 values: <= 1e-5."""
    q, k, v = bf16_qkv(2, 128, seed=7)
    want = np.asarray(
        ref.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    )
    got = port.reference_attention(
        convert.to_torch(q), convert.to_torch(k), convert.to_torch(v), causal
    ).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5


TILINGS = [
    (seq, bq, bk)
    for seq in (256, 512, 1536, 2048, 8192)
    for bq, bk in ((64, 64), (128, 128), (128, 256), (256, 128), (256, 1024))
    if seq % bq == 0 and seq % bk == 0
]


@pytest.mark.parametrize("seq,bq,bk", TILINGS)
def test_tiling_arithmetic_agrees(seq, bq, bk):
    for i in range(seq // bq):
        assert port.diag_stop(i, bq, bk) == ref.diag_stop(i, bq, bk)
    assert port.causal_flops(seq, 8, 128, bq, bk) == ref.causal_flops(seq, 8, 128, bq, bk)


# 251, 257 and 1031 are prime; 728 = 8*7*13
DEFAULT_BLOCK_SEQS = [8, 24, 251, 257, 728, 1031, 1536, 2048, 8192]


@pytest.mark.parametrize("seq", DEFAULT_BLOCK_SEQS)
def test_default_block_agrees(seq, monkeypatch):
    """The port's ``_default_block`` picks what the reference's probe picks
    for its own caps (256/1024), read by intercepting its make_flash_fn."""
    captured = {}

    class Stop(Exception):
        pass

    def spy(seq_, heads, head_dim, block_q, block_k, *a, **kw):
        captured["blocks"] = (block_q, block_k)
        raise Stop()

    monkeypatch.setattr(ref, "make_flash_fn", spy)
    res = ref.run_flashattn_probe(seq=seq, heads=1)
    assert not res.ok and "blocks" in captured
    assert (port._default_block(seq, 256), port._default_block(seq, 1024)) == captured["blocks"]


def test_default_blocks_at_the_operating_point():
    """The port's caps at seq 8192: 128/128, shapes the kernel takes. A
    prime seq at or below the cap gets one whole-seq block."""
    assert port._default_block(8192, port.BLOCK_Q_CAP) == 128
    assert port._default_block(8192, port.BLOCK_K_CAP) == 128
    assert port._default_block(127, port.BLOCK_Q_CAP) == 127


def test_non_tiling_seq_raises():
    with pytest.raises(ValueError):
        port.make_flash_fn(300, 2, block_q=128, block_k=128)
    q = torch.zeros((2, 300, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        port.flash_attention(q, q, q, 128, 128)


@pytest.mark.parametrize("variant", ["pipelined", "bf16exp", "softmax_stub", "qk_only"])
def test_unported_variants_raise(variant):
    with pytest.raises(ValueError, match="not ported yet"):
        port.make_flash_fn(512, 2, 128, 128, 128, variant=variant)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown"):
        port.make_flash_fn(512, 2, 128, 128, 128, variant="nope")


def test_probe_cpu():
    res = port.run_flashattn_probe(seq=256, heads=2, device="cpu")
    assert res.ok, res.error
    assert res.max_err < 2e-2
    assert res.platform == "cpu" and res.tflops == 0.0  # numerics only off the card
    assert res.to_dict().keys() == ref.FlashAttnResult(True).to_dict().keys()


def test_plain_version_launches_nothing():
    _build.reset_launches()
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(1, 128, seed=1))
    port.flash_attention(q, k, v, 64, 64)
    assert _build.launches["flash_fwd"] == 0
