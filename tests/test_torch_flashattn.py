"""The port's flash attention against the JAX package's, on the CPU: the
plain version of the CUDA kernel against the interpreted Pallas kernel and
both oracles, also at the card's partial tilings against the reference's
own, and the tiling arithmetic (diag_stop, causal_flops, default blocks)
shape for shape."""

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


# (seq, heads, block_q, block_k, causal): the shapes of tests/test_flashattn.py,
# then the edges of K3's Hopper kernel: one warpgroup and a q-block with a
# single sub-tile (64/64), one warpgroup over two (64/128), eight sub-tiles
# per k-block so its ring wraps inside a block (128/512), and no mask
SHAPES = [
    (256, 2, 128, 128, True),
    (256, 2, 128, 128, False),
    (512, 1, 128, 256, True),
    (128, 1, 64, 64, True),
    (256, 2, 64, 128, True),
    (1024, 2, 128, 512, True),
    (1024, 2, 128, 128, False),
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


@pytest.mark.parametrize("variant", port.REFERENCE_VARIANTS)
def test_every_reference_variant_is_ported(variant):
    """The JAX package's five variants all build and run in the port."""
    assert variant in port.PORTED_VARIANTS
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(2, 256, seed=5))
    out = port.make_flash_fn(256, 2, 128, 128, 128, variant=variant)(q, k, v)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 256, 128)
    assert torch.isfinite(out.float()).all()


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown"):
        port.make_flash_fn(512, 2, 128, 128, 128, variant="nope")
    q = torch.zeros((1, 128, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown"):
        port.flash_attention(q, q, q, 64, 64, variant="nope")


def test_probe_cpu():
    res = port.run_flashattn_probe(seq=256, heads=2, device="cpu")
    assert res.ok, res.error
    assert res.max_err < 2e-2
    assert res.platform == "cpu" and res.tflops == 0.0  # numerics only off the card
    assert res.to_dict().keys() == ref.FlashAttnResult(True).to_dict().keys()
    # the tiling it ran, which the payload leaves out
    assert (res.block_q, res.block_k) == port.default_blocks(256, torch.device("cpu"))


@pytest.mark.parametrize("block_q,takes", [(32, False), (64, True), (128, True), (256, False)])
def test_k3_tiling_contract(block_q, takes):
    """K3 runs whole warpgroups of 64 query rows: block_q 64 or 128. The
    check runs before any CUDA call, so it is the same here as on the card."""
    if takes:
        port.check_kernel_tiling("flash_fwd", block_q, 128)
    else:
        with pytest.raises(ValueError, match="block_q 64 or 128"):
            port.check_kernel_tiling("flash_fwd", block_q, 128)


@pytest.mark.parametrize(
    "name", ["flash_fwd_pipelined", "flash_fwd_bf16exp", "flash_fwd_paired", "flash_fwd_bf16s",
             "flash_fwd_paired16"])
@pytest.mark.parametrize("block_q,takes", [(32, False), (64, True), (128, True), (256, False)])
def test_hopper_variants_take_k3s_tiling_contract(name, block_q, takes):
    """K4, K5, K7a, K7b and K7c run on K3's Hopper kernel, so they take its
    block_q 64 or 128, and block_k a multiple of 64."""
    if takes:
        port.check_kernel_tiling(name, block_q, 128)
    else:
        with pytest.raises(ValueError, match="block_q 64 or 128"):
            port.check_kernel_tiling(name, block_q, 128)
    with pytest.raises(ValueError):
        port.check_kernel_tiling(name, 128, 96)


SYNCHRONOUS_KERNELS = ("flash_softmax_stub", "flash_qk_only")


def test_synchronous_kernels_keep_their_tiling_contract():
    """K6a and K6b keep block_q a multiple of 16 up to 128; every kernel
    takes block_k a multiple of 64 only."""
    assert not set(SYNCHRONOUS_KERNELS) & set(port.WGMMA_KERNELS)
    assert set(SYNCHRONOUS_KERNELS) | set(port.WGMMA_KERNELS) == {
        name for name in _build.KERNELS if name.startswith("flash_")}
    port.check_kernel_tiling("flash_softmax_stub", 32, 128)
    port.check_kernel_tiling("flash_softmax_stub", 16, 64)
    port.check_kernel_tiling("flash_qk_only", 48, 128)
    for name, bq, bk in (("flash_softmax_stub", 144, 128), ("flash_fwd_paired", 24, 128),
                         ("flash_fwd", 128, 96), ("flash_qk_only", 64, 0)):
        with pytest.raises(ValueError):
            port.check_kernel_tiling(name, bq, bk)


# every multiple of 64 from 64 to 16384
CARD_SEQS = range(64, 16384 + 1, 64)


def test_card_blocks_pass_every_kernels_tiling_contract():
    """At every seq that is a multiple of 64, the card's default blocks
    tile seq and pass ``check_kernel_tiling`` for every flash kernel, the
    Hopper instances and the synchronous ones."""
    for seq in CARD_SEQS:
        bq, bk = port.card_blocks(seq)
        assert seq % bq == 0 and seq % bk == 0, seq
        assert bk <= port.BLOCK_K_CAP
        for name in port.WGMMA_KERNELS + SYNCHRONOUS_KERNELS:
            port.check_kernel_tiling(name, bq, bk)


def test_card_blocks_at_4160_and_their_refusal():
    """Seq 4160 (65 x 64), where the reference's rule gives 104/104, which
    no kernel takes, gets 64/64 on the card and keeps 104/104 on the CPU;
    seq 8192 keeps 128/128; seq 520 (not a multiple of 64, which the
    reference tiles 104/520) gets 128/128 with a partial last block; seq
    300, which the reference refuses, raises its must-tile error."""
    assert port.card_blocks(4160) == (64, 64)
    assert port.card_blocks(8192) == (port.BLOCK_Q_CAP, port.BLOCK_K_CAP) == (128, 128)
    assert port.default_blocks(4160, torch.device("cuda")) == (64, 64)
    assert port.default_blocks(4160, torch.device("cpu")) == (104, 104)
    assert port.default_blocks(4160, torch.device("cuda"), 128, 128) == (128, 128)
    assert port.card_blocks(520) == (128, 128)
    assert port.default_blocks(520, torch.device("cuda")) == (128, 128)
    assert port.default_blocks(520, torch.device("cpu")) == (104, 104)
    with pytest.raises(ValueError, match="must tile"):
        port.card_blocks(300)
    with pytest.raises(ValueError, match="must tile"):
        port.default_blocks(300, torch.device("cuda"))


def test_cpu_path_takes_any_tiling_the_reference_does():
    """The plain version is not bound by the kernels' contract: block_q 32
    runs on the CPU and agrees with 128."""
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(1, 128, seed=3))
    a = port.flash_attention(q, k, v, 32, 64)
    b = port.flash_attention(q, k, v, 128, 64)
    assert float((a.float() - b.float()).abs().max()) <= 1e-2


def test_plain_version_launches_nothing():
    _build.reset_launches()
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(1, 128, seed=1))
    port.flash_attention(q, k, v, 64, 64)
    assert _build.launches["flash_fwd"] == 0


def reference_takes(seq: int) -> bool:
    """Whether the reference's probe runs at ``seq``: its default blocks
    (``_default_block`` with caps 256/1024, held against the reference by
    ``test_default_block_agrees``) tile it."""
    bq, bk = port._default_block(seq, 256), port._default_block(seq, 1024)
    return seq % bq == 0 and seq % bk == 0


def test_card_blocks_take_every_seq_the_reference_takes():
    """From 8 to 16384: at every seq the reference's probe takes, the
    card's default blocks pass ``check_kernel_tiling`` for every flash
    kernel and ``check_tiling`` at that seq, and cover it with at most
    one partial block each; at every other seq (300 and 1031 among them)
    ``card_blocks`` raises the reference's must-tile error."""
    refused = []
    for seq in range(8, 16384 + 1):
        if not reference_takes(seq):
            refused.append(seq)
            with pytest.raises(ValueError, match="must tile"):
                port.card_blocks(seq)
            continue
        bq, bk = port.card_blocks(seq)
        port.check_tiling(seq, bq, bk)
        for name in port.WGMMA_KERNELS + SYNCHRONOUS_KERNELS:
            port.check_kernel_tiling(name, bq, bk)
        assert port.n_blocks(seq, bq) * bq - seq < bq and bq <= max(seq, 64), seq
    assert {300, 1031} <= set(refused) and 520 not in refused and 1000 not in refused


def test_tiling_follows_the_reference_probe():
    """``tiling_ok`` admits a partial last block exactly at the seqs the
    reference's probe takes, and every tiling that divides seq."""
    for seq in range(1, 4096 + 1):
        assert port.tiling_ok(seq, 128, 128) == (reference_takes(seq) or seq % 128 == 0), seq
    assert port.tiling_ok(8192, 128, 128) and port.tiling_ok(300, 100, 150)
    assert not port.tiling_ok(300, 128, 128) and not port.tiling_ok(1031, 64, 64)


# (seq, heads, causal) at seqs none of the card's blocks divide: the port's
# plain version at the card's tiling (card_blocks: 128/128, or 64/64 below
# 128), the JAX kernel at the reference's (_default_block, caps 256/1024)
PARTIAL_SEQS = [
    (520, 2, True),   # card 128/128, reference 104/520
    (1000, 1, True),  # card 128/128, reference 200/1000
    (100, 2, True),   # card 64/64, reference 100/100
    (72, 2, True),    # card 64/64, reference 72/72
    (200, 2, False),  # card 128/128, reference 200/200
]


@pytest.mark.parametrize("seq,heads,causal", PARTIAL_SEQS)
def test_partial_tiling_matches_jax(seq, heads, causal):
    """The card's partial tiling against the reference's own at the same
    seq: port against JAX max-abs <= 1e-2, each against the f32 oracle
    < 2e-2."""
    bq, bk = port.card_blocks(seq)
    rq, rk = port._default_block(seq, 256), port._default_block(seq, 1024)
    assert seq % bq or seq % bk  # a partial last block on the port's side
    q, k, v = bf16_qkv(heads, seq, seed=seq + 3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(
        ref.make_flash_fn(seq, heads, block_q=rq, block_k=rk, causal=causal,
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


# (variant, causal): a partial last block computed as the kernels compute it,
# on rows past seq filled with zeros; full attention only causal, where every
# zero key lies above a real row's diagonal (non-causal, the kernels mask it)
ZERO_FILL_CASES = [
    (variant, causal)
    for variant in port.REFERENCE_VARIANTS
    for causal in (True, False)
    if causal or variant in ("softmax_stub", "qk_only")
]


@pytest.mark.parametrize("variant,causal", ZERO_FILL_CASES)
def test_plain_partial_block_is_the_zero_filled_block(variant, causal):
    """The plain version's clipped last blocks at seq 200 (128/128) equal,
    on the first 200 rows, the same function over the inputs padded with
    zero rows to 256, whose blocks divide it: what the kernels compute by
    filling rows past seq with zeros."""
    seq, padded, heads = 200, 256, 2
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(heads, seq, seed=17))
    pad = [torch.nn.functional.pad(t, (0, 0, 0, padded - seq)) for t in (q, k, v)]
    got = port.flash_attention(q, k, v, 128, 128, causal, variant).float()
    want = port.flash_attention(*pad, 128, 128, causal, variant)[:, :seq].float()
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("seq,bq,bk,pairs", [
    (520, 128, 128, [1, 2, 3, 4, 5]),
    # diag_stop(4) = 10 k-blocks of 64 reach key 639; seq 520 has 9
    (520, 128, 64, [2, 4, 6, 8, 9]),
    (72, 64, 64, [1, 2]),
    (200, 64, 128, [1, 1, 2, 2]),
])
def test_causal_flops_count_the_partial_tiling(seq, bq, bk, pairs):
    """``causal_flops`` counts ceil(seq/block_q) q-blocks, each through
    ``diag_stop`` cut at the last k-block, whole blocks: what the kernels
    run."""
    assert [port.k_range(i, seq, bq, bk, True)[0] for i in range(port.n_blocks(seq, bq))] == pairs
    assert port.causal_flops(seq, 8, 128, bq, bk) == 4.0 * 8 * sum(pairs) * bq * bk * 128


def test_non_causal_partial_block_is_masked():
    """Non-causal, every k-block runs and only a partial last one takes
    the mask: n_full is the count of whole k-blocks."""
    assert port.k_range(0, 200, 64, 128, False) == (2, 1)
    assert port.k_range(3, 256, 64, 128, False) == (2, 2)
