"""The port's flash-attention variants against the JAX package's, on the
CPU: the plain versions of K4 (``pipelined``), K5 (``bf16exp``), K6a
(``softmax_stub``) and K6b (``qk_only``) against the interpreted Pallas
kernels on the same numpy inputs, and the breakdown's reading and
attribution arithmetic against the reference's formulas."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_flashattn import bf16_qkv
from tpu_operator.workloads import flashattn as ref
from tpu_operator_torch import _build, convert
from tpu_operator_torch.workloads import flashattn as port


def run_both(variant, seq, heads, bq, bk, causal, seed):
    """(port output, JAX output, f32 oracle) as f32 numpy arrays."""
    q, k, v = bf16_qkv(heads, seq, seed=seed)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(
        ref.make_flash_fn(seq, heads, block_q=bq, block_k=bk, causal=causal,
                          interpret=True, variant=variant)(jq, jk, jv)
    ).astype(np.float32)
    tq, tk, tv = (convert.to_torch(a) for a in (q, k, v))
    out = port.make_flash_fn(seq, heads, block_q=bq, block_k=bk, causal=causal,
                             variant=variant)(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (heads, seq, 128)
    got = convert.to_numpy(out, jnp.bfloat16).astype(np.float32)
    oracle = np.asarray(ref.reference_attention(jq, jk, jv, causal))
    return got, want, oracle


# (variant, seq, heads, block_q, block_k, causal): the reference tests'
# shapes for the two variants that compute attention
ATTENTION_CASES = [
    ("pipelined", 512, 2, 128, 128, True),
    ("pipelined", 1024, 2, 256, 512, True),
    ("bf16exp", 512, 2, 128, 128, True),
    ("bf16exp", 512, 2, 128, 128, False),
    ("bf16exp", 512, 1, 128, 256, True),
]


@pytest.mark.parametrize("variant,seq,heads,bq,bk,causal", ATTENTION_CASES)
def test_attention_variant_matches_jax(variant, seq, heads, bq, bk, causal):
    """Port against JAX: max-abs <= 1e-2 (both round p and the output to
    bf16, sums in another order). Each side against the f32 oracle: < 2e-2,
    the reference's tolerance."""
    got, want, oracle = run_both(variant, seq, heads, bq, bk, causal, seed=seq + heads + bk)
    assert float(np.abs(got - want).max()) <= 1e-2
    assert float(np.abs(got - oracle).max()) < 2e-2
    assert float(np.abs(want - oracle).max()) < 2e-2


# (seq, heads, block_q, block_k, causal): the edges of the Hopper kernel K5
# runs on the card, K3's edge tilings: one warpgroup and a q-block with a
# single sub-tile (64/64), one warpgroup over two (64/128), eight sub-tiles
# per k-block so the ring wraps inside a block (128/512), and no mask
BF16EXP_EDGE_SHAPES = [
    (128, 1, 64, 64, True),
    (256, 2, 64, 128, True),
    (1024, 2, 128, 512, True),
    (1024, 2, 128, 128, False),
]


@pytest.mark.parametrize("seq,heads,bq,bk,causal", BF16EXP_EDGE_SHAPES)
def test_bf16exp_matches_jax_at_the_hopper_edges(seq, heads, bq, bk, causal):
    """Port against JAX: max-abs <= 1e-2, or one bf16 ulp of the
    reference's output (at most 2^-7 of it) where that is more. Both round
    p to bf16 after their own exp and the output to bf16, so a value near a
    rounding midpoint may land one ulp apart; at seq 128 the first rows
    average two or three keys and keep |output| above 2, where one ulp is
    1.56e-2. Each side against the f32 oracle: < 2e-2."""
    got, want, oracle = run_both("bf16exp", seq, heads, bq, bk, causal, seed=seq + heads + bk)
    assert (np.abs(got - want) <= np.maximum(1e-2, 2.0**-7 * np.abs(want))).all()
    assert float(np.abs(got - oracle).max()) < 2e-2
    assert float(np.abs(want - oracle).max()) < 2e-2


def test_pipelined_plain_is_full():
    """``pipelined`` computes the same function as ``full``: the port has
    one plain version for both, so the outputs are equal bit for bit."""
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(2, 512, seed=3))
    full = port.flash_attention(q, k, v, 128, 256, True)
    assert torch.equal(port.flash_attention(q, k, v, 128, 256, True, "pipelined"), full)


STUB_SHAPES = [
    (512, 2, 128, 128, True),
    (512, 2, 128, 128, False),
    (512, 1, 128, 256, True),
    (512, 1, 128, 256, False),
]
# the stubs run on the Hopper kernel too, so their plain versions, which
# the card holds them against, are held against Pallas at its edges:
# BF16EXP_EDGE_SHAPES (one warpgroup, the ring wrapping inside a k-block
# where K6b discards parts 2-7, no mask); K6b where block_k >= head_dim
STUB_EDGE_SHAPES = BF16EXP_EDGE_SHAPES
QK_ONLY_EDGE_SHAPES = [s for s in STUB_EDGE_SHAPES if s[3] >= 128]


@pytest.mark.parametrize("seq,heads,bq,bk,causal", STUB_SHAPES + STUB_EDGE_SHAPES)
def test_softmax_stub_matches_jax(seq, heads, bq, bk, causal):
    """Independent q, k and v. Max-abs <= 1e-2: the same bf16((s*scale)*
    0.001) products summed in f32, in another order."""
    got, want, _ = run_both("softmax_stub", seq, heads, bq, bk, causal, seed=seq + bk + 1)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-2


@pytest.mark.parametrize("seq,heads,bq,bk,causal", STUB_SHAPES + QK_ONLY_EDGE_SHAPES)
def test_qk_only_matches_jax(seq, heads, bq, bk, causal):
    """Independent q, k (the reference test's q, q, q would make the
    diagonal scores ~11 and hide an offset). The f32 sums agree to a few
    f32 ulps; rounding them to bf16 may then differ by one bf16 ulp, at
    most 2^-7 of the value, plus 1e-3 for values near 0."""
    got, want, _ = run_both("qk_only", seq, heads, bq, bk, causal, seed=seq + bk + 2)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-3).all()


def test_qk_only_needs_a_block_of_head_dim_keys():
    q = torch.zeros((1, 256, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="qk_only"):
        port.flash_attention(q, q, q, 64, 64, True, "qk_only")


@pytest.mark.parametrize("variant", ["pipelined", "bf16exp", "softmax_stub", "qk_only"])
def test_plain_variants_launch_nothing(variant):
    """The ``full`` case is test_torch_flashattn's test_plain_version_launches_nothing."""
    _build.reset_launches()
    q, k, v = (convert.to_torch(a) for a in bf16_qkv(1, 256, seed=4))
    port.flash_attention(q, k, v, 128, 128, True, variant)
    assert _build.launches == {name: 0 for name in _build.KERNELS}


def test_every_variant_has_its_own_counter():
    names = [name for name, _ in port.VARIANT_KERNELS.values()]
    assert sorted(port.VARIANT_KERNELS) == sorted(port.REFERENCE_VARIANTS)
    assert len(set(names)) == len(names) and set(names) <= set(_build.KERNELS)


# --- the breakdown's arithmetic, against the reference's inline formulas
# (tpu_operator/workloads/flashattn.py, run_flashattn_breakdown)

def reference_pick(readings, flops, peak):
    """The reference's choice over a finished list of readings."""
    def plausible(per_iter):
        return peak is None or flops / per_iter / 1e12 <= peak * 1.05

    sane = [r for r in readings if plausible(r)]
    return (min(sane) if sane else max(readings)), not sane


FLOPS = 1.4e11  # about the causal tiling's FLOPs at 8 x 8192
PEAK = 989.0  # H100 SXM bf16 TFLOPS
# per-iteration seconds; FLOPS / 1e-4 s = 1400 TFLOPS is above 1.05 x PEAK
PICK_CASES = {
    "all_plausible": [1.3e-3, 1.2e-3],
    # 1009 TFLOPS: above the peak but within its 1.05 margin, so it counts
    "near_peak": [1.2e-3, FLOPS / 1009e12],
    "one_implausible": [1.0e-4, 1.25e-3, 1.3e-3],
    "all_implausible": [0.9e-4, 1.0e-4, 1.1e-4, 1.2e-4],
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_reading_follows_the_reference(case):
    readings = PICK_CASES[case]
    per_iter, implausible = port._pick_reading(readings, FLOPS, PEAK)
    assert (per_iter, implausible) == reference_pick(readings, FLOPS, PEAK)
    assert implausible == (case == "all_implausible")
    if case == "all_implausible":
        assert per_iter == max(readings)  # the slowest reading is taken
    # with no known peak every reading counts
    assert port._pick_reading(readings, FLOPS, None) == (min(readings), False)


def test_attribution_follows_the_reference():
    variants = {
        "full": {"per_pair_us": 0.07762},
        "pipelined": {"per_pair_us": 0.07597},
        "softmax_stub": {"per_pair_us": 0.07128},
        "qk_only": {"per_pair_us": 0.04856},
    }
    t_full, t_pipe, t_stub, t_qk = (
        variants[n]["per_pair_us"] for n in ("full", "pipelined", "softmax_stub", "qk_only")
    )
    got = port._attribution(variants)
    assert got == {
        "matmuls_us": t_stub,
        "softmax_added_us": round(t_full - t_stub, port.PAIR_US_DIGITS),
        "softmax_fraction_of_full": round(max(0.0, t_full - t_stub) / t_full, 4),
        "pv_added_us": round(t_stub - t_qk, port.PAIR_US_DIGITS),
        "pipeline_recovered_us": round(t_full - t_pipe, port.PAIR_US_DIGITS),
    }
    # a softmax that costs nothing never reads as a negative fraction
    variants["softmax_stub"]["per_pair_us"] = 0.08
    assert port._attribution(variants)["softmax_fraction_of_full"] == 0.0


def test_breakdown_requires_gpu():
    """The counterpart of the reference's test_breakdown_requires_tpu."""
    out = port.run_flashattn_breakdown(seq=512, heads=2, device="cpu")
    assert out["ok"] is False
    assert "GPU" in out.get("error", "")
    assert {k: out[k] for k in ("seq", "heads", "block_q", "block_k")} == {
        "seq": 512, "heads": 2, "block_q": 128, "block_k": 128,
    }


def test_bf16exp_probe_cpu():
    """The probe passes ``variant`` through to the plain K5 on the CPU."""
    res = port.run_flashattn_probe(seq=256, heads=2, device="cpu", variant="bf16exp")
    assert res.ok, res.error
    assert res.max_err < 2e-2
