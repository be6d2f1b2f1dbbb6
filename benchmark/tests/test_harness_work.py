"""The frozen work counts and the table of peaks."""

import pytest

from benchmark.work import counts


def test_causal_triangle_flops_at_the_probe_shape():
    # 4 * heads * d * s(s+1)/2 at 8 x 8192 x 128: the kernel table's 1.374e11
    assert counts.causal_attention_flops(8, 8192, 128) == 4 * 8 * 128 * 8192 * 8193 / 2
    assert counts.causal_attention_flops(8, 8192, 128) == pytest.approx(1.374e11, rel=1e-3)


def test_copy_bytes_of_the_2gib_buffer():
    assert counts.copy_bytes(32768, 16384) == 4 * 2**30  # read once, written once


def test_attention_bytes_are_q_k_v_read_and_o_written_once():
    assert counts.attention_bytes(8, 8192, 128) == 4 * 8 * 8192 * 128 * 2


@pytest.mark.parametrize("shape, bound_ms", [((8, 8192, 128), 0.139), ((1, 128, 128), None)])
def test_least_time_is_the_larger_term(shape, bound_ms):
    peak = counts.card_peak("NVIDIA H100 80GB HBM3")
    flops = counts.causal_attention_flops(*shape)
    nbytes = counts.attention_bytes(*shape)
    least = counts.least_seconds(flops, nbytes, peak)
    assert least == max(flops / 989e12, nbytes / 3.35e12)
    if bound_ms:
        assert least * 1e3 == pytest.approx(bound_ms, rel=1e-2)


def test_k2_bound_is_the_kernel_tables():
    peak = counts.card_peak("NVIDIA H100 80GB HBM3")
    assert counts.least_seconds(0.0, counts.copy_bytes(32768, 16384), peak) * 1e3 == \
        pytest.approx(1.282, rel=1e-3)


def test_unknown_card_has_no_peak():
    assert counts.card_peak("cpu") is None
