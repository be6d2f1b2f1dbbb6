"""The block sweep's per-performed-FLOP ratio (``workloads/blocktune.py``)
against the reference's ``scripts/fa_blocktune.py:33-38``: the same
transform of ``adjacent_ratio_stats``, with the FLOPs from the reference's
``causal_flops`` at the port's candidate blocks. Timings are a fake
measure: no card is needed."""

import pytest

from tpu_operator.workloads import flashattn as ref_fa
from tpu_operator_torch.workloads import blocktune
from tpu_operator_torch.workloads.timing import adjacent_ratio_stats

SEQ, HEADS, HD = 8192, 8, 128


def ref_per_flop_ratio(key, b, c, blocks, default):
    """The reference's ``per_flop_ratio``, over its own ``causal_flops``."""
    return (ref_fa.causal_flops(SEQ, HEADS, HD, *blocks[key]) / c) / (
        ref_fa.causal_flops(SEQ, HEADS, HD, *default) / b)


@pytest.mark.parametrize("bq,bk", blocktune.CANDIDATES)
def test_per_flop_transform_matches_the_reference(bq, bk):
    blocks = {"c": (bq, bk)}
    fn = blocktune.per_flop_transform(SEQ, HEADS, blocks, blocktune.DEFAULT)
    for b, c in ((1.0, 1.0), (2e-3, 3e-3), (4.1e-4, 3.9e-4)):
        assert fn("c", b, c) == pytest.approx(ref_per_flop_ratio("c", b, c, blocks, blocktune.DEFAULT),
                                              rel=1e-12)
    # an equally fast tiling that performs more FLOPs reads as faster
    more = ref_fa.causal_flops(SEQ, HEADS, HD, bq, bk) / ref_fa.causal_flops(SEQ, HEADS, HD, *blocktune.DEFAULT)
    assert fn("c", 1.0, 1.0) == pytest.approx(more)


def test_per_flop_ratio_through_adjacent_ratio_stats():
    """With the transform, each rep's ratio is the wall ratio times the
    candidate's performed FLOPs over the default's."""
    blocks = {"64/64": (64, 64), "128/512": (128, 512)}
    times = {"base": 2.0e-3, "64/64": 2.5e-3, "128/512": 1.6e-3}
    measure = lambda fn: times[fn]  # noqa: E731
    stats = adjacent_ratio_stats(measure, "base", {k: k for k in blocks}, reps=3,
                                 transform=blocktune.per_flop_transform(SEQ, HEADS, blocks, blocktune.DEFAULT))
    wall = adjacent_ratio_stats(measure, "base", {k: k for k in blocks}, reps=3)
    for key, bl in blocks.items():
        flops = ref_fa.causal_flops(SEQ, HEADS, HD, *bl) / ref_fa.causal_flops(SEQ, HEADS, HD, *blocktune.DEFAULT)
        assert stats[key][0] == pytest.approx(wall[key][0] * flops)
        assert wall[key][0] == pytest.approx(times["base"] / times[key])
