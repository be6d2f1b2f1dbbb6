"""The port's card topology (``workloads/topology.py``) against the
reference's ``tpu_operator/workloads/topology.py``.

Equal by design: the mesh helpers, on the same inputs, and ``pick_chips``'s
contract (count, distinct, only offered ids, must-include kept, None where
the reference gives None). Different by design: the fabric. The reference
reasons over a torus of ids ``0..n-1``; the port over NVLink domains, in
which NVSwitch links every pair, and over the ids that were advertised,
which are minor numbers: {3, 5, 7} is a host of three cards, not ids out of
range."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_operator.workloads import topology as ref
from tpu_operator_torch.workloads import topology as topo

dims_strategy = st.lists(st.integers(1, 8), min_size=1, max_size=3)


def to_str(dims):
    return "x".join(str(d) for d in dims)


@pytest.mark.parametrize("s", ["2x4", "2x2x4", "1x1", "8", "16x1", "2X4"])
def test_parse_format_count_match(s):
    assert topo.parse_topology(s) == ref.parse_topology(s)
    assert topo.format_topology(topo.parse_topology(s)) == ref.format_topology(ref.parse_topology(s))
    assert topo.chip_count(s) == ref.chip_count(s)


@pytest.mark.parametrize("s", ["", "2xx4", "0x2", "ax2", "-1"])
def test_bad_topology_raises_as_the_reference(s):
    with pytest.raises(ValueError):
        ref.parse_topology(s)
    with pytest.raises(ValueError):
        topo.parse_topology(s)


@given(dims=dims_strategy)
def test_coords_match_the_reference(dims):
    n = topo.chip_count(to_str(dims))
    for i in range(n):
        c = topo.index_to_coord(i, dims)
        assert c == ref.index_to_coord(i, dims)
        assert topo.coord_to_index(c, dims) == ref.coord_to_index(c, dims) == i


@given(dims=dims_strategy, data=st.data())
def test_subslices_and_blocks_match_the_reference(dims, data):
    shape = tuple(data.draw(st.sampled_from([s for s in range(1, d + 1) if d % s == 0])) for d in dims)
    mine = topo.enumerate_subslices(to_str(dims), shape)
    theirs = ref.enumerate_subslices(to_str(dims), shape)
    assert [(t.origin, t.shape, t.coords(), t.chip_count(), t.name()) for t in mine] == [
        (t.origin, t.shape, t.coords(), t.chip_count(), t.name()) for t in theirs
    ]
    count = data.draw(st.integers(1, topo.chip_count(to_str(dims))))
    assert list(topo._blocks_of(count, dims)) == list(ref._blocks_of(count, dims))


def test_subslice_refusals_match_the_reference():
    for topology, shape in (("2x4", (3, 1)), ("2x4", (1, 1, 1)), ("2x2", (4, 1))):
        with pytest.raises(ValueError):
            ref.enumerate_subslices(topology, shape)
        with pytest.raises(ValueError):
            topo.enumerate_subslices(topology, shape)
    assert len(topo.enumerate_subslices("2x2x1", (2, 1))) == 2


@given(dims=dims_strategy, data=st.data())
@settings(max_examples=200)
def test_pick_chips_contract_matches_the_reference(dims, data):
    """Over ids inside the reference's mesh both answer None on the same
    requests; otherwise the port gives ``count`` distinct offered ids with
    every must-include id."""
    n = topo.chip_count(to_str(dims))
    available = data.draw(st.lists(st.integers(0, n - 1), unique=True, max_size=n))
    count = data.draw(st.integers(-1, n + 1))
    must = data.draw(st.lists(st.integers(0, n - 1), unique=True, max_size=3))
    mine = topo.pick_chips(count, available, must)
    theirs = ref.pick_chips(to_str(dims), "v5p", count, available, must)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert len(mine) == count == len(set(mine))
        assert set(mine) <= set(available)
        assert set(must) <= set(mine)
        assert mine == sorted(mine)


card_tables = st.dictionaries(
    st.integers(0, 63),
    st.fixed_dictionaries(
        {},
        optional={"numa_node": st.integers(-1, 3), "nvlink_domain": st.integers(0, 2)},
    ),
    min_size=1,
    max_size=12,
)


@given(cards=card_tables, data=st.data())
@settings(max_examples=300)
def test_pick_chips_invariants_over_advertised_ids(cards, data):
    """Any ids, any NUMA nodes and domains: ``count`` distinct offered ids
    with the must-include ones, the same answer for the same request
    whatever the order of the offer, and inside one domain where one
    domain holds the request."""
    ids = sorted(cards)
    available = data.draw(st.lists(st.sampled_from(ids), unique=True, min_size=1))
    count = data.draw(st.integers(1, len(available)))
    must = data.draw(st.lists(st.sampled_from(available), unique=True, max_size=count))
    out = topo.pick_chips(count, available, must, cards)
    assert out is not None and len(out) == count == len(set(out))
    assert set(out) <= set(available) and set(must) <= set(out)
    shuffled = data.draw(st.permutations(available))
    assert topo.pick_chips(count, shuffled, list(reversed(must)), cards) == out
    domains = {}
    for i in available:
        domains.setdefault(cards[i].get("nvlink_domain", 0), set()).add(i)
    if any(len(pool) >= count and set(must) <= pool for pool in domains.values()):
        assert topo.contiguous(out, cards)


@pytest.mark.parametrize(
    "available,count,must,want",
    [
        ([3, 5, 7], 3, [], [3, 5, 7]),
        ([7, 5, 3], 2, [], [3, 5]),
        ([3, 5, 7], 1, [7], [7]),
        ([3, 5, 7], 2, [7], [3, 7]),
        ([1, 2, 3, 4, 5], 4, [5], [1, 2, 3, 5]),
        ([0, 1, 3, 6], 4, [6, 0], [0, 1, 3, 6]),
    ],
)
def test_minor_number_ids_are_picked_without_loss(available, count, must, want):
    """Minor numbers H100 hosts advertised (5, 3, 7, 1, 2-5, 0/1/3/6):
    every id is a card. The reference drops ids at or past its mesh's size
    (``:228``)."""
    assert topo.pick_chips(count, available, must) == want


def test_reference_drops_ids_past_its_mesh():
    """What the port must not do: with a mesh of three, the reference
    keeps none of the minors 3, 5, 7."""
    assert ref.pick_chips("3", "v5e", 3, [3, 5, 7]) is None
    assert topo.pick_chips(3, [3, 5, 7]) == [3, 5, 7]


def test_pick_prefers_shared_numa_then_lowest_ids():
    cards = {1: {"numa_node": 0}, 3: {"numa_node": 1}, 5: {"numa_node": 1}, 7: {"numa_node": 0},
             9: {"numa_node": 1}}
    # no must: the lowest-id NUMA node that holds the request alone
    assert topo.pick_chips(2, list(cards), (), cards) == [1, 7]
    assert topo.pick_chips(3, list(cards), (), cards) == [3, 5, 9]
    # must on node 1: the rest from node 1 first
    assert topo.pick_chips(2, list(cards), [9], cards) == [3, 9]
    assert topo.pick_chips(4, list(cards), [7], cards) == [1, 3, 5, 7]
    # deterministic
    assert all(topo.pick_chips(3, list(cards), (), cards) == [3, 5, 9] for _ in range(5))


def test_pick_stays_inside_one_nvlink_domain():
    cards = {0: {"nvlink_domain": 0}, 1: {"nvlink_domain": 0}, 2: {"nvlink_domain": 1},
             3: {"nvlink_domain": 1}}
    assert topo.pick_chips(2, [0, 2, 3], (), cards) == [2, 3]
    assert topo.pick_chips(2, [0, 1, 2, 3], [3], cards) == [2, 3]
    assert topo.pick_chips(3, [0, 1, 2, 3], (), cards) == [0, 1, 2]  # no domain holds 3
    assert not topo.contiguous([1, 2], cards)


def test_nvlink_fabric_every_pair_one_hop():
    board = {i: {} for i in (1, 3, 5, 7)}
    assert topo.neighbors(3, board) == [1, 5, 7]
    assert topo.contiguous([1, 7], board) and not topo.contiguous([], board)
    assert topo.nvlink_pair_count(board) == 6
    assert topo.domain_topology(board) == "1x4"
    pairs = {i: {"nvlink_domain": i // 2} for i in range(4)}
    assert topo.neighbors(2, pairs) == [3]
    assert topo.nvlink_pair_count(pairs) == 2
    assert topo.domain_topology(pairs) == "2x2"
    assert topo.domain_topology({}) == ""
    assert topo.domain_topology({0: {}, 1: {}, 2: {"nvlink_domain": 1}}) == ""
    # the reference's torus counts mesh links, not pairs: 2x2 has 4
    assert ref.ici_link_count("2x2", "v5e") == 4


@pytest.mark.parametrize(
    "name,tag,gb",
    [("NVIDIA H100 80GB HBM3", "h100-sxm", 80), ("NVIDIA H100 PCIe", "h100-pcie", 80),
     ("NVIDIA H100 NVL", "h100-nvl", 94)],
)
def test_card_tables(name, tag, gb):
    assert topo.device_generation(name) == tag
    assert topo.HBM_GB[tag] == gb
    assert topo.host_count("1x8", tag) == 1 and topo.host_count("2x8", tag) == 2
    assert set(topo.HBM_GB) == set(topo.CARDS_PER_HOST) == set(topo.PEAK_BF16_TFLOPS)
