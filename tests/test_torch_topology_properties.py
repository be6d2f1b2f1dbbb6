"""The 5 hypothesis properties of ``tests/test_topology_properties.py`` on
each package: coordinates round trip, subslices tile exactly, the
``pick_chips`` contract, contiguous placement when every card is free, and
``parse_max_unavailable``'s bounds.

Each property runs once a side. The reference's case draws what the
reference's test draws and holds the reference's property. The port's
case draws the same and holds the port's property on the port's functions
(``workloads/topology.py``, ``upgrade/upgrade_state.py``), and where the two
packages are equal by design (the mesh helpers, the int-or-percent
scaling, whether ``pick_chips`` can answer) it also holds the reference's
answer on the same draw equal to the port's. Tolerance: exact equality.

Two properties are about the fabric, which differs by design (ROADMAP
queue 3 item 4, "the card's own geometry"): the reference's contiguity is
a torus's over ids ``0..n-1``; the port's is NVLink's, one domain, over
the ids a host advertised. So the port's side of those two draws the
port's own shapes: a host of ``D`` NVLink domains of ``C`` cards each, its
cards named by distinct minor numbers, its mesh ``DxC``
(``domain_topology``, a mesh row being a domain, as the slice manager
lays it out). There, a subslice inside one domain (shape ``1xs``) is
contiguous and the slice manager takes it; a subslice across domains is
refused; and ``pick_chips`` over a whole free host stays inside one
domain.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.two_sided import BY_SIDE
from tpu_operator.upgrade.upgrade_state import parse_max_unavailable as ref_parse_max_unavailable
from tpu_operator.workloads import topology as ref_topo
from tpu_operator_torch.sliceman import slice_manager
from tpu_operator_torch.upgrade.upgrade_state import parse_max_unavailable
from tpu_operator_torch.workloads import topology as topo

# the reference's draws: TPU host topologies of 1-3 small axes
dims_strategy = st.lists(st.integers(1, 8), min_size=1, max_size=3)
generations = st.sampled_from(["v4", "v5e", "v5p", "v6e"])


@st.composite
def hosts(draw):
    """The port's shapes: a chip table of ``D`` NVLink domains of ``C``
    cards with distinct minor numbers, and its mesh ``DxC``."""
    domains, per = draw(st.integers(1, 4)), draw(st.integers(1, 8))
    ids = draw(st.lists(st.integers(0, 63), unique=True, min_size=domains * per, max_size=domains * per))
    cards = {i: {"index": i, "nvlink_domain": k // per} for k, i in enumerate(ids)}
    return cards, domains, per


def to_str(dims):
    return "x".join(str(d) for d in dims)


def divisor(data, d):
    return data.draw(st.sampled_from([s for s in range(1, d + 1) if d % s == 0]))


@BY_SIDE
@given(dims=dims_strategy)
def test_coord_index_round_trip(side, dims):
    mod = topo if side == "port" else ref_topo
    n = mod.chip_count(to_str(dims))
    for i in range(n):
        c = mod.index_to_coord(i, dims)
        assert mod.coord_to_index(c, dims) == i
        assert all(0 <= x < d for x, d in zip(c, dims))
        if side == "port":
            assert c == ref_topo.index_to_coord(i, dims)


def tiling_of(mod, dims, shape):
    """The tiles' coordinates; they must be disjoint and cover the mesh."""
    tiles = [t.coords() for t in mod.enumerate_subslices(to_str(dims), shape)]
    seen = [c for coords in tiles for c in coords]
    assert len(seen) == len(set(seen)), "tiles overlap"
    assert len(seen) == mod.chip_count(to_str(dims)), "tiles don't cover"
    return tiles


@BY_SIDE
@given(dims=dims_strategy, host=hosts(), data=st.data())
def test_subslices_tile_exactly(side, dims, host, data):
    """Tiles are disjoint, cover every chip, and each is contiguous in the
    side's fabric."""
    shape = tuple(divisor(data, d) for d in dims)
    if side == "reference":
        for coords in tiling_of(ref_topo, dims, shape):
            assert ref_topo.contiguous(coords, to_str(dims), "v5p"), (coords, dims)
        return
    assert tiling_of(topo, dims, shape) == tiling_of(ref_topo, dims, shape)
    cards, domains, per = host
    mesh = topo.domain_topology(cards)
    assert mesh == to_str((domains, per))
    tile = (divisor(data, domains), divisor(data, per))
    chips = list(cards.values())
    if tile[0] > 1:  # across NVLink domains: refused
        with pytest.raises(ValueError, match="spans NVLink domains"):
            slice_manager.compute_partitions(mesh, "h100-sxm", to_str(tile), chips)
        return
    parts = slice_manager.compute_partitions(mesh, "h100-sxm", to_str(tile), chips)["subslices"]
    owned = [i for p in parts for i in p["chips"]]
    assert len(owned) == len(set(owned)), "tiles overlap"
    assert sorted(owned) == sorted(cards), "tiles don't cover"
    for p in parts:
        assert len(p["chips"]) == tile[1] and topo.contiguous(p["chips"], cards), p


@BY_SIDE
@given(dims=dims_strategy, gen=generations, data=st.data())
@settings(max_examples=200)
def test_pick_chips_contract(side, dims, gen, data):
    """None only when unsatisfiable; otherwise exactly ``count`` distinct
    offered ids with every must-include id."""
    n = ref_topo.chip_count(to_str(dims))
    available = data.draw(st.lists(st.integers(0, max(0, n - 1)), unique=True, min_size=0, max_size=n))
    count = data.draw(st.integers(1, max(1, n)))
    must = data.draw(
        st.lists(st.sampled_from(available), unique=True, min_size=0, max_size=min(3, len(available)))
        if available else st.just([]))
    ref_out = ref_topo.pick_chips(to_str(dims), gen, count, available, must)
    out = ref_out if side == "reference" else topo.pick_chips(count, available, must)
    if side == "port":
        assert (out is None) == (ref_out is None)
    if out is None:
        assert len(available) < count or len(must) > count
        return
    assert len(out) == count
    assert len(set(out)) == count, "duplicate ids"
    assert set(out) <= set(available), "picked an un-offered id"
    assert set(must) <= set(out), "must-include dropped"


@BY_SIDE
@given(dims=dims_strategy, gen=generations, host=hosts(), data=st.data())
@settings(max_examples=100)
def test_pick_chips_contiguous_when_everything_available(side, dims, gen, host, data):
    """With the whole host free and a count that one block of the mesh
    holds, the allocation is contiguous in the side's fabric."""
    if side == "reference":
        n = ref_topo.chip_count(to_str(dims))
        count = 1
        for d in dims:
            count *= divisor(data, d)
        out = ref_topo.pick_chips(to_str(dims), gen, count, list(range(n)))
        assert out is not None and len(out) == count
        coords = [ref_topo.index_to_coord(i, dims) for i in out]
        assert ref_topo.contiguous(coords, to_str(dims), gen), (out, dims, count)
        return
    cards, _, per = host
    count = divisor(data, per)  # a 1xs block of the DxC mesh: one domain's cards
    out = topo.pick_chips(count, sorted(cards), cards=cards)
    assert out is not None and len(out) == count == len(set(out))
    assert topo.contiguous(out, cards), (out, cards, count)


@BY_SIDE
@given(
    total=st.integers(0, 500),
    value=st.one_of(
        st.none(),
        st.integers(-10, 600),
        st.from_regex(r"\A\d{1,3}%\Z"),
        st.sampled_from(["0%", "100%", "25%", "garbage", ""]),
    ),
)
def test_parse_max_unavailable_bounds(side, total, value):
    fn = parse_max_unavailable if side == "port" else ref_parse_max_unavailable
    out = fn(value, total)
    assert 0 <= out <= max(total, 0)
    if total > 0:
        if value == "100%":
            assert out == total
        if value is None:
            assert out == total  # unset: no throttle
        if isinstance(value, int):
            assert out == max(0, min(value, total))
    if side == "port":
        assert out == ref_parse_max_unavailable(value, total)
