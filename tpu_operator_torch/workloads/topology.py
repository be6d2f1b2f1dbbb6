"""The cards' topology: peak tables, the mesh helpers and NVLink placement.

The counterpart of ``tpu_operator/workloads/topology.py``. Its pure mesh
helpers (``parse_topology`` to ``enumerate_subslices``) are kept unchanged:
the slice manager tiles a mesh with them, and a topology string keeps the
reference's ``"AxB"`` form.

The fabric is the card's, not a torus. On an HGX board NVSwitch links
every pair of cards in one hop, so every card of one NVLink domain is a
neighbour of every other and any set inside one domain is contiguous. A
card is named by its id, the minor number of ``/dev/nvidiaN``
(``native/gpuinfo.py``), never by a position in ``0..n-1``: the ids a host
advertises may be 1, 3, 5 and 7. A chip table entry may carry
``numa_node`` (from sysfs) and ``nvlink_domain``; a card without a domain
belongs to domain 0, the board's.

The rate tables are NVIDIA H100 datasheet figures, dense (no sparsity),
keyed by the variant tag that ``device_generation`` returns. They assume
the card's full power limit; a card set below it runs slower under load.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

Coord = Tuple[int, ...]
Cards = Mapping[int, dict]  # the chip table by card id

# single-card peak bf16 tensor-core TFLOPS
PEAK_BF16_TFLOPS = {"h100-sxm": 989.0, "h100-pcie": 756.0, "h100-nvl": 835.0}

# device-memory bandwidth GB/s per card
PEAK_HBM_GBPS = {"h100-sxm": 3350.0, "h100-pcie": 2000.0, "h100-nvl": 3900.0}

# device memory GB per card
HBM_GB = {"h100-sxm": 80, "h100-pcie": 80, "h100-nvl": 94}

# cards per host: an HGX H100 8-GPU board, or eight PCIe/NVL cards a server
CARDS_PER_HOST = {"h100-sxm": 8, "h100-pcie": 8, "h100-nvl": 8}


def device_generation(device_kind: str) -> Optional[str]:
    """Map ``torch.cuda.get_device_name()`` to an H100 variant tag."""
    kind = device_kind.lower()
    if "h100" not in kind:
        return None
    if "nvl" in kind:
        return "h100-nvl"
    if "pcie" in kind:
        return "h100-pcie"
    if "sxm" in kind or "hbm3" in kind:
        return "h100-sxm"
    return None


# ---------------------------------------------------------------------------
# mesh helpers, as the reference's
# ---------------------------------------------------------------------------


def parse_topology(topology: str) -> Tuple[int, ...]:
    """``"2x2x4"`` -> ``(2, 2, 4)``."""
    if not topology:
        raise ValueError("empty topology")
    try:
        dims = tuple(int(p) for p in topology.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"bad topology {topology!r}") from e
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"bad topology {topology!r}")
    return dims


def format_topology(dims: Sequence[int]) -> str:
    return "x".join(str(d) for d in dims)


def chip_count(topology: str) -> int:
    n = 1
    for d in parse_topology(topology):
        n *= d
    return n


def host_count(topology: str, generation: str) -> int:
    per_host = CARDS_PER_HOST.get(generation, 8)
    return max(1, chip_count(topology) // per_host)


def coord_to_index(coord: Coord, dims: Sequence[int]) -> int:
    idx = 0
    for c, d in zip(coord, dims):
        idx = idx * d + c
    return idx


def index_to_coord(index: int, dims: Sequence[int]) -> Coord:
    coord = []
    for d in reversed(dims):
        coord.append(index % d)
        index //= d
    return tuple(reversed(coord))


@dataclass(frozen=True)
class Subslice:
    """An axis-aligned block of a mesh (origin + shape)."""

    origin: Coord
    shape: Tuple[int, ...]

    def coords(self) -> List[Coord]:
        return [
            tuple(o + d for o, d in zip(self.origin, offset))
            for offset in itertools.product(*(range(s) for s in self.shape))
        ]

    def chip_count(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def name(self) -> str:
        return format_topology(self.shape)


def enumerate_subslices(topology: str, shape: Sequence[int]) -> List[Subslice]:
    """Tile the host topology with non-overlapping subslices of ``shape``.
    Raises if the shape doesn't tile the topology exactly (ragged
    partitions would strand cards)."""
    dims = parse_topology(topology)
    shape = tuple(shape)
    if len(shape) != len(dims):
        # pad trailing dims with 1 (e.g. shape 2x1 in topology 2x2x1)
        if len(shape) < len(dims):
            shape = shape + tuple(1 for _ in range(len(dims) - len(shape)))
        else:
            raise ValueError(f"shape {shape} has more dims than topology {dims}")
    for s, d in zip(shape, dims):
        if s > d or d % s != 0:
            raise ValueError(
                f"shape {format_topology(shape)} does not tile topology "
                f"{format_topology(dims)}"
            )
    steps = [range(0, d, s) for d, s in zip(dims, shape)]
    return [Subslice(origin=origin, shape=shape) for origin in itertools.product(*steps)]


def _blocks_of(count: int, dims: Sequence[int]) -> Iterator[Tuple[int, ...]]:
    """Axis-aligned shapes with exactly ``count`` chips that fit in dims,
    most compact (cube-like) first."""
    n = len(dims)
    shapes = set()

    def rec(remaining: int, axis: int, shape: List[int]):
        if axis == n:
            if remaining == 1:
                shapes.add(tuple(shape))
            return
        d = 1
        while d <= dims[axis]:
            if remaining % d == 0:
                rec(remaining // d, axis + 1, shape + [d])
            d += 1

    rec(count, 0, [])
    return iter(sorted(shapes, key=lambda s: (max(s) - min(s), sorted(s, reverse=True))))


# ---------------------------------------------------------------------------
# the NVLink fabric
# ---------------------------------------------------------------------------


def _domain(cards: Cards, card: int) -> int:
    return cards.get(card, {}).get("nvlink_domain", 0)


def neighbors(card: int, cards: Cards) -> List[int]:
    """Every other card of ``card``'s NVLink domain: NVSwitch links each
    pair in one hop."""
    dom = _domain(cards, card)
    return sorted(i for i in cards if i != card and _domain(cards, i) == dom)


def contiguous(ids: Sequence[int], cards: Cards) -> bool:
    """Whether a card set is NVLink-connected: non-empty and inside one
    domain."""
    return bool(ids) and len({_domain(cards, i) for i in ids}) == 1


def nvlink_pair_count(cards: Cards) -> int:
    """Card pairs that NVLink joins, over every domain (the counterpart of
    the reference's ``ici_link_count``)."""
    sizes = defaultdict(int)
    for i in cards:
        sizes[_domain(cards, i)] += 1
    return sum(n * (n - 1) // 2 for n in sizes.values())


def domain_topology(cards: Cards) -> str:
    """The host's NVLink domains as a topology string, ``"<domains>x<cards
    a domain>"`` (``"1x8"`` for one HGX board); ``""`` where there is no
    card or the domains differ in size."""
    sizes = defaultdict(int)
    for i in cards:
        sizes[_domain(cards, i)] += 1
    if not sizes or len(set(sizes.values())) != 1:
        return ""
    return format_topology((len(sizes), next(iter(sizes.values()))))


def pick_chips(
    count: int,
    available: Sequence[int],
    must_include: Sequence[int] = (),
    cards: Optional[Cards] = None,
) -> Optional[List[int]]:
    """NVLink- and NUMA-aware allocation for the device plugin: choose
    ``count`` of the ``available`` card ids, every ``must_include`` id
    among them (the kubelet's ``must_include_deviceIDs`` contract).

    The ids are the ones advertised, whatever their values. The choice
    stays inside one NVLink domain where one holds the request, and
    prefers cards on the NUMA nodes of the must-include cards, then a NUMA
    node that holds the rest alone, then the lowest ids; it is
    deterministic. None where no choice exists: ``count <= 0``, fewer
    cards offered than asked, more must-include ids than ``count``, or a
    must-include id that was not offered.
    """
    cards = cards or {}
    avail = sorted(set(available))
    must = sorted(set(must_include))
    if count <= 0 or len(avail) < count or len(must) > count:
        return None
    if not set(must) <= set(avail):
        return None
    for dom in sorted({_domain(cards, i) for i in avail}):
        pool = [i for i in avail if _domain(cards, i) == dom]
        if len(pool) >= count and set(must) <= set(pool):
            return _fill(count, pool, must, cards)
    return _fill(count, avail, must, cards)


def _fill(count: int, pool: List[int], must: List[int], cards: Cards) -> List[int]:
    """``must`` and the rest of ``count`` from ``pool``, by NUMA node."""
    need = count - len(must)
    by_node: Dict[int, List[int]] = defaultdict(list)
    for i in pool:
        if i not in must:
            by_node[cards.get(i, {}).get("numa_node", -1)].append(i)
    anchors = {cards[i]["numa_node"] for i in must if "numa_node" in cards.get(i, {})}
    order = sorted(
        by_node, key=lambda node: (node not in anchors, len(by_node[node]) < need, by_node[node][0])
    )
    rest = [i for node in order for i in by_node[node]][:need]
    return sorted(must + rest)
