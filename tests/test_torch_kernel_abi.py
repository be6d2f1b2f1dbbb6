"""The C interface of the port's CUDA kernels against its ctypes bindings,
on the CPU: the library cannot be built or loaded here, so the entries are
parsed from ``csrc/*.cu`` and the bindings are what ``_build.bind`` sets on
a stand-in object. A pointer bound without ``argtypes`` would be cut to 32
bits by ctypes; an argument count that differs shifts every argument after
it. Neither shows before the card."""

import ctypes
import re

import pytest

from tpu_operator_torch import _build
from tpu_operator_torch.workloads import fa_experiment, flashattn, membw

C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "long long": ctypes.c_longlong,
}
# membw's wrappers: launch counter -> C entry
COPY_KERNELS = {"tiled_copy": "tiled_copy_f32", "bulk_copy": "bulk_copy"}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _extern_c_spans(text: str):
    """(start, end) of each ``extern "C" { ... }`` block."""
    spans = []
    for m in re.finditer(r'extern\s+"C"\s*\{', text):
        depth, pos = 1, m.end()
        while depth:
            ch = text[pos]
            depth += {"{": 1, "}": -1}.get(ch, 0)
            pos += 1
        spans.append((m.end(), pos))
    return spans


def constants(src_name: str) -> dict:
    """The ``constexpr int NAME = value;`` constants of one ``csrc`` file."""
    text = _strip_comments((_build.CSRC / src_name).read_text())
    pairs = re.findall(r"constexpr int (\w+) = (\d+);", text)
    return {name: int(value) for name, value in pairs}


def c_entries() -> dict:
    """Every ``int`` function with C linkage in ``csrc/*.cu``: name ->
    list of argument types, as written."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = _strip_comments(src.read_text())
        spans = _extern_c_spans(text)
        for m in re.finditer(r'(extern\s+"C"\s+)?\bint\s+(\w+)\s*\(([^)]*)\)\s*\{', text):
            inside = any(a <= m.start() < b for a, b in spans)
            if not (m.group(1) or inside):
                continue
            args = [a.strip() for a in m.group(3).split(",") if a.strip()]
            # drop each argument's name: "const void* q" -> "const void*"
            entries[m.group(2)] = [re.sub(r"\s*\b\w+$", "", a).replace(" *", "*") for a in args]
    return entries


class _Recorder:
    """Stands in for the loaded library: hands out one object per entry
    name, on which ``bind`` sets ``argtypes`` and ``restype``."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type(name, (), {})())


@pytest.fixture(scope="module")
def bound():
    rec = _Recorder()
    _build.bind(rec)
    return rec.fns


def test_sources_have_the_entries_the_port_calls():
    entries = c_entries()
    assert {"flash_fwd_bf16", "bulk_copy", "tiled_copy_f32"} <= set(entries)
    assert len(entries) >= 10  # the ten kernels


@pytest.mark.parametrize("name", sorted(c_entries()))
def test_entry_is_bound_with_its_c_signature(name, bound):
    args = c_entries()[name]
    assert name in bound, f"{name} has no argtypes/restype in _build.bind"
    fn = bound[name]
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == len(args), f"{name}: {fn.argtypes} against {args}"
    for c_type, py_type in zip(args, fn.argtypes):
        assert c_type in C_TYPES, f"{name}: unknown C argument type {c_type!r}"
        assert py_type is C_TYPES[c_type], f"{name}: {c_type} bound as {py_type}"


def test_every_pointer_is_a_void_pointer(bound):
    for name, args in c_entries().items():
        for c_type, py_type in zip(args, bound[name].argtypes):
            if c_type.endswith("*"):
                assert py_type is ctypes.c_void_p, name


def test_every_launch_counter_has_an_entry():
    counters = dict(COPY_KERNELS)
    counters.update(flashattn.VARIANT_KERNELS.values())
    counters.update((name, name) for name in fa_experiment.MODE_KERNELS.values())
    assert set(counters) == set(_build.KERNELS)
    entries = c_entries()
    for counter, entry in counters.items():
        assert entry in entries, f"launch counter {counter} names no C entry ({entry})"


def entry_body(src_name: str, entry: str) -> str:
    """The body of the C entry ``entry`` in one ``csrc`` file."""
    text = _strip_comments((_build.CSRC / src_name).read_text())
    m = re.search(r'extern\s+"C"\s+int\s+' + entry + r"\s*\([^)]*\)\s*\{", text)
    assert m, f"no C entry {entry} in {src_name}"
    depth, pos = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(text[pos], 0)
        pos += 1
    return text[m.end():pos - 1]


# entry -> (its instance of the Hopper kernel's Step and PAIRED, its scale):
# K3 works in the log2 domain, K5 and K7c on the reference's s*scale
HOPPER_ENTRIES = {
    "flash_fwd_bf16": ("kFull", "false", "SCALE_LOG2"),
    "flash_fwd_bf16exp": ("kBf16Exp", "false", "SCALE"),
    "flash_fwd_paired16": ("kBf16S", "true", "SCALE"),
}


@pytest.mark.parametrize("entry", sorted(HOPPER_ENTRIES))
def test_hopper_entries_launch_through_launch_wgmma(entry):
    """K3, K5 and K7c each launch their own instance of the Hopper kernel
    (TMA ring, wgmma) with their scale, and nothing else."""
    body = entry_body("flash.cu", entry)
    m = re.fullmatch(
        r"\s*return\s+launch_wgmma<Step::(\w+),\s*(true|false),\s*\w+>\(([^;]*)\);\s*", body)
    assert m, f"{entry} does not launch through launch_wgmma: {body!r}"
    args = [a.strip() for a in m.group(3).split(",")]
    assert (m.group(1), m.group(2), args[-2]) == HOPPER_ENTRIES[entry]
    assert args[-1] == "stream"


def test_error_string_is_bound(bound):
    fn = bound["cuda_error_string"]
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_char_p


@pytest.mark.parametrize("rows", [8, membw.probe_rows(2048)])
def test_bulk_copy_plan_fits_the_probe_buffers(rows):
    """K2's plan, read from copy.cu: its ring fits the 227 KB of shared
    memory an H100 block may take, fewer stores are in flight at a refill
    than there are stages, and the buffers the probe and chip_smoke.py copy
    (8 rows, and 2 GiB) split into whole pieces in each of 8 chunks, as
    bulk_copy requires."""
    c = constants("copy.cu")
    piece, stages, lag = c["PIECE"], c["STAGES"], c["LAG"]
    assert piece % 16 == 0 and 0 <= lag < stages
    assert stages * piece <= 227 * 1024
    assert (rows * membw.LANES * 4) % (8 * piece) == 0
