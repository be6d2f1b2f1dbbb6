"""The C interface of the port's CUDA kernels against its ctypes bindings,
on the CPU: the library cannot be built or loaded here, so the entries are
parsed from ``csrc/*.cu`` and the bindings are what ``_build.bind`` sets on
a stand-in object. A pointer bound without ``argtypes`` would be cut to 32
bits by ctypes; an argument count that differs shifts every argument after
it. Neither shows before the card."""

import ctypes
import importlib.util
import re
from pathlib import Path

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
COPY_KERNELS = {
    "tiled_copy": "tiled_copy_f32",
    "tiled_copy_tma": "tiled_copy_tma_f32",
    "bulk_copy": "bulk_copy",
}


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


# entry -> (its instance of the Hopper kernel's Step and Body, its scale):
# K3, K4 and K7a work in the log2 domain, K5, K6a, K6b, K7b and K7c on the
# reference's s*scale
HOPPER_ENTRIES = {
    "flash_fwd_bf16": ("kFull", "kOne", "SCALE_LOG2"),
    "flash_fwd_pipelined": ("kFull", "kPipe", "SCALE_LOG2"),
    "flash_fwd_paired": ("kFull", "kPair", "SCALE_LOG2"),
    "flash_fwd_bf16exp": ("kBf16Exp", "kOne", "SCALE"),
    "flash_softmax_stub": ("kStub", "kOne", "SCALE"),
    "flash_qk_only": ("kQkOnly", "kOne", "SCALE"),
    "flash_fwd_bf16s": ("kBf16S", "kOne", "SCALE"),
    "flash_fwd_paired16": ("kBf16S", "kPair", "SCALE"),
}
LAUNCH_WGMMA = re.compile(
    r"\s*return\s+launch_wgmma<Step::(\w+),\s*Body::(\w+),\s*\w+>\(([^;]*)\);\s*")


@pytest.mark.parametrize("entry", sorted(HOPPER_ENTRIES))
def test_hopper_entries_launch_through_launch_wgmma(entry):
    """K3, K4, K5, K6a, K6b, K7a, K7b and K7c each launch their own
    instance of the Hopper kernel (TMA ring, wgmma) with their scale, and
    nothing else."""
    body = entry_body("flash.cu", entry)
    m = LAUNCH_WGMMA.fullmatch(body)
    assert m, f"{entry} does not launch through launch_wgmma: {body!r}"
    args = [a.strip() for a in m.group(3).split(",")]
    assert (m.group(1), m.group(2), args[-2]) == HOPPER_ENTRIES[entry]
    assert args[-1] == "stream"


def enum_values(src_name: str, enum: str) -> dict:
    """``enum class NAME { a, b, ... };`` of one ``csrc`` file: member ->
    its value, as the mangled name of a template instance spells it."""
    text = _strip_comments((_build.CSRC / src_name).read_text())
    m = re.search(r"enum\s+class\s+" + enum + r"\s*\{([^}]*)\}", text)
    assert m, f"no enum class {enum} in {src_name}"
    members = [a.strip() for a in m.group(1).split(",") if a.strip()]
    assert all(re.fullmatch(r"\w+", a) for a in members), members  # no explicit values
    return {name: str(i) for i, name in enumerate(members)}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_expects_the_instances_the_entries_launch():
    """``chip_smoke.WGMMA_INSTANCES`` (the instances its SASS check must
    find, by the enum values of the mangled name) names exactly the
    (Step, Body) of every C entry that launches the Hopper kernel, and
    its regex reads them from such a name."""
    steps, bodies = enum_values("flash.cu", "Step"), enum_values("flash.cu", "Body")
    launched = set()
    for entry in c_entries():
        if entry.startswith("flash_"):
            m = LAUNCH_WGMMA.fullmatch(entry_body("flash.cu", entry))
            if m:
                launched.add((steps[m.group(1)], bodies[m.group(2)]))
    smoke = _chip_smoke()
    assert set(smoke.WGMMA_INSTANCES) == launched
    assert len(set(smoke.WGMMA_INSTANCES.values())) == len(launched)
    # the start of the Itanium mangled name of
    # flash_fwd_wgmma_kernel<Step::kFull, Body::kPipe, 4> (the anonymous namespace's)
    name = "_ZN12_GLOBAL__N_122flash_fwd_wgmma_kernelILNS_4StepE0ELNS_4BodyE2ELi4EEEv"
    args = smoke.WGMMA_NAME_ARGS.search(name).groups()
    assert args == (steps["kFull"], bodies["kPipe"]) and smoke.WGMMA_INSTANCES[args] == "K4"


def test_chip_smoke_wants_no_exp_in_exactly_the_stubs():
    """``chip_smoke.NO_SOFTMAX``, the instances whose SASS must hold no
    MUFU.EX2, are the labels of the two stub steps' instances, and no
    instance of a step with a softmax."""
    steps, bodies = enum_values("flash.cu", "Step"), enum_values("flash.cu", "Body")
    smoke = _chip_smoke()
    stubs = {smoke.WGMMA_INSTANCES[(steps[step], bodies["kOne"])]
             for step in ("kStub", "kQkOnly")}
    assert set(smoke.NO_SOFTMAX) == stubs == {"K6a", "K6b"}


def _unmasked_subtiles(seq: int, block_q: int, block_k: int, kt: int) -> set:
    """The unmasked sub-tile counts of a causal run's q-blocks, as
    ``flash_fwd_wgmma_kernel`` computes ``n_unmasked``, over
    ceil(seq/block_q) q-blocks."""
    return {(i * block_q) // block_k * (block_k // kt)
            for i in range(flashattn.n_blocks(seq, block_q))}


@pytest.mark.parametrize("kernels", ["K4", "K7a/K7c"])
def test_chip_smoke_reaches_both_exits_of_the_two_s_bodies(kernels):
    """K4's pipelined loop and K7a's/K7c's pair loop leave one way after
    an even count of unmasked sub-tiles and another after an odd one;
    the card check of each must run q-blocks with an even count of 2 or
    more and an odd count of 3 or more."""
    smoke, kt = _chip_smoke(), constants("flash.cu")["KT"]
    shapes = {
        "K4": smoke.VARIANT_TEST_SHAPES + smoke.HOPPER_VARIANT_SHAPES,
        "K7a/K7c": smoke.STRUCTURAL_TEST_SHAPES,
    }[kernels]
    counts = set().union(*(
        _unmasked_subtiles(seq, bq, bk, kt) for _, seq, bq, bk, causal in shapes if causal
    ))
    assert any(n >= 2 and n % 2 == 0 for n in counts), counts
    assert any(n >= 3 and n % 2 for n in counts), counts


def test_every_flash_entry_launches_through_launch_wgmma():
    """The synchronous design is gone: every flash entry launches through
    launch_wgmma, and neither the synchronous kernel, its launcher, its
    staging nor its warp-level MMA is left in flash.cu, nor what the
    synchronous pair kernel had."""
    text = _strip_comments((_build.CSRC / "flash.cu").read_text())
    for dead in ("flash_fwd_kernel", "mma16816", "mma.sync", "stage_rows", "launch<",
                 "flash_fwd_paired_kernel", "launch_two_stage", "PIPE_SMEM", "softmax_pv"):
        assert dead not in text, dead
    flash_entries = {e for e in c_entries() if e.startswith("flash_")}
    for entry in sorted(flash_entries):
        assert LAUNCH_WGMMA.fullmatch(entry_body("flash.cu", entry)), entry
    assert set(HOPPER_ENTRIES) == flash_entries


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


def test_tiled_copy_tma_plan_fits_the_card():
    """K1's tried Hopper design, read from copy.cu: its TMA box (at most
    256 elements a side, rows of a multiple of 16 bytes) tiles the
    16384-wide probe rows, its ring and alignment slack fit the 227 KB of
    shared memory an H100 block may take, and fewer stores are in flight
    at a refill than there are stages."""
    c = constants("copy.cu")
    cols, rows = c["TMA_COPY_BOX_COLS"], c["TMA_COPY_BOX_ROWS"]
    stages, lag = c["TMA_COPY_STAGES"], c["TMA_COPY_LAG"]
    assert c["LANES"] == membw.LANES and membw.LANES % cols == 0
    assert cols <= 256 and rows <= 256 and (cols * 4) % 16 == 0
    assert 0 <= lag < stages and stages * cols * rows * 4 + 128 <= 227 * 1024
