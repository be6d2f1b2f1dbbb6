"""The port's native card probe (``native/csrc/libgpuinfo.cpp`` and
``gpu_smoke.cpp``, built by ``native/build.py``) against the Python probe
and against the reference's ``native/libtpuinfo.cpp`` and ``tpu_smoke.cpp``,
all compiled with ``g++`` into a temporary directory (never ``make -C
native``, which would rewrite the tracked ``native/out``).

NVML is a stand-in ``libnvidia-ml.so.1`` compiled from ``FAKE_NVML`` below:
its cards have minors {5, 1} in NVML's order, the second answers PCI info,
utilization and MIG mode with NOT_SUPPORTED as under gVisor, and a
variant fails ``nvmlInit_v2``, so both probes fall to the sysfs path."""

import ctypes
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

from test_torch_gpuinfo import _dev_tree, _pci_fn, _proc_card
from tpu_operator_torch.native import build as native_build
from tpu_operator_torch.native import gpuinfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC"]

FAKE_NVML = r"""
#include <string.h>
#ifndef INIT_RC
#define INIT_RC 0
#endif
#define NOT_SUPPORTED 3
typedef struct { char busIdLegacy[16]; unsigned domain, bus, device, pciDeviceId, pciSubSystemId;
                 char busId[32]; } pci_t;
typedef struct { unsigned long long total, free, used; } mem_t;
typedef struct { unsigned gpu, memory; } util_t;
struct card { const char *name; unsigned minor; const char *bus, *uuid; unsigned limit;
              unsigned long long total, used; int util_rc; unsigned util, util_mem, temp; int mig_rc; };
static const struct card cards[] = {
  {"NVIDIA H100 80GB HBM3", 5, "00000000:18:00.0", "GPU-5d0c1f8e-0000-0000-0000-000000000005",
   700000, 85520809984ULL, 1048576ULL, 0, 37, 12, 41, 0},
  {"NVIDIA H100 80GB HBM3", 1, 0, "GPU-5d0c1f8e-0000-0000-0000-000000000001",
   650000, 85520809984ULL, 2097152ULL, NOT_SUPPORTED, 0, 0, 39, NOT_SUPPORTED},
};
#define N (sizeof(cards) / sizeof(cards[0]))
static const struct card *card(void *h) { return &cards[(unsigned long)h - 1]; }
int nvmlInit_v2(void) { return INIT_RC; }
int nvmlShutdown(void) { return 0; }
const char *nvmlErrorString(int rc) { return rc == NOT_SUPPORTED ? "Not Supported" : "Driver Not Loaded"; }
int nvmlSystemGetDriverVersion(char *buf, unsigned n) { strncpy(buf, "550.54.15", n); return 0; }
int nvmlDeviceGetCount_v2(unsigned *n) { *n = N; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void **h) {
  if (i >= N) return 2;
  *h = (void *)(unsigned long)(i + 1);
  return 0;
}
int nvmlDeviceGetName(void *h, char *buf, unsigned n) { strncpy(buf, card(h)->name, n); return 0; }
int nvmlDeviceGetUUID(void *h, char *buf, unsigned n) { strncpy(buf, card(h)->uuid, n); return 0; }
int nvmlDeviceGetMinorNumber(void *h, unsigned *m) { *m = card(h)->minor; return 0; }
int nvmlDeviceGetPciInfo_v3(void *h, pci_t *p) {
  if (!card(h)->bus) return NOT_SUPPORTED;
  memset(p, 0, sizeof *p);
  strcpy(p->busId, card(h)->bus);
  return 0;
}
int nvmlDeviceGetPowerManagementLimit(void *h, unsigned *l) { *l = card(h)->limit; return 0; }
int nvmlDeviceGetMemoryInfo(void *h, mem_t *m) {
  m->total = card(h)->total; m->used = card(h)->used; m->free = m->total - m->used;
  return 0;
}
int nvmlDeviceGetUtilizationRates(void *h, util_t *u) {
  if (card(h)->util_rc) return card(h)->util_rc;
  u->gpu = card(h)->util; u->memory = card(h)->util_mem;
  return 0;
}
int nvmlDeviceGetTemperature(void *h, int sensor, unsigned *t) { (void)sensor; *t = card(h)->temp; return 0; }
int nvmlDeviceGetMigMode(void *h, unsigned *cur, unsigned *pending) {
  if (card(h)->mig_rc) return card(h)->mig_rc;
  *cur = 0; *pending = 0;
  return 0;
}
"""
# the stand-in's cards as NVML gives them, by minor
FAKE_MINORS = [1, 5]
FAKE_BUS = "0000:18:00.0"


def compile_all(jobs):
    """Run each (cmd) compile in parallel; raise with the compiler's output
    on a failure."""
    def run(cmd):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{' '.join(cmd)}\n{r.stderr[-3000:]}"

    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(run, cmd) for cmd in jobs]:
            f.result()


def build_fixtures(root, reference_programs):
    """The port's programs (``native/build.py``), the reference's named
    ``reference_programs`` from ``native/*.cpp`` and the two stand-in
    NVMLs, all under ``root``."""
    src = root / "fake_nvml.c"
    src.write_text(FAKE_NVML)
    ref = root / "ref"
    ref.mkdir()
    ns = SimpleNamespace(nvml_ok=str(root / "nvml_ok" / "libnvidia-ml.so.1"),
                         nvml_down=str(root / "nvml_down" / "libnvidia-ml.so.1"))
    cxx = native_build.find_cxx()
    jobs = []
    for path, rc in ((ns.nvml_ok, 0), (ns.nvml_down, 9)):
        os.makedirs(os.path.dirname(path))
        jobs.append(["gcc", "-shared", "-fPIC", "-O1", f"-DINIT_RC={rc}", "-o", path, str(src)])
    sources = {
        "libtpuinfo.so": (["-shared"], ["libtpuinfo.cpp"]),
        "tpu_smoke": ([], ["tpu_smoke.cpp", "libtpuinfo.cpp"]),
        "tpu_metricsd": (["-pthread"], ["tpu_metricsd.cpp", "libtpuinfo.cpp"]),
    }
    for name in reference_programs:
        flags, files = sources[name]
        setattr(ns, "ref_" + name.split(".")[0], str(ref / name))
        jobs.append([cxx, *CXX_FLAGS, *flags, "-o", str(ref / name),
                     *(os.path.join(NATIVE, f) for f in files)])
    with ThreadPoolExecutor(2) as pool:
        port = pool.submit(native_build.build, str(root / "port"))
        compile_all(jobs)
        ns.paths = port.result()["paths"]
    ns.lib = ns.paths[native_build.LIB_NAME]
    ns.smoke = ns.paths[native_build.SMOKE_NAME]
    ns.metricsd = ns.paths[native_build.METRICSD_NAME]
    return ns


def reset_loaders(monkeypatch, native_lib=None):
    """Fresh loader caches in ``gpuinfo``: the native library from
    ``native_lib`` (None: no native library), NVML loaded anew."""
    monkeypatch.setattr(gpuinfo, "_lib", None)
    monkeypatch.setattr(gpuinfo, "_loaded", False)
    monkeypatch.setattr(gpuinfo, "_native", None)
    monkeypatch.setattr(gpuinfo, "_native_loaded", native_lib is None)
    if native_lib is not None:
        monkeypatch.setenv("LIBGPUINFO_PATH", native_lib)
        assert gpuinfo.native_available()


@pytest.fixture(scope="module")
def progs(tmp_path_factory):
    return build_fixtures(tmp_path_factory.mktemp("native"), ["libtpuinfo.so", "tpu_smoke"])


@pytest.fixture
def tables(monkeypatch, progs):
    """tables(*roots) -> (native table, Python table) of the same roots."""
    def read(*roots):
        reset_loaders(monkeypatch, progs.lib)
        native = gpuinfo.chip_summary(*roots)
        reset_loaders(monkeypatch)
        return native, gpuinfo.chip_summary(*roots)

    return read


@pytest.fixture
def no_nvml(monkeypatch, progs):
    """NVML that does not answer: both probes read the sysfs path."""
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_down)


def test_nvml_table_equals_the_ctypes_table(monkeypatch, progs, tables, tmp_path):
    """Field for field: the index is the minor number in NVML's other
    order, an unanswered field is left out (card 1's bus id, utilization
    and MIG mode), and sysfs's vendor, class and NUMA node join on the bus
    id."""
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_ok)
    sysfs = tmp_path / "sys"
    _pci_fn(sysfs, FAKE_BUS, "0x10de", "0x030200", numa=1)
    native, py = tables(str(tmp_path / "dev"), str(tmp_path / "proc"), str(sysfs))
    assert native == py
    assert [c["index"] for c in native] == FAKE_MINORS
    one, five = native
    assert one["path"] == str(tmp_path / "dev" / "nvidia1") and one["source"] == "nvml"
    assert not {"pci_address", "utilization_gpu", "mig_mode", "numa_node"} & set(one)
    assert one["memory_used_bytes"] == 2097152 and one["power_limit_mw"] == 650000
    assert (five["pci_address"], five["numa_node"], five["vendor"]) == (FAKE_BUS, 1, "0x10de")
    assert (five["utilization_gpu"], five["temperature_c"], five["mig_mode"]) == (37, 41, 0)


def test_nvml_that_does_not_answer_falls_to_the_same_sysfs_table(monkeypatch, progs, tables,
                                                                  tmp_path, no_nvml):
    dev = _dev_tree(tmp_path / "dev", ["nvidia1", "nvidia5", "nvidiactl", "nvidia-uvm"])
    proc, sysfs = tmp_path / "proc", tmp_path / "sys"
    _proc_card(proc, FAKE_BUS, 5)
    _pci_fn(sysfs, FAKE_BUS, "0x10de", "0x030200", numa=1)
    native, py = tables(dev, str(proc), str(sysfs))
    assert native == py
    assert [(c["index"], c["source"]) for c in native] == [(1, "sysfs"), (5, "sysfs")]
    assert native[1]["uuid"] == "GPU-00000005" and native[1]["numa_node"] == 1


@pytest.mark.parametrize(
    "names",
    [
        ["nvidia0", "nvidia1"],
        ["nvidia0", "nvidia3", "nvidia10", "nvidia007"],
        ["vfio/vfio", "vfio/0", "vfio/5", "vfio/noiommu-0", "vfio/.hidden"],
        ["nvidiactl", "nvidia-uvm", "nvidia-caps/nvidia-cap1", "nvidia0foo", "nvidia-modeset"],
        [],
    ],
)
def test_sysfs_table_equals_the_python_path(progs, tables, tmp_path, no_nvml, names):
    dev = _dev_tree(tmp_path / "dev", names)
    roots = (dev, str(tmp_path / "proc"), str(tmp_path / "sys"))
    native, py = tables(*roots)
    assert native == py == gpuinfo._sysfs_chips(*roots)


def test_proc_identity_and_the_class_filter_equal_the_python_path(progs, tables, tmp_path, no_nvml):
    """Identity from /proc by minor number, a bus id spelled in upper case
    or with a long domain, an NVSwitch function (same vendor, class
    0x068000) dropped, a function with no sysfs entry kept, an
    ``information`` file with no minor skipped."""
    dev = _dev_tree(tmp_path / "dev", ["nvidia0", "nvidia2", "nvidia5", "nvidia7", "nvidiactl"])
    proc, sysfs = tmp_path / "proc", tmp_path / "sys"
    _proc_card(proc, "0000:18:00.0", 0)
    _proc_card(proc, "0000:2A:00.0", 2)
    _proc_card(proc, "0000:9c:00.0", 5, model="NVSwitch")
    _proc_card(proc, "00000000:c1:00.0", 7)
    (proc / "0000:ff:00.0").mkdir()
    (proc / "0000:ff:00.0" / "information").write_text("Model: \t H100\n")
    _pci_fn(sysfs, "0000:18:00.0", "0x10de", "0x030200", numa=0)
    _pci_fn(sysfs, "0000:2a:00.0", "0x10de", "0x030000", numa=1)
    _pci_fn(sysfs, "0000:9c:00.0", "0x10de", "0x068000", numa=1)
    native, py = tables(dev, str(proc), str(sysfs))
    assert native == py
    assert [(c["index"], c["pci_address"]) for c in native] == [
        (0, "0000:18:00.0"), (2, "0000:2a:00.0"), (7, "0000:c1:00.0")]
    assert "vendor" not in native[2]


def _summary(lib, prefix, dev_root, *roots):
    buf = ctypes.create_string_buffer(1 << 16)
    rc = getattr(lib, prefix + "_summary_json")(dev_root.encode(), *(r.encode() for r in roots),
                                                buf, len(buf))
    assert rc == 0
    return json.loads(buf.value.decode())


@pytest.mark.parametrize(
    "ref_names",
    [
        ["accel0", "accel2", "accel7"],  # holes: ids stay the suffixes
        ["accel3", "accelX", "accel0foo", "accel1"],  # accel0foo claims no id
        ["vfio/0", "vfio/3", "vfio/noiommu-0", "vfio/12"],  # past the largest parsed id
        ["vfio/noiommu-0", "vfio/noiommu-1"],
    ],
)
def test_stable_ids_agree_with_the_reference_library(progs, tmp_path, no_nvml, ref_names):
    """The reference's libtpuinfo and the port's libgpuinfo on the same name
    patterns (``accelN`` as ``nvidiaN``): a parsed name keeps its number,
    and a name that does not parse gets an id past the largest. On the
    port's side ``nvidiaX`` and ``nvidia0foo`` are not card nodes at all."""
    ref_root = _dev_tree(tmp_path / "ref", ref_names)
    port_root = _dev_tree(tmp_path / "port", [n.replace("accel", "nvidia") for n in ref_names])
    ref = _summary(ctypes.CDLL(progs.ref_libtpuinfo), "tpuinfo", ref_root)
    port = _summary(ctypes.CDLL(progs.lib), "gpuinfo", port_root, str(tmp_path / "p"),
                    str(tmp_path / "s"))
    ref_ids = {os.path.basename(c["path"]).replace("accel", "nvidia"): c["index"] for c in ref}
    port_ids = {os.path.basename(c["path"]): c["index"] for c in port}
    assert port_ids == {n: i for n, i in ref_ids.items() if n in port_ids}
    assert "nvidia0foo" not in port_ids and "nvidiaX" not in port_ids
    assert [c["index"] for c in port] == sorted(port_ids.values())


@pytest.fixture
def probe_paths(tmp_path, monkeypatch):
    """Paths to probe: a unix socket opens with ENXIO but stats fine, so a
    ``/vfio/`` socket that reads healthy was never opened."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "vfio").mkdir()
    (tmp_path / "nvidia0").touch()
    socks = []
    for rel in ("vfio/7", "sock"):
        s = socket.socket(socket.AF_UNIX)
        s.bind(rel)
        socks.append(s)
    yield {
        "regular": str(tmp_path / "nvidia0"),
        "missing": str(tmp_path / "nvidia9"),
        "vfio_socket": str(tmp_path / "vfio" / "7"),
        "vfio_missing": str(tmp_path / "vfio" / "8"),
        "socket": str(tmp_path / "sock"),
        "directory": str(tmp_path / "vfio"),
        "empty": "",
    }
    for s in socks:
        s.close()


@pytest.mark.parametrize("case", ["regular", "missing", "vfio_socket", "vfio_missing", "socket",
                                  "directory", "empty"])
def test_device_probe_path_agrees_with_the_reference(monkeypatch, progs, probe_paths, case):
    path = probe_paths[case]
    ref = ctypes.CDLL(progs.ref_libtpuinfo).tpuinfo_device_probe_path(path.encode())
    port = ctypes.CDLL(progs.lib).gpuinfo_device_probe_path(path.encode())
    assert port == ref
    if case == "vfio_socket":
        assert port == 0  # stat'ed, never opened
    reset_loaders(monkeypatch, progs.lib)
    native = gpuinfo.device_probe_path(path)
    reset_loaders(monkeypatch)
    assert native == gpuinfo.device_probe_path(path)


@pytest.mark.parametrize("nodes", [["0", "1"], []])
def test_smoke_exit_codes_agree_with_the_reference(progs, tables, tmp_path, no_nvml, nodes):
    ref_root = _dev_tree(tmp_path / "ref", [f"accel{n}" for n in nodes])
    port_root = _dev_tree(tmp_path / "port", [f"nvidia{n}" for n in nodes] + ["nvidiactl"])
    ref = subprocess.run([progs.ref_tpu_smoke, "--dev-root", ref_root, "--json"],
                         capture_output=True, text=True, timeout=30)
    port = subprocess.run([progs.smoke, "--dev-root", port_root, "--json"],
                          capture_output=True, text=True, timeout=30)
    assert port.returncode == ref.returncode == (0 if nodes else 2)
    assert json.loads(port.stdout) == tables(port_root)[1]
    text = subprocess.run([progs.smoke, "--dev-root", port_root], capture_output=True, text=True,
                          timeout=30)
    assert text.returncode == port.returncode
    assert text.stdout.splitlines()[0] == f"GPUs visible: {len(nodes)}"


def test_a_short_buffer_is_retried(monkeypatch, progs, tmp_path):
    """-2 for no buffer, -3 for a short one, which ``gpuinfo`` retries with
    a larger buffer (an eight-card NVML table outgrows the reference's
    fixed 16384 bytes)."""
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_ok)
    lib = ctypes.CDLL(progs.lib)
    lib.gpuinfo_summary_json.argtypes = gpuinfo.NATIVE_SIGNATURES["gpuinfo_summary_json"][0]
    short = ctypes.create_string_buffer(8)
    assert lib.gpuinfo_summary_json(b"/dev", b"", b"", None, 0) == -2
    assert lib.gpuinfo_summary_json(b"/dev", b"", b"", short, len(short)) == -3
    reset_loaders(monkeypatch, progs.lib)
    full = gpuinfo.chip_summary("/dev", str(tmp_path), str(tmp_path))
    monkeypatch.setattr(gpuinfo, "NATIVE_BUF_BYTES", 8)
    assert gpuinfo.chip_summary("/dev", str(tmp_path), str(tmp_path)) == full
    monkeypatch.setattr(gpuinfo, "NATIVE_BUF_MAX", 32)
    with pytest.raises(RuntimeError, match="returned -3"):
        gpuinfo.chip_summary("/dev", str(tmp_path), str(tmp_path))


def test_metrics_json_gives_the_drop_file_or_the_python_counters(monkeypatch, progs, tmp_path):
    monkeypatch.setenv("NVML_LIBRARY", progs.nvml_ok)
    reset_loaders(monkeypatch, progs.lib)
    roots = ("/dev", str(tmp_path / "proc"), str(tmp_path / "sys"))
    drop = tmp_path / "run" / "metricsd.json"
    chips = gpuinfo.chip_summary(*roots)
    assert gpuinfo.native_metrics(str(drop), *roots) == gpuinfo.metrics(chips=chips)
    assert gpuinfo.metrics(chips=chips)["source"] == "nvml"
    drop.parent.mkdir()
    payload = {"source": "gpu-metricsd-native", "chips": [{"index": 5, "present": 1}], "big": "x" * 20000}
    drop.write_text(json.dumps(payload) + "\n")
    assert gpuinfo.native_metrics(str(drop), *roots) == payload
    reset_loaders(monkeypatch)
    with pytest.raises(RuntimeError, match="not loaded"):
        gpuinfo.native_metrics(str(drop), *roots)


def test_the_loader_order_and_that_loading_never_compiles(monkeypatch, progs, tmp_path, no_nvml):
    """``LIBGPUINFO_PATH``, then the build of the current source hash, then
    the installed path; without any, the Python path answers and nothing
    was built."""
    dev = _dev_tree(tmp_path / "dev", ["nvidia2"])
    monkeypatch.setattr(gpuinfo, "INSTALLED_LIB", str(tmp_path / "absent.so"))
    empty_root = tmp_path / "build"
    monkeypatch.setattr(native_build, "BUILD_ROOT", empty_root)
    monkeypatch.delenv("LIBGPUINFO_PATH", raising=False)
    for name, value in (("_native", None), ("_native_loaded", False), ("_lib", None), ("_loaded", False)):
        monkeypatch.setattr(gpuinfo, name, value)
    assert not gpuinfo.native_available()
    assert not empty_root.exists()
    assert [c["index"] for c in gpuinfo.chip_summary(dev)] == [2]

    # the build directory of this source hash
    built_root = os.path.dirname(os.path.dirname(progs.lib))
    assert native_build.build_dir(built_root) == native_build.Path(progs.lib).parent
    monkeypatch.setattr(native_build, "BUILD_ROOT", native_build.Path(built_root))
    monkeypatch.setattr(gpuinfo, "_native_loaded", False)
    assert gpuinfo.native_available() and gpuinfo._native._name == progs.lib

    # LIBGPUINFO_PATH first
    other = tmp_path / "libgpuinfo-copy.so"
    other.write_bytes(open(progs.lib, "rb").read())
    monkeypatch.setenv("LIBGPUINFO_PATH", str(other))
    monkeypatch.setattr(gpuinfo, "_native_loaded", False)
    assert gpuinfo.native_available() and gpuinfo._native._name == str(other)
    assert [c["index"] for c in gpuinfo.chip_summary(dev)] == [2]


def test_build_command_and_no_torch(tmp_path):
    """``python -m tpu_operator_torch.native.build --out DIR`` prints the
    compiler and the three paths; the build, the probe, the daemon and the
    chain import without torch."""
    out = subprocess.run([sys.executable, "-m", "tpu_operator_torch.native.build", "--out",
                          str(tmp_path)], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "built=True" in lines[0]
    assert [os.path.basename(p) for p in lines[1:]] == list(native_build.PROGRAMS)
    assert all(os.path.dirname(p) == str(native_build.build_dir(str(tmp_path))) for p in lines[1:])
    code = """
import sys
sys.modules["torch"] = None
import importlib
for mod in ("tpu_operator_torch.native.build", "tpu_operator_torch.native.gpuinfo",
            "tpu_operator_torch.metricsd.daemon", "tpu_operator_torch.metricsd.chain"):
    importlib.import_module(mod)
assert not any(m.startswith(("torch", "jax", "tpu_operator.")) for m, v in sys.modules.items() if v)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                         cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
