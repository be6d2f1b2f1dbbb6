"""The port's card probe (``native/gpuinfo.py``) against the reference's
``native/tpuinfo.py`` on the same fixture trees, names mapped
(``accelN`` ↔ ``nvidiaN``): stable indices, the liveness probe, the
sysfs-path table and counters; and the parts with no reference: card
nodes against the driver's other nodes, the PCI class filter, and NVML
through a stand-in library."""

import ctypes
import os

import pytest

from tpu_operator.native import tpuinfo
from tpu_operator_torch.native import gpuinfo


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    """Both probes on their Python paths: no libtpuinfo, no NVML."""
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


def _mapped(name: str) -> str:
    return name.replace("accel", "nvidia")


@pytest.mark.parametrize(
    "names",
    [
        ["accel0", "accel1", "accel2"],
        ["accel0", "accel2", "accel7"],  # holes: ids stay the suffixes
        ["accel3", "accelX", "accel0foo", "accel1"],  # non-parsing names go past the max
        ["accelX", "accelY"],
        ["0", "3", "noiommu-0", "12"],  # vfio groups
        [],
    ],
)
def test_stable_indices_match_the_reference(names):
    ref = tpuinfo._py_stable_indices([f"/dev/{n}" for n in names])
    port = gpuinfo._py_stable_indices([f"/dev/{_mapped(n)}" for n in names])
    assert port == ref


@pytest.mark.parametrize("case", ["regular", "missing", "vfio_group", "vfio_missing", "empty"])
def test_device_probe_path_matches_the_reference(tmp_path, case):
    (tmp_path / "vfio").mkdir()
    (tmp_path / "nvidia0").touch()
    (tmp_path / "vfio" / "7").touch()
    path = {
        "regular": str(tmp_path / "nvidia0"),
        "missing": str(tmp_path / "nvidia9"),
        "vfio_group": str(tmp_path / "vfio" / "7"),
        "vfio_missing": str(tmp_path / "vfio" / "8"),
        "empty": "",
    }[case]
    assert gpuinfo.device_probe_path(path) == tpuinfo.device_probe_path(path)
    assert gpuinfo.device_probe_path(path, stat_only=True) == tpuinfo.device_probe_path(
        path, stat_only=True
    )


def test_wedged_node_reads_dead(tmp_path):
    os.symlink("/nonexistent/card", tmp_path / "nvidia1")
    assert gpuinfo.device_probe_path(str(tmp_path / "nvidia1")) is False


def _dev_tree(root, names):
    root.mkdir(parents=True, exist_ok=True)
    for name in names:
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
    return str(root)


@pytest.mark.parametrize(
    "ref_names",
    [
        ["accel0", "accel1"],
        ["accel0", "accel3", "accel10"],
        ["vfio/vfio", "vfio/0", "vfio/5"],  # passthrough host: groups, not the control node
    ],
)
def test_sysfs_table_matches_the_reference(tmp_path, ref_names):
    ref_root = _dev_tree(tmp_path / "ref", ref_names)
    port_root = _dev_tree(tmp_path / "port", [_mapped(n) for n in ref_names])
    # the driver's other nodes are not cards
    _dev_tree(tmp_path / "port", ["nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset",
                                  "nvidia-caps/nvidia-cap1", "nvidia-nvswitch0", "nvidia0foo"])
    ref = tpuinfo.chip_summary(ref_root)
    port = gpuinfo.chip_summary(port_root, proc_root=str(tmp_path / "proc"), sysfs=str(tmp_path / "sys"))
    assert [c.pop("source") for c in port] == ["sysfs"] * len(ref)
    assert port == [
        {**c, "path": c["path"].replace(ref_root, port_root).replace("accel", "nvidia")}
        for c in ref
    ]
    assert [os.path.basename(p) for p in gpuinfo.find_gpu_devices(port_root)] == [
        _mapped(os.path.basename(p)) for p in tpuinfo._py_devices(ref_root)
    ]
    assert gpuinfo.chip_count(port_root) == tpuinfo.chip_count(ref_root)
    ref_m, port_m = tpuinfo.metrics(ref_root), gpuinfo.metrics(port_root)
    assert (ref_m["source"], port_m["source"]) == ("fallback", "sysfs")
    # the reference lists its fallback counters in glob order, the port by index
    assert port_m["chips"] == sorted(ref_m["chips"], key=lambda c: c["index"])


def _pci_fn(sysfs, addr, vendor, cls, numa=0):
    d = sysfs / addr
    d.mkdir(parents=True)
    (d / "vendor").write_text(vendor + "\n")
    (d / "class").write_text(cls + "\n")
    (d / "numa_node").write_text(f"{numa}\n")


def _proc_card(proc, addr, minor, model="NVIDIA H100 80GB HBM3"):
    d = proc / addr
    d.mkdir(parents=True)
    (d / "information").write_text(
        f"Model: \t\t {model}\nIRQ:   \t\t 86\nGPU UUID: \t GPU-{minor:08d}\n"
        f"Bus Location: \t {addr}\nDevice Minor: \t {minor}\n"
    )


def test_proc_and_sysfs_identity_and_the_class_filter(tmp_path):
    """Each node's PCI identity comes from /proc/driver/nvidia by its minor
    number (not its position), sysfs adds vendor/class/NUMA, and a
    function that is not a display or 3D controller (an NVSwitch bridge,
    0x068000, with the same vendor) is no card."""
    dev = _dev_tree(tmp_path / "dev", ["nvidia0", "nvidia2", "nvidia5", "nvidiactl"])
    proc, sysfs = tmp_path / "proc", tmp_path / "sys"
    _proc_card(proc, "0000:18:00.0", 0)
    _proc_card(proc, "0000:2a:00.0", 2)
    _proc_card(proc, "0000:9c:00.0", 5, model="NVSwitch")
    _pci_fn(sysfs, "0000:18:00.0", "0x10de", "0x030200", numa=0)
    _pci_fn(sysfs, "0000:2a:00.0", "0x10de", "0x030000", numa=1)
    _pci_fn(sysfs, "0000:9c:00.0", "0x10de", "0x068000", numa=1)
    chips = gpuinfo.chip_summary(dev, proc_root=str(proc), sysfs=str(sysfs))
    assert [(c["index"], c["pci_address"], c["numa_node"]) for c in chips] == [
        (0, "0000:18:00.0", 0),
        (2, "0000:2a:00.0", 1),
    ]
    assert chips[0]["name"] == "NVIDIA H100 80GB HBM3" and chips[1]["uuid"] == "GPU-00000002"
    assert all(c["source"] == "sysfs" and c["vendor"] == "0x10de" for c in chips)


@pytest.mark.parametrize(
    "vendor,cls,card",
    [
        ("0x10de", "0x030200", True),  # 3D controller (H100 SXM)
        ("0x10de", "0x030000", True),  # VGA controller
        ("0x10de", "0x068000", False),  # NVSwitch bridge
        ("0x10de", "0x040300", False),  # the card's audio function
        ("0x1ae0", "0x120000", False),  # a TPU
        ("0x8086", "0x030000", False),
        (None, None, False),
    ],
)
def test_is_card_function(vendor, cls, card):
    assert gpuinfo.is_card_function(vendor, cls) is card


@pytest.mark.parametrize(
    "raw,want",
    [("00000000:BB:00.0", "0000:bb:00.0"), ("0000:18:00.0", "0000:18:00.0"),
     ("00000001:1A:00.1", "0001:1a:00.1")],
)
def test_normalize_bus_id(raw, want):
    assert gpuinfo.normalize_bus_id(raw) == want


def test_loader_without_nvml_reads_sysfs(monkeypatch, tmp_path):
    """No libnvidia-ml.so.1 on the host: the loader finds nothing and the
    table has the sysfs shape with source "sysfs"."""
    monkeypatch.undo()  # the real loader
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)
    monkeypatch.setattr(gpuinfo, "_lib", None)
    monkeypatch.setattr(gpuinfo, "_loaded", False)
    monkeypatch.setattr(gpuinfo, "NVML_NAMES", ("libnvidia-ml-absent.so.1",))
    monkeypatch.setenv("NVML_LIBRARY", str(tmp_path / "libnvidia-ml.so.1"))
    assert gpuinfo._load() is None
    dev = _dev_tree(tmp_path / "dev", ["nvidia0", "nvidia1"])
    chips = gpuinfo.chip_summary(dev, proc_root=str(tmp_path / "proc"), sysfs=str(tmp_path / "sys"))
    assert chips == [
        {"index": 0, "path": os.path.join(dev, "nvidia0"), "source": "sysfs"},
        {"index": 1, "path": os.path.join(dev, "nvidia1"), "source": "sysfs"},
    ]


class _FakeNvml:
    """Stands in for libnvidia-ml.so.1: each entry takes the ctypes
    arguments the probe passes and writes through them, as NVML does.
    ``cards`` is NVML's order: (name, minor, bus id or None, limit mW)."""

    def __init__(self, cards, init_rc=0):
        self.cards, self.init_rc, self.shutdowns = cards, init_rc, 0

        def handle(i, out):
            out._obj.value = i + 1
            return 0

        def card(h):
            return self.cards[h.value - 1]

        def name(h, buf, n):
            buf.value = card(h)[0].encode()
            return 0

        def minor(h, out):
            out._obj.value = card(h)[1]
            return 0

        def pci(h, out):
            bus = card(h)[2]
            if bus is None:
                return 3  # NVML_ERROR_NOT_SUPPORTED
            out._obj.busId = bus.encode()
            return 0

        def limit(h, out):
            out._obj.value = card(h)[3]
            return 0

        def shutdown():
            self.shutdowns += 1
            return 0

        def count(out):
            out._obj.value = len(self.cards)
            return 0

        self.nvmlInit_v2 = lambda: self.init_rc
        self.nvmlShutdown = shutdown
        self.nvmlErrorString = lambda rc: {3: b"Not Supported", 9: b"Driver Not Loaded"}[rc]
        self.nvmlDeviceGetCount_v2 = count
        self.nvmlDeviceGetHandleByIndex_v2 = handle
        self.nvmlDeviceGetName = name
        self.nvmlDeviceGetUUID = lambda h, buf, n: 3
        self.nvmlDeviceGetMinorNumber = minor
        self.nvmlDeviceGetPciInfo_v3 = pci
        self.nvmlDeviceGetPowerManagementLimit = limit
        self.nvmlDeviceGetMemoryInfo = lambda h, out: 3
        self.nvmlDeviceGetUtilizationRates = lambda h, out: 3
        self.nvmlDeviceGetTemperature = lambda h, sensor, out: 3
        self.nvmlDeviceGetMigMode = lambda h, current, pending: 3


def test_nvml_table_keys_cards_by_minor_and_bus_id(monkeypatch, tmp_path):
    """NVML's order is not the minor numbers': each card's index is its
    minor, its bus id is spelled as sysfs does and joins sysfs's NUMA node;
    an entry NVML does not support is left out, not guessed."""
    sysfs = tmp_path / "sys"
    _pci_fn(sysfs, "0000:bb:00.0", "0x10de", "0x030200", numa=1)
    lib = _FakeNvml([("NVIDIA H100 80GB HBM3", 5, "00000000:BB:00.0", 700000),
                     ("NVIDIA H100 80GB HBM3", 3, None, 700000)])
    monkeypatch.setattr(gpuinfo, "_load", lambda: lib)
    chips = gpuinfo.chip_summary("/dev", sysfs=str(sysfs))
    assert chips == [
        {"index": 3, "path": "/dev/nvidia3", "name": "NVIDIA H100 80GB HBM3", "source": "nvml",
         "power_limit_mw": 700000},
        {"index": 5, "path": "/dev/nvidia5", "name": "NVIDIA H100 80GB HBM3", "source": "nvml",
         "pci_address": "0000:bb:00.0", "power_limit_mw": 700000, "vendor": "0x10de",
         "pci_class": "0x030200", "numa_node": 1},
    ]
    assert lib.shutdowns == 1
    assert gpuinfo.metrics("/dev") == {
        "source": "nvml",
        "chips": [{"index": 3, "present": 1, "power_limit_mw": 700000},
                  {"index": 5, "present": 1, "power_limit_mw": 700000}],
    }


def test_nvml_that_does_not_answer_reads_sysfs(monkeypatch, tmp_path):
    lib = _FakeNvml([], init_rc=9)
    monkeypatch.setattr(gpuinfo, "_load", lambda: lib)
    dev = _dev_tree(tmp_path / "dev", ["nvidia0"])
    chips = gpuinfo.chip_summary(dev, proc_root=str(tmp_path / "p"), sysfs=str(tmp_path / "s"))
    assert [c["source"] for c in chips] == ["sysfs"]


def test_nvml_signatures_are_ctypes_declarations():
    """Every entry the probe calls is declared, so the real library gets
    argtypes and restype before its first call."""
    for fn, (argtypes, restype) in gpuinfo.NVML_SIGNATURES.items():
        assert fn.startswith("nvml")
        assert restype in (ctypes.c_int, ctypes.c_char_p)
        assert isinstance(argtypes, list)
    assert ctypes.sizeof(gpuinfo._PciInfo) == 16 + 5 * 4 + 32
