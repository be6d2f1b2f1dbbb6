"""The card probe of the node agents: chip table, counters, liveness.

The counterpart of ``tpu_operator/native/tpuinfo.py`` and the enumeration
of ``native/libtpuinfo.cpp``, with the same native-or-Python split
(``tpuinfo.py:1-8``). Where ``libgpuinfo.so`` (``csrc/libgpuinfo.cpp``,
built by ``native/build.py``) loads, it answers: it reaches NVML itself
through ``dlopen`` and falls to the device nodes and sysfs as the Python
path does. Without it, NVML is loaded here through ``ctypes`` where the
host driver ships ``libnvidia-ml.so.1``. Either way NVML gives each card's
name, UUID, PCI bus id, power limit, memory, utilization, temperature and
MIG mode (``source: "nvml"``); without NVML the table comes from the device
nodes, ``/proc/driver/nvidia/gpus`` and sysfs (``source: "sysfs"``). Every
path gives the same table, so callers never branch; ``source`` says which
backend answered and ``native_available()`` whether the library did.

Three orders number the cards: NVML's index, the minor number of
``/dev/nvidiaN`` and CUDA's default ``FASTEST_FIRST``. A card's ``index``
is its minor number, never a position, and a join between two sources is
keyed on the PCI bus id (``0000:bb:00.0``), never on an index.
"""

from __future__ import annotations

import ctypes
import errno
import glob
import json
import logging
import os
import re
from typing import Dict, List, Optional

from tpu_operator_torch.native import build as native_build

log = logging.getLogger("gpuinfo")

NVIDIA_PCI_VENDOR = "0x10de"
# VGA and 3D controllers; NVSwitch functions on HGX boards share the vendor
# and are bridges (0x0680xx)
CARD_PCI_CLASSES = ("0x0300", "0x0302")
PROC_GPUS = "/proc/driver/nvidia/gpus"
SYSFS_PCI = "/sys/bus/pci/devices"
_CARD_NODE = re.compile(r"nvidia(\d+)")

NVML_SUCCESS = 0
NVML_TEMPERATURE_GPU = 0  # nvmlTemperatureSensors_t: the die
NVML_NAMES = ("libnvidia-ml.so.1",)
_NAME_LEN = 96
_UUID_LEN = 96
_VERSION_LEN = 80  # NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE


class _PciInfo(ctypes.Structure):  # nvmlPciInfo_t
    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class _Memory(ctypes.Structure):  # nvmlMemory_t
    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class _Utilization(ctypes.Structure):  # nvmlUtilization_t
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


_HANDLE = ctypes.c_void_p
_UINT_P = ctypes.POINTER(ctypes.c_uint)
# every NVML entry the probe calls: (argtypes, restype)
NVML_SIGNATURES = {
    "nvmlInit_v2": ([], ctypes.c_int),
    "nvmlShutdown": ([], ctypes.c_int),
    "nvmlErrorString": ([ctypes.c_int], ctypes.c_char_p),
    "nvmlSystemGetDriverVersion": ([ctypes.c_char_p, ctypes.c_uint], ctypes.c_int),
    "nvmlDeviceGetCount_v2": ([_UINT_P], ctypes.c_int),
    "nvmlDeviceGetHandleByIndex_v2": ([ctypes.c_uint, ctypes.POINTER(_HANDLE)], ctypes.c_int),
    "nvmlDeviceGetName": ([_HANDLE, ctypes.c_char_p, ctypes.c_uint], ctypes.c_int),
    "nvmlDeviceGetUUID": ([_HANDLE, ctypes.c_char_p, ctypes.c_uint], ctypes.c_int),
    "nvmlDeviceGetMinorNumber": ([_HANDLE, _UINT_P], ctypes.c_int),
    "nvmlDeviceGetPciInfo_v3": ([_HANDLE, ctypes.POINTER(_PciInfo)], ctypes.c_int),
    "nvmlDeviceGetPowerManagementLimit": ([_HANDLE, _UINT_P], ctypes.c_int),
    "nvmlDeviceGetMemoryInfo": ([_HANDLE, ctypes.POINTER(_Memory)], ctypes.c_int),
    "nvmlDeviceGetUtilizationRates": ([_HANDLE, ctypes.POINTER(_Utilization)], ctypes.c_int),
    "nvmlDeviceGetTemperature": ([_HANDLE, ctypes.c_int, _UINT_P], ctypes.c_int),
    "nvmlDeviceGetMigMode": ([_HANDLE, _UINT_P, _UINT_P], ctypes.c_int),
}

# every entry of libgpuinfo.so: (argtypes, restype); the roots are
# ``dev_root, proc_root, sysfs``, and a JSON entry writes into the caller's
# buffer and returns 0, -2 for no buffer or -3 for a short one
_ROOTS = [ctypes.c_char_p] * 3
NATIVE_SIGNATURES = {
    "gpuinfo_chip_count": (_ROOTS, ctypes.c_int),
    "gpuinfo_summary_json": (_ROOTS + [ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "gpuinfo_metrics_json": (_ROOTS + [ctypes.c_char_p] * 2 + [ctypes.c_int], ctypes.c_int),
    "gpuinfo_device_probe_path": ([ctypes.c_char_p], ctypes.c_int),
}
INSTALLED_LIB = "/usr/local/lib/libgpuinfo.so"
NATIVE_SHORT_BUFFER = -3
NATIVE_BUF_BYTES = 16384  # the first buffer; a short one is retried 4x larger
NATIVE_BUF_MAX = 1 << 26

_lib = None
_loaded = False
_native = None
_native_loaded = False


class NvmlError(RuntimeError):
    pass


def _load():
    """NVML through ``ctypes``, once a process; None where the host driver
    ships no ``libnvidia-ml.so.1`` (``NVML_LIBRARY`` names another path)."""
    global _lib, _loaded
    if _loaded:
        return _lib
    _loaded = True
    explicit = os.environ.get("NVML_LIBRARY", "")
    for name in ([explicit] if explicit else []) + list(NVML_NAMES):
        try:
            lib = ctypes.CDLL(name)
            for fn, (argtypes, restype) in NVML_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        except (OSError, AttributeError) as e:
            log.info("NVML not usable from %s: %s", name, e)
            continue
        _lib = lib
        return _lib
    return None


def _load_native():
    """``libgpuinfo.so``, once a process: ``LIBGPUINFO_PATH``, then the
    build of the current source hash (``native/build.py``), then
    ``/usr/local/lib``; None where none loads. Loading never compiles."""
    global _native, _native_loaded
    if _native_loaded:
        return _native
    _native_loaded = True
    candidates = (
        os.environ.get("LIBGPUINFO_PATH", ""),
        str(native_build.build_dir() / native_build.LIB_NAME),
        INSTALLED_LIB,
    )
    for path in candidates:
        if not path or not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in NATIVE_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        except (OSError, AttributeError) as e:
            log.info("libgpuinfo not usable from %s: %s", path, e)
            continue
        _native = lib
        return _native
    return None


def native_available() -> bool:
    """Whether ``libgpuinfo.so`` answers the chip table."""
    return _load_native() is not None


def _native_json(fn, *args: str):
    """The JSON a libgpuinfo entry writes, with a larger buffer after a
    short one."""
    size = NATIVE_BUF_BYTES
    while True:
        buf = ctypes.create_string_buffer(size)
        rc = fn(*(a.encode() for a in args), buf, size)
        if rc == 0:
            return json.loads(buf.value.decode())
        if rc != NATIVE_SHORT_BUFFER or size >= NATIVE_BUF_MAX:
            raise RuntimeError(f"libgpuinfo: {fn.__name__} returned {rc} with {size} bytes")
        size *= 4


def normalize_bus_id(bus_id: str) -> str:
    """``00000000:BB:DD.F`` (NVML) or ``0000:bb:dd.f`` (sysfs, /proc) as
    sysfs spells it: a four-digit domain, lower case."""
    dom, rest = bus_id.strip().lower().split(":", 1)
    return f"{int(dom, 16):04x}:{rest}"


def is_card_function(vendor: Optional[str], pci_class: Optional[str]) -> bool:
    """An NVIDIA display or 3D controller: vendor 0x10de and class
    0x0300xx/0x0302xx; NVSwitch bridges (0x0680xx) are not cards."""
    return (vendor or "").strip().lower() == NVIDIA_PCI_VENDOR and (
        pci_class or ""
    ).strip().lower().startswith(CARD_PCI_CLASSES)


def card_functions(devices_dir: str = SYSFS_PCI) -> List[str]:
    """The sorted PCI addresses under a sysfs ``devices`` directory whose
    vendor and class read as a card: the functions the vfio manager binds
    and the ``vfio-pci`` component checks."""
    out = []
    for addr in sorted(os.listdir(devices_dir)) if os.path.isdir(devices_dir) else []:
        try:
            with open(os.path.join(devices_dir, addr, "vendor")) as f:
                vendor = f.read()
            with open(os.path.join(devices_dir, addr, "class")) as f:
                pci_class = f.read()
        except OSError:
            continue
        if is_card_function(vendor, pci_class):
            out.append(addr)
    return out


# ---------------------------------------------------------------------------
# NVML
# ---------------------------------------------------------------------------


def _nvml_error(lib, rc: int) -> str:
    msg = lib.nvmlErrorString(rc)
    return f"{rc} ({msg.decode() if msg else 'unknown'})"


def _check(lib, call: str, rc: int) -> None:
    if rc != NVML_SUCCESS:
        raise NvmlError(f"{call}: {_nvml_error(lib, rc)}")


def _nvml_card(lib, i: int, dev_root: str) -> dict:
    """Card ``i`` in NVML's order. Its handle, name and minor number must
    answer; the rest is left out where NVML does not support it."""
    handle = _HANDLE()
    _check(lib, "nvmlDeviceGetHandleByIndex_v2", lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(handle)))
    name = ctypes.create_string_buffer(_NAME_LEN)
    _check(lib, "nvmlDeviceGetName", lib.nvmlDeviceGetName(handle, name, _NAME_LEN))
    minor = ctypes.c_uint()
    _check(lib, "nvmlDeviceGetMinorNumber", lib.nvmlDeviceGetMinorNumber(handle, ctypes.byref(minor)))
    card = {
        "index": minor.value,
        "path": os.path.join(dev_root, f"nvidia{minor.value}"),
        "name": name.value.decode(),
        "source": "nvml",
    }
    skipped = []

    def answered(what: str, rc: int) -> bool:
        if rc != NVML_SUCCESS:
            skipped.append(f"{what} {_nvml_error(lib, rc)}")
        return rc == NVML_SUCCESS

    pci, uuid, limit = _PciInfo(), ctypes.create_string_buffer(_UUID_LEN), ctypes.c_uint()
    mem, util, temp = _Memory(), _Utilization(), ctypes.c_uint()
    mig, mig_pending = ctypes.c_uint(), ctypes.c_uint()
    if answered("pci", lib.nvmlDeviceGetPciInfo_v3(handle, ctypes.byref(pci))) and pci.busId:
        card["pci_address"] = normalize_bus_id(pci.busId.decode())
    if answered("uuid", lib.nvmlDeviceGetUUID(handle, uuid, _UUID_LEN)):
        card["uuid"] = uuid.value.decode()
    if answered("power limit", lib.nvmlDeviceGetPowerManagementLimit(handle, ctypes.byref(limit))):
        card["power_limit_mw"] = limit.value
    if answered("memory", lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem))):
        card["memory_total_bytes"], card["memory_used_bytes"] = mem.total, mem.used
    if answered("utilization", lib.nvmlDeviceGetUtilizationRates(handle, ctypes.byref(util))):
        card["utilization_gpu"], card["utilization_memory"] = util.gpu, util.memory
    if answered("temperature", lib.nvmlDeviceGetTemperature(handle, NVML_TEMPERATURE_GPU, ctypes.byref(temp))):
        card["temperature_c"] = temp.value
    if answered("mig mode", lib.nvmlDeviceGetMigMode(handle, ctypes.byref(mig), ctypes.byref(mig_pending))):
        card["mig_mode"], card["mig_mode_pending"] = mig.value, mig_pending.value
    if skipped:
        log.debug("nvml card %d: not reported: %s", i, "; ".join(skipped))
    return card


def _nvml_chips(lib, dev_root: str, sysfs: str) -> Optional[List[dict]]:
    """Every card NVML sees, by minor number, with sysfs's NUMA node and
    vendor joined on the PCI bus id; None when NVML does not answer."""
    rc = lib.nvmlInit_v2()
    if rc != NVML_SUCCESS:
        log.warning("nvmlInit_v2 failed: %s; reading sysfs", _nvml_error(lib, rc))
        return None
    try:
        count = ctypes.c_uint()
        _check(lib, "nvmlDeviceGetCount_v2", lib.nvmlDeviceGetCount_v2(ctypes.byref(count)))
        cards = [_nvml_card(lib, i, dev_root) for i in range(count.value)]
    except NvmlError as e:
        log.warning("NVML query failed: %s; reading sysfs", e)
        return None
    finally:
        lib.nvmlShutdown()
    for card in cards:
        if "pci_address" in card:
            card.update(_py_pci_info(card["pci_address"], sysfs))
    return sorted(cards, key=lambda c: c["index"])


# ---------------------------------------------------------------------------
# the probe's surface
# ---------------------------------------------------------------------------


def chip_summary(
    dev_root: str = "/dev", proc_root: str = PROC_GPUS, sysfs: str = SYSFS_PCI
) -> List[dict]:
    """Per-card dicts: ``{index, path, source, name?, uuid?, pci_address?,
    numa_node?, vendor?, pci_class?}``, with ``power_limit_mw``,
    ``memory_*_bytes``, ``utilization_*``, ``temperature_c`` and
    ``mig_mode``/``mig_mode_pending`` (1 enabled) where NVML answers."""
    native = _load_native()
    if native is not None:
        return _native_json(native.gpuinfo_summary_json, dev_root, proc_root, sysfs)
    lib = _load()
    if lib is not None:
        cards = _nvml_chips(lib, dev_root, sysfs)
        if cards is not None:
            return cards
    return _sysfs_chips(dev_root, proc_root, sysfs)


def driver_version() -> Optional[str]:
    """The kernel driver's version as NVML reports it (``550.54.15``); None
    where NVML is missing or does not answer."""
    lib = _load()
    if lib is None:
        return None
    rc = lib.nvmlInit_v2()
    if rc != NVML_SUCCESS:
        log.warning("nvmlInit_v2 failed: %s", _nvml_error(lib, rc))
        return None
    try:
        buf = ctypes.create_string_buffer(_VERSION_LEN)
        rc = lib.nvmlSystemGetDriverVersion(buf, _VERSION_LEN)
        if rc != NVML_SUCCESS:
            log.warning("nvmlSystemGetDriverVersion failed: %s", _nvml_error(lib, rc))
            return None
        return buf.value.decode()
    finally:
        lib.nvmlShutdown()


def chip_count(dev_root: str = "/dev") -> int:
    return len(chip_summary(dev_root))


def metrics(dev_root: str = "/dev", chips: Optional[List[dict]] = None) -> dict:
    """Utilization counters of ``chips`` (the chip table by default); NVML
    gives real values, the sysfs path gives presence only (``source``
    says which)."""
    chips = chips if chips is not None else chip_summary(dev_root)
    counters = ("utilization_gpu", "utilization_memory", "memory_used_bytes", "power_limit_mw",
                "temperature_c")
    return {
        "source": chips[0]["source"] if chips else "sysfs",
        "chips": [
            {"index": c["index"], "present": 1, **{k: c[k] for k in counters if k in c}}
            for c in chips
        ],
    }


def native_metrics(drop_file: str, dev_root: str = "/dev", proc_root: str = PROC_GPUS,
                   sysfs: str = SYSFS_PCI) -> dict:
    """What a file-based reader sees through ``libgpuinfo.so``: the metrics
    hostengine's drop file verbatim where it holds a JSON object, else
    ``metrics``'s counters over the chip table. Raises where the library is
    not loaded."""
    native = _load_native()
    if native is None:
        raise RuntimeError("libgpuinfo.so is not loaded")
    return _native_json(native.gpuinfo_metrics_json, dev_root, proc_root, sysfs, drop_file)


def device_probe_path(path: str, stat_only: bool = False) -> bool:
    """Liveness (not existence) of one device node: open and close it
    read-only and non-blocking. True when the open succeeds, the device is
    busy (EBUSY proves the driver path works) or the caller was denied
    (EPERM/EACCES: an unprivileged container's device cgroup says nothing
    about the card); False when the node is gone or wedged (ENOENT, ENXIO,
    EIO...).

    Takes the device PATH, never a positional index: enumeration order
    shifts when a node disappears, and health must not be given to the
    wrong card. VFIO groups allow one open file, so they are only
    stat'ed (``tpuinfo.py:146-154``). ``libgpuinfo.so`` answers where it
    is loaded, with the same rules."""
    if not path:
        return False
    if stat_only or os.sep + "vfio" + os.sep in path:
        try:
            os.stat(path)
            return True
        except OSError:
            return False
    native = _load_native()
    if native is not None:
        return native.gpuinfo_device_probe_path(path.encode()) >= 0
    return _py_probe_path(path)


def _py_probe_path(path: str) -> bool:
    """``device_probe_path``'s open, in Python."""
    try:
        fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        os.close(fd)
        return True
    except OSError as e:
        return e.errno in (errno.EBUSY, errno.EPERM, errno.EACCES)


# ---------------------------------------------------------------------------
# the Python path: device nodes, /proc/driver/nvidia, sysfs
# ---------------------------------------------------------------------------


def find_gpu_devices(dev_root: str = "/dev") -> List[str]:
    """Card nodes: ``/dev/nvidia[0-9]+`` (not ``nvidiactl``,
    ``nvidia-uvm*``, ``nvidia-modeset`` or ``nvidia-caps/``), or the
    ``/dev/vfio/*`` groups on VM-passthrough hosts."""
    nodes = sorted(
        p
        for p in glob.glob(os.path.join(dev_root, "nvidia*"))
        if _CARD_NODE.fullmatch(os.path.basename(p))
    )
    if nodes:
        return nodes
    return [
        p
        for p in sorted(glob.glob(os.path.join(dev_root, "vfio", "*")))
        if os.path.basename(p) != "vfio"
    ]


def _py_stable_indices(paths: List[str]) -> List[int]:
    """Stable device ids: the numeric suffix of each node name (nvidiaN's
    minor number, a vfio group's number), NOT the enumeration position.
    Names that do not parse get ids past the largest parsed one, so they
    can never shadow a real card; the parse is of the whole name
    (``nvidia0foo`` and ``noiommu-0`` claim no id). ``tpuinfo.py:171``."""
    parsed: List[Optional[int]] = []
    for p in paths:
        m = re.fullmatch(r"nvidia(\d+)|(\d+)", os.path.basename(p))
        parsed.append(int(m.group(1) or m.group(2)) if m else None)
    next_fallback = max((x for x in parsed if x is not None), default=-1)
    out = []
    for x in parsed:
        if x is None:
            next_fallback += 1
            x = next_fallback
        out.append(x)
    return out


def _proc_cards(proc_root: str) -> Dict[int, dict]:
    """{minor: {pci_address, name?, uuid?}} from each card's
    ``/proc/driver/nvidia/gpus/<bus id>/information``."""
    out: Dict[int, dict] = {}
    for info in sorted(glob.glob(os.path.join(proc_root, "*", "information"))):
        fields = {}
        try:
            with open(info) as f:
                for line in f:
                    key, sep, value = line.partition(":")
                    if sep:
                        fields[key.strip()] = value.strip()
        except OSError:
            continue
        try:
            minor = int(fields["Device Minor"])
            bus = fields.get("Bus Location") or os.path.basename(os.path.dirname(info))
            card = {"pci_address": normalize_bus_id(bus)}
        except (KeyError, ValueError):
            continue
        if fields.get("Model"):
            card["name"] = fields["Model"]
        if fields.get("GPU UUID"):
            card["uuid"] = fields["GPU UUID"]
        out[minor] = card
    return out


def _py_pci_info(pci_address: str, sysfs: str) -> dict:
    """vendor, pci_class and numa_node of one function from sysfs, each
    where it reads."""
    out = {}
    for key, fname, conv in (
        ("vendor", "vendor", str),
        ("pci_class", "class", str),
        ("numa_node", "numa_node", int),
    ):
        try:
            with open(os.path.join(sysfs, pci_address, fname)) as f:
                out[key] = conv(f.read().strip())
        except (OSError, ValueError):
            pass
    return out


def _sysfs_chips(dev_root: str, proc_root: str, sysfs: str) -> List[dict]:
    devs = find_gpu_devices(dev_root)
    proc = _proc_cards(proc_root)
    chips = []
    for idx, path in zip(_py_stable_indices(devs), devs):
        chip = {"index": idx, "path": path, "source": "sysfs"}
        card = proc.get(idx) if _CARD_NODE.fullmatch(os.path.basename(path)) else None
        if card is not None:
            chip.update(card)
            chip.update(_py_pci_info(card["pci_address"], sysfs))
            if "vendor" in chip and "pci_class" in chip and not is_card_function(
                chip["vendor"], chip["pci_class"]
            ):
                continue
        chips.append(chip)
    return sorted(chips, key=lambda c: c["index"])
