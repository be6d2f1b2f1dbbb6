"""GPU feature discovery (``discovery/tfd.py``) against the reference's
``tpu_operator/discovery/tfd.py`` on mapped fixtures: ``accelN`` ↔
``nvidiaN`` nodes, the reference's GKE topology label ↔ the port's
``TPU_TOPOLOGY``, libtpu's version ↔ the driver's, in the same run.

Equal by design: the card count, the slice's host count, the worker id,
the slice id (with its node-pool fallback), the version string, the
pruning of stale labels and the NFD file's format. Different by design:
the names (``nvidia.com/gpu.*`` for the chip type, count and memory,
``nvidia.com/cuda.driver-version.full`` for libtpu's version), memory in
MiB from NVML for HBM GB from a table, and no wraparound label: NVSwitch
has no torus."""

import ctypes
import os
import subprocess
import sys

import pytest

from tests.conftest import make_tpu_node
from tpu_operator import consts as ref_consts
from tpu_operator.discovery import tfd as ref
from tpu_operator.kube import FakeClient
from tpu_operator.native import tpuinfo
from tpu_operator_torch import consts
from tpu_operator_torch.discovery import tfd
from tpu_operator_torch.native import gpuinfo

VERSION = "550.54.15"
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.fixture()
def roots(tmp_path):
    """(ref dev root, ref libtpu dir, port dev root, port driver root)."""
    out = []
    for side, prefix in (("r", "accel"), ("p", "nvidia")):
        d = tmp_path / side / "dev"
        d.mkdir(parents=True)
        for i in range(4):
            (d / f"{prefix}{i}").touch()
        out.append(str(d))
    lib = tmp_path / "libtpu"
    lib.mkdir()
    (lib / f"libtpu-{VERSION}.so").touch()
    drv = tmp_path / "driver" / "usr" / "lib64"
    drv.mkdir(parents=True)
    for name in ("libcuda.so", "libcuda.so.1", f"libcuda.so.{VERSION}", "libnvidia-ml.so.1"):
        (drv / name).touch()
    return out[0], str(lib), out[1], str(tmp_path / "driver")


def table(n=4, memory=True):
    chips = [{"index": i, "path": f"/dev/nvidia{i}", "name": H100, "source": "nvml"} for i in (1, 3, 5, 7)[:n]]
    if memory:
        for c in chips:
            c["memory_total_bytes"] = 81559 * 2**20
    return chips


def test_gather_features_matches_the_reference(roots):
    ref_dev, lib, dev, driver = roots
    node = make_tpu_node("n1", accelerator="tpu-v5p-slice", topology="2x2x4",
                         extra_labels={ref_consts.GKE_NODEPOOL_LABEL: "pool-a"})
    theirs = ref.gather_features(node, dev_root=ref_dev, libtpu_dir=lib, env={"TPU_WORKER_ID": "2"})
    mine = tfd.gather_features(node, dev_root=dev, driver_root=driver, chips=table(),
                               env={"TPU_WORKER_ID": "2", "TPU_TOPOLOGY": "4x8"})
    pairs = [
        (ref_consts.TFD_CHIP_COUNT_LABEL, consts.GPU_COUNT_LABEL),
        (ref_consts.TFD_SLICE_HOSTS_LABEL, consts.TFD_SLICE_HOSTS_LABEL),
        (ref_consts.TFD_WORKER_ID_LABEL, consts.TFD_WORKER_ID_LABEL),
        (ref_consts.TFD_SLICE_ID_LABEL, consts.TFD_SLICE_ID_LABEL),
        (ref_consts.TFD_LIBTPU_VERSION_LABEL, consts.DRIVER_VERSION_LABEL),
    ]
    for theirs_key, my_key in pairs:
        assert mine[my_key] == theirs[theirs_key], my_key
    assert (theirs[ref_consts.TFD_SLICE_HOSTS_LABEL], mine[consts.TFD_SLICE_ID_LABEL]) == ("4", "pool-a")
    assert mine[consts.GPU_PRODUCT_LABEL] == "NVIDIA-H100-80GB-HBM3"
    assert mine[consts.GPU_MEMORY_LABEL] == "81559"
    assert mine[consts.TFD_TOPOLOGY_LABEL] == "4x8"
    assert theirs[ref_consts.TFD_ICI_WRAP_LABEL] == "true"
    assert not any("wrap" in k for k in mine)
    assert set(mine) == set(tfd.MANAGED_LABELS)


def test_gather_features_on_one_board(roots):
    """No slice topology: the host's NVLink domains, one host, no slice id;
    no memory where NVML gave none."""
    _, _, dev, driver = roots
    feats = tfd.gather_features({"metadata": {}}, dev_root=dev, driver_root=driver,
                                chips=table(memory=False), env={})
    assert feats == {
        consts.GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
        consts.GPU_COUNT_LABEL: "4",
        consts.TFD_TOPOLOGY_LABEL: "1x4",
        consts.TFD_SLICE_HOSTS_LABEL: "1",
        consts.DRIVER_VERSION_LABEL: VERSION,
    }


def test_gather_features_from_the_sysfs_table(roots):
    """Off NVML the table has no name: count and topology only, as the
    reference publishes count alone without a generation."""
    ref_dev, lib, dev, _ = roots
    theirs = ref.gather_features({"metadata": {}}, dev_root=ref_dev, libtpu_dir=lib, env={})
    mine = tfd.gather_features({"metadata": {}}, dev_root=dev, driver_root=lib, env={})
    assert mine[consts.GPU_COUNT_LABEL] == theirs[ref_consts.TFD_CHIP_COUNT_LABEL] == "4"
    assert consts.GPU_PRODUCT_LABEL not in mine and consts.TFD_SLICE_HOSTS_LABEL not in mine
    assert consts.DRIVER_VERSION_LABEL not in mine


class _FakeNvml:
    def __init__(self, rc=0):
        self.rc, self.shutdowns = rc, 0

    def nvmlInit_v2(self):
        return 0

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlErrorString(self, rc):
        return b"Not Supported"

    def nvmlSystemGetDriverVersion(self, buf, n):
        assert n == 80
        ctypes.memmove(buf, VERSION.encode() + b"\0", len(VERSION) + 1)
        return self.rc


def test_driver_version_reader_matches_the_reference(roots, tmp_path, monkeypatch):
    """NVML first, as the reference reads the installer's marker first;
    else the versioned library name, as the reference reads
    ``libtpu-<version>.so``; else nothing."""
    _, lib, _, driver = roots
    assert tfd.driver_version(driver) == ref._libtpu_version(lib) == VERSION
    marker = tmp_path / "marker"
    marker.mkdir()
    (marker / "VERSION").write_text("535.1.2\n")
    fake = _FakeNvml()
    monkeypatch.setattr(gpuinfo, "_load", lambda: fake)
    assert tfd.driver_version(str(tmp_path / "nothing")) == VERSION
    assert fake.shutdowns == 1
    assert ref._libtpu_version(str(marker)) == "535.1.2"
    monkeypatch.setattr(gpuinfo, "_load", lambda: _FakeNvml(rc=3))
    assert gpuinfo.driver_version() is None
    assert tfd.driver_version(driver) == VERSION  # falls back to the file name
    # an older driver's library kept beside the live one: the .so.1 link decides
    two = tmp_path / "two" / "usr" / "lib64"
    two.mkdir(parents=True)
    for v in ("535.1.2", VERSION, "575.57.08"):
        (two / f"libcuda.so.{v}").touch()
    os.symlink(f"libcuda.so.{VERSION}", two / "libcuda.so.1")
    assert tfd.driver_version(str(tmp_path / "two")) == VERSION
    empty = tmp_path / "empty" / "usr" / "lib64"
    empty.mkdir(parents=True)
    (empty / "libcuda.so.1").touch()
    assert tfd.driver_version(str(tmp_path / "empty")) == ref._libtpu_version(str(empty)) == ""


def test_apply_features_prunes_stale_as_the_reference(roots):
    ref_dev, lib, dev, driver = roots
    results = []
    for mod, kw, count_key in (
        (ref, dict(dev_root=ref_dev, libtpu_dir=lib), ref_consts.TFD_CHIP_COUNT_LABEL),
        (tfd, dict(dev_root=dev, driver_root=driver, chips=table()), consts.GPU_COUNT_LABEL),
    ):
        client = FakeClient([make_tpu_node("n1", extra_labels={"keep/me": "x"})])
        node = client.get("v1", "Node", "n1")
        feats = mod.gather_features(node, env={}, **kw)
        first = mod.apply_features(client, "n1", feats)
        labels = client.get("v1", "Node", "n1")["metadata"]["labels"]
        assert labels[count_key] == "4"
        again = mod.apply_features(client, "n1", feats)
        feats2 = dict(feats)
        del feats2[count_key]
        pruned = mod.apply_features(client, "n1", feats2)
        labels = client.get("v1", "Node", "n1")["metadata"]["labels"]
        results.append((first, again, pruned, count_key in labels, labels["keep/me"]))
    assert results[1] == results[0] == (True, False, True, False, "x")


def test_nfd_feature_file_matches_the_reference(roots, tmp_path):
    ref_dev, lib, dev, driver = roots
    node = make_tpu_node("n1")
    theirs = ref.gather_features(node, dev_root=ref_dev, libtpu_dir=lib, env={})
    mine = tfd.gather_features(node, dev_root=dev, driver_root=driver, chips=table(), env={})
    ref.write_nfd_feature_file(theirs, str(tmp_path / "r" / "tpu"))
    tfd.write_nfd_feature_file(mine, str(tmp_path / "p" / "gpu"))
    for path, feats in ((tmp_path / "r" / "tpu", theirs), (tmp_path / "p" / "gpu", mine)):
        lines = path.read_text().splitlines()
        assert lines == [f"{k}={v}" for k, v in sorted(feats.items())]
    assert f"{consts.GPU_COUNT_LABEL}=4" in (tmp_path / "p" / "gpu").read_text().splitlines()


def test_run_loop_once_labels_the_node(roots, monkeypatch):
    _, _, dev, driver = roots
    monkeypatch.setattr(gpuinfo, "chip_summary", lambda dev_root="/dev", *a, **k: table())
    client = FakeClient([make_tpu_node("n1")])
    tfd.run_loop(client, "n1", once=True, dev_root=dev, driver_root=driver)
    labels = client.get("v1", "Node", "n1")["metadata"]["labels"]
    assert labels[consts.GPU_PRODUCT_LABEL] == "NVIDIA-H100-80GB-HBM3"
    assert labels[consts.DRIVER_VERSION_LABEL] == VERSION
    assert tfd.main([]) == 1  # no node name


def test_discovery_runs_as_a_program():
    proc = subprocess.run([sys.executable, "-m", "tpu_operator_torch.discovery", "--help"],
                          capture_output=True, text=True, timeout=60,
                          env={k: v for k, v in os.environ.items() if k != "NODE_NAME"})
    assert proc.returncode == 0 and "--driver-root" in proc.stdout, proc.stderr
