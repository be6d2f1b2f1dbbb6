"""CDI generation (``plugin/cdi.py``) and the runtime wire
(``operands/runtime_wire.py``) against the reference's on one fixture: the
same devfs tree with names mapped ``accelN`` ↔ ``nvidiaN``, the same
partition file, written by the reference's slice manager.

Equal by design: the device names, one device a card plus ``all`` plus one
composite a subslice, each with the same cards' nodes. Different by design:
the kind (``nvidia.com/gpu`` for ``google.com/tpu``), the spec-level edits
(the driver's control nodes and libraries for the libtpu mount and its
env), no per-device env, and JSON where the path ends in ``.json``."""

import json
import os
import signal
import subprocess
import sys
import threading

import pytest
import yaml

from tpu_operator.native import tpuinfo
from tpu_operator.operands import runtime_wire as ref_wire
from tpu_operator.plugin import cdi as ref_cdi
from tpu_operator.sliceman import slice_manager as sm
from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.operands import runtime_wire
from tpu_operator_torch.plugin import cdi
from tpu_operator_torch.validator import components as comp

CARDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.fixture()
def trees(tmp_path):
    """(ref dev root, port dev root, port driver root)."""
    ref_dev, dev = tmp_path / "ref" / "dev", tmp_path / "port" / "dev"
    for d, prefix in ((ref_dev, "accel"), (dev, "nvidia")):
        d.mkdir(parents=True)
        for i in CARDS:
            (d / f"{prefix}{i}").touch()
    for ctl in ("nvidiactl", "nvidia-uvm"):
        (dev / ctl).touch()
    lib = tmp_path / "driver" / "usr" / "lib64"
    lib.mkdir(parents=True)
    for name in ("libcuda.so.1", "libcuda.so.550.54.15", "libnvidia-ml.so.1"):
        (lib / name).touch()
    return str(ref_dev), str(dev), str(tmp_path / "driver")


@pytest.fixture()
def partitions(tmp_path):
    path = str(tmp_path / "partitions.json")
    sm.write_partition_state(sm.compute_partitions("2x2", "v5e", "2x1"), path)
    return path


def _devices(spec):
    return [
        (d["name"], [os.path.basename(n["path"]).replace("accel", "nvidia")
                     for n in d["containerEdits"]["deviceNodes"]])
        for d in spec["devices"]
    ]


@pytest.mark.parametrize("partitioned", [False, True])
def test_build_spec_matches_the_reference(trees, partitions, tmp_path, partitioned):
    ref_dev, dev, driver = trees
    part = partitions if partitioned else str(tmp_path / "none.json")
    theirs = ref_cdi.build_spec(dev_root=ref_dev, libtpu_dir="/lib/tpu", partition_file=part)
    mine = cdi.build_spec(dev_root=dev, driver_root=driver, partition_file=part)
    assert _devices(mine) == _devices(theirs)
    names = [d["name"] for d in mine["devices"]]
    want = ["0", "1", "2", "3", "all"] + (["subslice-0-2x1", "subslice-1-2x1"] if partitioned else [])
    assert names == want
    assert (theirs["kind"], mine["kind"]) == ("google.com/tpu", "nvidia.com/gpu")
    assert mine["cdiVersion"] == theirs["cdiVersion"]
    edits = mine["containerEdits"]
    assert [n["path"] for n in edits["deviceNodes"]] == [os.path.join(dev, "nvidiactl"),
                                                        os.path.join(dev, "nvidia-uvm")]
    assert sorted(m["containerPath"] for m in edits["mounts"]) == [
        "/usr/lib64/libcuda.so.1", "/usr/lib64/libcuda.so.550.54.15", "/usr/lib64/libnvidia-ml.so.1"]
    assert all(m["options"][0] == "ro" and m["hostPath"].startswith(driver) for m in edits["mounts"])
    assert all("env" not in d["containerEdits"] for d in mine["devices"])


def test_spec_from_a_chip_table_keeps_minor_numbers(trees, tmp_path):
    _, dev, driver = trees
    chips = [{"index": i, "path": os.path.join(dev, f"nvidia{i}")} for i in (3, 5, 7)]
    spec = cdi.build_spec(dev_root=dev, driver_root=driver, chips=chips,
                          partition_file=str(tmp_path / "none.json"))
    assert [d["name"] for d in spec["devices"]] == ["3", "5", "7", "all"]
    assert spec["devices"][1]["containerEdits"]["deviceNodes"] == [
        {"path": os.path.join(dev, "nvidia5"), "permissions": "rw"}]


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_write_spec_matches_the_reference_and_the_toolkit_reads_it(trees, partitions, tmp_path, suffix):
    ref_dev, dev, driver = trees
    theirs_path = tmp_path / "ref-cdi" / "google.com-tpu.yaml"
    theirs = ref_cdi.write_spec(str(theirs_path), dev_root=ref_dev, libtpu_dir="/lib/tpu",
                                partition_file=partitions)
    path = tmp_path / "cdi" / f"nvidia{suffix}"
    mine = cdi.write_spec(str(path), dev_root=dev, driver_root=driver, partition_file=partitions)
    on_disk = json.loads(path.read_text()) if suffix == ".json" else yaml.safe_load(path.read_text())
    assert on_disk == mine
    assert yaml.safe_load(theirs_path.read_text()) == theirs
    assert _devices(mine) == _devices(theirs)
    assert not os.path.exists(str(path) + ".tmp")
    info = comp.validate_toolkit(comp.StatusFiles(str(tmp_path / "val")), cdi_spec_path=str(path))
    assert info["devices"] == [d["name"] for d in mine["devices"]]


def test_json_spec_needs_no_yaml(trees, tmp_path):
    _, dev, driver = trees
    code = (
        "import sys, json; sys.modules['yaml'] = None; "
        "from tpu_operator_torch.plugin import cdi; "
        f"s = cdi.write_spec({str(tmp_path / 's.json')!r}, dev_root={dev!r}, "
        f"driver_root={driver!r}, chips=[{{'index': 0}}]); print(json.dumps(s['kind']))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == consts.GPU_RESOURCE


def test_cdi_defaults_agree_with_the_toolkit_component():
    import inspect

    assert cdi.DEFAULT_SPEC_PATH == consts.CDI_SPEC_PATH
    default = inspect.signature(comp.validate_toolkit).parameters["cdi_spec_path"].default
    assert default == cdi.DEFAULT_SPEC_PATH
    assert cdi.CDI_KIND == consts.GPU_RESOURCE


def test_wire_once_matches_the_reference(trees, tmp_path):
    ref_dev, dev, driver = trees
    theirs = ref_wire.wire_once(str(tmp_path / "r" / "spec.yaml"), dev_root=ref_dev,
                                libtpu_dir="/lib/tpu", containerd_conf_dir=str(tmp_path / "r-conf"))
    conf = tmp_path / "conf"
    mine = runtime_wire.wire_once(str(tmp_path / "p" / "spec.json"), dev_root=dev, driver_root=driver,
                                  containerd_conf_dir=str(conf))
    # the reference reads its partition file from /run/tpu; neither exists here
    assert _devices(mine) == _devices(theirs)
    snippet = (conf / runtime_wire.SNIPPET_NAME).read_text()
    assert snippet.splitlines()[1:] == ref_wire.CONTAINERD_SNIPPET.splitlines()[1:]
    (conf / runtime_wire.SNIPPET_NAME).write_text("# kept\n")
    runtime_wire.wire_once(str(tmp_path / "p" / "spec.json"), dev_root=dev, driver_root=driver,
                           containerd_conf_dir=str(conf))
    assert (conf / runtime_wire.SNIPPET_NAME).read_text() == "# kept\n"  # written once


def test_wire_pass_refreshes_on_card_or_partition_change(trees, tmp_path):
    _, dev, driver = trees
    status = comp.StatusFiles(str(tmp_path / "val"))
    out = tmp_path / "cdi" / "nvidia.json"
    part = tmp_path / "partitions.json"
    kw = dict(dev_root=dev, driver_root=driver, partition_file=str(part))
    sig = runtime_wire.wire_pass(status, str(out), None, **kw)
    ready = json.loads((tmp_path / "val" / consts.STATUS_FILE_TOOLKIT).read_text())
    assert ready == {"cdiSpec": str(out), "chips": 4}
    # nothing changed: no rewrite
    out.unlink()
    assert runtime_wire.wire_pass(status, str(out), sig, **kw) == sig
    assert not out.exists()
    # a repartition rewrites the spec with the composite devices
    sm.write_partition_state(sm.compute_partitions("2x2", "v5e", "2x1"), str(part))
    sig2 = runtime_wire.wire_pass(status, str(out), sig, **kw)
    assert sig2 != sig
    assert [d["name"] for d in json.loads(out.read_text())["devices"]][-2:] == [
        "subslice-0-2x1", "subslice-1-2x1"]
    # a card leaving rewrites it too
    os.unlink(os.path.join(dev, "nvidia3"))
    runtime_wire.wire_pass(status, str(out), sig2, **kw)
    assert [d["name"] for d in json.loads(out.read_text())["devices"]][:4] == ["0", "1", "2", "all"]
    assert json.loads((tmp_path / "val" / consts.STATUS_FILE_TOOLKIT).read_text())["chips"] == 3


def test_runtime_wire_main_once(trees, tmp_path):
    _, dev, driver = trees
    out = tmp_path / "spec.json"
    rc = runtime_wire.main(["--cdi-output", str(out), "--dev-root", dev, "--driver-root", driver,
                            "--output-dir", str(tmp_path / "val"), "--once"])
    assert rc == 0 and out.exists()
    assert (tmp_path / "val" / consts.STATUS_FILE_TOOLKIT).exists()


def test_runtime_wire_removes_toolkit_ready_on_sigterm(trees, tmp_path):
    """As a program: writes the spec and ``toolkit-ready``, then on SIGTERM
    removes ``toolkit-ready`` and exits 0."""
    _, dev, driver = trees
    out, val = tmp_path / "spec.json", tmp_path / "val"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.operands.runtime_wire", "--cdi-output", str(out),
         "--dev-root", dev, "--driver-root", driver, "--output-dir", str(val), "--interval", "0.05"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    seen = threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if "CDI spec refreshed" in line:
                seen.set()

    threading.Thread(target=pump, daemon=True).start()
    try:
        assert seen.wait(60), "".join(lines)
        assert (val / consts.STATUS_FILE_TOOLKIT).exists()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not (val / consts.STATUS_FILE_TOOLKIT).exists()
    assert out.exists()
