"""The port's node-status exporter (``validator/metrics.py``) against the
reference's on the same fixtures: the perf read, the status-file and
probe gauges, the live driver re-validation, the card count, capacity and
the validator-perf annotation; each watcher's one pass without
``prometheus_client``, and the gauges ``run()`` serves."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
from prometheus_client import CollectorRegistry

from tpu_operator import consts as ref_consts
from tpu_operator.kube import FakeClient
from tpu_operator.native import tpuinfo
from tpu_operator.validator import metrics as ref
from tpu_operator.validator.components import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.validator import metrics
from tpu_operator_torch.validator.components import StatusFiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.mark.parametrize(
    "payload",
    [
        {"tflops": 123.4, "ok": True},
        {"gbps": 2900.5},
        {"tflops": "812.5", "gbps": 3001},
        {"result": {"tflops": 99.0}},  # legacy nested
        {"result": {"gbps": 1.5}, "tflops": None},
        {"tflops": "n/a"},
        {"result": "Succeeded", "workload": "pod"},  # the workload-pod payload: no perf
        {},
        None,
        ["tflops"],
    ],
)
def test_payload_perf_matches_the_reference(payload):
    assert metrics.payload_perf(payload) == ref.payload_perf(payload)


def _ref_status_gauges(status, reg):
    nm = ref.NodeMetrics(node_name="n1", status=status, registry=reg)
    nm.WATCH_STATUS_S = 0.01
    t = threading.Thread(target=nm._watch_status_files, daemon=True)
    t.start()
    time.sleep(0.15)
    nm._stop.set()
    t.join(timeout=5)
    assert not t.is_alive()


@pytest.mark.parametrize(
    "files",
    [
        {"cuda": {"tflops": 123.4}, "ringattn-ready": {"ok": True}, "moe-ready": {"ok": True}},
        {"driver": {}, "toolkit": {}, "plugin": {}, "cuda": {"result": {"tflops": 7.5}}},
        {"membw-ready": {"gbps": 10.0}, "slice-workload-ready": {}},
        {},
    ],
)
def test_status_pass_matches_the_reference_gauges(tmp_path, files):
    names = {"driver": ("libtpu-ready", "driver-ready"), "toolkit": ("runtime-ready", "toolkit-ready"),
             "plugin": ("plugin-ready", "plugin-ready"), "cuda": ("jax-ready", "cuda-ready")}
    rstatus, pstatus = RefStatusFiles(str(tmp_path / "ref")), StatusFiles(str(tmp_path / "port"))
    for key, payload in files.items():
        rname, pname = names.get(key, (key, key))
        rstatus.write(rname, payload)
        pstatus.write(pname, payload)
    reg = CollectorRegistry()
    _ref_status_gauges(rstatus, reg)
    out = metrics.NodeMetrics(node_name="n1", status=pstatus).status_pass()
    g = lambda name, **labels: reg.get_sample_value(name, {"node": "n1", **labels})  # noqa: E731
    for key, (rname, pname) in names.items():
        assert out["ready"][pname] == g(f"tpu_validator_{rname.replace('-ready', '')}_ready")
    for name in consts.PROBE_STATUS_FILES:
        probe = name.removesuffix("-ready")
        assert out["probes"][probe] == g("tpu_validator_probe_ready", probe=probe)
    assert out["cuda_tflops"] == g("tpu_validator_jax_matmul_tflops")


def _tree(tmp_path, nodes, lib_rel):
    dev, root = tmp_path / "dev", tmp_path / "root"
    dev.mkdir(parents=True, exist_ok=True)
    for n in nodes:
        (dev / n).touch()
    lib = root / lib_rel
    lib.parent.mkdir(parents=True, exist_ok=True)
    lib.touch()
    return dev, root


def _ref_driver_gauge(tmp_path, nodes):
    dev, lib_dir = _tree(tmp_path / "ref", nodes, "libtpu.so")
    reg = CollectorRegistry()
    nm = ref.NodeMetrics(node_name="n1", status=RefStatusFiles(str(tmp_path)), registry=reg,
                         install_dir=str(lib_dir), dev_root=str(dev))
    nm.WATCH_LIBTPU_S = 0.01
    t = threading.Thread(target=nm._watch_libtpu, daemon=True)
    t.start()
    value = None
    deadline = time.time() + 3
    while value is None and time.time() < deadline:
        value = reg.get_sample_value("tpu_validator_libtpu_validation", {"node": "n1"})
        time.sleep(0.01)
    nm._stop.set()
    t.join(timeout=5)
    return value, dev


@pytest.mark.parametrize("wedged", [False, True])
def test_driver_pass_matches_the_libtpu_watcher(tmp_path, wedged):
    """OPEN-probe, not stat: a wedged card whose node still exists reads 0
    on both sides (``validator/metrics.go:237-250``)."""
    nodes = ["accel0", "accel1"]
    if wedged:
        os.makedirs(tmp_path / "ref" / "dev", exist_ok=True)
        os.symlink("/nonexistent/card", tmp_path / "ref" / "dev" / "accel1")
        nodes = ["accel0"]
    rvalue, _ = _ref_driver_gauge(tmp_path, nodes)
    dev, root = _tree(tmp_path / "port", ["nvidia0", "nvidiactl"] + ([] if wedged else ["nvidia1"]),
                      "usr/lib64/libcuda.so.1")
    if wedged:
        os.symlink("/nonexistent/card", dev / "nvidia1")
    nm = metrics.NodeMetrics(node_name="n1", status=StatusFiles(str(tmp_path)),
                             driver_root=str(root), dev_root=str(dev))
    assert nm.driver_pass() == rvalue == (0 if wedged else 1)


def test_driver_pass_needs_libcuda_and_survives_probe_exceptions(tmp_path, monkeypatch):
    dev, root = _tree(tmp_path, ["nvidia0"], "usr/lib64/libnvidia-ml.so.1")
    nm = metrics.NodeMetrics(status=StatusFiles(str(tmp_path)), driver_root=str(root), dev_root=str(dev))
    assert nm.driver_pass() == 0  # no libcuda
    (root / "usr/lib64/libcuda.so.1").touch()
    assert nm.driver_pass() == 1

    def wedged(path):
        raise RuntimeError("probe machinery wedged")

    monkeypatch.setattr(gpuinfo, "device_probe_path", wedged)
    assert nm.driver_pass() == 0
    monkeypatch.undo()
    assert nm.driver_pass() == 1


@pytest.mark.parametrize("nodes", [["accel0", "accel1", "accel5"], [], ["accel0"]])
def test_devices_pass_counts_like_the_reference(tmp_path, nodes):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    for n in nodes:
        (tmp_path / "ref" / n).touch()
        (tmp_path / "port" / n.replace("accel", "nvidia")).touch()
    (tmp_path / "port" / "nvidiactl").touch()
    reg = CollectorRegistry()
    rnm = ref.NodeMetrics(node_name="n1", registry=reg, dev_root=str(tmp_path / "ref"))
    rnm.WATCH_PCI_S = 0.01
    t = threading.Thread(target=rnm._watch_devices, daemon=True)
    t.start()
    time.sleep(0.1)
    rnm._stop.set()
    t.join(timeout=5)
    nm = metrics.NodeMetrics(node_name="n1", dev_root=str(tmp_path / "port"))
    assert nm.devices_pass() == reg.get_sample_value("tpu_validator_tpu_devices", {"node": "n1"})


def _node(name, capacity, labels=None):
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": labels or {}},
            "status": {"capacity": capacity}}


def test_capacity_pass_matches_the_reference():
    rclient = FakeClient([_node("n1", {ref_consts.TPU_RESOURCE: "4", "google.com/tpu-2x2": "2"})])
    pclient = FakeClient([_node("n1", {consts.GPU_RESOURCE: "4", "nvidia.com/mig-1g.10gb": "2"})])
    reg = CollectorRegistry()
    rnm = ref.NodeMetrics(client=rclient, node_name="n1", registry=reg)
    rnm.WATCH_PLUGIN_S = 0.01
    t = threading.Thread(target=rnm._watch_plugin_capacity, daemon=True)
    t.start()
    time.sleep(0.1)
    rnm._stop.set()
    t.join(timeout=5)
    nm = metrics.NodeMetrics(client=pclient, node_name="n1")
    assert nm.capacity_pass() == reg.get_sample_value("tpu_validator_tpu_capacity", {"node": "n1"}) == 6
    assert metrics.NodeMetrics(node_name="n1").capacity_pass() is None


@pytest.mark.parametrize("env_version", ["", "580.159.03"])
def test_perf_annotation_matches_the_reference(tmp_path, monkeypatch, env_version):
    """The same validator-perf annotation, tagged with the driver's version
    where the reference tags libtpu's."""
    monkeypatch.setenv("LIBTPU_VERSION", env_version)
    monkeypatch.setenv("DRIVER_VERSION", env_version)
    rclient = FakeClient([_node("n1", {}, {ref_consts.TFD_LIBTPU_VERSION_LABEL: "550.1"})])
    pclient = FakeClient([_node("n1", {}, {consts.DRIVER_VERSION_LABEL: "550.1"})])
    perf = {"tflops": 812.345, "gbps": 2950.04}
    ref.NodeMetrics(client=rclient, node_name="n1", registry=CollectorRegistry())._publish_perf_annotation(perf)
    metrics.NodeMetrics(client=pclient, node_name="n1")._publish_perf_annotation(perf)
    key = consts.VALIDATOR_PERF_ANNOTATION
    assert key == ref_consts.VALIDATOR_PERF_ANNOTATION
    got = pclient.get("v1", "Node", "n1")["metadata"]["annotations"][key]
    assert got == rclient.get("v1", "Node", "n1")["metadata"]["annotations"][key]
    assert json.loads(got)["version"] == (env_version or "550.1")


def test_passes_run_without_prometheus_client(tmp_path):
    code = (
        "import sys; sys.modules['prometheus_client'] = None\n"
        "from tpu_operator_torch.validator.metrics import NodeMetrics\n"
        "from tpu_operator_torch.validator.components import StatusFiles\n"
        f"nm = NodeMetrics(status=StatusFiles({str(tmp_path)!r}), dev_root={str(tmp_path)!r})\n"
        "print(nm.status_pass()['ready'], nm.driver_pass(), nm.capacity_pass(), nm.devices_pass())\n"
        "assert 'torch' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "'driver-ready': 0" in proc.stdout


def test_run_serves_the_gauges(tmp_path):
    status = StatusFiles(str(tmp_path / "v"))
    status.write(consts.STATUS_FILE_CUDA, {"tflops": 512.0})
    status.write("moe-ready", {"ok": True})
    dev, root = _tree(tmp_path, ["nvidia0", "nvidia1", "nvidiactl"], "usr/lib64/libcuda.so.1")
    reg = CollectorRegistry()
    nm = metrics.NodeMetrics(client=FakeClient([_node("n1", {consts.GPU_RESOURCE: "2"})]),
                             node_name="n1", status=status, port=0, driver_root=str(root),
                             dev_root=str(dev), registry=reg)
    nm.run(block=False)
    try:
        want = {
            "gpu_validator_cuda_ready": 1, "gpu_validator_driver_ready": 0,
            "gpu_validator_cuda_matmul_tflops": 512.0, "gpu_validator_driver_validation": 1,
            "gpu_validator_gpu_capacity": 2, "gpu_validator_gpu_devices": 2,
        }
        deadline = time.time() + 5
        got = {}
        while time.time() < deadline:
            got = {k: reg.get_sample_value(k, {"node": "n1"}) for k in want}
            if got == want:
                break
            time.sleep(0.02)
        assert got == want
        assert reg.get_sample_value("gpu_validator_probe_ready", {"node": "n1", "probe": "moe"}) == 1
    finally:
        nm.stop()
