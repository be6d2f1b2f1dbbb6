"""The port's host checks against the reference's on the same fixtures,
names mapped (``accelN`` ↔ ``nvidiaN``, ``libtpu.so`` ↔ ``libcuda.so`` +
``libnvidia-ml.so``, ``google.com/tpu`` ↔ ``nvidia.com/gpu``, the PCI
vendor 0x1ae0 ↔ 0x10de with a display class): the same verdict and the
same payload keys. The reference's own cases are
``tests/test_validator.py:35-395``."""

import json
import os
import subprocess
import sys
import threading

import pytest
import yaml

from tpu_operator import consts as ref_consts
from tpu_operator.kube import FakeClient
from tpu_operator.native import tpuinfo
from tpu_operator.operands import devchar as ref_devchar
from tpu_operator.validator import components as ref
from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.operands import devchar
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.validator import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = "tpu-operator"


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    """Both sides poll every 10 ms instead of 5 s."""
    from tpu_operator.validator import workload_pods as ref_wp
    from tpu_operator_torch.validator import workload_pods as wp

    for mod in (ref, comp):
        monkeypatch.setattr(mod, "WAIT_SLEEP_S", 0.01)
    for mod in (ref_wp, wp):
        monkeypatch.setattr(mod.run_to_completion, "__defaults__", (mod.POLL_RETRIES, 0.01))


@pytest.fixture()
def statuses(tmp_path):
    return (ref.StatusFiles(str(tmp_path / "ref")), comp.StatusFiles(str(tmp_path / "port")))


def _verdict(fn, *args, **kw):
    """("ok", payload keys) or ("error", message)."""
    try:
        return "ok", fn(*args, **kw)
    except RuntimeError as e:
        return "error", str(e)


@pytest.mark.parametrize("mod", [ref, comp], ids=["reference", "port"])
def test_status_file_lifecycle_and_barrier(tmp_path, mod):
    status = mod.StatusFiles(str(tmp_path))
    assert not status.exists("driver-ready")
    status.write("driver-ready", {"x": 1})
    with open(status.path("driver-ready")) as f:
        assert json.load(f) == {"x": 1}
    status.remove("driver-ready")
    status.remove("driver-ready")  # idempotent
    assert not status.exists("driver-ready")
    t = threading.Timer(0.05, lambda: status.write("driver-ready"))
    t.start()
    status.wait_for("driver-ready", retries=200)
    with pytest.raises(mod.ValidationError, match="timed out"):
        status.wait_for("never-appears", retries=2)


# ---------------------------------------------------------------------------
# driver (libtpu)
# ---------------------------------------------------------------------------


def _touch(root, names):
    for name in names:
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()


@pytest.mark.parametrize(
    "devices,libs,ok",
    [
        ([], True, False),  # no devices
        (["accel0", "accel1"], False, False),  # devices, no library
        (["accel0", "accel1"], True, True),
        (["accel0", "accel7"], True, True),  # a hole in the minors
        (["vfio/vfio", "vfio/0"], True, True),  # passthrough host: the group, not the control node
    ],
)
def test_driver_matches_libtpu(tmp_path, statuses, devices, libs, ok):
    ref_dev, port_dev = tmp_path / "ref-dev", tmp_path / "port-dev"
    ref_dev.mkdir()
    port_dev.mkdir()
    _touch(ref_dev, devices)
    mapped = [d.replace("accel", "nvidia") for d in devices]
    _touch(port_dev, mapped + (["nvidiactl"] if any("nvidia" in d for d in mapped) else []))
    lib, root = tmp_path / "libtpu", tmp_path / "driver-root"
    lib.mkdir()
    (root / "usr/lib/x86_64-linux-gnu").mkdir(parents=True)
    if libs:
        (lib / "libtpu.so").touch()
        _touch(root, ["usr/lib/x86_64-linux-gnu/libcuda.so.1",
                      "usr/lib/x86_64-linux-gnu/libnvidia-ml.so.1"])
    r = _verdict(ref.validate_libtpu, statuses[0], install_dir=str(lib), dev_root=str(ref_dev))
    p = _verdict(comp.validate_driver, statuses[1], driver_root=str(root), dev_root=str(port_dev))
    assert (r[0], p[0]) == ("ok",) * 2 if ok else ("error",) * 2, (r, p)
    if not ok:
        assert statuses[1].exists(consts.STATUS_FILE_DRIVER) is False
        return
    rinfo, pinfo = r[1], p[1]
    assert set(rinfo) - {"chips", "devCharSymlinks"} == {"devices", "libtpu"}
    assert set(pinfo) - {"devCharSymlinks"} == {"devices", "libcuda", "libnvidia_ml", "chips"}
    assert [os.path.basename(d) for d in pinfo["devices"]] == [
        os.path.basename(d).replace("accel", "nvidia") for d in rinfo["devices"]
    ]
    assert [c["index"] for c in pinfo["chips"]] == gpuinfo._py_stable_indices(pinfo["devices"])
    with open(statuses[1].path(consts.STATUS_FILE_DRIVER)) as f:
        assert json.load(f) == pinfo


def test_driver_needs_nvidiactl_and_both_libraries(tmp_path, statuses):
    dev, root = tmp_path / "dev", tmp_path / "root"
    _touch(dev, ["nvidia0"])
    _touch(root, ["lib64/libcuda.so.580.1"])
    with pytest.raises(comp.ValidationError, match="nvidiactl"):
        comp.validate_driver(statuses[1], driver_root=str(root), dev_root=str(dev))
    _touch(dev, ["nvidiactl"])
    with pytest.raises(comp.ValidationError, match="libnvidia-ml.so not found"):
        comp.validate_driver(statuses[1], driver_root=str(root), dev_root=str(dev))
    _touch(root, ["usr/local/nvidia/lib64/libnvidia-ml.so.1"])
    info = comp.validate_driver(statuses[1], driver_root=str(root), dev_root=str(dev))
    assert info["libcuda"] == [str(root / "lib64/libcuda.so.580.1")]


def test_driver_waits_on_the_driver_container(tmp_path, statuses):
    with pytest.raises(comp.ValidationError, match=r"\.driver-ctr-ready"):
        comp.validate_driver(statuses[1], dev_root=str(tmp_path), with_wait=True)
    with pytest.raises(ref.ValidationError, match=r"\.libtpu-ctr-ready"):
        ref.validate_libtpu(statuses[0], dev_root=str(tmp_path), with_wait=True)


def _run_cli(args, block_torch=False):
    pre = "import sys; sys.modules['torch'] = None; " if block_torch else ""
    code = pre + "from tpu_operator_torch.validator.main import main; sys.exit(main(sys.argv[1:]))"
    return subprocess.run([sys.executable, "-c", "import sys; " + code, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_cli_driver_and_toolkit_run_without_torch(tmp_path):
    """The host checks import no torch: with ``torch`` blocked, the driver
    and toolkit components pass through the CLI, as the reference's libtpu
    and runtime components do."""
    _touch(tmp_path / "dev", ["nvidia0", "nvidiactl"])
    _touch(tmp_path / "root", ["usr/lib64/libcuda.so.1", "usr/lib64/libnvidia-ml.so.1"])
    spec = tmp_path / "nvidia.json"
    spec.write_text(json.dumps({"kind": "nvidia.com/gpu", "devices": [{"name": "0"}]}))
    out = tmp_path / "validations"
    for args, status_file in (
        (["--component", "driver", "--driver-root", str(tmp_path / "root"),
          "--dev-root", str(tmp_path / "dev")], "driver-ready"),
        (["--component", "toolkit", "--cdi-spec", str(spec)], "toolkit-ready"),
    ):
        proc = _run_cli([*args, "--output-dir", str(out)], block_torch=True)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert (out / status_file).exists()
    proc = _run_cli(["--component", "toolkit", "--cdi-spec", str(tmp_path / "missing.json"),
                     "--output-dir", str(out)], block_torch=True)
    assert proc.returncode == 1 and "CDI spec missing" in proc.stderr


def test_node_agents_import_neither_torch_nor_optional_packages():
    """The host checks, the exporter, the daemon and their helpers import
    no torch, and PyYAML and prometheus_client only where they are used."""
    code = (
        "import importlib, sys\n"
        "for m in ('validator.main', 'validator.components', 'validator.metrics',\n"
        "          'validator.workload_pods', 'native.gpuinfo', 'operands.devchar',\n"
        "          'operands.vm_manager', 'controllers.slice_status',\n"
        "          'controllers.state_manager', 'kube.incluster', 'metricsd.daemon'):\n"
        "    importlib.import_module('tpu_operator_torch.' + m)\n"
        "bad = sorted(n for n in ('torch', 'yaml', 'prometheus_client', 'jax', 'tpu_operator')\n"
        "             if n in sys.modules)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cli_has_a_counterpart_of_every_reference_component():
    from tpu_operator.validator.main import COMPONENTS as REF

    counterpart = {"libtpu": "driver", "runtime": "toolkit", "jax": "cuda"}
    assert sorted(cli.COMPONENTS) == sorted(counterpart.get(c, c) for c in REF)
    assert len(cli.COMPONENTS) == 16


def test_cli_host_check_flags_and_environment(monkeypatch):
    monkeypatch.setenv("DRIVER_ROOT", "/host/driver")
    monkeypatch.setenv("CDI_SPEC_PATH", "/etc/cdi/nvidia.json")
    monkeypatch.setenv("WITH_WAIT", "true")
    monkeypatch.setenv("NODE_NAME", "n1")
    monkeypatch.setenv("VM_DEVICE_STATE_FILE", "/run/x.json")
    args = cli.build_parser().parse_args(["--component", "driver"])
    assert (args.driver_root, args.cdi_spec, args.with_wait) == ("/host/driver", "/etc/cdi/nvidia.json", True)
    assert (args.node_name, args.vm_state_file, args.with_workload) == ("n1", "/run/x.json", False)
    assert (args.dev_root, args.sysfs, args.metrics_port) == ("/dev", "/sys/bus/pci/devices", 8000)


# ---------------------------------------------------------------------------
# devchar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod,node", [(ref_devchar, "accel0"), (devchar, "nvidia0")],
                         ids=["reference", "port"])
def test_devchar_links_and_stale_link(tmp_path, monkeypatch, mod, node):
    dev = tmp_path / "dev"
    dev.mkdir()
    monkeypatch.setattr(
        mod, "_char_devices",
        lambda dev_root="/dev": [(str(dev / node), 195, 0), (str(dev / "vfio" / "7"), 241, 7)],
    )
    char_dir = tmp_path / "char"
    char_dir.mkdir()
    os.symlink("/nonexistent/old", char_dir / "195:0")
    created = mod.create_dev_char_symlinks(str(dev), str(char_dir))
    assert sorted(os.path.basename(c) for c in created) == ["195:0", "241:7"]
    assert os.readlink(char_dir / "195:0") == str(dev / node)
    assert mod.create_dev_char_symlinks(str(dev), str(char_dir)) == []  # idempotent


@pytest.mark.parametrize("mod", [ref_devchar, devchar], ids=["reference", "port"])
def test_devchar_no_devices_is_noop(tmp_path, mod):
    (tmp_path / "dev").mkdir()
    assert mod.create_dev_char_symlinks(str(tmp_path / "dev"), str(tmp_path / "char")) == []
    assert not (tmp_path / "char").exists()


def test_devchar_globs_take_every_driver_node(tmp_path, monkeypatch):
    """Every node the driver makes gets its link (the cards, the control,
    UVM and modeset nodes, the MIG caps) and the VFIO groups; a node of
    another driver does not."""
    names = ["nvidia0", "nvidia3", "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset",
             "nvidia-caps/nvidia-cap1", "vfio/7", "accel0", "nvidia-nvswitch0"]
    _touch(tmp_path, names)
    monkeypatch.setattr(devchar.stat, "S_ISCHR", lambda mode: True)
    found = sorted(os.path.relpath(p, tmp_path) for p, _, _ in devchar._char_devices(str(tmp_path)))
    assert found == sorted(n for n in names if n not in ("accel0", "nvidia-nvswitch0"))


# ---------------------------------------------------------------------------
# toolkit (runtime)
# ---------------------------------------------------------------------------


def _write_spec(path, doc):
    if str(path).endswith(".json"):
        path.write_text(json.dumps(doc))
    else:
        path.write_text(yaml.safe_dump(doc))


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
@pytest.mark.parametrize("case", ["missing", "no_devices", "devices"])
def test_toolkit_matches_runtime(tmp_path, statuses, suffix, case):
    ref_spec, port_spec = tmp_path / "google.com-tpu.yaml", tmp_path / f"nvidia{suffix}"
    if case != "missing":
        devices = [] if case == "no_devices" else [{"name": "0"}, {"name": "1"}]
        _write_spec(ref_spec, {"cdiVersion": "0.6.0", "kind": ref_consts.TPU_RESOURCE, "devices": devices})
        _write_spec(port_spec, {"cdiVersion": "0.6.0", "kind": consts.GPU_RESOURCE, "devices": devices})
    r = _verdict(ref.validate_runtime, statuses[0], cdi_spec_path=str(ref_spec))
    p = _verdict(comp.validate_toolkit, statuses[1], cdi_spec_path=str(port_spec))
    assert r[0] == p[0]
    if r[0] == "error":
        assert r[1].replace(str(ref_spec), "SPEC") == p[1].replace(str(port_spec), "SPEC")
    else:
        assert r[1]["devices"] == p[1]["devices"] == ["0", "1"]
        assert set(r[1]) == set(p[1]) == {"cdiSpec", "devices"}
        assert statuses[1].exists(consts.STATUS_FILE_TOOLKIT)


def test_toolkit_refuses_a_spec_of_another_kind(tmp_path, statuses):
    spec = tmp_path / "tpu.json"
    spec.write_text(json.dumps({"kind": "google.com/tpu", "devices": [{"name": "0"}]}))
    with pytest.raises(comp.ValidationError, match="not nvidia.com/gpu"):
        comp.validate_toolkit(statuses[1], cdi_spec_path=str(spec))


# ---------------------------------------------------------------------------
# plugin
# ---------------------------------------------------------------------------


def _node(name, capacity=None, allocatable=None, labels=None):
    node = {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or {})},
            "status": {"capacity": capacity or {}}}
    if allocatable is not None:
        node["status"]["allocatable"] = allocatable
    return node


def _res(mapping, resource, prefix):
    return {k.replace("TPU", resource).replace("SUB-", prefix): v for k, v in (mapping or {}).items()}


@pytest.mark.parametrize(
    "capacity,allocatable",
    [
        ({"TPU": "8"}, None),
        ({"SUB-2x2": "2"}, None),  # subslices ↔ MIG slices
        ({"TPU": "4", "SUB-1g.10gb": "3"}, None),
        ({}, None),  # never advertised
        ({"TPU": "8"}, {"TPU": "0"}),  # all cards unhealthy
        ({"TPU": "8"}, {"TPU": "6"}),
        ({"TPU": "x"}, None),
    ],
)
def test_plugin_matches_the_reference(statuses, capacity, allocatable):
    rnode = _node("n1", _res(capacity, ref_consts.TPU_RESOURCE, ref_consts.TPU_SUBSLICE_RESOURCE_PREFIX),
                  _res(allocatable, ref_consts.TPU_RESOURCE, ref_consts.TPU_SUBSLICE_RESOURCE_PREFIX)
                  if allocatable else None)
    pnode = _node("n1", _res(capacity, consts.GPU_RESOURCE, consts.MIG_RESOURCE_PREFIX),
                  _res(allocatable, consts.GPU_RESOURCE, consts.MIG_RESOURCE_PREFIX)
                  if allocatable else None)
    assert comp.node_gpu_capacity(pnode) == ref.node_tpu_capacity(rnode)
    assert comp.node_gpu_allocatable(pnode) == ref.node_tpu_allocatable(rnode)
    r = _verdict(ref.validate_plugin, statuses[0], FakeClient([rnode]), "n1", retries=2, sleep_s=0)
    p = _verdict(comp.validate_plugin, statuses[1], FakeClient([pnode]), "n1", retries=2, sleep_s=0)
    assert r[0] == p[0]
    if r[0] == "ok":
        assert r[1] == p[1]
    else:
        assert r[1].replace(ref_consts.TPU_RESOURCE, "R").replace("chips", "cards") == p[1].replace(
            consts.GPU_RESOURCE, "R")


def _kubelet(client, phase, prefix=""):
    def watcher(event, obj):
        if event == "ADDED" and obj["kind"] == "Pod" and obj["metadata"]["name"].startswith(prefix):
            def finish():
                pod = client.get("v1", "Pod", obj["metadata"]["name"], NS)
                pod["status"] = {"phase": phase}
                client.update_status(pod)

            threading.Timer(0.05, finish).start()

    client.add_watcher(watcher)


@pytest.mark.parametrize("phase", ["Succeeded", "Failed"])
def test_plugin_and_cuda_workload_pods(statuses, phase):
    """The ``--with-workload`` paths: one pod, one card, polled to its end;
    the cuda payload holds the pod's outcome and no perf fields."""
    results = []
    for mod, status, resource, calls in (
        (ref, statuses[0], ref_consts.TPU_RESOURCE,
         (lambda c, s: ref.validate_plugin(s, c, "n1", with_workload=True, namespace=NS, retries=1, sleep_s=0),
          lambda c, s: ref.validate_jax(s, client=c, node_name="n1", namespace=NS, with_workload=True))),
        (comp, statuses[1], consts.GPU_RESOURCE,
         (lambda c, s: comp.validate_plugin(s, c, "n1", with_workload=True, namespace=NS, retries=1, sleep_s=0),
          lambda c, s: comp.validate_cuda(s, client=c, node_name="n1", namespace=NS, with_workload=True))),
    ):
        out = []
        for call in calls:
            client = FakeClient([_node("n1", {resource: "4"})])
            _kubelet(client, phase)
            verdict = _verdict(call, client, status)
            if verdict[0] == "ok":
                pods = client.list("v1", "Pod", NS)
                assert [p["spec"]["containers"][0]["resources"]["limits"] for p in pods] == [{resource: "1"}]
                verdict = ("ok", sorted(verdict[1]))
            out.append(verdict if verdict[0] == "ok" else ("error", "failed" in verdict[1]))
        results.append(out)
    assert results[0] == results[1]
    if phase == "Succeeded":
        assert results[1] == [("ok", ["allocatable", "capacity", "node", "workload"]),
                              ("ok", ["result", "workload"])]


def test_cuda_workload_needs_a_client(statuses):
    with pytest.raises(comp.ValidationError, match="needs a k8s client"):
        comp.validate_cuda(statuses[1], with_workload=True)


# ---------------------------------------------------------------------------
# vfio-pci and the sandbox components
# ---------------------------------------------------------------------------


def _pci(sysfs, addr, vendor, cls=None, driver=None):
    d = sysfs / addr
    d.mkdir(parents=True)
    (d / "vendor").write_text(vendor + "\n")
    if cls is not None:
        (d / "class").write_text(cls + "\n")
    if driver:
        os.symlink(f"/sys/bus/pci/drivers/{driver}", d / "driver")


@pytest.mark.parametrize(
    "functions",
    [
        [("04.0", "vfio-pci")],
        [("04.0", "vfio-pci"), ("06.0", None)],  # one unbound
        [("04.0", "nvidia"), ("06.0", "vfio-pci")],
        [],  # no accelerator function at all
    ],
)
def test_vfio_pci_matches_the_reference(tmp_path, statuses, functions):
    rsys, psys = tmp_path / "ref", tmp_path / "port"
    for sysfs, vendor, cls in ((rsys, "0x1ae0", "0x120000"), (psys, "0x10de", "0x030200")):
        sysfs.mkdir()
        _pci(sysfs, "0000:00:05.0", "0x8086", "0x060000")  # another vendor
        for slot, driver in functions:
            _pci(sysfs, f"0000:00:{slot}", vendor, cls, driver)
    # an NVSwitch bridge of the same vendor, not bound: not a card
    _pci(psys, "0000:00:07.0", "0x10de", "0x068000", "nvidia-nvswitch")
    r = _verdict(ref.validate_vfio_pci, statuses[0], sysfs=str(rsys))
    p = _verdict(comp.validate_vfio_pci, statuses[1], sysfs=str(psys))
    assert r[0] == p[0]
    if r[0] == "ok":
        assert r[1] == p[1]
        assert statuses[1].exists(consts.STATUS_FILE_VFIO_PCI)
    else:
        assert r[1].replace("TPU", "GPU").replace("Google PCI accelerator", "NVIDIA GPU") == p[1]
        assert not statuses[1].exists(consts.STATUS_FILE_VFIO_PCI)


def test_vfio_pci_without_a_tree(tmp_path, statuses):
    for mod, status in zip((ref, comp), statuses):
        with pytest.raises(mod.ValidationError, match="no sysfs PCI tree"):
            mod.validate_vfio_pci(status, sysfs=str(tmp_path / "absent"))


def _sandbox_node(name, workload_config=None):
    labels = {ref_consts.WORKLOAD_CONFIG_LABEL: workload_config} if workload_config else {}
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": labels}}


@pytest.mark.parametrize("config", [None, "container", "bogus"])
def test_sandbox_gate_skips_container_nodes(tmp_path, statuses, config):
    assert consts.WORKLOAD_CONFIG_LABEL == ref_consts.WORKLOAD_CONFIG_LABEL
    outs = []
    for mod, status in zip((ref, comp), statuses):
        client = FakeClient([_sandbox_node("n1", config)])
        outs.append([
            mod.validate_vm_manager(status, client=client, node_name="n1"),
            mod.validate_vfio_pci(status, client=client, node_name="n1"),
            mod.validate_vm_devices(status, client=client, node_name="n1"),
        ])
        with open(status.path(mod.WORKLOAD_TYPE_STATUS_FILE)) as f:
            assert json.load(f) == {"config": "container"}
        assert not status.exists("vm-manager-ready")
    assert outs[0] == outs[1] == [{"skipped": True, "workload_config": "container"}] * 3


def test_sandbox_gate_reports_an_unreadable_node(statuses):
    with pytest.raises(comp.ValidationError, match="cannot read node gone"):
        comp.validate_vm_manager(statuses[1], client=FakeClient([]), node_name="gone")


@pytest.mark.parametrize("stage", ["no_control", "no_groups", "ok"])
def test_vm_manager_matches_the_reference(tmp_path, statuses, stage):
    dev = tmp_path / "dev"
    (dev / "vfio").mkdir(parents=True)
    if stage != "no_control":
        (dev / "vfio" / "vfio").touch()
    if stage == "ok":
        (dev / "vfio" / "0").touch()
    outs = []
    for mod, status in zip((ref, comp), statuses):
        client = FakeClient([_sandbox_node("n1", "vm-passthrough")])
        outs.append(_verdict(mod.validate_vm_manager, status, client=client, node_name="n1",
                             dev_root=str(dev)))
    assert outs[0] == outs[1]
    assert outs[1][0] == ("ok" if stage == "ok" else "error")


@pytest.mark.parametrize("stage", ["no_state", "dead_group", "empty", "ok"])
def test_vm_devices_matches_the_reference(tmp_path, statuses, stage):
    dev = tmp_path / "dev"
    (dev / "vfio").mkdir(parents=True)
    group = dev / "vfio" / "0"
    group.touch()
    state_file = tmp_path / "vm-devices.json"
    if stage != "no_state":
        devices = {"dead_group": [{"id": 0, "vfio_group": "/nope"}], "empty": [],
                   "ok": [{"id": 0, "vfio_group": str(group)}]}[stage]
        state_file.write_text(json.dumps({"config": "default", "devices": devices}))
    outs = []
    for mod, status in zip((ref, comp), statuses):
        client = FakeClient([_sandbox_node("n1", "vm-passthrough")])
        outs.append(_verdict(mod.validate_vm_devices, status, client=client, node_name="n1",
                             dev_root=str(dev), state_file=str(state_file), retries=1))
    assert outs[0] == outs[1]
    if stage == "ok":
        assert outs[1] == ("ok", {"config": "default", "devices": 1})
        assert statuses[1].exists(consts.STATUS_FILE_VM_DEVICES)


# ---------------------------------------------------------------------------
# slice-workload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "labels,name,want",
    [
        ({}, "solo-1", "solo-1"),
        ({"tpu.k8s.io/tpu.slice-id": "s-7"}, "n", "s-7"),
        ({"tpu.k8s.io/tpu.slice-hosts": "4", "cloud.google.com/gke-nodepool": "pool-a"}, "n", "pool-a"),
        ({"tpu.k8s.io/tpu.slice-hosts": "1", "cloud.google.com/gke-nodepool": "pool-a"}, "n", "n"),
        ({"tpu.k8s.io/tpu.slice-hosts": "x", "cloud.google.com/gke-nodepool": "pool-a"}, "n", "n"),
        ({"tpu.k8s.io/tpu.slice-hosts": "2"}, "n", "n"),
    ],
)
def test_slice_id_matches_the_reference(labels, name, want):
    """The port drops the reference's TPU-topology fallback; without
    those labels both agree."""
    from tpu_operator.controllers.slice_status import slice_id_for_node as ref_sid
    from tpu_operator_torch.controllers.slice_status import slice_id_for_node

    node = {"metadata": {"name": name, "labels": labels}}
    assert slice_id_for_node(node) == ref_sid(node) == want


def _gang_kubelet(client, phases):
    """Marks each gang pod the phase ``phases`` gives its ordinal."""
    def run():
        import time

        deadline = time.monotonic() + 5
        done = set()
        while time.monotonic() < deadline and len(done) < len(phases):
            for pod in client.list("v1", "Pod", NS):
                name = pod["metadata"]["name"]
                if name.startswith("tpu-slice-gang") and name not in done:
                    pod["spec"]["nodeName"] = pod["spec"]["nodeSelector"]["kubernetes.io/hostname"]
                    pod["status"] = {"phase": phases[int(name.rsplit("-", 1)[1])]}
                    client.update_status(pod)
                    done.add(name)
            time.sleep(0.02)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize(
    "node_name,phases,ok",
    [
        ("h-0", ["Succeeded", "Succeeded"], True),  # leader
        ("h-1", [], False),  # follower, the leader never spawned
        ("h-0", ["Succeeded", "Failed"], False),  # a failed member
    ],
)
def test_slice_workload_matches_the_reference(statuses, node_name, phases, ok):
    outs = []
    for mod, status, resource in ((ref, statuses[0], ref_consts.TPU_RESOURCE),
                                  (comp, statuses[1], consts.GPU_RESOURCE)):
        labels = lambda i: {"tpu.k8s.io/tpu.slice-id": "s-1", "tpu.k8s.io/tpu.worker-id": str(i)}  # noqa: E731
        client = FakeClient([
            {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
            _node("h-1", {resource: "8"}, labels=labels(1)),
            _node("h-0", {resource: "8"}, labels=labels(0)),
            _node("other", {resource: "8"}),
        ])
        t = _gang_kubelet(client, phases) if phases else None
        outs.append(_verdict(mod.validate_slice_workload, status, client, node_name, NS,
                             retries=100, sleep_s=0.02 if phases else 0.001))
        if t is not None:
            t.join(timeout=10)
            pods = sorted(client.list("v1", "Pod", NS), key=lambda p: p["metadata"]["name"])
            assert [p["spec"]["containers"][0]["resources"]["limits"] for p in pods] == [{resource: "8"}] * 2
    assert outs[0] == outs[1], outs
    assert outs[1][0] == ("ok" if ok else "error")
    if ok:
        assert outs[1][1]["hosts"] == ["h-0", "h-1"] and outs[1][1]["role"] == "leader"
        assert statuses[1].exists(consts.STATUS_FILE_SLICE_WORKLOAD)
