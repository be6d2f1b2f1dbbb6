"""The port's node operands against the reference's on one fixture
(``tests/test_operands.py:28-160``, ``:210-294``, ``:427-476``):

* the driver installer (``operands/driver_installer.py``) for libtpu's
  (``libtpu_installer.py``): the same payloads with ``libtpu-<v>.so`` ↔
  ``libcuda.so.<v>`` and ``libnvidia-ml.so.<v>``, and the ``driver``
  component passing on what it installs;
* the driver manager (``driver_manager.py``) for libtpu's: the same pods
  with ``google.com/tpu`` ↔ ``nvidia.com/gpu``, the same barriers
  (``libtpu-ready`` ↔ ``driver-ready`` and so on), on the reference's
  ``FakeClient`` and, over the wire, on its ``KubeSim``;
* the vfio manager for the reference's, on sysfs trees whose functions
  carry the card's vendor and class; the ``vfio-pci`` component passes on
  what it binds;
* the vm, vm-device and kata managers, and the ``vm-manager`` and
  ``vm-devices`` components on what they write.

Every wait is shortened: the eviction loop's pause is a module constant."""

import json
import os
import subprocess
import sys
import time
import types
from http.client import HTTPConnection

import pytest
import yaml

from tpu_operator.kube import FakeClient
from tpu_operator.kube.kubesim import KubeSim, KubeSimServer, make_client
from tpu_operator.kube.selector import pod_requests_tpu
from tpu_operator.operands import libtpu_installer, libtpu_manager, vfio_manager as ref_vfio
from tpu_operator.operands import vm_manager as ref_vm
from tpu_operator.validator.components import StatusFiles as RefStatusFiles
from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import EvictionBlockedError, NotFoundError
from tpu_operator_torch.kube.eviction import evict_pods
from tpu_operator_torch.kube.incluster import InClusterClient
from tpu_operator_torch.kube.selector import pod_requests_gpu
from tpu_operator_torch.operands import devchar, driver_installer, driver_manager, vfio_manager, vm_manager
from tpu_operator_torch.validator import components as comp

CUDA_OLD, CUDA_NEW = "550.54.15", "580.159.03"


# ---------------------------------------------------------------------------
# driver installer
# ---------------------------------------------------------------------------


def _payload(root, versions, libs=driver_installer.LIBRARIES):
    root.mkdir(parents=True, exist_ok=True)
    for v in versions:
        for name in libs:
            (root / f"{name}.so.{v}").write_bytes(f"{name} {v}".encode())
    return str(root)


def _lib_dir(driver_root):
    return os.path.join(driver_root, driver_installer.LIB_DIR)


def test_install_and_upgrade_as_the_reference(tmp_path):
    ref_src, ref_dst = tmp_path / "ref-image", tmp_path / "ref-host"
    ref_src.mkdir()
    (ref_src / "libtpu-2025.1.0.so").write_bytes(b"v1" * 100)
    libtpu_installer.install(str(ref_src), str(ref_dst))
    src, root = tmp_path / "image", str(tmp_path / "driver")
    assert driver_installer.install(_payload(src, [CUDA_OLD]), root) == CUDA_OLD
    lib = _lib_dir(root)
    assert (ref_dst / "VERSION").read_text().strip() == "2025.1.0"
    assert open(os.path.join(lib, "VERSION")).read().strip() == CUDA_OLD
    assert os.readlink(ref_dst / "libtpu.so") == "libtpu-2025.1.0.so"
    for name in driver_installer.LIBRARIES:
        assert os.readlink(os.path.join(lib, f"{name}.so.1")) == f"{name}.so.{CUDA_OLD}"
        assert os.readlink(os.path.join(lib, f"{name}.so")) == f"{name}.so.1"
    # an upgrade swaps the links and removes the old version
    (ref_src / "libtpu-2025.1.0.so").unlink()
    (ref_src / "libtpu-2025.2.0.so").write_bytes(b"v2" * 100)
    libtpu_installer.install(str(ref_src), str(ref_dst))
    for name in driver_installer.LIBRARIES:
        (src / f"{name}.so.{CUDA_OLD}").unlink()
    driver_installer.install(_payload(src, [CUDA_NEW]), root)
    assert not (ref_dst / "libtpu-2025.1.0.so").exists()
    assert sorted(os.listdir(lib)) == sorted(
        ["VERSION"] + [f"{n}.so{s}" for n in driver_installer.LIBRARIES for s in ("", ".1", f".{CUDA_NEW}")])
    assert open(os.path.join(lib, "libcuda.so")).read() == f"libcuda {CUDA_NEW}"
    # uninstall clears everything
    libtpu_installer.uninstall(str(ref_dst))
    driver_installer.uninstall(root)
    assert not (ref_dst / "VERSION").exists() and not os.path.lexists(ref_dst / "libtpu.so")
    assert os.listdir(lib) == []


def test_install_missing_source_as_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError):
        libtpu_installer.install(str(tmp_path), str(tmp_path / "host"))
    with pytest.raises(FileNotFoundError):
        driver_installer.install(str(tmp_path), str(tmp_path / "driver"))
    # libcuda without its NVML library
    with pytest.raises(FileNotFoundError, match="libnvidia-ml"):
        driver_installer.install(_payload(tmp_path / "half", [CUDA_NEW], ["libcuda"]), str(tmp_path / "d"))


def test_installer_cli_as_the_reference(tmp_path):
    src = tmp_path / "image"
    src.mkdir()
    (src / "libtpu-1.0.so").write_bytes(b"x")
    rc = libtpu_installer.main(["install", "--source-dir", str(src), "--install-dir", str(tmp_path / "h")])
    assert rc == 0 and (tmp_path / "h" / "libtpu.so").exists()
    root = str(tmp_path / "driver")
    assert driver_installer.main(["install", "--source-dir", _payload(tmp_path / "p", [CUDA_NEW]),
                                  "--driver-root", root]) == 0
    assert os.path.exists(os.path.join(_lib_dir(root), "libcuda.so"))
    assert driver_installer.main(["uninstall", "--driver-root", root]) == 0
    assert not os.path.lexists(os.path.join(_lib_dir(root), "libcuda.so"))
    assert driver_installer.main(["install", "--source-dir", str(tmp_path / "none"),
                                  "--driver-root", root]) == 1


@pytest.mark.parametrize(
    "versions,want",
    [(["575.57.08", CUDA_NEW], CUDA_NEW),  # two drivers side by side
     (["580.9.1", "580.10.2"], "580.10.2"),  # numeric, not lexicographic
     (["535.183.01", "1", "99.1"], "535.183.01")],  # the .so.1 name loses to any driver
)
def test_version_choice_as_the_reference(tmp_path, versions, want):
    ref_src = tmp_path / "ref"
    ref_src.mkdir()
    for v in versions:
        (ref_src / f"libtpu-{v}.so").write_bytes(b"x")
    theirs = os.path.basename(libtpu_installer.find_source(str(ref_src)))
    assert theirs == f"libtpu-{want}.so"
    src = _payload(tmp_path / "p", versions)
    assert driver_installer.find_source(src, "libcuda") == os.path.join(src, f"libcuda.so.{want}")
    root = str(tmp_path / "driver")
    assert driver_installer.install(src, root) == want
    assert open(os.path.join(_lib_dir(root), "VERSION")).read().strip() == want
    # an explicit version takes the exact file, whatever is newest
    assert driver_installer.install(src, root, version=versions[0]) == versions[0]
    assert os.readlink(os.path.join(_lib_dir(root), "libcuda.so.1")) == f"libcuda.so.{versions[0]}"


def test_init_installs_and_holds_until_sigterm(tmp_path):
    """``init`` installs, stays resident (the DaemonSet's startupProbe and
    preStop hook manage the barrier) and exits 0 on SIGTERM."""
    import signal

    root = tmp_path / "driver"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.operands.driver_installer", "init",
         "--source-dir", _payload(tmp_path / "p", [CUDA_NEW]), "--driver-root", str(root)],
        cwd=os.path.dirname(os.path.dirname(__file__)), stderr=subprocess.PIPE, text=True)
    try:
        version = root / driver_installer.LIB_DIR / "VERSION"
        deadline = time.monotonic() + 60
        while not version.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert version.read_text().strip() == CUDA_NEW
        assert proc.poll() is None  # resident
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_libraries_of_two_versions_are_refused(tmp_path):
    src = tmp_path / "p"
    _payload(src, [CUDA_NEW], ["libcuda"])
    _payload(src, [CUDA_OLD], ["libnvidia-ml"])
    with pytest.raises(ValueError, match="does not match"):
        driver_installer.install(str(src), str(tmp_path / "d"))
    assert driver_installer.main(["install", "--source-dir", str(src),
                                  "--driver-root", str(tmp_path / "d")]) == 1


def test_driver_component_passes_on_the_install(tmp_path, monkeypatch):
    """After an install into a driver root the port's ``driver`` component
    passes on that root; after ``uninstall`` it fails."""
    monkeypatch.setenv(devchar.DISABLE_ENV, "true")
    monkeypatch.setattr(comp.gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(comp.gpuinfo, "_load_native", lambda: None)
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia0", "nvidiactl"):
        (dev / name).touch()
    root = str(tmp_path / "driver")
    status = comp.StatusFiles(str(tmp_path / "val"))
    with pytest.raises(comp.ValidationError, match="libcuda.so not found"):
        comp.validate_driver(status, driver_root=root, dev_root=str(dev))
    driver_installer.install(_payload(tmp_path / "p", [CUDA_OLD, CUDA_NEW]), root)
    info = comp.validate_driver(status, driver_root=root, dev_root=str(dev))
    lib = _lib_dir(root)
    assert info["libcuda"] == [os.path.join(lib, n) for n in ("libcuda.so", "libcuda.so.1",
                                                             f"libcuda.so.{CUDA_NEW}")]
    assert status.exists(consts.STATUS_FILE_DRIVER)
    driver_installer.uninstall(root)
    with pytest.raises(comp.ValidationError, match="libcuda.so not found"):
        comp.validate_driver(status, driver_root=root, dev_root=str(dev))


# ---------------------------------------------------------------------------
# driver manager
# ---------------------------------------------------------------------------

REF_BARRIERS = ("libtpu-ready", "runtime-ready", "plugin-ready", "jax-ready", ".libtpu-ctr-ready")


@pytest.fixture()
def fast_drain(monkeypatch):
    monkeypatch.setattr(driver_manager, "EVICTION_POLL_S", 0.01)
    monkeypatch.setattr(libtpu_manager, "time", types.SimpleNamespace(
        monotonic=time.monotonic, sleep=lambda s: time.sleep(0.01)))


def _pod(name, resource=None, node="n1", labels=None, owned=True, count="1"):
    meta = {"name": name, "namespace": "default", "labels": labels or {}}
    if owned:
        meta["ownerReferences"] = [{"kind": "Job", "name": "j", "uid": "u"}]
    res = {"limits": {resource: count}} if resource else {}
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"nodeName": node, "containers": [{"resources": res}]},
            "status": {"phase": "Running"}}


class _Both:
    """The reference's manager and the port's, each on its own FakeClient
    seeded with the same pods (resource names mapped)."""

    def __init__(self, tmp_path, pods):
        self.ref_client, self.client = FakeClient(), FakeClient()
        for pod in pods:
            self.ref_client.create(pod("google.com/tpu"))
            self.client.create(pod("nvidia.com/gpu"))
        self.ref_status = RefStatusFiles(str(tmp_path / "ref-val"))
        self.status = comp.StatusFiles(str(tmp_path / "val"))
        for name in REF_BARRIERS:
            self.ref_status.write(name)
        for name in driver_manager.BARRIERS:
            self.status.write(name)

    def run(self, **kw):
        return (libtpu_manager.uninstall_libtpu(self.ref_client, "n1", self.ref_status, **kw),
                driver_manager.uninstall_gpu_driver(self.client, "n1", self.status, **kw))

    def left(self):
        return ([p["metadata"]["name"] for p in self.ref_client.list("v1", "Pod")],
                [p["metadata"]["name"] for p in self.client.list("v1", "Pod")])


def test_manager_clears_barriers_and_evicts_as_the_reference(tmp_path, fast_drain):
    both = _Both(tmp_path, [lambda r: _pod("train", r, count="4"), lambda r: _pod("web"),
                            lambda r: _pod("elsewhere", r, node="n2")])
    assert both.run() == (0, 0)
    theirs, mine = both.left()
    assert mine == theirs == ["elsewhere", "web"]
    assert not any(both.ref_status.exists(n) for n in REF_BARRIERS)
    assert not any(both.status.exists(n) for n in driver_manager.BARRIERS)
    assert set(driver_manager.BARRIERS) == {"driver-ready", "toolkit-ready", "plugin-ready",
                                            "cuda-ready", ".driver-ctr-ready"}


def test_manager_evicts_mig_slice_pods(tmp_path, fast_drain):
    client = FakeClient([_pod("sliced", "nvidia.com/mig-1x2"), _pod("plain")])
    assert driver_manager.uninstall_gpu_driver(client, "n1", comp.StatusFiles(str(tmp_path))) == 0
    assert [p["metadata"]["name"] for p in client.list("v1", "Pod")] == ["plain"]


def test_manager_reevicts_a_recreated_managed_pod_as_the_reference(tmp_path, fast_drain):
    """A controller recreating its evicted pod mid-drain is evicted again,
    not reported as not evictable."""
    both = _Both(tmp_path, [lambda r: _pod("train-0", r)])
    for client, resource in ((both.ref_client, "google.com/tpu"), (both.client, "nvidia.com/gpu")):
        real_evict = client.evict
        recreated = {"done": False}

        def racing_evict(name, ns="", client=client, real_evict=real_evict, recreated=recreated,
                         resource=resource):
            real_evict(name, ns)
            if not recreated["done"]:
                recreated["done"] = True
                client.create(_pod("train-1", resource))

        client.evict = racing_evict
    assert both.run(eviction_timeout_s=10.0) == (0, 0)
    assert both.left() == ([], [])


def test_manager_unmanaged_pod_blocks_without_force_as_the_reference(tmp_path, fast_drain):
    both = _Both(tmp_path, [lambda r: _pod("naked", r, owned=False)])
    assert both.run() == (1, 1)
    assert both.left() == (["naked"], ["naked"])
    assert both.run(force=True) == (0, 0)
    assert both.left() == ([], [])


def test_manager_auto_drain_disabled_as_the_reference(tmp_path, fast_drain):
    both = _Both(tmp_path, [lambda r: _pod("train", r, count="4")])
    assert both.run(evict=False) == (0, 0)
    assert both.left() == (["train"], ["train"])
    assert not both.status.exists(consts.STATUS_FILE_DRIVER)
    assert not both.ref_status.exists("libtpu-ready")


def test_manager_pod_selector_evicts_extra_pods_as_the_reference(tmp_path, fast_drain):
    both = _Both(tmp_path, [
        lambda r: _pod("gpu-train", r),
        lambda r: _pod("sidecar", labels={"drain": "me", "tier": "aux"}),
        lambda r: _pod("bystander", labels={"tier": "aux"}),
        lambda r: _pod("other-node", labels={"drain": "me"}, node="n2"),
    ])
    assert both.run(pod_selector="drain=me") == (0, 0)
    theirs, mine = both.left()
    assert mine == theirs == ["bystander", "other-node"]


def test_manager_without_a_client_only_clears_barriers(tmp_path):
    status = comp.StatusFiles(str(tmp_path))
    status.write(consts.STATUS_FILE_DRIVER_CTR)
    assert driver_manager.uninstall_gpu_driver(None, "n1", status) == 0
    assert not status.exists(consts.STATUS_FILE_DRIVER_CTR)
    assert driver_manager.main(["preflight"]) == 0


class _HttpInCluster(InClusterClient):
    def _make_conn(self):
        return HTTPConnection(self.host, self.port, timeout=self.timeout_s)


@pytest.mark.parametrize("budget", [False, True])
def test_manager_over_the_wire_as_the_reference(tmp_path, fast_drain, budget):
    """The port over its in-cluster client (``evict`` on the eviction
    subresource) and the reference over its RestClient, each on its own
    namespace of the reference's simulated API server: both evict the
    GPU pod, or both stop at a disruption budget's veto (429) and fail at
    the deadline."""
    server = KubeSimServer(KubeSim()).start()
    try:
        ref_client = make_client(server.port)
        client = _HttpInCluster(host="127.0.0.1", port=str(server.port), token="t", insecure=True)
        results = []
        for ns, c, resource, run in (
            ("ref", ref_client, "google.com/tpu",
             lambda c, s: libtpu_manager.uninstall_libtpu(c, "n1", RefStatusFiles(s), eviction_timeout_s=0.3)),
            ("port", client, "nvidia.com/gpu",
             lambda c, s: driver_manager.uninstall_gpu_driver(c, "n1", comp.StatusFiles(s),
                                                              eviction_timeout_s=0.3)),
        ):
            for name, res in (("train", resource), ("web", None)):
                pod = _pod(name, res, labels={"app": name})
                pod["metadata"]["namespace"] = ns
                pod["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
                c.create(pod)
            if budget:
                ref_client.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                                   "metadata": {"name": "keep", "namespace": ns},
                                   "spec": {"minAvailable": 1, "selector": {"matchLabels": {"app": "train"}}}})
            rc = run(c, str(tmp_path / ns))
            results.append((rc, sorted(p["metadata"]["name"] for p in c.list("v1", "Pod", ns))))
        want = (1, ["train", "web"]) if budget else (0, ["web"])
        assert results == [want, want]
    finally:
        server.stop()


@pytest.mark.parametrize(
    "containers",
    [
        [{"resources": {"limits": {"R": "1"}}}],
        [{"resources": {"requests": {"R": "2"}}}],
        [{"resources": {"limits": {"cpu": "1"}}}, {"resources": {"limits": {"R-2x2": "1"}}}],
        [{"resources": {"limits": {"cpu": "1", "memory": "1Gi"}}}],
        [{"resources": None}, {}],
        [],
    ],
)
def test_pod_predicate_matches_the_reference(containers):
    def pod(resource, prefix):
        cs = json.loads(json.dumps(containers).replace('"R-', f'"{prefix}').replace('"R"', f'"{resource}"'))
        return {"spec": {"containers": cs}}

    assert pod_requests_gpu(pod("nvidia.com/gpu", "nvidia.com/mig-")) == pod_requests_tpu(
        pod("google.com/tpu", "google.com/tpu-"))
    assert pod_requests_gpu({}) is False


class _PortErrors:
    """The reference's FakeClient raising the port's error types, as the
    port's in-cluster client does."""

    def __init__(self, client):
        self.client = client

    def evict(self, name, namespace=""):
        from tpu_operator.kube import client as ref_kube

        try:
            self.client.evict(name, namespace)
        except ref_kube.NotFoundError as e:
            raise NotFoundError(str(e)) from e
        except ref_kube.EvictionBlockedError as e:
            raise EvictionBlockedError(str(e)) from e


def test_evict_pods_counts_as_the_reference():
    from tpu_operator.upgrade.upgrade_state import PodManager

    pdb = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
           "metadata": {"name": "keep", "namespace": "default"},
           "spec": {"minAvailable": 1, "selector": {"matchLabels": {"app": "kept"}}}}
    pods = [_pod("a", "x"), _pod("b", "x", owned=False), _pod("c", "x"), _pod("k", "x", labels={"app": "kept"})]
    ref_client, client = FakeClient(pods[:2] + pods[3:] + [pdb]), FakeClient(pods[:2] + pods[3:] + [pdb])
    theirs = PodManager(ref_client, "").evict_pods(pods)
    mine = evict_pods(_PortErrors(client), pods)
    # pod c was never created: evicting it finds it gone, which both count
    assert (mine.evicted, mine.skipped, len(mine.blocked)) == (theirs.evicted, theirs.skipped,
                                                               len(theirs.blocked)) == (2, 1, 1)
    assert [p["metadata"]["name"] for p in mine.blocked_pods] == ["k"]
    assert evict_pods(_PortErrors(client), pods[1:2], force=True).evicted == 1
    assert [p["metadata"]["name"] for p in client.list("v1", "Pod")] == ["k"]


# ---------------------------------------------------------------------------
# vfio manager
# ---------------------------------------------------------------------------


def _sysfs(root, functions):
    """A sysfs PCI tree: ``functions`` maps an address to (vendor, class or
    None, bound driver or None)."""
    pci = root / "pci"
    (pci / "drivers" / "vfio-pci").mkdir(parents=True)
    (pci / "drivers_probe").touch()
    for addr, (vendor, cls, driver) in functions.items():
        d = pci / "devices" / addr
        d.mkdir(parents=True)
        (d / "vendor").write_text(vendor + "\n")
        if cls:
            (d / "class").write_text(cls + "\n")
        (d / "driver_override").touch()
        if driver:
            drv = pci / "drivers" / driver
            drv.mkdir(exist_ok=True)
            (drv / "unbind").touch()
            os.symlink(drv, d / "driver")
    return str(pci)


def _kernel_binds(monkeypatch, module, pci):
    """drivers_probe is write-only in real sysfs; bind through a link after
    the write, and an unbind write drops the link, as the kernel would."""
    orig = module._write

    def fake_write(path, value):
        orig(path, value)
        if path.endswith("drivers_probe"):
            override = open(os.path.join(pci, "devices", value.strip(), "driver_override")).read()
            link = os.path.join(pci, "devices", value.strip(), "driver")
            if override == "vfio-pci" and not os.path.islink(link):
                os.symlink(os.path.join(pci, "drivers", "vfio-pci"), link)
        elif path.endswith("unbind"):
            os.unlink(os.path.join(pci, "devices", value.strip(), "driver"))

    monkeypatch.setattr(module, "_write", fake_write)


def test_vfio_bind_all_as_the_reference(tmp_path, monkeypatch):
    addrs = ["0000:00:04.0", "0000:00:05.0"]
    ref_pci = _sysfs(tmp_path / "r", {a: ("0x1ae0", None, None) for a in addrs})
    pci = _sysfs(tmp_path / "p", {a: ("0x10de", "0x030200", None) for a in addrs})
    _kernel_binds(monkeypatch, ref_vfio, ref_pci)
    _kernel_binds(monkeypatch, vfio_manager, pci)
    ref_status, status = RefStatusFiles(str(tmp_path / "rv")), comp.StatusFiles(str(tmp_path / "pv"))
    assert ref_vfio.bind_all(ref_pci, ref_status) == vfio_manager.bind_all(pci, status) == 0
    theirs = json.loads((tmp_path / "rv" / "vfio-pci-ready").read_text())
    mine = json.loads((tmp_path / "pv" / consts.STATUS_FILE_VFIO_PCI).read_text())
    assert mine == theirs == {"bound": addrs}
    # the vfio-pci component passes on what the operand bound
    info = comp.validate_vfio_pci(comp.StatusFiles(str(tmp_path / "check")), sysfs=os.path.join(pci, "devices"))
    assert info == {"bound": addrs}
    assert vfio_manager.bind_one(addrs[0], pci) is ref_vfio.bind_one(addrs[0], ref_pci) is False


def test_vfio_no_devices_as_the_reference(tmp_path):
    ref_pci = _sysfs(tmp_path / "r", {"0000:00:01.0": ("0x8086", None, None)})
    pci = _sysfs(tmp_path / "p", {"0000:00:01.0": ("0x8086", "0x030000", None)})
    assert ref_vfio.bind_all(ref_pci, RefStatusFiles(str(tmp_path / "rv"))) == 1
    assert vfio_manager.bind_all(pci, comp.StatusFiles(str(tmp_path / "pv"))) == 1
    assert vfio_manager.card_functions(str(tmp_path / "absent")) == []


def test_vfio_binds_cards_and_leaves_nvswitch_and_audio(tmp_path, monkeypatch):
    """NVIDIA's vendor id also covers the NVSwitch bridges and each card's
    audio function: only the card is bound, the switch keeps its driver,
    and the component's filter agrees. unbind-all releases the card."""
    pci = _sysfs(tmp_path, {
        "0000:18:00.0": ("0x10de", "0x030200", "nvidia"),  # the card
        "0000:18:00.1": ("0x10de", "0x040300", "snd_hda_intel"),  # its audio function
        "0000:fe:00.0": ("0x10de", "0x068000", "nvidia-nvswitch"),  # an NVSwitch
        "0000:fe:01.0": ("0x8086", "0x030000", "i915"),  # another vendor's display
    })
    _kernel_binds(monkeypatch, vfio_manager, pci)
    status = comp.StatusFiles(str(tmp_path / "val"))
    assert vfio_manager.card_functions(pci) == ["0000:18:00.0"]
    assert vfio_manager.bind_all(pci, status) == 0
    drivers = {a: vfio_manager.current_driver(a, pci) for a in os.listdir(os.path.join(pci, "devices"))}
    assert drivers == {"0000:18:00.0": "vfio-pci", "0000:18:00.1": "snd_hda_intel",
                       "0000:fe:00.0": "nvidia-nvswitch", "0000:fe:01.0": "i915"}
    assert comp.validate_vfio_pci(comp.StatusFiles(str(tmp_path / "c")),
                                  sysfs=os.path.join(pci, "devices")) == {"bound": ["0000:18:00.0"]}
    assert vfio_manager.main(["unbind-all", "--sysfs-pci", pci, "--output-dir", str(tmp_path / "val")]) == 0
    assert vfio_manager.current_driver("0000:18:00.0", pci) == ""
    assert open(os.path.join(pci, "devices", "0000:18:00.0", "driver_override")).read() == "\n"
    assert not status.exists(consts.STATUS_FILE_VFIO_PCI)
    assert vfio_manager.unbind_one("0000:18:00.0", pci) is False


# ---------------------------------------------------------------------------
# vm manager / vm device manager / kata
# ---------------------------------------------------------------------------


def _vfio_dev(root, groups=("12",), control=True):
    (root / "vfio").mkdir(parents=True)
    if control:
        (root / "vfio" / "vfio").touch()
    for g in groups:
        (root / "vfio" / g).touch()
    return str(root)


def test_vm_manager_ready_as_the_reference(tmp_path):
    dev = _vfio_dev(tmp_path / "dev")
    ref_status, status = RefStatusFiles(str(tmp_path / "rv")), comp.StatusFiles(str(tmp_path / "pv"))
    assert ref_vm.vm_manager_ready(dev, ref_status) == vm_manager.vm_manager_ready(dev, status) == 0
    assert (json.loads((tmp_path / "pv" / consts.STATUS_FILE_VM_MANAGER).read_text())
            == json.loads((tmp_path / "rv" / "vm-manager-ready").read_text()))
    info = comp.validate_vm_manager(comp.StatusFiles(str(tmp_path / "c")), dev_root=dev)
    assert info == {"groups": [os.path.join(dev, "vfio", "12")]}
    os.unlink(os.path.join(dev, "vfio", "vfio"))  # no control node: both fail
    assert ref_vm.vm_manager_ready(dev, ref_status) == vm_manager.vm_manager_ready(dev, status) == 1


def test_vm_device_config_as_the_reference(tmp_path):
    dev = _vfio_dev(tmp_path / "dev", groups=("7", "9"))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({"vm-device-configs": {"default": [{"devices": "all", "passthrough": True}]}}))
    theirs = ref_vm.apply_vm_device_config(str(cfg), "default", dev, str(tmp_path / "r" / "vm.json"))
    state_file = str(tmp_path / "p" / "vm.json")
    mine = vm_manager.apply_vm_device_config(str(cfg), "default", dev, state_file)
    assert mine == {**theirs, "devices": [{**d, "resource": consts.GPU_VM_RESOURCE} for d in theirs["devices"]]}
    assert mine["devices"][0]["vfio_group"].endswith("vfio/7")
    info = comp.validate_vm_devices(comp.StatusFiles(str(tmp_path / "c")), dev_root=dev,
                                    state_file=state_file, retries=1)
    assert info == {"config": "default", "devices": 2}
    for mod in (ref_vm, vm_manager):
        with pytest.raises(ValueError):
            mod.apply_vm_device_config(str(cfg), "nope", dev, state_file)
    assert vm_manager.vm_device_main(["--config-file", str(cfg), "--dev-root", dev,
                                      "--state-file", state_file, "--once"]) == 0
    assert vm_manager.vm_device_main(["--config-file", str(cfg), "--config", "nope",
                                      "--state-file", state_file, "--once"]) == 1


def test_vm_devices_feed_the_sandbox_plugin_as_the_reference(tmp_path, monkeypatch):
    """The vm-device manager's state file drives the sandbox device
    plugin, whose probe only stats a group (one open file a group) and
    reads a dangling group dead (``tests/test_operands.py:478-519``)."""
    from tpu_operator.plugin.manager import VfioPluginServicer as RefVfioPluginServicer
    from tpu_operator_torch.plugin.manager import VfioPluginServicer

    dev = _vfio_dev(tmp_path / "dev", groups=("7",))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({"vm-device-configs": {"default": []}}))
    ref_state, state = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    ref_vm.apply_vm_device_config(str(cfg), "default", dev, ref_state)
    vm_manager.apply_vm_device_config(str(cfg), "default", dev, state)
    opens = []
    real_open = os.open

    def spy_open(path, *a, **kw):
        opens.append(str(path))
        return real_open(path, *a, **kw)

    servicers = (RefVfioPluginServicer(ref_state, dev_root=dev), VfioPluginServicer(state, dev_root=dev))
    try:
        monkeypatch.setattr(os, "open", spy_open)
        assert [s.device_probe("0") for s in servicers] == [True, True]
        assert not any(p.endswith(os.path.join("vfio", "7")) for p in opens)  # stat only
        monkeypatch.undo()
        group = os.path.join(dev, "vfio", "7")
        os.unlink(group)
        os.symlink("/nonexistent/group", group)
        for s in servicers:
            s.refresh_devices()
        assert [s.device_probe("0") for s in servicers] == [False, False]
        assert servicers[1].resource_name == consts.GPU_VM_RESOURCE
    finally:
        for s in servicers:
            s.stop()


def test_kata_install_as_the_reference(tmp_path):
    for side, mod, artifact in (("r", ref_vm, "configuration-tpu.toml"),
                                ("p", vm_manager, vm_manager.KATA_CONFIG)):
        src = tmp_path / side / "artifacts"
        src.mkdir(parents=True)
        (src / artifact).write_text("x")
        assert mod.install_kata(str(src), str(tmp_path / side / "kata"), str(tmp_path / side / "conf")) == 0
        assert (tmp_path / side / "kata" / artifact).read_text() == "x"
    snippet = (tmp_path / "p" / "conf" / f"{consts.KATA_RUNTIME_CLASS}.toml").read_text()
    assert f"runtimes.{consts.KATA_RUNTIME_CLASS}]" in snippet
    assert f'ConfigPath = "/opt/kata/{vm_manager.KATA_CONFIG}"' in snippet
    assert snippet.replace(consts.KATA_RUNTIME_CLASS, "kata-tpu").replace(
        vm_manager.KATA_CONFIG, "configuration-tpu.toml").replace("gpu-kata", "tpu-kata") == (
        tmp_path / "r" / "conf" / "kata-tpu.toml").read_text()
    # a second run overwrites neither the artifacts nor the snippet
    (tmp_path / "p" / "kata" / vm_manager.KATA_CONFIG).write_text("local")
    assert vm_manager.kata_main(["--artifacts-src", str(tmp_path / "p" / "artifacts"), "--artifacts-dst",
                                 str(tmp_path / "p" / "kata"), "--containerd-conf-dir",
                                 str(tmp_path / "p" / "conf"), "--once"]) == 0
    assert (tmp_path / "p" / "kata" / vm_manager.KATA_CONFIG).read_text() == "local"


# ---------------------------------------------------------------------------
# what the operands import
# ---------------------------------------------------------------------------


def test_operands_import_no_torch_yaml_or_prometheus():
    """``import tpu_operator_torch`` and every module of the slice import
    with torch, PyYAML, prometheus_client and grpc blocked: the host-side
    operands run where none is installed."""
    code = """
import sys
for name in ("torch", "yaml", "prometheus_client", "grpc"):
    sys.modules[name] = None
import importlib
for mod in ("tpu_operator_torch", "tpu_operator_torch.sliceman.slice_manager",
            "tpu_operator_torch.exporter.exporter", "tpu_operator_torch.operands.driver_installer",
            "tpu_operator_torch.operands.driver_manager", "tpu_operator_torch.operands.vfio_manager",
            "tpu_operator_torch.operands.vm_manager", "tpu_operator_torch.kube.eviction",
            "tpu_operator_torch.kube.selector"):
    importlib.import_module(mod)
assert not any(m.startswith(("torch", "yaml", "prometheus_client", "jax", "tpu_operator."))
               for m, v in sys.modules.items() if v is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", ["operands.driver_installer", "operands.driver_manager",
                                    "operands.vfio_manager", "exporter", "sliceman"])
def test_operands_run_as_programs(module):
    out = subprocess.run([sys.executable, "-m", f"tpu_operator_torch.{module}", "--help"],
                         capture_output=True, text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0 and "usage: gpu-" in out.stdout, out.stderr
