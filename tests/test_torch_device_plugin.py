"""The port's device plugin (``plugin/server.py``, ``grpc_glue.py``,
``manager.py``, ``proto/``) against the reference's, over real gRPC on unix
sockets in ``tmp_path``, on one fixture: the same devfs tree with names
mapped ``accelN`` ↔ ``nvidiaN``, the same requests, ``google.com/tpu`` ↔
``nvidia.com/gpu`` in the answers.

Equal by design: the advertisement, its sending only on change, health
(sticky ``mark_unhealthy``, open probes), the contract cases of
``GetPreferredAllocation`` (size <= 0, ids that are not numbers, more
must-include ids than the size, must-include ids that vanished), the
manager's re-registration and retries, ``stop``'s socket guard, and the
kubelet's capacity from the advertisement. Different by design: placement
(NVLink domains and NUMA nodes over the advertised ids, not a torus over
``0..n-1``), and ``Allocate``'s env (the cards by UUID in
``NVIDIA_VISIBLE_DEVICES`` and ``CUDA_VISIBLE_DEVICES`` for
``TPU_CHIPS_VISIBLE``) and legacy mounts (the driver's control nodes and
libraries for the libtpu directory). Polls run at milliseconds; every
stream and server has a time limit."""

import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent import futures

import grpc
import pytest

from tpu_operator.kube import FakeClient
from tpu_operator.kube.kubelet_sim import KubeletDeviceManager
from tpu_operator.kube.testing import make_cpu_node
from tpu_operator.native import tpuinfo
from tpu_operator.plugin import grpc_glue as ref_glue
from tpu_operator.plugin import manager as ref_manager
from tpu_operator.plugin import server as ref_server
from tpu_operator_torch import consts
from tpu_operator_torch.kube import client as port_client
from tpu_operator_torch.kube import kubelet_sim as port_kubelet_sim
from tpu_operator_torch.kube import testing as port_testing
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.plugin import grpc_glue, manager, server
from tpu_operator_torch.plugin.proto import deviceplugin_pb2 as pb2
from tpu_operator_torch.validator import components as comp

POLL_S = 0.02
WAIT_S = 30  # a time limit on every wait, never what decides a result
NODE = "gpu-node-1"


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


@pytest.fixture()
def dev_roots(tmp_path):
    roots = []
    for side, prefix in (("r", "accel"), ("p", "nvidia")):
        d = tmp_path / side / "dev"
        d.mkdir(parents=True)
        for i in range(8):
            (d / f"{prefix}{i}").touch()
        roots.append(str(d))
    for ctl in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        (tmp_path / "p" / "dev" / ctl).touch()
    lib = tmp_path / "driver" / "usr" / "lib64"
    lib.mkdir(parents=True)
    for name in ("libcuda.so.1", "libnvidia-ml.so.1"):
        (lib / name).touch()
    return roots


class Side:
    """One plugin served over gRPC, and a stub on it."""

    def __init__(self, servicer, srv, glue):
        self.servicer, self.server = servicer, srv
        self.channel = grpc.insecure_channel(srv.start())
        self.stub = glue.DevicePluginStub(self.channel)

    def close(self):
        self.channel.close()
        self.server.stop()


@pytest.fixture()
def sides(tmp_path, dev_roots):
    """(reference, port), each serving eight cards."""
    ref = ref_server.TPUDevicePluginServicer(
        dev_root=dev_roots[0], generation="v5e", host_topology="2x4", cdi_enabled=True,
        slice_env={"TPU_WORKER_ID": "0"}, poll_interval_s=POLL_S, health_probe_interval_s=3600)
    port = server.GPUDevicePluginServicer(
        dev_root=dev_roots[1], generation="h100-sxm", cdi_enabled=True,
        driver_root=str(tmp_path / "driver"), slice_env={"TPU_WORKER_ID": "0"},
        poll_interval_s=POLL_S, health_probe_interval_s=3600)
    out = (
        Side(ref, ref_server.DevicePluginServer(ref, socket_dir=str(tmp_path / "rk"),
                                                socket_name="tpu.sock"), ref_glue),
        Side(port, server.DevicePluginServer(port, socket_dir=str(tmp_path / "pk")), grpc_glue),
    )
    yield out
    for s in out:
        s.close()


def pump(stream):
    """Messages of a ListAndWatch stream into a queue, on a thread."""
    msgs = queue.Queue()

    def run():
        try:
            for m in stream:
                msgs.put(m)
        except grpc.RpcError:
            pass

    threading.Thread(target=run, daemon=True).start()
    return msgs


def health(msg):
    return {d.ID: d.health for d in msg.devices}


def preferred(stub, available, must, size):
    req = pb2.GetPreferredAllocationRequest()
    creq = req.container_requests.add()
    creq.available_deviceIDs.extend(available)
    creq.must_include_deviceIDs.extend(must)
    creq.allocation_size = size
    return list(stub.GetPreferredAllocation(req, timeout=WAIT_S).container_responses[0].deviceIDs)


def test_options_match_the_reference(sides):
    ref, port = sides
    assert port.stub.GetDevicePluginOptions(pb2.Empty(), timeout=WAIT_S) == ref.stub.GetDevicePluginOptions(
        pb2.Empty(), timeout=WAIT_S)


def test_list_and_watch_matches_the_reference(sides, dev_roots):
    streams = [s.stub.ListAndWatch(pb2.Empty(), timeout=WAIT_S) for s in sides]
    firsts = [next(st) for st in streams]
    assert health(firsts[1]) == health(firsts[0]) == {str(i): "Healthy" for i in range(8)}
    for root, name in zip(dev_roots, ("accel7", "nvidia7")):
        os.unlink(os.path.join(root, name))
    for s in sides:
        s.servicer.refresh_devices()
    seconds = [next(st) for st in streams]
    assert health(seconds[1]) == health(seconds[0]) == {str(i): "Healthy" for i in range(7)}
    for st in streams:
        st.cancel()


def test_list_and_watch_sends_only_on_change(sides, dev_roots, monkeypatch):
    """After the first list, many poll ticks without a change send nothing:
    the next message is the change itself. The ticks are counted, not
    slept for."""
    for s, root, name in zip(sides, dev_roots, ("accel6", "nvidia6")):
        ticks = threading.Semaphore(0)
        real = s.servicer.discover

        def counted(real=real, ticks=ticks):
            ticks.release()
            return real()

        monkeypatch.setattr(s.servicer, "discover", counted)
        stream = s.stub.ListAndWatch(pb2.Empty(), timeout=WAIT_S)
        msgs = pump(stream)
        assert len(msgs.get(timeout=WAIT_S).devices) == 8
        for _ in range(10):  # ten poll ticks, each a chance to re-send
            assert ticks.acquire(timeout=WAIT_S)
        os.unlink(os.path.join(root, name))
        assert sorted(health(msgs.get(timeout=WAIT_S))) == [str(i) for i in (0, 1, 2, 3, 4, 5, 7)]
        stream.cancel()


def test_concurrent_streams_each_see_every_change(sides):
    for s in sides:
        streams = [s.stub.ListAndWatch(pb2.Empty(), timeout=WAIT_S) for _ in range(2)]
        queues = [pump(st) for st in streams]
        for q in queues:
            assert len(q.get(timeout=WAIT_S).devices) == 8
        s.servicer.mark_unhealthy("3")
        for q in queues:
            assert health(q.get(timeout=WAIT_S))["3"] == "Unhealthy"
        for st in streams:
            st.cancel()


def test_health_matches_the_reference(sides):
    streams = [s.stub.ListAndWatch(pb2.Empty(), timeout=WAIT_S) for s in sides]
    for st in streams:
        next(st)
    for s in sides:
        s.servicer.mark_unhealthy("2")
    flips = [health(next(st)) for st in streams]
    assert flips[1] == flips[0] and flips[1]["2"] == "Unhealthy"
    for s in sides:
        s.servicer.refresh_devices()  # sticky across re-enumeration
        assert s.servicer.snapshot()["2"] == "Unhealthy"
        s.servicer.mark_healthy("2")
    back = [health(next(st)) for st in streams]
    assert back[1] == back[0] and set(back[1].values()) == {"Healthy"}
    snap = sides[1].servicer.snapshot()
    snap["0"] = "Unhealthy"  # a private copy
    assert sides[1].servicer.snapshot()["0"] == "Healthy"
    for st in streams:
        st.cancel()


def test_wedged_card_goes_unhealthy_and_back(tmp_path, dev_roots):
    """The open probe, at the path recorded when the card was discovered,
    flips a card whose node no longer opens, in both plugins."""
    for mod, glue, root, name in ((ref_server, ref_glue, dev_roots[0], "accel4"),
                                  (server, grpc_glue, dev_roots[1], "nvidia4")):
        cls = getattr(mod, "TPUDevicePluginServicer", None) or mod.GPUDevicePluginServicer
        servicer = cls(dev_root=root, poll_interval_s=POLL_S, health_probe_interval_s=POLL_S)
        side = Side(servicer, mod.DevicePluginServer(servicer, socket_dir=str(tmp_path / name),
                                                     socket_name="p.sock"), glue)
        try:
            stream = side.stub.ListAndWatch(pb2.Empty(), timeout=WAIT_S)
            msgs = pump(stream)
            assert set(health(msgs.get(timeout=WAIT_S)).values()) == {"Healthy"}
            node = os.path.join(root, name)
            os.unlink(node)
            os.symlink("/nonexistent/card", node)
            while health(msgs.get(timeout=WAIT_S)).get("4") != "Unhealthy":
                pass
            os.unlink(node)
            open(node, "w").close()
            while health(msgs.get(timeout=WAIT_S)).get("4") != "Healthy":
                pass
            stream.cancel()
        finally:
            side.close()


def test_dead_peer_releases_the_stream(dev_roots):
    class DeadContext:
        def is_active(self):
            return False

    for servicer in (ref_server.TPUDevicePluginServicer(dev_root=dev_roots[0], poll_interval_s=POLL_S),
                     server.GPUDevicePluginServicer(dev_root=dev_roots[1], poll_interval_s=POLL_S)):
        gen = servicer.ListAndWatch(None, DeadContext())
        assert len(next(gen).devices) == 8
        with pytest.raises(StopIteration):
            next(gen)
        servicer.stop()


@pytest.mark.parametrize(
    "available,must,size",
    [
        ([str(i) for i in range(8)], [], 0),  # size 0
        ([str(i) for i in range(8)], ["3"], -2),  # size < 0 with a must id
        ([str(i) for i in range(8)], [], -1),
        (["a", "b", "c"], ["c"], 2),  # ids that are not numbers
        (["gpu-x", "7", "gpu-y"], [], 3),
        ([str(i) for i in range(8)], ["1", "2", "3"], 2),  # must > size
        (["0", "1", "2"], ["5"], 2),  # a must id that vanished
        (["0", "2", "4"], ["9", "2"], 2),
        (["0", "1", "2"], [], 5),  # more than offered
    ],
)
def test_preferred_allocation_contract_cases_match_the_reference(sides, available, must, size):
    ref, port = sides
    assert preferred(port.stub, available, must, size) == preferred(ref.stub, available, must, size)


def test_preferred_allocation_property(sides):
    """Every offer, must-include set and size: the answer is the size,
    distinct, offered and holds every must-include id, in both."""
    import itertools

    for s in sides:
        for avail in ([str(i) for i in range(8)], ["0", "2", "3", "5", "6", "7"]):
            for must_n, size in itertools.product([0, 1, 2], [1, 2, 4]):
                if must_n > size:
                    continue
                must = avail[-must_n:] if must_n else []
                ids = preferred(s.stub, avail, must, size)
                assert len(ids) == len(set(ids)) == size
                assert set(must) <= set(ids) <= set(avail)


def test_preferred_allocation_over_minor_numbers(sides):
    """Ids an H100 host advertises (5, 3, 7, 1): the port keeps them;
    the reference's labeled mesh has no room for 7."""
    _, port = sides
    assert preferred(port.stub, ["5", "3", "7", "1"], [], 2) == ["1", "3"]
    assert preferred(port.stub, ["5", "3", "7", "1"], ["7"], 2) == ["1", "7"]
    assert preferred(port.stub, ["5", "3", "7"], ["7"], 3) == ["3", "5", "7"]


def test_preferred_allocation_prefers_a_shared_numa_node(dev_roots, monkeypatch):
    table = [{"index": i, "path": os.path.join(dev_roots[1], f"nvidia{i}"), "numa_node": i % 2}
             for i in range(8)]
    monkeypatch.setattr(gpuinfo, "chip_summary", lambda dev_root="/dev", *a, **k: table)
    servicer = server.GPUDevicePluginServicer(dev_root=dev_roots[1])
    assert servicer.preferred([str(i) for i in range(8)], ["3"], 3) == ["1", "3", "5"]
    assert servicer.preferred([str(i) for i in range(8)], [], 4) == ["0", "2", "4", "6"]
    resp = servicer.ListAndWatch(None, None)
    assert [d.topology.nodes[0].ID for d in next(resp).devices] == [i % 2 for i in range(8)]
    servicer.stop()


def test_preferred_allocation_degrades_to_naive_on_error(sides, monkeypatch):
    from tpu_operator_torch.workloads import topology

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(topology, "pick_chips", broken)
    _, port = sides
    assert preferred(port.stub, ["4", "2", "6"], ["6"], 2) == ["6", "4"]


def test_allocate_cdi_matches_the_reference(sides):
    ref, port = sides
    req = pb2.AllocateRequest()
    req.container_requests.add().devicesIDs.extend(["1", "0"])
    theirs = ref.stub.Allocate(req, timeout=WAIT_S).container_responses[0]
    mine = port.stub.Allocate(req, timeout=WAIT_S).container_responses[0]
    assert [c.name.replace("nvidia.com/gpu", "google.com/tpu") for c in mine.cdi_devices] == [
        c.name for c in theirs.cdi_devices]
    assert [c.name for c in mine.cdi_devices] == ["nvidia.com/gpu=1", "nvidia.com/gpu=0"]
    assert not mine.devices and not mine.mounts
    # no UUID in a sysfs table without /proc: the ids, in the reference's order
    assert mine.envs["NVIDIA_VISIBLE_DEVICES"] == mine.envs["CUDA_VISIBLE_DEVICES"] == theirs.envs[
        "TPU_CHIPS_VISIBLE"] == "0,1"
    assert mine.envs["TPU_WORKER_ID"] == theirs.envs["TPU_WORKER_ID"] == "0"
    assert mine.envs["TPU_ACCELERATOR_GENERATION"] == "h100-sxm"


def test_allocate_names_cards_by_uuid(dev_roots, monkeypatch):
    table = [{"index": i, "path": os.path.join(dev_roots[1], f"nvidia{i}"), "uuid": f"GPU-{i}abc"}
             for i in (5, 3, 7)]
    monkeypatch.setattr(gpuinfo, "chip_summary", lambda dev_root="/dev", *a, **k: table)
    servicer = server.GPUDevicePluginServicer(dev_root=dev_roots[1])
    content = servicer.allocate_container(["7", "3"])
    assert content["envs"]["NVIDIA_VISIBLE_DEVICES"] == "GPU-3abc,GPU-7abc"
    assert content["envs"]["CUDA_VISIBLE_DEVICES"] == "GPU-3abc,GPU-7abc"
    assert content["cdi_devices"] == ["nvidia.com/gpu=7", "nvidia.com/gpu=3"]
    servicer.stop()


def test_allocate_legacy_matches_the_reference(tmp_path, dev_roots):
    theirs = ref_server.TPUDevicePluginServicer(dev_root=dev_roots[0], cdi_enabled=False, host_topology="2x4")
    mine = server.GPUDevicePluginServicer(dev_root=dev_roots[1], cdi_enabled=False,
                                          driver_root=str(tmp_path / "driver"))
    req = pb2.AllocateRequest()
    req.container_requests.add().devicesIDs.extend(["3"])
    r = theirs.Allocate(req, None).container_responses[0]
    m = mine.Allocate(req, None).container_responses[0]
    assert not m.cdi_devices and not r.cdi_devices
    assert r.devices[0].container_path == "/dev/accel3"
    assert [(d.container_path, d.permissions) for d in m.devices] == [
        ("/dev/nvidia3", "rw"), ("/dev/nvidiactl", "rw"), ("/dev/nvidia-uvm", "rw"),
        ("/dev/nvidia-uvm-tools", "rw")]
    assert m.devices[0].host_path == os.path.join(dev_roots[1], "nvidia3")
    assert sorted((x.container_path, x.read_only) for x in m.mounts) == [
        ("/usr/lib64/libcuda.so.1", True), ("/usr/lib64/libnvidia-ml.so.1", True)]
    assert r.mounts[0].read_only
    theirs.stop()
    mine.stop()


def test_slice_env_from_labels_matches_the_reference():
    theirs = ref_server.slice_env_from_node_labels({
        "cloud.google.com/gke-tpu-topology": "2x8",
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5p-slice",
        "tpu.k8s.io/tpu.worker-id": "3",
        "tpu.k8s.io/tpu.slice-hosts": "2",
    })
    mine = server.slice_env_from_node_labels({
        consts.TFD_TOPOLOGY_LABEL: "2x8",
        consts.GPU_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
        consts.TFD_WORKER_ID_LABEL: "3",
        consts.TFD_SLICE_HOSTS_LABEL: "2",
    })
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if k != "TPU_ACCELERATOR_TYPE"} == {
        k: v for k, v in theirs.items() if k != "TPU_ACCELERATOR_TYPE"}
    assert mine["TPU_ACCELERATOR_TYPE"] == "NVIDIA-H100-80GB-HBM3"
    assert server.slice_env_from_node_labels({consts.TFD_WORKER_ID_LABEL: ""}) == {}


def test_registration_matches_the_reference(tmp_path, dev_roots):
    received = []

    class FakeKubelet:
        def Register(self, request, context):
            received.append((request.version, request.endpoint, request.resource_name,
                             request.options.get_preferred_allocation_available))
            return pb2.Empty()

    sock_dir = tmp_path / "kubelet"
    sock_dir.mkdir()
    kubelet = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    kubelet.add_generic_rpc_handlers((grpc_glue.registration_handler(FakeKubelet()),))
    kubelet.add_insecure_port(f"unix://{sock_dir / 'kubelet.sock'}")
    kubelet.start()
    try:
        for mod, root in ((ref_server, dev_roots[0]), (server, dev_roots[1])):
            cls = getattr(mod, "TPUDevicePluginServicer", None) or mod.GPUDevicePluginServicer
            srv = mod.DevicePluginServer(cls(dev_root=root), socket_dir=str(sock_dir))
            srv.start()
            srv.register_with_kubelet()
            srv.stop()
    finally:
        kubelet.stop(grace=None)
    assert received == [("v1beta1", "tpu.sock", "google.com/tpu", True),
                        ("v1beta1", "nvidia-gpu.sock", "nvidia.com/gpu", True)]


@pytest.mark.parametrize("mod", [ref_manager, manager], ids=["reference", "port"])
def test_manager_reregisters_on_kubelet_restart(tmp_path, dev_roots, mod):
    root = dev_roots[0] if mod is ref_manager else dev_roots[1]
    sock_dir = tmp_path / "kubelet"
    sock_dir.mkdir()
    (sock_dir / "kubelet.sock").write_text("")
    mgr = mod.PluginManager(socket_dir=str(sock_dir), partition_file=str(tmp_path / "none.json"),
                            servicer_kw={"dev_root": root})
    try:
        assert mgr.sync() is True
        first = dict(mgr.servers)
        assert mgr.sync() is False
        (sock_dir / "kubelet.sock").unlink()
        (sock_dir / "kubelet.sock").write_text("")  # a new inode: the kubelet restarted
        assert mgr.sync() is True
        assert mgr.servers.keys() == first.keys()
        assert all(mgr.servers[r] is not first[r] for r in first)
        assert mgr.sync() is False
    finally:
        mgr.stop()
    want = "google.com/tpu" if mod is ref_manager else "nvidia.com/gpu"
    assert list(first) == [want]


@pytest.mark.parametrize("mod", [ref_manager, manager], ids=["reference", "port"])
def test_manager_retries_failed_registration(tmp_path, dev_roots, mod):
    root = dev_roots[0] if mod is ref_manager else dev_roots[1]
    sock_dir = tmp_path / "kubelet"
    sock_dir.mkdir()  # no kubelet.sock: registration fails
    mgr = mod.PluginManager(socket_dir=str(sock_dir), partition_file=str(tmp_path / "none.json"),
                            servicer_kw={"dev_root": root})
    try:
        assert mgr.sync(register=True) is True
        assert mgr._last_sig is None
        assert mgr.sync(register=True) is True
    finally:
        mgr.stop()


@pytest.mark.parametrize("strategy", ["single", "mixed"])
def test_manager_resources_from_the_partition_file(tmp_path, strategy):
    """Resources from a partition file in the reference's format, mapped
    ``google.com/tpu-<shape>`` ↔ ``nvidia.com/mig-<shape>``."""
    from tpu_operator.sliceman import slice_manager as sm

    part = tmp_path / "partitions.json"
    sm.write_partition_state(sm.compute_partitions("2x4", "v5e", "2x2"), str(part))
    theirs = ref_manager.PluginManager(strategy=strategy, partition_file=str(part)).desired_resources()
    mine = manager.PluginManager(strategy=strategy, partition_file=str(part)).desired_resources()
    assert {k.replace("google.com/tpu-", "nvidia.com/mig-").replace("google.com/tpu", "nvidia.com/gpu"): v
            for k, v in theirs.items()} == mine
    assert list(mine) == (["nvidia.com/mig-2x2"] if strategy == "mixed" else ["nvidia.com/gpu"])
    assert manager.PluginManager(partition_file=str(tmp_path / "none.json")).desired_resources() == {
        "nvidia.com/gpu": {"kind": "chips"}}


def test_subslice_servicer_matches_the_reference(dev_roots):
    subs = [{"id": i, "shape": "1x2", "chips": [2 * i, 2 * i + 1]} for i in range(4)]
    theirs = ref_manager.SubslicePluginServicer(subs, resource_name="google.com/tpu-1x2",
                                                dev_root=dev_roots[0], host_topology="2x4")
    mine = manager.SubslicePluginServicer(subs, resource_name="nvidia.com/mig-1x2", dev_root=dev_roots[1])
    assert mine.snapshot() == theirs.snapshot()
    for must in ([], ["2"], ["3", "1"]):
        req = pb2.GetPreferredAllocationRequest()
        creq = req.container_requests.add()
        creq.available_deviceIDs.extend(["0", "1", "2", "3"])
        creq.must_include_deviceIDs.extend(must)
        creq.allocation_size = 2
        assert mine.GetPreferredAllocation(req, None) == theirs.GetPreferredAllocation(req, None)
    req = pb2.AllocateRequest()
    req.container_requests.add().devicesIDs.extend(["1"])
    r = theirs.Allocate(req, None).container_responses[0]
    m = mine.Allocate(req, None).container_responses[0]
    assert [c.name for c in m.cdi_devices] == ["nvidia.com/gpu=subslice-1-1x2"]
    assert [c.name.replace("nvidia.com/gpu", "google.com/tpu") for c in m.cdi_devices] == [
        c.name for c in r.cdi_devices]
    assert m.envs["NVIDIA_VISIBLE_DEVICES"] == r.envs["TPU_CHIPS_VISIBLE"] == "2,3"
    assert m.envs["TPU_SUBSLICE_SHAPE"] == r.envs["TPU_SUBSLICE_SHAPE"] == "1x2"
    assert mine.device_probe("1") and not mine.device_probe("9")
    theirs.stop()
    mine.stop()


def test_vfio_servicer_matches_the_reference(tmp_path):
    dev = tmp_path / "dev"
    (dev / "vfio").mkdir(parents=True)
    devices = [{"id": g, "vfio_group": str(dev / "vfio" / str(g))} for g in (11, 12)]
    for d in devices:
        open(d["vfio_group"], "w").close()
    state = tmp_path / "vm-devices.json"
    state.write_text(json.dumps({"devices": devices}))
    theirs = ref_manager.VfioPluginServicer(str(state), dev_root=str(dev), cdi_enabled=False)
    mine = manager.VfioPluginServicer(str(state), dev_root=str(dev), cdi_enabled=False)
    assert mine.resource_name == consts.GPU_VM_RESOURCE
    assert mine.snapshot() == theirs.snapshot() == {"11": "Healthy", "12": "Healthy"}
    req = pb2.AllocateRequest()
    req.container_requests.add().devicesIDs.extend(["12"])
    assert mine.Allocate(req, None) == theirs.Allocate(req, None)
    assert mine.device_probe("11") and not mine.device_probe("13")

    class Abort(Exception):
        pass

    class Context:
        def abort(self, code, msg):
            raise Abort(code, msg)

    stale = pb2.AllocateRequest()
    stale.container_requests.add().devicesIDs.extend(["99"])
    for s in (theirs, mine):
        with pytest.raises(Abort) as e:
            s.Allocate(stale, Context())
        assert e.value.args[0] == grpc.StatusCode.NOT_FOUND
    state.write_text("{")
    for s in (theirs, mine):
        with pytest.raises(Abort) as e:
            s.Allocate(req, Context())
        assert e.value.args[0] == grpc.StatusCode.UNAVAILABLE
    theirs.stop()
    mine.stop()


@pytest.mark.parametrize("mod", [ref_server, server], ids=["reference", "port"])
def test_stop_leaves_the_guard_when_shutdown_is_unconfirmed(tmp_path, dev_roots, mod):
    """A successor re-bound the fixed socket name; a shutdown that does not
    confirm leaves the successor's socket under the guard name, then puts
    it back once the shutdown completes."""
    cls = getattr(mod, "TPUDevicePluginServicer", None) or mod.GPUDevicePluginServicer
    srv = mod.DevicePluginServer(cls(dev_root=dev_roots[1]), socket_dir=str(tmp_path / "k"),
                                 socket_name="p.sock")
    srv.start()
    real = srv.server
    os.rename(srv.socket_path, srv.socket_path + ".old")
    with open(srv.socket_path, "w") as f:
        f.write("successor")
    release = threading.Event()

    class SlowDone:
        def wait(self, timeout=None):
            return release.wait(timeout=0 if timeout is not None else WAIT_S)

    class SlowServer:
        def stop(self, grace=None):
            return SlowDone()

    srv.server = SlowServer()
    try:
        srv.stop()
        guard = srv.socket_path + ".shutdown-guard"
        assert os.path.exists(guard) and not os.path.exists(srv.socket_path)
        release.set()
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(srv.socket_path) and time.monotonic() < deadline:
            time.sleep(0.01)
        with open(srv.socket_path) as f:
            assert f.read() == "successor"
    finally:
        real.stop(grace=0)


@pytest.mark.parametrize("mod", [ref_server, server], ids=["reference", "port"])
def test_stop_restores_the_successors_socket(tmp_path, dev_roots, mod):
    cls = getattr(mod, "TPUDevicePluginServicer", None) or mod.GPUDevicePluginServicer
    srv = mod.DevicePluginServer(cls(dev_root=dev_roots[1]), socket_dir=str(tmp_path / "k"),
                                 socket_name="p.sock")
    srv.start()
    os.rename(srv.socket_path, srv.socket_path + ".old")
    with open(srv.socket_path, "w") as f:
        f.write("successor")
    srv.stop()
    with open(srv.socket_path) as f:
        assert f.read() == "successor"
    assert not os.path.exists(srv.socket_path + ".shutdown-guard")


def test_stop_ends_streams_and_joins_the_poller(sides):
    _, port = sides
    stream = port.stub.ListAndWatch(pb2.Empty(), timeout=WAIT_S)
    msgs = pump(stream)
    msgs.get(timeout=WAIT_S)
    poller = port.servicer._poller
    assert poller is not None and poller.is_alive()
    port.server.stop()
    assert not poller.is_alive()


@pytest.mark.parametrize("side", ["reference", "port"])
def test_kubelet_sim_drives_the_port_plugin_into_validate_plugin(tmp_path, dev_roots, side):
    """Each simulated kubelet, the reference's and the port's, registers
    the port's plugin over gRPC, consumes its ListAndWatch and writes the
    node's capacity and allocatable into its own FakeClient; the port's
    plugin component passes on them, and fails when every card is
    Unhealthy."""
    if side == "reference":
        client = FakeClient([make_cpu_node(NODE)])
        kubelet_cls = KubeletDeviceManager
    else:
        client = port_client.FakeClient([port_testing.make_cpu_node(NODE)])
        kubelet_cls = port_kubelet_sim.KubeletDeviceManager
    socket_dir = str(tmp_path / "kubelet")
    kubelet = kubelet_cls(client, NODE, socket_dir)
    kubelet.start()
    servicer = server.GPUDevicePluginServicer(dev_root=dev_roots[1], poll_interval_s=POLL_S,
                                              health_probe_interval_s=3600)
    plugin = server.DevicePluginServer(servicer, socket_dir=socket_dir)
    plugin.start()
    status = comp.StatusFiles(str(tmp_path / "val"))

    def caps():
        st = client.get("v1", "Node", NODE).get("status", {})
        return st.get("capacity", {}).get("nvidia.com/gpu"), st.get("allocatable", {}).get("nvidia.com/gpu")

    def wait_for(want):
        deadline = time.monotonic() + WAIT_S
        while caps() != want and time.monotonic() < deadline:
            time.sleep(POLL_S)
        assert caps() == want

    try:
        plugin.register_with_kubelet(kubelet.kubelet_socket)
        wait_for(("8", "8"))
        info = comp.validate_plugin(status, client, NODE, retries=3, sleep_s=POLL_S)
        assert (info["capacity"], info["allocatable"]) == (8, 8)
        assert status.exists(consts.STATUS_FILE_PLUGIN)
        # admission through the port's preference and Allocate, checked
        # fail-closed by the kubelet's own sequence
        resp = kubelet.allocate("nvidia.com/gpu", 2, must_include=["5"])
        names = [c.name for c in resp.container_responses[0].cdi_devices]
        assert names == ["nvidia.com/gpu=0", "nvidia.com/gpu=5"]
        servicer.mark_unhealthy("3")
        wait_for(("8", "7"))
        for i in range(8):
            servicer.mark_unhealthy(str(i))
        wait_for(("8", "0"))
        with pytest.raises(comp.ValidationError, match="none are allocatable"):
            comp.validate_plugin(status, client, NODE, retries=2, sleep_s=POLL_S)
    finally:
        plugin.stop()
        kubelet.stop()


def test_transport_free_path_needs_no_grpc_protobuf_or_yaml(dev_roots):
    """``import tpu_operator_torch`` and every module of the slice import
    with grpc, protobuf and PyYAML blocked, and the servicer answers
    through its plain-data methods (what the card check falls back to
    without grpc). ``deviceplugin_pb2`` is protoc's output and needs
    protobuf by nature. The control plane's read and write paths (the
    informer cache, the write pipeline, Events, the warm journal,
    log-once), the state machine's leaf modules and the state machine
    itself (the object controls, slice aggregation and the rollout
    ledger's head) import too; ``controllers.resource_manager`` is the one
    that needs PyYAML, and only where it loads a state directory (the
    assets ``ClusterPolicyController.init`` reads), so no import needs
    it. The node FSMs (the upgrade, remediation and the re-partition roll)
    and the reconcilers (the ClusterPolicy reconciler, the delta reconciler
    and event router, the whole rollout module and the upgrade reconciler)
    import too, and so does the operator process (the manager, sharding,
    ``main`` and the maintenance handler), and a node carrying each of the upgrade FSM's renamed labels
    and annotations crosses ``convert`` to the reference's names and back.
    So do the allocation ledger and the gang coordinator
    (``schedsim.registry``, ``schedsim.gang``), the chaos schedule and the
    soak module (``chaos.schedule``, ``chaos.soak``) and the lock-order
    watchdog (``analysis.lockwatch``). ``schedsim.engine`` is the one module
    of that slice left out: it needs ``kube.kubelet_sim``, which imports grpc
    at module level, and ``SoakRunner.run`` imports it when a soak runs
    with churn."""
    code = f"""
import sys
for name in ("grpc", "google", "google.protobuf", "yaml"):
    sys.modules[name] = None
import importlib
for mod in ("tpu_operator_torch", "tpu_operator_torch.workloads.topology",
            "tpu_operator_torch.plugin", "tpu_operator_torch.plugin.proto",
            "tpu_operator_torch.plugin.cdi", "tpu_operator_torch.plugin.grpc_glue",
            "tpu_operator_torch.plugin.server", "tpu_operator_torch.plugin.manager",
            "tpu_operator_torch.operands.runtime_wire", "tpu_operator_torch.discovery",
            "tpu_operator_torch.discovery.tfd", "tpu_operator_torch.controllers.state_manager",
            "tpu_operator_torch.native.gpuinfo", "tpu_operator_torch.api.v1",
            "tpu_operator_torch.cfg.main", "tpu_operator_torch.cfg.crdgen", "tpu_operator_torch.obs",
            "tpu_operator_torch.kube", "tpu_operator_torch.kube.rest", "tpu_operator_torch.kube.kubesim",
            "tpu_operator_torch.kube.testing", "tpu_operator_torch.kube.cache",
            "tpu_operator_torch.kube.write_pipeline", "tpu_operator_torch.kube.events",
            "tpu_operator_torch.kube.warm", "tpu_operator_torch.obs.logonce",
            "tpu_operator_torch.controllers.render_cache", "tpu_operator_torch.controllers.cluster_snapshot",
            "tpu_operator_torch.controllers.operator_metrics",
            "tpu_operator_torch.controllers.resource_manager",
            "tpu_operator_torch.controllers.object_controls", "tpu_operator_torch.controllers.slice_status",
            "tpu_operator_torch.controllers.rollout", "tpu_operator_torch.upgrade.upgrade_state",
            "tpu_operator_torch.controllers.remediation", "tpu_operator_torch.controllers.repartition",
            "tpu_operator_torch.sliceman.slice_manager", "tpu_operator_torch.kube.disruption",
            "tpu_operator_torch.controllers.clusterpolicy_controller", "tpu_operator_torch.controllers.delta",
            "tpu_operator_torch.upgrade.upgrade_controller", "tpu_operator_torch.manager",
            "tpu_operator_torch.shard", "tpu_operator_torch.main", "tpu_operator_torch.operands.maintenance",
            "tpu_operator_torch.schedsim", "tpu_operator_torch.schedsim.registry",
            "tpu_operator_torch.schedsim.gang", "tpu_operator_torch.chaos", "tpu_operator_torch.chaos.schedule",
            "tpu_operator_torch.chaos.soak", "tpu_operator_torch.analysis",
            "tpu_operator_torch.analysis.lockwatch"):
    importlib.import_module(mod)
from tpu_operator_torch import consts, convert
renamed = [consts.UPGRADE_SKIP_LABEL, consts.UPGRADE_SKIP_DRAIN_LABEL] + list(convert.ANNOTATION_KEYS.values())
kept = [consts.REMEDIATION_SKIP_LABEL, consts.REPAIR_LABEL, consts.REMEDIATION_ATTEMPTS_ANNOTATION,
        consts.REMEDIATION_INITIAL_STATE_ANNOTATION]
labels = [consts.UPGRADE_SKIP_LABEL, consts.UPGRADE_SKIP_DRAIN_LABEL, consts.REMEDIATION_SKIP_LABEL, consts.REPAIR_LABEL]
node = {{"apiVersion": "v1", "kind": "Node", "metadata": {{
    "name": "n", "labels": {{k: "true" for k in labels}},
    "annotations": {{k: "x" for k in renamed + kept if k not in labels}}}}}}
ref = convert.object_to_reference(node)
keys = set(ref["metadata"]["labels"]) | set(ref["metadata"]["annotations"])
assert len(keys) == len(renamed + kept) and set(kept) <= keys, ref
assert all("libtpu" in k for k in keys - set(kept)), ref
assert convert.object_from_reference(ref) == node
from tpu_operator_torch.native import gpuinfo
gpuinfo._load = lambda: None
gpuinfo._load_native = lambda: None
from tpu_operator_torch.plugin.server import GPUDevicePluginServicer
s = GPUDevicePluginServicer(dev_root={dev_roots[1]!r}, poll_interval_s=0.01)
first = next(s.watch())
s.mark_unhealthy("2")
print(len(first), s.snapshot()["2"], s.preferred(["5", "3", "7"], ["7"], 2),
      s.allocate_container(["3"])["cdi_devices"])
s.stop()
assert not any(m == "grpc" or m.startswith(("grpc.", "google.protobuf", "yaml"))
               for m, v in sys.modules.items() if v is not None)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["8", "Unhealthy", "['3',", "'7']", "['nvidia.com/gpu=3']"]


def test_both_protos_share_one_descriptor():
    """The port's generated module is the reference's file byte for byte:
    one pool entry, one set of message classes."""
    from tpu_operator.plugin.proto import pb2 as ref_pb2

    assert pb2.DESCRIPTOR.serialized_pb == ref_pb2.DESCRIPTOR.serialized_pb
    assert pb2.Device is ref_pb2.Device
    here = os.path.dirname(pb2.__file__)
    theirs = os.path.dirname(ref_pb2.__file__)
    for name in ("deviceplugin.proto", "deviceplugin_pb2.py"):
        with open(os.path.join(here, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read()


def test_plugin_module_runs_as_a_program():
    for mod, flag in (("tpu_operator_torch.plugin", "--strategy"),
                      ("tpu_operator_torch.plugin.manager", "--vm-state-file")):
        proc = subprocess.run([sys.executable, "-m", mod, "--help"], capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == 0 and flag in proc.stdout, proc.stderr
