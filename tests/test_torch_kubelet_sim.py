"""The port's simulated kubelet (``kube/kubelet_sim.py``) against the
reference's, each over the port's device plugin on its own copy of one
fixture devfs tree, over real gRPC on unix sockets in ``tmp_path``.

One sequence drives each kubelet: registration, a card Unhealthy and back,
a card removed, an allocation with a must-include card, a plugin restart
on the fixed socket name (the superseded stream must not clobber the fresh
advertisement), the refusal of a misbehaving plugin's preferences, and the
caller's contract. The capacity and allocatable the kubelet writes after
each step, the allocations and the refusals must be the same for both
kubelets. The sequence runs once over each side's ``FakeClient`` and once
over each side's ``RestClient`` into its own ``KubeSim``.

Polls run at milliseconds; every wait has a limit of ``WAIT_S``, and every
server and kubelet is stopped in a ``finally``."""

import time

import pytest

from tpu_operator.kube import client as ref_client
from tpu_operator.kube import kubelet_sim as ref_kubelet_sim
from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube.testing import make_cpu_node as ref_make_cpu_node
from tpu_operator_torch import consts
from tpu_operator_torch.kube import client, kubelet_sim, kubesim
from tpu_operator_torch.kube.testing import make_cpu_node
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.plugin import server
from tpu_operator_torch.plugin.proto import deviceplugin_pb2 as pb2

POLL_S = 0.02
WAIT_S = 30  # a limit on every wait, never what decides a result
ZOMBIE_S = 1.0  # how long the fresh advertisement must survive the old server's death
NODE = "gpu-node-1"
RES = consts.GPU_RESOURCE
SIDES = {
    "reference": (ref_kubelet_sim, ref_client, ref_kubesim, ref_make_cpu_node),
    "port": (kubelet_sim, client, kubesim, make_cpu_node),
}


@pytest.fixture(autouse=True)
def no_nvml(monkeypatch):
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


class Misbehaving(server.GPUDevicePluginServicer):
    """A plugin whose preferences break the kubelet's contract in a chosen
    way (``mode``)."""

    mode = "none"

    def GetPreferredAllocation(self, request, context):
        resp = super().GetPreferredAllocation(request, context)
        creq = request.container_requests[0]
        for cresp in resp.container_responses:
            if self.mode == "unknown-device":
                del cresp.deviceIDs[:]
                cresp.deviceIDs.extend(["99", "100"])
            elif self.mode == "wrong-size":
                cresp.deviceIDs.append(next(i for i in creq.available_deviceIDs if i not in cresp.deviceIDs))
            elif self.mode == "drops-must-include":
                rest = [i for i in creq.available_deviceIDs if i not in creq.must_include_deviceIDs]
                del cresp.deviceIDs[:]
                cresp.deviceIDs.extend(rest[: creq.allocation_size])
            elif self.mode == "empty":
                del resp.container_responses[:]
                break
        return resp


def plugin_for(dev_root, socket_dir, cls=server.GPUDevicePluginServicer):
    servicer = cls(dev_root=dev_root, poll_interval_s=POLL_S, health_probe_interval_s=3600)
    plugin = server.DevicePluginServer(servicer, socket_dir=socket_dir)
    plugin.start()
    return servicer, plugin


def run_sequence(side, backend, tmp_path):
    """The steps' observations for one kubelet over one backend."""
    kubelet_mod, client_mod, sim_mod, cpu_node = SIDES[side]
    root = tmp_path / f"{side[0]}{backend[0]}"  # unix socket paths stay under 108 bytes
    dev = root / "dev"
    dev.mkdir(parents=True)
    for name in ("nvidia0", "nvidia1", "nvidia2", "nvidia3", "nvidiactl"):
        (dev / name).touch()
    socket_dir = str(root / "k")
    sim_server = None
    if backend == "fake":
        c = client_mod.FakeClient([cpu_node(NODE)])
    else:
        sim_server = sim_mod.KubeSimServer(sim_mod.KubeSim(bookmark_interval_s=1.0)).start()
        c = sim_mod.make_client(sim_server.port)
        c.create(cpu_node(NODE))
    kubelet = kubelet_mod.KubeletDeviceManager(c, NODE, socket_dir)
    plugins = []
    seen = []

    def caps():
        st = c.get("v1", "Node", NODE).get("status", {})
        return st.get("capacity", {}).get(RES), st.get("allocatable", {}).get(RES)

    def wait_for(want):
        deadline = time.monotonic() + WAIT_S
        while caps() != want and time.monotonic() < deadline:
            time.sleep(POLL_S)
        seen.append(caps())
        assert seen[-1] == want, (side, backend, seen)

    def refusal(*a, **kw):
        try:
            resp = kubelet.allocate(*a, **kw)
        except RuntimeError as e:
            return type(e).__name__, str(e)
        return "admitted", sorted(d.name for d in resp.container_responses[0].cdi_devices)

    try:
        kubelet.start()
        servicer, plugin = plugin_for(str(dev), socket_dir)
        plugins.append(plugin)
        plugin.register_with_kubelet(kubelet.kubelet_socket)
        wait_for(("4", "4"))
        servicer.mark_unhealthy("1")
        wait_for(("4", "3"))
        servicer.mark_healthy("1")
        wait_for(("4", "4"))
        (dev / "nvidia3").unlink()
        servicer.refresh_devices()
        wait_for(("3", "3"))
        resp = kubelet.allocate(RES, 2, must_include=["2"])
        cresp = resp.container_responses[0]
        seen.append(sorted(d.name for d in cresp.cdi_devices))
        seen.append(sorted(cresp.envs))

        # a restart on the same socket: the old stream dies after the new registration
        servicer2, plugin2 = plugin_for(str(dev), socket_dir)
        plugins.append(plugin2)
        plugin2.register_with_kubelet(kubelet.kubelet_socket)
        wait_for(("3", "3"))
        plugin.stop()
        deadline = time.monotonic() + ZOMBIE_S
        while time.monotonic() < deadline:
            assert caps() == ("3", "3"), "the superseded stream clobbered the fresh advertisement"
            time.sleep(POLL_S)
        servicer2.mark_unhealthy("0")
        wait_for(("3", "2"))
        servicer2.mark_healthy("0")
        wait_for(("3", "3"))

        # a plugin whose preferences break the contract is refused
        plugin2.stop()
        bad, plugin3 = plugin_for(str(dev), socket_dir, Misbehaving)
        plugins.append(plugin3)
        plugin3.register_with_kubelet(kubelet.kubelet_socket)
        wait_for(("3", "3"))
        for mode, must in (("unknown-device", ()), ("wrong-size", ()), ("drops-must-include", ("0",)),
                           ("empty", ("2",)), ("none", ())):
            bad.mode = mode
            seen.append((mode, refusal(RES, 2, must_include=must)))
        bad.mark_unhealthy("2")
        wait_for(("3", "2"))
        seen.append(refusal(RES, 2, must_include=("2",)))
        seen.append(refusal(RES, 1, must_include=("0", "1")))
        seen.append(refusal(RES, 3))
        seen.append(refusal("nvidia.com/mig-1x2", 1))
    finally:
        for p in plugins:
            p.stop()
        kubelet.stop()
        if sim_server is not None:
            sim_server.stop()
    return seen


@pytest.mark.parametrize("backend", ["fake", "kubesim"])
def test_port_kubelet_writes_the_reference_kubelet_s_sequence(backend, tmp_path):
    want = run_sequence("reference", backend, tmp_path)
    got = run_sequence("port", backend, tmp_path)
    assert got == want
    assert got[4] == ["nvidia.com/gpu=0", "nvidia.com/gpu=2"]
    modes = dict(x for x in got if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], tuple))
    assert "unavailable" in modes["unknown-device"][1] and "asked for" in modes["wrong-size"][1]
    assert "must-include" in modes["drops-must-include"][1]
    assert modes["empty"] == ("admitted", ["nvidia.com/gpu=0", "nvidia.com/gpu=2"])
    assert modes["none"][0] == "admitted"


def test_in_process_stub_and_admission_match_the_reference(tmp_path):
    """``admit_and_allocate`` over ``InProcessPluginStub``: the admission
    sequence without a socket gives the same cards and env keys."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(4):
        (dev / f"nvidia{i}").touch()
    servicer = server.GPUDevicePluginServicer(dev_root=str(dev), poll_interval_s=POLL_S)
    try:
        out = []
        for mod in (ref_kubelet_sim, kubelet_sim):
            stub = mod.InProcessPluginStub(servicer)
            chosen, resp = mod.admit_and_allocate(stub, RES, ["0", "1", "2", "3"], 2, ["3"])
            out.append((chosen, sorted(resp.container_responses[0].envs)))
        assert out[0] == out[1] and "3" in out[0][0]
    finally:
        servicer.stop()


def test_status_write_failure_is_logged_and_swallowed(caplog):
    """A failed node-status write (a node the API server does not have) is
    logged, not raised: the stream consumer keeps running."""
    kubelet = kubelet_sim.KubeletDeviceManager(client.FakeClient(), "absent", "/nonexistent")
    kubelet.resources = {RES: {"0": kubelet_sim.HEALTHY}}
    kubelet._write_node_status()
    assert "failed to write node device status" in caplog.text
    assert pb2.AllocateResponse is kubelet_sim.pb2.AllocateResponse
