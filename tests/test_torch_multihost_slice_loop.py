"""The port's multi-host slice loop in one system against the JAX package's,
on the 2 cases of ``tests/test_multihost_slice_loop.py``: one KubeSim, four
nodes, four ``KubeletDeviceManager`` rigs (``kube/kubelet_sim.py``), each
consuming a shipped ``DevicePluginServer`` (``plugin/server.py``) over real
gRPC, feature discovery (``discovery/tfd.py``) labelling the four hosts
into one slice, and the whole operator aggregating the slice's readiness.

* All four hosts validate: ``SLICE_READY_LABEL`` is ``true`` on every
  member and the CR counts the slice. One host's cards go Unhealthy in its
  plugin: its allocatable falls to 0, the slice flips to not ready and a
  ``SliceDegraded`` Event names the host. The cards recover, and so does
  the slice.
* The slice gang (``validator/components.py`` ``validate_slice_workload``):
  the leader spawns one pod a member host, the follower converges on the
  same gang, and with one member cordoned the run raises
  ``ValidationError`` naming that host.

Each case runs one script on both packages (``both``, from
``tests/test_torch_fault_matrix.py``), each on its own KubeSim, CRD
(``cfg/crdgen.build_crd``), nodes, rigs and operator. The reference's hosts
are v5e ``4x8`` (its GKE topology label); the port's are HGX H100 boards of
8 cards whose slice is ``TPU_TOPOLOGY=4x8`` (32 cards, 4 hosts), the slice
id from ``TPU_SLICE_ID`` on both (``tfd.py``), the port's chip table given
to discovery and its devices as ``nvidia<i>`` nodes under a stub devfs
(NVML is kept out so the table does not come from the host). The script
returns outcomes; tolerance: exact equality. Every wait has a limit of 60 s
or more (90 s for a convergence), and every server, rig and thread stops in
a ``finally``.
"""

import threading
from contextlib import contextmanager

import pytest
import yaml

from tests.test_torch_fault_matrix import NS, both, operator_env, start_server, wait  # noqa: F401
from tpu_operator_torch.kube import testing
from tpu_operator_torch.native import gpuinfo

CPV = "tpu.k8s.io/v1"
HOSTS = 4
SLICE_ID = "pod-slice-a"
NODES = tuple(f"ms-node-{i}" for i in range(HOSTS))
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def no_nvml(monkeypatch):
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


def _devfs(side, root):
    prefix = "accel" if side.name == "reference" else "nvidia"
    root.mkdir(parents=True)
    for c in range(8):
        (root / f"{prefix}{c}").touch()
    return str(root)


def _driver_root(root):
    """A driver root whose library names the simulated nodes' driver."""
    lib = root / "usr" / "lib64"
    lib.mkdir(parents=True)
    (lib / f"libcuda.so.{testing.DEFAULT_DRIVER_VERSION}").touch()
    return str(root)


def features(side, node, i, dev_root, tmp, slice_id=SLICE_ID):
    """Feature discovery's labels for slice member ``i`` (worker id, slice id
    and, on the port, the slice's ``TPU_TOPOLOGY``)."""
    env = {"TPU_WORKER_ID": str(i), "TPU_SLICE_ID": slice_id}
    if side.name == "reference":
        return side.tfd.gather_features(node, dev_root=dev_root, env=env)
    chips = [{"index": c, "path": f"{dev_root}/nvidia{c}", "name": H100, "memory_total_bytes": 81559 * 2**20}
             for c in range(8)]
    return side.tfd.gather_features(node, dev_root=dev_root, driver_root=_driver_root(tmp / f"driver-{i}"),
                                    env={**env, "TPU_TOPOLOGY": "4x8"}, chips=chips)


def servicer(side, dev_root):
    if side.name == "reference":
        return side.plugin.TPUDevicePluginServicer(dev_root=dev_root, generation="v5e", host_topology="2x4",
                                                   cdi_enabled=True, poll_interval_s=0.2,
                                                   health_probe_interval_s=3600)
    return side.plugin.GPUDevicePluginServicer(dev_root=dev_root, generation="h100-sxm", cdi_enabled=True,
                                               poll_interval_s=0.2, health_probe_interval_s=3600)


def node_of(side, name):
    if side.name == "reference":
        return side.node(name, topology="4x8")
    return side.node(name)


@contextmanager
def slice_cluster(side, tmp):
    """KubeSim, four card nodes in one slice, a kubelet rig and a shipped
    plugin on each; yields (client, rigs, the features of each host)."""
    server = start_server(side)
    rigs, stops = {}, [server.stop]
    try:
        client = side.kubesim.make_client(server.port)
        client.GET_RETRY_BACKOFF_S = 0.05
        client.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}})
        client.create(side.crdgen.build_crd())
        for name in NODES:
            client.create(node_of(side, name))
        with open(side.sample) as f:
            client.create(yaml.safe_load(f))
        feats = {}
        for i, name in enumerate(NODES):
            dev_root = _devfs(side, tmp / side.name / f"dev-{i}")
            socket_dir = str(tmp / side.name / f"kubelet-{i}")
            f = features(side, client.get("v1", "Node", name), i, dev_root, tmp / side.name)
            feats[name] = (f[side.consts.TFD_SLICE_HOSTS_LABEL], f[side.consts.TFD_SLICE_ID_LABEL],
                           side.tfd.apply_features(client, name, f))
            kubelet = side.kubelet_sim.KubeletDeviceManager(client, name, socket_dir)
            kubelet.start()
            stops.append(kubelet.stop)
            svc = servicer(side, dev_root)
            plugin = side.plugin.DevicePluginServer(svc, socket_dir=socket_dir)
            plugin.start()
            stops.append(plugin.stop)
            plugin.register_with_kubelet(kubelet.kubelet_socket)
            rigs[name] = (kubelet, svc, plugin)
        yield client, rigs, feats
    finally:
        for stop in reversed(stops):
            stop()


def slice_ready_labels(side, client):
    return {n: (client.get("v1", "Node", n)["metadata"].get("labels") or {}).get(side.consts.SLICE_READY_LABEL)
            for n in NODES}


def all_slice(side, client, value):
    return all(v == value for v in slice_ready_labels(side, client).values())


def cr_slices(client):
    return ((client.get_or_none(CPV, "ClusterPolicy", "cluster-policy") or {}).get("status") or {}).get("slices") or {}


def allocatable(side, client, name):
    return (client.get("v1", "Node", name)["status"].get("allocatable") or {}).get(side.resource)


def test_multihost_slice_loop(tmp_path):
    victim = NODES[2]

    def script(side):
        with slice_cluster(side, tmp_path) as (client, rigs, feats):
            out = {"features": feats}
            out["advertised"] = wait(lambda: all(allocatable(side, client, n) == "8" for n in NODES), 60)
            with side.running_operator(client, NS, NODES):
                out["slice ready"] = wait(lambda: all_slice(side, client, "true"), 90)
                out["CR counts it"] = wait(lambda: cr_slices(client).get("ready") == 1
                                           and cr_slices(client).get("total") == 1, 60)
                svc = rigs[victim][1]
                for c in range(8):
                    svc.mark_unhealthy(str(c))
                out["victim 0"] = wait(lambda: allocatable(side, client, victim) == "0", 60)
                out["slice not ready"] = wait(lambda: all_slice(side, client, "false"), 60)
                out["CR ready 0"] = wait(lambda: cr_slices(client).get("ready") == 0, 60)
                out["healthy host keeps 8"] = allocatable(side, client, NODES[0]) == "8"
                out["SliceDegraded names host"] = wait(lambda: any(
                    e.get("reason") == "SliceDegraded" and SLICE_ID in e.get("message", "")
                    and victim in e.get("message", "") for e in client.list("v1", "Event", NS)), 60)
                for c in range(8):
                    svc.mark_healthy(str(c))
                out["slice ready again"] = wait(lambda: all_slice(side, client, "true"), 90)
                out["CR ready 1"] = wait(lambda: cr_slices(client).get("ready") == 1, 60)
            return out

    out = both(script)
    assert out.pop("features") == {n: (str(HOSTS), SLICE_ID, True) for n in NODES}
    assert all(out.values()), out


def _gang_kubelet(side, client, halt, expect_hosts="4"):
    """The scheduler and kubelet for gang pods: a pod runs only where its
    nodeSelector matches the node's labels (the slice-ready gate) and the
    node is schedulable, and succeeds only with the gang's env."""
    while not halt.is_set():
        try:
            for pod in client.list("v1", "Pod", NS):
                name = pod["metadata"]["name"]
                if not name.startswith("tpu-slice-gang") or pod.get("status", {}).get("phase") in (
                        "Succeeded", "Failed"):
                    continue
                sel = pod["spec"].get("nodeSelector") or {}
                target = sel.get("kubernetes.io/hostname")
                node = client.get_or_none("v1", "Node", target) if target else None
                if node is None:
                    continue
                labels = node["metadata"].get("labels") or {}
                if any(labels.get(k) != v for k, v in sel.items()) or node.get("spec", {}).get("unschedulable"):
                    continue
                env = {e["name"]: e.get("value", "") for e in pod["spec"]["containers"][0].get("env", [])}
                ok = (env.get("TPU_SLICE_HOSTS") == expect_hosts and "MEGASCALE_COORDINATOR_ADDRESS" in env
                      and env.get("TPU_WORKER_ID", "") != "")
                pod["spec"]["nodeName"] = target
                client.update(pod)
                fresh = client.get("v1", "Pod", name, NS)
                fresh["status"] = {"phase": "Succeeded" if ok else "Failed"}
                client.update_status(fresh)
        except Exception:
            pass  # races with the component's delete and recreate; retried
        halt.wait(0.1)


def test_slice_gang_workload_validation(tmp_path):
    """The slice-workload component on the 4-host rig spawns one pod a
    member host (gated on the slice verdict, ordinal and coordinator env
    injected), passes when all four succeed, and with one member unable to
    schedule fails naming that host."""
    victim = NODES[2]

    def script(side):
        comp = side.components
        with slice_cluster(side, tmp_path) as (client, rigs, _):
            halt = threading.Event()
            gang = threading.Thread(target=_gang_kubelet, args=(side, client, halt), daemon=True)
            gang.start()
            try:
                out = {}
                with side.running_operator(client, NS, NODES):
                    out["slice ready"] = wait(lambda: all_slice(side, client, "true"), 90)
                    status = comp.StatusFiles(str(tmp_path / side.name / "val-leader"))
                    info = comp.validate_slice_workload(status, client, NODES[0], NS, retries=200, sleep_s=0.1)
                    out["leader"] = (info["result"], info["role"], sorted(info["hosts"]))
                    out["status file"] = status.exists(side.consts.STATUS_FILE_SLICE_WORKLOAD)
                    info = comp.validate_slice_workload(comp.StatusFiles(str(tmp_path / side.name / "val-follower")),
                                                        client, NODES[1], NS, retries=200, sleep_s=0.1)
                    out["follower"] = (info["result"], info["role"])
                    pods = [p for p in client.list("v1", "Pod", NS)
                            if p["metadata"]["name"].startswith("tpu-slice-gang")]
                    out["gang"] = (len(pods), all(p["spec"]["nodeSelector"][side.consts.SLICE_READY_LABEL] == "true"
                                                  for p in pods))
                    vnode = client.get("v1", "Node", victim)
                    vnode.setdefault("spec", {})["unschedulable"] = True
                    client.update(vnode)
                    with pytest.raises(comp.ValidationError) as exc:
                        comp.validate_slice_workload(comp.StatusFiles(str(tmp_path / side.name / "val-neg")), client,
                                                     NODES[0], NS, retries=15, sleep_s=0.1)
                    msg = str(exc.value)
                    out["refusal names host"] = victim in msg and ("Unschedulable" in msg or "refusing" in msg)
                return out
            finally:
                halt.set()
                gang.join(timeout=10)

    out = both(script)
    assert out.pop("leader") == ("Succeeded", "leader", sorted(NODES))
    assert out.pop("follower") == ("Succeeded", "follower")
    assert out.pop("gang") == (HOSTS, True)
    assert all(out.values()), out
