"""The port's slice manager (``sliceman/slice_manager.py``) against the
reference's on one fixture: the same layouts and chip-clients files, the
same devfs tree with names mapped ``accelN`` ↔ ``nvidiaN``, the same label
FSM on a node of each (``tests/test_discovery_exporter_sliceman.py:
219-402``, ``tests/test_sliceman_kubesim.py:92``), with
``google.com/tpu-<shape>`` ↔ ``nvidia.com/mig-<shape>``.

Equal by design: the states written, the partition file (subslice ids,
shapes, cards), the CDI composites, the paused clients, the plugin's
resources. Different by design: a subslice's cards are the chip table's
ids (minor numbers), mesh position p being the p-th card in (NVLink
domain, id) order; a partition whose topology does not count the table's
cards, or whose subslice spans NVLink domains, fails."""

import json
import os
import threading
import time
from http.client import HTTPConnection

import pytest
import yaml

from tpu_operator import consts as ref_consts
from tpu_operator.kube import FakeClient
from tpu_operator.kube.client import ConflictError as RefConflictError
from tpu_operator.kube.client import NotFoundError as RefNotFoundError
from tpu_operator.kube.kubesim import KubeSim, KubeSimServer, make_client
from tpu_operator.kube.rest import TransientAPIError as RefTransientAPIError
from tpu_operator.kube.testing import make_tpu_node
from tpu_operator.native import tpuinfo
from tpu_operator.plugin.manager import PluginManager as RefPluginManager
from tpu_operator.sliceman import slice_manager as ref_sm
from tpu_operator_torch import consts
from tpu_operator_torch.kube.client import ConflictError, NotFoundError
from tpu_operator_torch.kube.incluster import InClusterClient, TransientAPIError
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.plugin import cdi
from tpu_operator_torch.plugin.manager import PluginManager
from tpu_operator_torch.sliceman import slice_manager as sm

NODE = "n1"
PRODUCT = "NVIDIA-H100-80GB-HBM3"
CLIENT_LABEL = "device-plugin"
CONFIGS = {
    "all-disabled": [{"devices": "all", "partitioned": False}],
    "all-1x1": [{"devices": "all", "partitioned": True, "layout": {"shape": "1x1"}}],
    "all-1x2": [{"devices": "all", "partitioned": True, "layout": {"shape": "1x2"}}],
    "all-2x2": [{"devices": "all", "partitioned": True, "layout": {"shape": "2x2"}}],
    "all-host": [{"devices": "all", "partitioned": True, "layout": {"shape": "host"}}],
    "bad-shape": [{"devices": "all", "partitioned": True, "layout": {"shape": "3x1"}}],
}


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(tpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load", lambda: None)
    monkeypatch.setattr(gpuinfo, "_load_native", lambda: None)


def _files(root, client_label_key):
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump({"version": "v1", "slice-configs": CONFIGS}))
    clients = root / "clients.yaml"
    clients.write_text(yaml.safe_dump({"version": "v1", "kubernetes-labels": [client_label_key]}))
    return str(cfg), str(clients)


def _dev(root, prefix, ids):
    d = root / "dev"
    d.mkdir(parents=True)
    for i in ids:
        (d / f"{prefix}{i}").touch()
    return str(d)


def _port_node(topology="2x4", name=NODE):
    labels = {consts.GPU_PRODUCT_LABEL: PRODUCT, consts.DEPLOY_LABEL_PREFIX + CLIENT_LABEL: "true"}
    if topology:
        labels[consts.TFD_TOPOLOGY_LABEL] = topology
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name, "labels": labels}}


def _ref_node(topology="2x4", name=NODE):
    node = make_tpu_node(name, topology=topology)
    if not topology:
        del node["metadata"]["labels"][ref_consts.GKE_TPU_TOPOLOGY_LABEL]
    node["metadata"]["labels"][ref_consts.DEPLOY_LABEL_PREFIX + CLIENT_LABEL] = "true"
    return node


class _Side:
    """One side of the fixture: its client, manager and files."""

    def __init__(self, client, mgr, root, labels, cdi_path):
        self.client, self.mgr, self.root, self.labels, self.cdi_path = client, mgr, root, labels, cdi_path

    def set_config(self, name):
        node = self.client.get("v1", "Node", NODE)
        node["metadata"]["labels"][self.labels.SLICE_CONFIG_LABEL] = name
        self.client.update(node)

    def node_labels(self):
        return self.client.get("v1", "Node", NODE)["metadata"]["labels"]

    def client_label(self):
        return self.node_labels()[self.labels.DEPLOY_LABEL_PREFIX + CLIENT_LABEL]

    def state(self):
        return json.loads((self.root / "partitions.json").read_text())

    def composites(self):
        with open(self.cdi_path) as f:
            spec = yaml.safe_load(f)
        return {
            d["name"]: sorted(os.path.basename(n["path"]).replace("accel", "nvidia")
                              for n in d["containerEdits"]["deviceNodes"])
            for d in spec["devices"] if d["name"].startswith("subslice-")
        }


def _sides(tmp_path, topology="2x4", ids=range(8)):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    ref_root.mkdir()
    port_root.mkdir()
    ref_cfg, ref_clients = _files(ref_root, ref_consts.DEPLOY_LABEL_PREFIX + CLIENT_LABEL)
    cfg, clients = _files(port_root, consts.DEPLOY_LABEL_PREFIX + CLIENT_LABEL)
    ref_client = FakeClient([_ref_node(topology)])
    ref_mgr = ref_sm.SliceManager(
        ref_client, NODE, config_file=ref_cfg, chip_clients_file=ref_clients,
        partition_file=str(ref_root / "partitions.json"), cdi_spec_path=str(ref_root / "cdi.yaml"),
        dev_root=_dev(ref_root, "accel", range(len(ids))),
    )
    client = FakeClient([_port_node(topology)])
    mgr = sm.SliceManager(
        client, NODE, config_file=cfg, chip_clients_file=clients,
        partition_file=str(port_root / "partitions.json"), cdi_spec_path=str(port_root / "cdi.json"),
        dev_root=_dev(port_root, "nvidia", ids), driver_root=str(port_root / "driver"),
    )
    return (_Side(ref_client, ref_mgr, ref_root, ref_consts, str(ref_root / "cdi.yaml")),
            _Side(client, mgr, port_root, consts, str(port_root / "cdi.json")))


def _mapped_subslices(state):
    return [
        {**s, "resource": s["resource"].replace(ref_consts.TPU_SUBSLICE_RESOURCE_PREFIX,
                                                consts.MIG_RESOURCE_PREFIX)}
        for s in state["subslices"]
    ]


def _reconcile_both(ref, port, config):
    ref.set_config(config)
    port.set_config(config)
    return ref.mgr.reconcile_once(), port.mgr.reconcile_once()


@pytest.mark.parametrize("config,shape,count", [("all-2x2", "2x2", 2), ("all-1x2", "1x2", 4),
                                                 ("all-1x1", "1x1", 8), ("all-host", "2x4", 1)])
def test_partition_matches_the_reference(tmp_path, config, shape, count):
    ref, port = _sides(tmp_path)
    assert _reconcile_both(ref, port, config) == (ref_sm.STATE_SUCCESS, sm.STATE_SUCCESS)
    theirs, mine = ref.state(), port.state()
    assert mine["partitioned"] and mine["shape"] == theirs["shape"]
    assert len(mine["subslices"]) == count
    assert mine["subslices"] == _mapped_subslices(theirs)
    assert {k: mine[k] for k in ("topology", "config")} == {k: theirs[k] for k in ("topology", "config")}
    assert mine["generation"] == "h100-sxm"
    if config == "all-2x2":
        assert mine["subslices"][0]["chips"] == [0, 1, 4, 5]
        assert mine["subslices"][0]["resource"] == "nvidia.com/mig-2x2"
    assert port.composites() == ref.composites()
    for side in (ref, port):
        labels = side.node_labels()
        assert labels[side.labels.SLICE_CONFIG_STATE_LABEL] == "success"
        assert side.client_label() == "true"  # clients restored after the apply


def test_partition_drives_plugin_resources_as_the_reference(tmp_path):
    ref, port = _sides(tmp_path)
    _reconcile_both(ref, port, "all-2x2")
    for strategy in ("mixed", "single"):
        theirs = RefPluginManager(strategy=strategy, partition_file=str(ref.root / "partitions.json"))
        mine = PluginManager(strategy=strategy, partition_file=str(port.root / "partitions.json"))
        t, m = theirs.desired_resources(), mine.desired_resources()
        assert [k.replace(ref_consts.TPU_SUBSLICE_RESOURCE_PREFIX, consts.MIG_RESOURCE_PREFIX)
                .replace(ref_consts.TPU_RESOURCE, consts.GPU_RESOURCE) for k in t] == list(m)
        for (_, tcfg), (_, mcfg) in zip(t.items(), m.items()):
            assert mcfg["kind"] == tcfg["kind"] == "subslice"
            assert [s["chips"] for s in mcfg["subslices"]] == [s["chips"] for s in tcfg["subslices"]]
    assert set(PluginManager(strategy="mixed", partition_file=str(port.root / "partitions.json"))
               .desired_resources()) == {"nvidia.com/mig-2x2"}
    # de-partitioning restores whole-card advertisement
    assert _reconcile_both(ref, port, "all-disabled") == ("success", "success")
    mixed = PluginManager(strategy="mixed", partition_file=str(port.root / "partitions.json"))
    assert mixed.desired_resources() == {consts.GPU_RESOURCE: {"kind": "chips"}}


def test_lingering_pause_recovers_as_the_reference(tmp_path):
    ref, port = _sides(tmp_path)
    _reconcile_both(ref, port, "all-2x2")
    for side, paused in ((ref, ref_sm.PAUSED_VALUE), (port, sm.PAUSED_VALUE)):
        node = side.client.get("v1", "Node", NODE)
        node["metadata"]["labels"][side.labels.DEPLOY_LABEL_PREFIX + CLIENT_LABEL] = paused
        side.client.update(node)
    assert (ref.mgr.reconcile_once(), port.mgr.reconcile_once()) == ("success", "success")
    assert ref.client_label() == port.client_label() == "true"


def test_unpartitioned_matches_the_reference(tmp_path):
    ref, port = _sides(tmp_path)
    assert _reconcile_both(ref, port, "all-disabled") == ("success", "success")
    assert port.state() == ref.state() == {"partitioned": False, "subslices": [], "config": "all-disabled"}


@pytest.mark.parametrize("config", ["bad-shape", "nope"])
def test_bad_shape_and_unknown_config_fail_as_the_reference(tmp_path, config):
    ref, port = _sides(tmp_path)
    assert _reconcile_both(ref, port, config) == (ref_sm.STATE_FAILED, sm.STATE_FAILED)
    for side in (ref, port):
        assert side.node_labels()[side.labels.SLICE_CONFIG_STATE_LABEL] == "failed"
        assert side.client_label() == "true"  # clients restored even on failure


def test_idempotent_as_the_reference(tmp_path):
    ref, port = _sides(tmp_path)
    _reconcile_both(ref, port, "all-1x1")
    for side in (ref, port):
        rv = side.client.get("v1", "Node", NODE)["metadata"]["resourceVersion"]
        assert side.mgr.reconcile_once() == "success"
        assert side.client.get("v1", "Node", NODE)["metadata"]["resourceVersion"] == rv


def test_no_config_label_does_nothing_as_the_reference(tmp_path):
    ref, port = _sides(tmp_path)
    assert ref.mgr.reconcile_once() is None and port.mgr.reconcile_once() is None
    assert not (port.root / "partitions.json").exists()


def test_no_topology_label_partitions_every_visible_card(tmp_path):
    """Without a topology label both fall back to ``1x<visible cards>``."""
    ref, port = _sides(tmp_path, topology="")
    assert _reconcile_both(ref, port, "all-1x2") == ("success", "success")
    assert port.state()["topology"] == ref.state()["topology"] == "1x8"
    assert port.state()["subslices"] == _mapped_subslices(ref.state())


@pytest.mark.parametrize(
    "profile",
    [CONFIGS[name] for name in CONFIGS]
    + [[], [{"partitioned": True}], [{"partitioned": True, "layout": None}],
       [{"partitioned": True, "layout": {"shape": ""}}, {"partitioned": True, "layout": {"shape": "2x1"}}]],
)
def test_resolve_shape_matches_the_reference(profile):
    assert sm.resolve_shape(profile, "2x4") == ref_sm.resolve_shape(profile, "2x4")


def test_config_files_read_as_the_reference(tmp_path):
    cfg, clients = _files(tmp_path, "k")
    assert sm.load_slice_configs(cfg) == ref_sm.load_slice_configs(cfg)
    assert sm.load_chip_clients(clients) == ref_sm.load_chip_clients(clients) == ["k"]
    assert sm.load_chip_clients(str(tmp_path / "absent")) == ref_sm.load_chip_clients(str(tmp_path / "absent")) == []
    (tmp_path / "empty.yaml").write_text("version: v1\n")
    for mod in (sm, ref_sm):
        with pytest.raises(ValueError, match="no slice-configs"):
            mod.load_slice_configs(str(tmp_path / "empty.yaml"))


def test_partition_state_round_trips_as_the_reference(tmp_path):
    state = {"partitioned": True, "subslices": [{"id": 0, "chips": [1, 3]}], "config": "c"}
    sm.write_partition_state(state, str(tmp_path / "a" / "p.json"))
    ref_sm.write_partition_state(state, str(tmp_path / "b" / "p.json"))
    assert (tmp_path / "a" / "p.json").read_text() == (tmp_path / "b" / "p.json").read_text()
    assert sm.read_partition_state(str(tmp_path / "a" / "p.json")) == state
    assert not (tmp_path / "a" / "p.json.tmp").exists()
    (tmp_path / "bad.json").write_text("{")
    for path in ("bad.json", "absent.json"):
        assert sm.read_partition_state(str(tmp_path / path)) is None
        assert ref_sm.read_partition_state(str(tmp_path / path)) is None


# ---------------------------------------------------------------------------
# ids are minor numbers; NVLink domains
# ---------------------------------------------------------------------------


def test_partition_over_minors_keeps_every_card(tmp_path):
    """On a host whose cards are minors 1, 3, 5 and 7 the subslices name
    those ids, and every composite CDI device keeps both of its cards. The
    reference's positions (0..3) read by the CDI writer would lose cards
    silently: only 1 and 3 are ids there."""
    _, port = _sides(tmp_path, topology="1x4", ids=(1, 3, 5, 7))
    port.set_config("all-1x2")
    assert port.mgr.reconcile_once() == "success"
    assert [s["chips"] for s in port.state()["subslices"]] == [[1, 3], [5, 7]]
    assert port.composites() == {"subslice-0-1x2": ["nvidia1", "nvidia3"],
                                 "subslice-1-1x2": ["nvidia5", "nvidia7"]}
    positions = ref_sm.compute_partitions("1x4", "", "1x2")
    ref_file = tmp_path / "ref-positions.json"
    ref_sm.write_partition_state(positions, str(ref_file))
    lossy = cdi.build_spec(dev_root=str(port.root / "dev"), driver_root=str(tmp_path),
                           partition_file=str(ref_file))
    kept = {d["name"]: len(d["containerEdits"]["deviceNodes"]) for d in lossy["devices"]}
    assert kept["subslice-0-1x2"] == 1 and kept["subslice-1-1x2"] == 1


def _two_domains():
    return [{"index": i, "path": f"/dev/nvidia{i}", "nvlink_domain": 0 if i in (0, 2, 4, 6) else 1}
            for i in range(8)]


@pytest.mark.parametrize(
    "shape,want",
    [("1x4", [[0, 2, 4, 6], [1, 3, 5, 7]]),  # a mesh row is a domain
     ("1x2", [[0, 2], [4, 6], [1, 3], [5, 7]]),
     ("1x1", [[0], [2], [4], [6], [1], [3], [5], [7]]),
     ("2x2", None), ("2x4", None), ("2x1", None)],  # spans both domains
)
def test_subslices_stay_inside_an_nvlink_domain(shape, want):
    chips = _two_domains()
    if want is None:
        with pytest.raises(ValueError, match="spans NVLink domains"):
            sm.compute_partitions("2x4", "h100-sxm", shape, chips)
    else:
        state = sm.compute_partitions("2x4", "h100-sxm", shape, chips)
        assert [s["chips"] for s in state["subslices"]] == want


def test_shape_spanning_domains_fails_the_reconcile(tmp_path, monkeypatch):
    _, port = _sides(tmp_path)
    monkeypatch.setattr(sm.gpuinfo, "chip_summary", lambda dev_root="/dev": _two_domains())
    port.set_config("all-2x2")
    assert port.mgr.reconcile_once() == "failed"
    port.set_config("all-1x2")
    assert port.mgr.reconcile_once() == "success"
    assert [s["chips"] for s in port.state()["subslices"]] == [[0, 2], [4, 6], [1, 3], [5, 7]]


@pytest.mark.parametrize("topology", ["2x4", "1x2"])
def test_topology_that_does_not_count_the_cards_fails(tmp_path, topology):
    """A topology label of 8 (or 2) cards on a host with 4: the positions
    would name cards that are not there (or leave some out)."""
    _, port = _sides(tmp_path, topology=topology, ids=range(4))
    port.set_config("all-1x1")
    assert port.mgr.reconcile_once() == "failed"
    with pytest.raises(ValueError, match="chip table has 4"):
        sm.compute_partitions(topology, "", "1x1", [{"index": i} for i in range(4)])
    assert sm.compute_partitions(topology, "", None, []) == {"partitioned": False, "subslices": []}


# ---------------------------------------------------------------------------
# the label FSM under write races, over the wire (tests/test_sliceman_kubesim.py:92)
# ---------------------------------------------------------------------------


class _HttpInCluster(InClusterClient):
    def _make_conn(self):
        return HTTPConnection(self.host, self.port, timeout=self.timeout_s)


def _churn_until_success(client, mgr, node_name, labels, transient):
    """Another label writer races the manager on the node, with no pause;
    returns the states seen and whether the manager reached success."""
    halt = threading.Event()
    seen = set()

    def churn():
        i = 0
        while not halt.is_set():
            try:
                node = client.get("v1", "Node", node_name)
                state = node["metadata"]["labels"].get(labels.SLICE_CONFIG_STATE_LABEL)
                if state:
                    seen.add(state)
                node["metadata"]["labels"]["churn.test/seq"] = str(i)
                client.update(node)
                i += 1
            except transient:
                pass

    def loop():
        while not halt.is_set():
            try:
                mgr.reconcile_once()
            except transient:
                pass
            time.sleep(0.05)

    threads = [threading.Thread(target=churn, daemon=True), threading.Thread(target=loop, daemon=True)]
    for t in threads:
        t.start()
    try:
        for _ in range(20):
            try:
                node = client.get("v1", "Node", node_name)
                node["metadata"]["labels"][labels.SLICE_CONFIG_LABEL] = "all-2x2"
                client.update(node)
                break
            except transient:
                time.sleep(0.02)
        deadline = time.monotonic() + 30
        done = False
        while time.monotonic() < deadline and not done:
            done = client.get("v1", "Node", node_name)["metadata"]["labels"].get(
                labels.SLICE_CONFIG_STATE_LABEL) == "success"
            time.sleep(0.05)
    finally:
        halt.set()
        for t in threads:
            t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    return seen, done


def test_label_fsm_converges_under_churn_as_the_reference(tmp_path):
    """The port over its own in-cluster client and the reference over its
    RestClient, each against the reference's simulated API server, with a
    second writer forcing real 409s on the node: both reach success, never
    write failed, partition alike and restore their clients."""
    server = KubeSimServer(KubeSim()).start()
    try:
        ref_client = make_client(server.port)
        ref_client.GET_RETRY_BACKOFF_S = 0.05
        port_client = _HttpInCluster(host="127.0.0.1", port=str(server.port), token="kubesim",
                                     insecure=True)
        port_client.GET_BACKOFF_S = 0.05
        ref_client.create(_ref_node(name="ref-node"))
        port_client.create(_port_node(name="port-node"))
        ref, port = _sides(tmp_path)
        ref.mgr.client, ref.mgr.node_name = ref_client, "ref-node"
        port.mgr.client, port.mgr.node_name = port_client, "port-node"
        ref_seen, ref_done = _churn_until_success(
            ref_client, ref.mgr, "ref-node", ref_consts,
            (RefConflictError, RefNotFoundError, RefTransientAPIError, OSError))
        seen, done = _churn_until_success(
            port_client, port.mgr, "port-node", consts,
            (ConflictError, NotFoundError, TransientAPIError, OSError))
        assert ref_done and done
        assert "failed" not in ref_seen and "failed" not in seen, (ref_seen, seen)
        assert port.state()["subslices"] == _mapped_subslices(ref.state())
        assert port.composites() == ref.composites()
        key = consts.DEPLOY_LABEL_PREFIX + CLIENT_LABEL
        assert port_client.get("v1", "Node", "port-node")["metadata"]["labels"][key] == "true"
    finally:
        server.stop()


def test_slice_manager_runs_as_a_program(tmp_path):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "tpu_operator_torch.sliceman", "--node-name", ""],
                         capture_output=True, text=True, timeout=60, env={**os.environ, "NODE_NAME": ""})
    assert out.returncode == 1 and "NODE_NAME required" in out.stderr
