"""The port's slice aggregation (``controllers/slice_status.py``) against the
JAX package's, on the cases of ``tests/test_slice_status.py`` that need no
reconciler.

Each case runs one script on both sides over paired nodes: a reference TPU
node with the slice labels (node pool, slice-hosts, worker id) is an H100
node with the same labels; a validator pod carries each side's validator
app (``tpu-operator-validator``, ``consts.VALIDATOR_APP``). Summaries,
verdict labels and Event messages must be equal, the messages after
``google.com/tpu`` reads ``nvidia.com/gpu``. Tolerance: exact equality.

A GPU node carries no TPU topology labels, so the reference's
topology-derived host count has no counterpart: without the slice-hosts
label a node is a single-host slice (``test_no_slice_hosts_label_means_single_host``).
"""

from types import SimpleNamespace

import pytest

from tests.conftest import make_tpu_node
from tpu_operator import consts as ref_consts
from tpu_operator.controllers import slice_status as ref_ss
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import apply as ref_apply
from tpu_operator.kube.write_pipeline import BatchLane as RefBatchLane, WritePipeline as RefWritePipeline
from tpu_operator_torch import consts
from tpu_operator_torch.controllers import slice_status as ss
from tpu_operator_torch.kube import apply
from tpu_operator_torch.kube.client import FakeClient
from tpu_operator_torch.kube.testing import make_gpu_node
from tpu_operator_torch.kube.write_pipeline import BatchLane, WritePipeline

NS = "tpu-operator"
SIDES = {
    "reference": SimpleNamespace(ss=ref_ss, consts=ref_consts, FakeClient=RefFakeClient, apply=ref_apply,
                                 BatchLane=RefBatchLane, WritePipeline=RefWritePipeline,
                                 resource=ref_consts.TPU_RESOURCE, mig=ref_consts.TPU_SUBSLICE_RESOURCE_PREFIX,
                                 node=lambda name, **kw: make_tpu_node(name, accelerator="tpu-v5p-slice",
                                                                       topology="4x4x4", **kw)),
    "port": SimpleNamespace(ss=ss, consts=consts, FakeClient=FakeClient, apply=apply, BatchLane=BatchLane,
                            WritePipeline=WritePipeline, resource=consts.GPU_RESOURCE,
                            mig=consts.MIG_RESOURCE_PREFIX, node=make_gpu_node),
}


def both(script, *args):
    out = [script(SIDES[name], *args) for name in ("reference", "port")]
    return out[0], out[1]


def single(side, name):
    """A single-host node (the slice-hosts label says 1)."""
    return side.node(name, extra_labels={consts.TFD_SLICE_HOSTS_LABEL: "1"})


def multihost(side, name, pool="pool-a", hosts=4, worker=0):
    return side.node(name, extra_labels={consts.GKE_NODEPOOL_LABEL: pool, consts.TFD_SLICE_HOSTS_LABEL: str(hosts),
                                         consts.TFD_WORKER_ID_LABEL: str(worker)})


def validator_pod(side, client, node, ready=True):
    client.create({"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": f"val-{node}", "namespace": NS, "labels": {"app": side.ss.VALIDATOR_APP}},
                   "spec": {"nodeName": node},
                   "status": {"phase": "Running" if ready else "Pending", "containerStatuses": [{"ready": ready}]}})


def verdicts(client, names):
    return [client.get("v1", "Node", n)["metadata"]["labels"].get(consts.SLICE_READY_LABEL) for n in names]


def summary_of(summary):
    return (summary.total, summary.ready, summary.degraded,
            {k: (sorted(v.member_nodes), v.expected_hosts, v.ready_nodes, v.unhealthy_hosts, v.maintenance_hosts,
                 v.quarantined_hosts, v.repartitioning_hosts) for k, v in summary.slices.items()})


def test_validator_app_is_the_port_name():
    assert ss.VALIDATOR_APP == consts.VALIDATOR_APP == "gpu-operator-validator"
    assert ref_ss.VALIDATOR_APP == "tpu-operator-validator"


def test_single_host_nodes_are_own_slices():
    ref, port = both(lambda side: sorted(side.ss.group_slices([single(side, "n1"), single(side, "n2")])))
    assert ref == port == ["n1", "n2"]


def test_multihost_nodes_group_by_pool():
    def script(side):
        slices = side.ss.group_slices([multihost(side, f"n{i}", worker=i) for i in range(4)])
        return {k: (sorted(v.member_nodes), v.expected_hosts) for k, v in slices.items()}

    ref, port = both(script)
    assert ref == port == {"pool-a": (["n0", "n1", "n2", "n3"], 4)}


def test_explicit_slice_id_label_wins():
    def script(side):
        n = multihost(side, "n1")
        n["metadata"]["labels"][consts.TFD_SLICE_ID_LABEL] = "slice-7"
        return side.ss.slice_id_for_node(n)

    assert both(script) == ("slice-7", "slice-7")


def test_no_slice_hosts_label_means_single_host():
    """Decision of the port: without the slice-hosts label the node is a
    single-host slice of its own, even in a node pool (the reference reads
    16 hosts off a v5p 4x4x4 topology label here)."""
    n = make_gpu_node("n1", extra_labels={consts.GKE_NODEPOOL_LABEL: "pool-b"})
    del n["metadata"]["labels"][consts.TFD_SLICE_HOSTS_LABEL]
    assert ss._expected_hosts(n) == 0
    assert ss.slice_id_for_node(n) == "n1"
    slices = ss.group_slices([n])
    assert list(slices) == ["n1"] and slices["n1"].expected_hosts == 0
    ref = make_tpu_node("n1", accelerator="tpu-v5p-slice", topology="4x4x4",
                        extra_labels={ref_consts.GKE_NODEPOOL_LABEL: "pool-b"})
    assert (ref_ss._expected_hosts(ref), ref_ss.slice_id_for_node(ref)) == (16, "pool-b")


@pytest.mark.parametrize("path", ["inline", "pipeline", "lane"])
def test_slice_ready_only_when_all_hosts_validated(path):
    """A never-labelled node stays unlabelled while not ready; the last
    host validating flips every member true; a real true -> false flip
    writes false. Inline, through a write pipeline and through a batch
    lane alike."""

    def script(side):
        client = side.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}])
        pipe = side.WritePipeline(depth=4, name="ss-test") if path != "inline" else None
        lane = side.BatchLane(pipe, lambda payloads: side.apply.batch_flush(
            client, payloads, force=False, prune=False, update_only=True), name="ss-labels") if path == "lane" else None
        kw = {"pipeline": pipe} if path == "pipeline" else {"lane": lane} if path == "lane" else {}
        nodes = [multihost(side, f"n{i}", worker=i) for i in range(4)]
        names = [n["metadata"]["name"] for n in nodes]
        for n in nodes:
            client.create(n)
        for i in range(3):
            validator_pod(side, client, f"n{i}")
        validator_pod(side, client, "n3", ready=False)
        out = [summary_of(side.ss.aggregate(client, NS, nodes, **kw)), verdicts(client, names)]
        client.delete("v1", "Pod", "val-n3", NS)
        validator_pod(side, client, "n3")
        out += [summary_of(side.ss.aggregate(client, NS, nodes, **kw)), verdicts(client, names)]
        fresh = [client.get("v1", "Node", n) for n in names]
        client.delete("v1", "Pod", "val-n3", NS)
        validator_pod(side, client, "n3", ready=False)
        out += [summary_of(side.ss.aggregate(client, NS, fresh, **kw)), verdicts(client, names)]
        out.append(sorted(e["message"] for e in client.list("v1", "Event", NS)))
        return out

    ref, port = both(script)
    assert ref == port
    assert port[1] == [None] * 4 and port[3] == ["true"] * 4 and port[5] == ["false"] * 4
    assert port[6] == ["slice pool-a is no longer ready: 3 of 4 member hosts validated"]


def test_missing_member_hosts_keep_slice_not_ready():
    def script(side):
        client = side.FakeClient()
        nodes = [multihost(side, f"n{i}", worker=i) for i in range(3)]
        for n in nodes:
            client.create(n)
            validator_pod(side, client, n["metadata"]["name"])
        s = side.ss.aggregate(client, NS, nodes)
        return s.total, s.ready

    assert both(script) == ((1, 0), (1, 0))


def test_mixed_single_and_multi_host():
    def script(side):
        client = side.FakeClient()
        nodes = [multihost(side, f"m{i}", hosts=2, worker=i) for i in range(2)] + [single(side, "solo")]
        for n in nodes:
            client.create(n)
            validator_pod(side, client, n["metadata"]["name"])
        return summary_of(side.ss.aggregate(client, NS, nodes))

    ref, port = both(script)
    assert ref == port and port[:2] == (2, 2)


def test_partitioned_host_counts_as_healthy():
    """A partition zeroes the plain resource while its cards live on as MIG
    resources: healthy. Every advertised resource at zero: unhealthy. None
    advertised: unknown."""

    def script(side):
        def node(cap, alloc):
            return {"status": {"capacity": cap, "allocatable": alloc}}

        r, m = side.resource, side.mig + "1x2"
        return [side.ss.host_allocatable_ok(node({r: "8", m: "4"}, {r: "0", m: "4"})),
                side.ss.host_allocatable_ok(node({r: "8", m: "4"}, {r: "0", m: "0"})),
                side.ss.host_allocatable_ok(node({}, {})),
                side.ss.host_allocatable_ok(node({r: "8"}, {r: "8"})),
                side.ss.host_allocatable_ok(node({"cpu": "8"}, {"cpu": "8"}))]

    assert both(script) == ([True, False, None, True, None],) * 2


@pytest.mark.parametrize("reason", ["maintenance", "quarantined", "repartitioning", "unhealthy"])
def test_degraded_member_flips_slice_not_ready(reason):
    """A member inside a maintenance window, held by remediation, mid
    re-partition or advertising no allocatable card takes its slice down
    ahead of its validator; the Event names it, and the slice comes back
    when the reason clears."""

    def script(side):
        client = side.FakeClient([{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}])
        nodes = [multihost(side, f"n{i}", worker=i) for i in range(4)]
        for n in nodes:
            client.create(n)
            validator_pod(side, client, n["metadata"]["name"])
        out = [summary_of(side.ss.aggregate(client, NS, nodes))]
        node = client.get("v1", "Node", "n2")
        labels = node["metadata"]["labels"]
        if reason == "maintenance":
            labels[side.consts.MAINTENANCE_STATE_LABEL] = "pending"
        elif reason == "quarantined":
            labels[side.consts.REMEDIATION_STATE_LABEL] = side.consts.REMEDIATION_STATE_QUARANTINED
        elif reason == "repartitioning":
            labels[side.consts.REPARTITION_STATE_LABEL] = side.consts.REPARTITION_STATE_ROLLING
        client.update(node)
        if reason == "unhealthy":
            node = client.get("v1", "Node", "n2")
            node["status"] = {"capacity": {side.resource: "8"}, "allocatable": {side.resource: "0"}}
            client.update_status(node)
        nodes = [client.get("v1", "Node", f"n{i}") for i in range(4)]
        out.append(summary_of(side.ss.aggregate(client, NS, nodes)))
        out.append([e["message"].replace(side.resource, consts.GPU_RESOURCE)
                    for e in client.list("v1", "Event", NS) if e.get("reason") == "SliceDegraded"])
        return out

    ref, port = both(script)
    assert ref == port
    assert port[0][1] == 1 and port[1][1] == 0 and port[1][2] == ["pool-a"]
    assert len(port[2]) == 1 and "n2" in port[2][0]


def test_validated_on_nodes_and_slice_members():
    def script(side):
        client = side.FakeClient()
        nodes = [multihost(side, f"n{i}", worker=i) for i in range(3)] + [single(side, "solo")]
        for n in nodes:
            client.create(n)
        validator_pod(side, client, "n0")
        validator_pod(side, client, "n1", ready=False)
        sid, members = side.ss.slice_members(client, nodes[0])
        return (sorted(side.ss.validated_on_nodes(client, NS, ["n0", "n1", "n2"])),
                sorted(side.ss.validator_ready_nodes(client, NS)), sid,
                sorted(m["metadata"]["name"] for m in members))

    ref, port = both(script)
    assert ref == port == (["n0"], ["n0"], "pool-a", ["n0", "n1", "n2"])


def test_verdict_conflict_is_reclaimed():
    """A foreign field manager holding the verdict key makes the lane's
    non-forced apply conflict; the aggregation takes it back, forced."""

    def script(side):
        client = side.FakeClient()
        node = single(side, "solo")
        client.create(node)
        validator_pod(side, client, "solo")
        client.apply_ssa({"apiVersion": "v1", "kind": "Node",
                          "metadata": {"name": "solo", "labels": {consts.SLICE_READY_LABEL: "false"}}},
                         field_manager="someone-else", force=True, prune=False)
        pipe = side.WritePipeline(depth=2, name="ss-reclaim")
        lane = side.BatchLane(pipe, lambda payloads: side.apply.batch_flush(
            client, payloads, force=False, prune=False, update_only=True), name="ss-reclaim")
        s = side.ss.aggregate(client, NS, [client.get("v1", "Node", "solo")], lane=lane)
        return s.ready, verdicts(client, ["solo"])

    assert both(script) == ((1, ["true"]), (1, ["true"]))
