"""The port's workload pods against the reference's
(``validator/workload_pods.py``): names bit for bit, pod specs with the
card's resource and the process group's env, the gang's verdicts and
straggler text over the same fake API server, and the three pod scripts,
which need CUDA."""

import os
import re
import subprocess
import sys
import threading
import time

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.kube import FakeClient
from tpu_operator.validator import workload_pods as ref
from tpu_operator_torch import consts
from tpu_operator_torch.validator import workload_pods as wp

NS = "tpu-operator"
LONG = "gke-gpu-cluster-np-h100-64-very-long-pool-name-abcdef012345-node-7"


@pytest.mark.parametrize("base", ["tpu-cuda-validator", "tpu-plugin-validator", "tpu-slice-gang"])
@pytest.mark.parametrize("node", ["host-0", "Host_1.example", LONG, LONG + "x", "---", "s-7"])
def test_per_node_name_bit_for_bit(base, node):
    name = wp._per_node_name(base, node)
    assert name == ref._per_node_name(base, node)
    assert len(name) <= 63 and re.fullmatch(r"[a-z0-9]([a-z0-9-]*[a-z0-9])?", name), name


def test_workload_pods_are_per_node_with_one_card():
    names = set()
    for node in ("host-0", "host-1", LONG, LONG + "x"):
        for factory in (wp.cuda_workload_pod, wp.plugin_workload_pod):
            pod = factory(node, NS)
            assert pod["metadata"]["name"] not in names
            names.add(pod["metadata"]["name"])
            assert pod["metadata"]["labels"]["app"] == pod["metadata"]["name"]
            ctr = pod["spec"]["containers"][0]
            assert ctr["resources"]["limits"] == {consts.GPU_RESOURCE: "1"}
            assert pod["spec"]["tolerations"][0]["key"] == consts.GPU_RESOURCE
    ref_pod, pod = ref.plugin_workload_pod("host-0", NS), wp.plugin_workload_pod("host-0", NS)
    assert set(pod["spec"]) == set(ref_pod["spec"]) and set(pod["metadata"]) == set(ref_pod["metadata"])


def test_workload_image_from_the_environment(monkeypatch):
    assert wp.cuda_workload_pod("n", NS)["spec"]["containers"][0]["image"] == (
        consts.DEFAULT_CUDA_WORKLOAD_IMAGE
    )
    monkeypatch.setenv("CUDA_WORKLOAD_IMAGE", "registry.local/cuda:1")
    monkeypatch.setenv("CUDA_WORKLOAD_PULL_SECRETS", "a,b")
    pod = wp.plugin_workload_pod("n", NS)
    assert pod["spec"]["containers"][0]["image"] == "registry.local/cuda:1"
    assert pod["spec"]["imagePullSecrets"] == [{"name": "a"}, {"name": "b"}]


def _env(pod):
    return {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}


@pytest.mark.parametrize("ordinal,hosts", [(0, 1), (1, 4), (3, 4)])
def test_gang_pod_matches_the_reference(ordinal, hosts):
    """The same pod, gate and names; the three JAX_* variables become the
    process group's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK."""
    rpod = ref.slice_gang_pod("s-1", "h-1", NS, ordinal, hosts, chips="8")
    pod = wp.slice_gang_pod("s-1", "h-1", NS, ordinal, hosts, chips="8")
    assert pod["metadata"]["name"] == rpod["metadata"]["name"]
    assert pod["spec"]["nodeSelector"] == rpod["spec"]["nodeSelector"]
    assert pod["spec"]["nodeSelector"][consts.SLICE_READY_LABEL] == "true"
    assert (pod["spec"]["hostname"], pod["spec"]["subdomain"]) == (
        rpod["spec"]["hostname"], rpod["spec"]["subdomain"])
    assert pod["spec"]["containers"][0]["resources"]["limits"] == {consts.GPU_RESOURCE: "8"}
    renv, env = _env(rpod), _env(pod)
    jax = {"JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"}
    assert set(env) == set(renv) - jax | {"MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"}
    for k in ("TPU_WORKER_ID", "TPU_SLICE_HOSTS", "TPU_WORKER_HOSTNAMES"):
        assert env[k] == renv[k]
    assert (env["RANK"], env["WORLD_SIZE"]) == (renv["JAX_PROCESS_ID"], renv["JAX_NUM_PROCESSES"])
    assert env["MASTER_ADDR"] == renv["JAX_COORDINATOR_ADDRESS"].rsplit(":", 1)[0]
    assert env["MASTER_PORT"] == str(wp.GANG_PORT)
    extra = wp.slice_gang_pod("s-1", "h-1", NS, ordinal, hosts, extra_env={"MASTER_ADDR": "10.0.0.1"})
    assert _env(extra)["MASTER_ADDR"] == "10.0.0.1"


def test_gang_script_reads_only_what_the_pod_injects():
    read = set(re.findall(r"os\.environ(?:\.get)?[\[(]'([A-Z_]+)'", wp.SLICE_GANG_SCRIPT))
    if "env://" in wp.SLICE_GANG_SCRIPT:  # init_process_group's env:// reads these
        read |= {"MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"}
    assert read and read <= set(_env(wp.slice_gang_pod("s", "n", NS, 0, 2)))


@pytest.mark.parametrize(
    "script", ["CUDA_MATMUL_SCRIPT", "PLUGIN_SMOKE_SCRIPT", "SLICE_GANG_SCRIPT"]
)
def test_pod_scripts_need_cuda(script):
    env = {**os.environ, **_env(wp.slice_gang_pod("s", "n", NS, 0, 1)), "MASTER_ADDR": "127.0.0.1"}
    proc = subprocess.run([sys.executable, "-c", getattr(wp, script)], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "expected CUDA" in proc.stderr, proc.stderr[-2000:]


def _client(resource, extra=()):
    return FakeClient([
        {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}},
        {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "g-1", "labels": {}},
         "status": {"capacity": {resource: "4"}}},
        *extra,
    ])


def _validator_ds(name, generation=None):
    """The validator DaemonSet under one side's name: the reference's
    ``tpu-operator-validator``, the port's ``consts.VALIDATOR_APP``."""
    meta = {"name": name, "namespace": NS}
    if generation is not None:
        meta["generation"] = generation
    return {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": meta,
            "spec": {"selector": {"matchLabels": {"app": name}}}}


def _kubelet(client, phases, schedule=True):
    def run():
        deadline = time.monotonic() + 5
        done = set()
        while time.monotonic() < deadline and len(done) < len(phases):
            for pod in client.list("v1", "Pod", NS):
                name = pod["metadata"]["name"]
                if name.startswith("tpu-slice-gang") and name not in done:
                    if schedule:
                        pod["spec"]["nodeName"] = pod["spec"]["nodeSelector"]["kubernetes.io/hostname"]
                    pod["status"] = {"phase": phases[int(name.rsplit("-", 1)[1])]}
                    client.update_status(pod)
                    done.add(name)
            time.sleep(0.01)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _gang(mod, resource, members, spawn, phases, schedule=True, extra=()):
    client = _client(resource, extra)
    t = _kubelet(client, phases, schedule) if phases else None
    try:
        out = ("ok", mod.run_slice_gang(client, NS, "s-1", members, spawn=spawn,
                                        retries=60 if phases else 3, sleep_s=0.02))
    except RuntimeError as e:
        out = ("error", str(e))
    if t is not None:
        t.join(timeout=10)
    return out, client


@pytest.mark.parametrize(
    "spawn,phases,schedule",
    [
        (True, ["Succeeded"], True),  # leader, gang of one
        (True, ["Succeeded", "Succeeded", "Succeeded"], True),  # leader, three hosts
        (True, ["Succeeded", "Failed"], True),  # a failed member
        (True, ["Pending", "Succeeded"], False),  # a member the gate refuses
        (False, [], True),  # follower before the leader spawned
    ],
)
def test_run_slice_gang_matches_the_reference(spawn, phases, schedule):
    members = [(f"h-{i}", "4") for i in range(max(1, len(phases)))]
    r, _ = _gang(ref, ref_consts.TPU_RESOURCE, members, spawn, phases, schedule)
    p, client = _gang(wp, consts.GPU_RESOURCE, members, spawn, phases, schedule)
    assert p == r, (p, r)
    if spawn:
        svc = client.get("v1", "Service", wp.gang_name("s-1"), NS)
        assert svc["spec"]["ports"] == [{"name": "coordinator", "port": wp.GANG_PORT}]


def test_stale_epoch_follower_matches_the_reference():
    """After the validator DaemonSet re-rolls, a follower that sees only
    the previous epoch's Succeeded gang fails naming it stale, as in the
    reference (``tests/test_validator.py:491-555``)."""
    outs = []
    for mod, resource, ds_name in ((ref, ref_consts.TPU_RESOURCE, "tpu-operator-validator"),
                                   (wp, consts.GPU_RESOURCE, consts.VALIDATOR_APP)):
        client = _client(resource, [_validator_ds(ds_name)])
        epoch = mod.gang_epoch(client, NS)
        client.delete("apps/v1", "DaemonSet", ds_name, NS)
        client.create(_validator_ds(ds_name, generation=2))
        assert mod.gang_epoch(client, NS) not in ("", epoch)
        stale = mod.slice_gang_pod("g-1", "g-1", NS, 0, 1, chips="4")
        stale["metadata"]["labels"][mod.GANG_EPOCH_LABEL] = epoch
        stale["status"] = {"phase": "Succeeded"}
        client.create(stale)
        with pytest.raises(RuntimeError) as exc:
            mod.run_slice_gang(client, NS, "g-1", [("g-1", "4")], spawn=False, retries=3, sleep_s=0.01)
        outs.append(str(exc.value))
    assert outs[0] == outs[1]
    assert "StaleEpoch" in outs[1] and "previous-epoch" in outs[1]


def test_gang_pods_are_owned_by_the_validator_daemonset():
    client = _client(consts.GPU_RESOURCE, [_validator_ds(consts.VALIDATOR_APP)])
    _kubelet(client, ["Succeeded"])
    wp.run_slice_gang(client, NS, "s-1", [("g-1", "4")], retries=60, sleep_s=0.02)
    pod = client.get("v1", "Pod", f"{wp.gang_name('s-1')}-0", NS)
    assert pod["metadata"]["ownerReferences"][0]["name"] == consts.VALIDATOR_APP == "gpu-operator-validator"
    assert pod["metadata"]["labels"][wp.GANG_EPOCH_LABEL] == wp.gang_epoch(client, NS)


@pytest.mark.parametrize("phase,ok", [("Succeeded", True), ("Failed", False), ("", False)])
def test_run_to_completion_matches_the_reference(phase, ok):
    outs = []
    for mod, factory, resource in ((ref, ref.plugin_workload_pod, ref_consts.TPU_RESOURCE),
                                   (wp, wp.plugin_workload_pod, consts.GPU_RESOURCE)):
        client = _client(resource)

        def watcher(event, obj, client=client):
            if event == "ADDED" and obj["kind"] == "Pod" and phase:
                def finish():
                    pod = client.get("v1", "Pod", obj["metadata"]["name"], NS)
                    pod["status"] = {"phase": phase}
                    client.update_status(pod)

                threading.Timer(0.02, finish).start()

        client.add_watcher(watcher)
        pod = factory("g-1", NS)
        try:
            outs.append(("ok", mod.run_to_completion(client, pod, retries=30, sleep_s=0.01)))
        except RuntimeError as e:
            outs.append(("error", str(e).replace(pod["metadata"]["name"], "POD")))
    assert outs[0] == outs[1]
    assert (outs[1][0] == "ok") is ok
