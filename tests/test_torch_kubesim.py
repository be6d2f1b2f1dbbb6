"""The port's API server and REST client (``kube/kubesim.py``,
``kube/rest.py``) against the JAX package's, over real HTTP on loopback.

A cross-wire matrix, {reference, port} ``RestClient`` × {reference, port}
``KubeSim``, runs one request script in each cell: CR admission with a 422,
the status subresource, a 409 on a stale update, ownerRef GC, paging, a
watch with BOOKMARKs and the 410 re-list, eviction under a PDB, a batch
apply, and injected faults (``inject_fault``, ``partition``) with their
retry counts and breaker states. Every cell's log of status codes (or error
class names) and normalised bodies (uids and timestamps, which KubeSim
draws at random and from the clock, replaced) must equal the
reference × reference cell's. The CR is the port's sample and the CRD the
port's in every cell: both servers admit with the same algorithm.

Every server is stopped in a ``finally``, every watch thread joined with a
limit and asserted dead, and every client socket has a timeout of a few
seconds."""

import copy
import os
import random
import threading
import time

import pytest
import yaml

from tpu_operator.kube import kubesim as ref_kubesim
from tpu_operator.kube import retry as ref_retry
from tpu_operator_torch import consts
from tpu_operator_torch.cfg import crdgen, schema_validate
from tpu_operator_torch.kube import kubesim, retry
from tpu_operator_torch.kube.testing import make_gpu_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tpu_operator_torch", "api", "v1", "sample_clusterpolicy.yaml")
CPV = consts.API_VERSION
NS = "default"
WAIT_S = 10  # a limit on every wait, never what decides a result
MODS = {"reference": (ref_kubesim, ref_retry), "port": (kubesim, retry)}
CELLS = [(c, s) for c in MODS for s in MODS]
GROUPS = ["admission", "status", "conflict", "gc", "paging", "watch", "eviction", "apply", "faults"]


def normalise(x):
    if isinstance(x, dict):
        return {k: ("<uid>" if k == "uid" else "<ts>" if k == "creationTimestamp" else normalise(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [normalise(v) for v in x]
    return x


def make_client(client_side, port):
    """One side's RestClient on a loopback server, with test-cadence
    retries (same code paths, sleeps scaled down, seeded jitter)."""
    mod, retry_mod = MODS[client_side]
    c = mod.make_client(port)
    c.retry_policy = retry_mod.RetryPolicy(read_attempts=3, write_attempts=3, backoff_s=0.005, cap_s=0.02,
                                           budget_s=5.0, rng=random.Random(0))
    c.breaker = retry_mod.CircuitBreaker(threshold=3, cooldown_base_s=60.0)
    return c


def script(c, sim, log):
    """The request script; ``log[group]`` collects that group's results."""

    def do(group, fn, *a, **kw):
        try:
            out = ("ok", normalise(fn(*a, **kw)))
        except Exception as e:  # noqa: BLE001 - the class and code are the result
            msg = str(e)
            out = ("err", type(e).__name__, [code for code in ("404", "409", "410", "422", "429", "503")
                                              if code in msg])
        log.setdefault(group, []).append(out)
        return out

    with open(SAMPLE) as f:
        cr = yaml.safe_load(f)
    # admission: defaulting, then validation; a violated enum answers 422
    do("admission", c.create, crdgen.build_crd())
    created = do("admission", c.create, copy.deepcopy(cr))
    want = copy.deepcopy(cr)
    schema_validate.default_cr(crdgen.build_crd(), want)
    log["admission"].append(created[1]["spec"] == want["spec"])
    bad = copy.deepcopy(cr)
    bad["metadata"]["name"] = "bad"
    bad["spec"]["operator"]["defaultRuntime"] = "rkt"
    do("admission", c.create, bad)
    pruned = copy.deepcopy(cr)
    pruned["metadata"]["name"] = "pruned"
    pruned["spec"]["operator"]["useOcpDriverToolkit"] = True
    do("admission", c.create, pruned)

    # the status subresource: a main PUT cannot write status, /status cannot write spec
    got = c.get(CPV, "ClusterPolicy", "cluster-policy")
    got["status"] = {"state": "smuggled"}
    do("status", c.update, got)
    got = c.get(CPV, "ClusterPolicy", "cluster-policy")
    got["status"] = {"state": "ready"}
    got["spec"]["operator"]["runtimeClass"] = "other"
    do("status", c.update_status, got)
    do("status", c.get, CPV, "ClusterPolicy", "cluster-policy")

    # 409 on a stale update; 404 on a missing object
    cm = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm", "namespace": NS},
          "data": {"k": "1"}}
    do("conflict", c.create, cm)
    a = c.get("v1", "ConfigMap", "cm", NS)
    b = c.get("v1", "ConfigMap", "cm", NS)
    a["data"]["k"] = "2"
    do("conflict", c.update, a)
    b["data"]["k"] = "3"
    do("conflict", c.update, b)
    do("conflict", c.create, cm)
    do("conflict", c.get, "v1", "ConfigMap", "nope", NS)
    do("conflict", c.patch_labels, "v1", "ConfigMap", "cm", NS, labels={"x": "1"})

    # ownerRef GC, transitively, and the node's pods
    owner = c.create({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "owner", "namespace": NS}})
    mid = c.create({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {
        "name": "mid", "namespace": NS,
        "ownerReferences": [{"kind": "ConfigMap", "name": "owner", "uid": owner["metadata"]["uid"]}]}})
    do("gc", c.create, {"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": "leaf", "namespace": NS,
        "ownerReferences": [{"kind": "ConfigMap", "name": "mid", "uid": mid["metadata"]["uid"]}]}, "spec": {}})
    do("gc", c.delete, "v1", "ConfigMap", "owner", NS)
    do("gc", lambda: sorted(o["metadata"]["name"] for o in c.list("v1", "ConfigMap", NS)))
    do("gc", c.get, "v1", "Pod", "leaf", NS)

    # paging: limit/continue, every object once, a pinned resourceVersion
    for i in range(7):
        c.create({"apiVersion": "v1", "kind": "Node", "metadata": {
            "name": f"n{i}", "labels": {"parity": str(i % 2)}}})
    page = c._request("GET", "/api/v1/nodes?limit=3")
    log["paging"] = [([o["metadata"]["name"] for o in page["items"]], page["metadata"])]
    do("paging", lambda: [o["metadata"]["name"] for o in c.list("v1", "Node")])
    do("paging", lambda: [o["metadata"]["name"] for o in c.list("v1", "Node", label_selector="parity in (1)")])
    do("paging", lambda: [o["metadata"]["name"] for o in c.list("v1", "Node", label_selector={"parity": "0"})])
    do("paging", c.list, "v1", "Node", label_selector="parity in 1)")

    # a watch from a resourceVersion: replay, BOOKMARKs, then a clean close
    rv0 = c.list_with_rv("v1", "ConfigMap", NS)[1]
    c.create({"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "w1", "namespace": NS}})
    c.delete("v1", "ConfigMap", "w1", NS)
    events, progress = [], []
    stop = threading.Event()
    last = c._watch_stream("v1", "ConfigMap", NS, rv0, lambda e, o: events.append((e, o["metadata"]["name"])),
                           stop, 1, None, progress.append)
    log["watch"] = [events, int(last) >= int(rv0) + 2, len(progress) > len(events)]
    # the 410: history compacted past the resume point answers ERROR, and
    # the watch loop re-lists (a DELETED for what vanished, ADDED for what is)
    sim.compact_now()
    log["watch"].append(c._watch_stream("v1", "ConfigMap", NS, rv0, lambda e, o: None, stop, 1))
    relisted, synced = [], threading.Event()
    t = threading.Thread(target=c.watch, args=("v1", "ConfigMap", lambda e, o: relisted.append(
        (e, o["metadata"]["name"]))), kwargs={"namespace": NS, "stop_event": stop, "timeout_s": 1,
                                              "on_sync": synced.set, "seed_rv": rv0,
                                              "seed_known": {(NS, "cm"), (NS, "vanished")}}, daemon=True)
    t.start()
    assert synced.wait(WAIT_S)
    stop.set()
    t.join(WAIT_S)
    assert not t.is_alive()
    log["watch"].append(sorted(relisted))

    # eviction under a PodDisruptionBudget: 429 blocks, a free pod goes
    for i in range(2):
        c.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": f"p{i}", "namespace": NS,
                                                                 "labels": {"app": "train"}},
                  "spec": {}, "status": {"phase": "Running"}})
    c.create({"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "free", "namespace": NS}, "spec": {}})
    c.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
              "metadata": {"name": "pdb", "namespace": NS},
              "spec": {"minAvailable": 2, "selector": {"matchLabels": {"app": "train"}}}})
    do("eviction", c.evict, "p0", NS)
    do("eviction", c.evict, "free", NS)
    do("eviction", c.evict, "free", NS)
    do("eviction", lambda: sorted(o["metadata"]["name"] for o in c.list("v1", "Pod", NS)))

    # server-side apply, single and batched
    app = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "app", "namespace": NS},
           "data": {"a": "1"}}
    do("apply", c.apply_ssa, app, field_manager="m1")
    do("apply", c.apply_ssa, app, field_manager="m1")
    do("apply", c.apply_ssa, dict(app, data={"a": "2"}), field_manager="m2", force=False)
    batch = [(dict(app, data={"a": "3"}), False), ({"apiVersion": "v1", "kind": "ConfigMap",
                                                    "metadata": {"name": "new", "namespace": NS}}, False),
             (app, True)]
    do("apply", lambda: [(normalise(o), type(e).__name__ if e else None)
                         for o, e in c.apply_ssa_batch(batch, field_manager="m3")])
    log["apply"].append((sim.apply_batches, sim.apply_batch_items))

    # injected faults: retries, 429's Retry-After, the breaker and a partition
    sim.inject_fault("GET", "nodes", code=503, count=2)
    do("faults", lambda: c.get("v1", "Node", "n0")["metadata"]["name"])
    sim.inject_fault("POST", "configmaps", code=429, retry_after=0.01)
    do("faults", lambda: c.create({"apiVersion": "v1", "kind": "ConfigMap",
                                   "metadata": {"name": "f1", "namespace": NS}})["metadata"]["name"])
    sim.inject_fault("PUT", "*", code=500, count=3)
    n0 = c.get("v1", "Node", "n0")
    do("faults", c.update, n0)
    log["faults"].append(c.breaker.stats()["state"])
    do("faults", c.get, "v1", "Node", "n0")  # open breaker: fails fast
    c.breaker.record_success()
    sim.partition(WAIT_S)
    do("faults", c.get, "v1", "Node", "n0")
    log["faults"].append(c.breaker.stats()["state"])
    sim._partition_until = 0.0
    c.breaker.record_success()
    do("faults", lambda: c.get("v1", "Node", "n0")["metadata"]["name"])
    stats = c.retry_policy.stats()
    log["faults"].append((stats, c.breaker.stats()["trips_total"], sim.faults_pending(),
                          sim.faults_injected, sim.partition_rejects))


@pytest.fixture(scope="module")
def matrix():
    logs = {}
    for client_side, server_side in CELLS:
        sim_mod = MODS[server_side][0]
        server = sim_mod.KubeSimServer(sim_mod.KubeSim(bookmark_interval_s=0.05)).start()
        try:
            c = make_client(client_side, server.port)
            log = {}
            script(c, server.sim, log)
            logs[(client_side, server_side)] = log
            c.close_idle_connections()
        finally:
            server.stop()
    return logs


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("cell", CELLS[1:], ids=[f"{c}-client-{s}-server" for c, s in CELLS[1:]])
def test_cross_wire_cell_matches_the_reference(matrix, cell, group):
    assert matrix[cell][group] == matrix[("reference", "reference")][group]


def test_reference_cell_shows_each_behaviour(matrix):
    """The baseline the cells are held to is the behaviour the script is
    about, not an accident."""
    log = matrix[("reference", "reference")]
    assert log["admission"][2] is True
    assert log["admission"][3][:3] == ("err", "RuntimeError", ["422"])
    assert "useOcpDriverToolkit" not in log["admission"][4][1]["spec"]["operator"]
    assert "status" not in log["status"][0][1]
    assert log["status"][2][1]["status"] == {"state": "ready"}
    assert log["status"][2][1]["spec"]["operator"]["runtimeClass"] == "nvidia"
    assert [r[:2] for r in log["conflict"][1:5]] == [("ok", log["conflict"][1][1]), ("err", "ConflictError"),
                                                     ("err", "ConflictError"), ("err", "NotFoundError")]
    assert log["gc"][2][1] == ["cm"] and log["gc"][3][:2] == ("err", "NotFoundError")
    names, meta = log["paging"][0]
    assert names == ["n0", "n1", "n2"] and meta["remainingItemCount"] == 4 and meta["continue"]
    assert log["paging"][1][1] == [f"n{i}" for i in range(7)]
    assert log["paging"][2][1] == ["n1", "n3", "n5"] and log["paging"][4][:2] == ("err", "RuntimeError")
    events, advanced, bookmarked, gone, relisted = log["watch"]
    assert events == [("ADDED", "w1"), ("DELETED", "w1")] and advanced and bookmarked and gone is None
    assert ("DELETED", "vanished") in relisted and ("ADDED", "cm") in relisted
    assert log["eviction"][0][:2] == ("err", "EvictionBlockedError")
    assert log["eviction"][3][1] == ["p0", "p1"]
    assert log["apply"][1][1]["metadata"]["resourceVersion"] == log["apply"][0][1]["metadata"]["resourceVersion"]
    assert log["apply"][2][:2] == ("err", "ApplyConflictError")
    assert [e for _, e in log["apply"][3][1]] == [None, None, "ConflictError"]
    assert log["apply"][4] == (1, 3)
    assert log["faults"][0] == ("ok", "n0") and log["faults"][1] == ("ok", "f1")
    assert log["faults"][2][:2] == ("err", "TransientAPIError") and log["faults"][3] == "open"
    assert log["faults"][4][:2] == ("err", "CircuitOpenError")
    assert log["faults"][5][:3] == ("err", "TransientAPIError", ["503"]) and log["faults"][6] == "open"
    assert log["faults"][7] == ("ok", "n0")
    stats, trips, pending, injected, rejects = log["faults"][8]
    assert stats["retries_by_verb"] == {"GET": 4, "POST": 1, "PUT": 2} and stats["retry_after_honored"] == 1
    assert (trips, pending, injected, rejects) == (2, 0, 6, 3)


def test_port_server_writes_the_card_s_capacity_and_joins_gpu_nodes():
    """``set_node_chips`` and the chip-fault helpers write
    ``nvidia.com/gpu``; ``add_nodes`` joins nodes of ``CARDS_PER_HOST``
    cards with feature discovery's labels; a paged LIST of 1000 nodes
    returns each once, and a label selector finds one."""
    server = kubesim.KubeSimServer().start()
    try:
        c = make_client("port", server.port)
        names = server.sim.add_nodes(999)
        card = make_gpu_node("card", extra_labels={"chip-smoke": "true"})
        c.create(card)
        server.sim.set_node_chips("card", 7, capacity=8)
        st = c.get("v1", "Node", "card")["status"]
        assert st["capacity"][consts.GPU_RESOURCE] == "8" and st["allocatable"][consts.GPU_RESOURCE] == "7"
        server.sim.kill_node_chips(names[0])
        server.sim.flap_node_chips(names[1])
        server.sim.flap_node_chips(names[1])
        st0, st1 = (c.get("v1", "Node", n)["status"] for n in names[:2])
        assert st0["allocatable"][consts.GPU_RESOURCE] == "0" and st0["capacity"][consts.GPU_RESOURCE] == "8"
        assert st1["allocatable"][consts.GPU_RESOURCE] == "8"
        assert c.get("v1", "Node", names[2])["metadata"]["labels"][consts.GPU_COUNT_LABEL] == "8"
        pages = []
        real = c._request

        def counting(method, path, *a, **kw):
            pages.append(path)
            return real(method, path, *a, **kw)

        c._request = counting
        os.environ["REST_LIST_PAGE_SIZE"] = "500"
        try:
            nodes = c.list("v1", "Node")
        finally:
            del os.environ["REST_LIST_PAGE_SIZE"]
        got = [n["metadata"]["name"] for n in nodes]
        assert len(got) == len(set(got)) == 1000 and len(pages) == 2
        assert [n["metadata"]["name"] for n in c.list("v1", "Node", label_selector="chip-smoke")] == ["card"]
    finally:
        server.stop()


def test_rest_client_keeps_every_kind_of_the_reference():
    from tpu_operator.kube import rest as ref_rest
    from tpu_operator_torch.kube import rest

    assert rest.KIND_TABLE == ref_rest.KIND_TABLE
    for kind in rest.KIND_TABLE:
        for av, ns, name in (("v1", "", ""), ("v1", NS, "x"), ("apps/v1", NS, ""), (CPV, "", "cp")):
            assert rest._resource_path(av, kind, ns, name) == ref_rest._resource_path(av, kind, ns, name)
