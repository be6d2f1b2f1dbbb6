"""The port's fleet driver ``tpu_operator_torch/e2e/fleet_converge.py``
held against the reference's ``tests/scripts/fleet_converge.py``.

Each mode runs both drivers at the same small size as subprocesses, the
reference first and the port after it (never at once, so neither loads
the other), and holds three things of their JSON lines:

* the key sets are equal;
* every field that is steady from run to run is equal, tolerance 0
  (``STEADY``; which fields are steady was read off three reference runs
  of each mode at these sizes);
* both lines say ``ok`` and the port's driver exits 0.

Fields that vary from run to run (request and write counts, batch fill,
the render fingerprint, the churn rounds' pass counts, every time) are
not compared. The helpers here (``run_driver``, ``steady_view``,
``flag_table``) serve the shard-replica and alloc-churn files too.
"""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the drivers set by default; the subprocesses get each side's own
DRIVER_ENV = ("OPERATOR_NAMESPACE", "UNIT_TEST", "WRITE_PIPELINE_DEPTH", "WARM_STATE_SAVE_INTERVAL_S", "POD_NAME")
RUN_TIMEOUT_S = 300

MODES = {
    "warm_restart": ["--nodes", "8", "--warm-restart"],
    "lifecycle": ["--nodes", "8", "--join-storm", "4", "--preempt-pct", "25", "--rollout", "--churn-storm", "2"],
    "bulk_pods": ["--nodes", "8", "--pods", "200"],
}
# fields every mode echoes or holds steady
COMMON = (
    "ok", "nodes", "bulk_pods", "join_storm_nodes", "preempt_pct", "applyset_members",
    "render_cache_renders_total", "render_cache_hit_rate", "pod_informer_objects",
    "apiserver_requests_per_reconcile", "write_pipeline_depth", "write_pipeline_errors", "apply_conflicts",
    "batch_items_total",
)
STEADY = {
    "warm_restart": COMMON + (
        "join_time_to_ready_s", "preempt_recover_s", "rollout_time_s", "rollout_stages",
        "warm_loaded", "warm_informer_kinds", "warm_first_pass_writes", "warm_relists", "warm_ok",
    ),
    "lifecycle": COMMON + (
        "rollout_stages", "join_phase_nodes", "churn_ok", "churn_storm_nodes", "churn_events_per_round",
        "churn_rounds_ok",
    ),
    "bulk_pods": COMMON + ("join_time_to_ready_s", "rollout_stages"),
}


def driver_command(side: str, name: str) -> list:
    if side == "reference":
        return [sys.executable, os.path.join(REPO, "tests", "scripts", f"{name}.py")]
    return [sys.executable, "-m", f"tpu_operator_torch.e2e.{name}"]


def run_driver(side: str, name: str, args: list, timeout: float = RUN_TIMEOUT_S):
    """One driver run as a subprocess from the repo root: (exit code, its
    last stdout line as JSON, the completed process)."""
    env = {k: v for k, v in os.environ.items() if k not in DRIVER_ENV}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        driver_command(side, name) + list(args),
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert lines, f"{side} {name} {args}: no JSON line\nstdout:\n{res.stdout}\nstderr:\n{res.stderr[-4000:]}"
    return res.returncode, json.loads(lines[-1]), res


def run_pair(name: str, args: list) -> dict:
    """The reference's run, then the port's, at the same arguments."""
    out = {}
    for side in ("reference", "port"):
        rc, line, res = run_driver(side, name, args)
        out[side] = {"rc": rc, "line": line, "stderr": res.stderr[-4000:]}
    return out


def steady_view(line: dict) -> dict:
    """The line plus the steady facts nested inside varying blocks."""
    view = dict(line)
    phases = line.get("join_phase_latency")
    if phases is not None:
        view["join_phase_nodes"] = {k: v["nodes"] for k, v in phases.items()}
    rounds = (line.get("churn_delta_rounds") or []) + (line.get("churn_baseline_rounds") or [])
    if rounds:
        view["churn_rounds_ok"] = [r["ok"] for r in rounds]
    return view


def assert_steady_equal(pair: dict, fields) -> None:
    ref, port = (steady_view(pair[s]["line"]) for s in ("reference", "port"))
    diff = {f: (ref.get(f, "<absent>"), port.get(f, "<absent>")) for f in fields if ref.get(f) != port.get(f)}
    assert not diff, f"steady fields differ (reference, port): {diff}"


def flag_table(path: str) -> list:
    """Every ``add_argument`` call of a driver's source: its flag and its
    ``type``, ``default``, ``action`` and ``required``, as source text."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords if k.arg in ("type", "default", "action", "required")}
            out.append((ast.literal_eval(node.args[0]), kw))
    return sorted(out, key=lambda x: x[0])


def assert_same_flags(name: str) -> None:
    ref = flag_table(os.path.join(REPO, "tests", "scripts", f"{name}.py"))
    port = flag_table(os.path.join(REPO, "tpu_operator_torch", "e2e", f"{name}.py"))
    assert len(ref) >= 8
    assert port == ref


@pytest.fixture(scope="module")
def pair_for():
    """Each mode's pair, run once for the module on first use."""
    pairs = {}

    def get(mode: str) -> dict:
        if mode not in pairs:
            pairs[mode] = run_pair("fleet_converge", MODES[mode])
        return pairs[mode]

    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_key_sets_equal(pair_for, mode):
    pair = pair_for(mode)
    ref, port = pair["reference"]["line"], pair["port"]["line"]
    assert set(port) == set(ref), (sorted(set(ref) - set(port)), sorted(set(port) - set(ref)))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_steady_fields_equal(pair_for, mode):
    assert_steady_equal(pair_for(mode), STEADY[mode])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_both_drivers_pass(pair_for, mode):
    pair = pair_for(mode)
    for side in ("reference", "port"):
        got = pair[side]
        assert got["rc"] == 0 and got["line"]["ok"] is True, f"{side}: {got['line']}\n{got['stderr']}"


def test_warm_restart_is_zero_write_and_zero_list_on_the_port(pair_for):
    line = pair_for("warm_restart")["port"]["line"]
    assert line["warm_loaded"] is True and line["warm_ok"] is True
    assert line["warm_first_pass_writes"] == 0 and line["warm_relists"] == 0
    assert line["warm_informer_kinds"] > 0
    assert line["apiserver_requests_per_reconcile"] <= 2


def test_lifecycle_axes_all_ran_on_the_port(pair_for):
    line = pair_for("lifecycle")["port"]["line"]
    assert line["join_phase_latency"]["slice_ready"]["nodes"] == 4
    assert line["join_time_to_ready_s"] is not None and line["preempt_recover_s"] is not None
    assert line["rollout_time_s"] is not None and line["rollout_stages"] == 3
    assert line["churn_ok"] is True and line["churn_storm_nodes"] == 2


def test_bulk_pods_stay_out_of_the_pod_informer(pair_for):
    pair = pair_for("bulk_pods")
    plain = pair_for("warm_restart")
    for side in ("reference", "port"):
        assert pair[side]["line"]["bulk_pods"] == 200
        # the scoped informer mirrors operand and GPU pods only
        assert pair[side]["line"]["pod_informer_objects"] == plain[side]["line"]["pod_informer_objects"]


def test_flags_are_the_reference_flags():
    assert_same_flags("fleet_converge")


def _imports(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_port_package_imports_neither_jax_nor_the_reference():
    pkg = os.path.join(REPO, "tpu_operator_torch")
    bad = {}
    for root, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                hits = {
                    m for m in _imports(path)
                    if m.split(".")[0] in ("jax", "jaxlib", "tpu_operator")
                }
                if hits:
                    bad[os.path.relpath(path, REPO)] = sorted(hits)
    assert not bad, bad
    # and at run time: the three drivers' modules pull in neither
    code = (
        "import sys\n"
        "import tpu_operator_torch.e2e.fleet_converge, tpu_operator_torch.e2e.shard_replica, "
        "tpu_operator_torch.e2e.alloc_churn, tpu_operator_torch.main, tpu_operator_torch.schedsim.engine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_operator'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name", ["fleet_converge", "shard_replica", "alloc_churn"])
def test_driver_does_not_insert_the_repo_into_sys_path(name):
    with open(os.path.join(REPO, "tpu_operator_torch", "e2e", f"{name}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    inserts = [
        ast.unparse(n) for n in ast.walk(tree)
        if isinstance(n, ast.Call) and ast.unparse(n.func) in ("sys.path.insert", "sys.path.append")
    ]
    assert inserts == []


# the reference's --rollout base: its TPU nodes carry no version label
REFERENCE_ROLLOUT_BASE = "1.0.0"
CONVERGE_WAIT_S = 90


def _first_pass_roll(side: str, base: str):
    """Each side's operator over its KubeSim of 4 nodes with ``--rollout``'s
    ClusterPolicy at ``base``: the rollout record once the CR is READY
    (or once a roll was staged) and the number of rolls started."""
    import threading

    if side == "reference":
        from tpu_operator.controllers.rollout import load_record
        from tpu_operator.kube import kubesim, testing
        from tpu_operator.main import CP_KEY, build_manager, wire_event_sources
        key = "libtpu"
    else:
        from tpu_operator_torch.controllers.rollout import load_record
        from tpu_operator_torch.kube import kubesim, testing
        from tpu_operator_torch.main import CP_KEY, build_manager, wire_event_sources
        key = "driver"

    def stage(cp):
        cp["spec"][key]["version"] = base
        cp["spec"][key]["upgradePolicy"] = {"autoUpgrade": True, "maxParallelUpgrades": 256, "maxUnavailable": "25%"}
        cp["spec"]["rollout"] = {"enabled": True, "canary": 1, "waves": ["10%"], "observeSeconds": 1}

    nodes = [f"fleet-{i}" for i in range(4)]
    server = kubesim.KubeSimServer(kubesim.KubeSim(compact_keep=16384)).start()
    halt, stop = threading.Event(), threading.Event()
    mgr = None
    try:
        client = kubesim.make_client(server.port)
        testing.seed_cluster(client, "tpu-operator", node_names=())
        server.sim.add_nodes(len(nodes), names=nodes)
        testing.edit_clusterpolicy(client, stage)
        mgr, rec, _ = build_manager(client, "tpu-operator", metrics_port=0, probe_port=0)
        wire_event_sources(mgr, client, "tpu-operator", stop_event=stop)
        mgr.start()

        def kubelet():
            while not halt.is_set():
                try:
                    testing.simulate_kubelet_nodes(client, "tpu-operator", nodes, halt_event=halt)
                except Exception:
                    pass  # races with the operator; the next sweep retries
                halt.wait(0.1)

        threading.Thread(target=kubelet, daemon=True).start()
        mgr.enqueue(CP_KEY)
        record = None
        deadline = time.monotonic() + CONVERGE_WAIT_S
        while time.monotonic() < deadline:
            cp = client.get_or_none("tpu.k8s.io/v1", "ClusterPolicy", "cluster-policy") or {}
            record = load_record(cp)
            if record or cp.get("status", {}).get("state") == "ready":
                break
            time.sleep(0.1)
        return record, rec.rollout.stats()["rollouts_started_total"]
    finally:
        halt.set()
        stop.set()
        if mgr is not None:
            mgr.stop()
        server.stop()


def test_rollout_base_stages_no_roll_in_the_first_pass(monkeypatch):
    """``--rollout`` converges at its base with no roll on both sides:
    the reference at 1.0.0 over nodes with no version label, the port at
    ``ROLLOUT_BASE_VERSION`` over nodes that report that driver. The
    reference's base on the port would stage a fleet-wide roll in the
    first pass (its canary can be rolled back before its validator
    runs), which is why the port pins its own."""
    from tpu_operator_torch.e2e import fleet_converge
    from tpu_operator_torch.kube import testing

    monkeypatch.setenv("OPERATOR_NAMESPACE", "tpu-operator")
    monkeypatch.setenv("UNIT_TEST", "true")
    monkeypatch.setenv("WRITE_PIPELINE_DEPTH", "4")
    assert fleet_converge.ROLLOUT_BASE_VERSION == testing.DEFAULT_DRIVER_VERSION
    for side, base in (("reference", REFERENCE_ROLLOUT_BASE), ("port", fleet_converge.ROLLOUT_BASE_VERSION)):
        assert _first_pass_roll(side, base) == (None, 0), side
    record, started = _first_pass_roll("port", REFERENCE_ROLLOUT_BASE)
    assert started == 1 and record["previous"] == testing.DEFAULT_DRIVER_VERSION
    assert record["target"] == REFERENCE_ROLLOUT_BASE


def test_rollout_spec_is_the_reference_spec_at_the_port_base():
    from tpu_operator_torch.e2e import fleet_converge

    cp = {"spec": {"driver": {}}}
    fleet_converge.stage_rollout_spec(cp)
    assert cp["spec"]["driver"] == {
        "version": fleet_converge.ROLLOUT_BASE_VERSION,
        "upgradePolicy": {"autoUpgrade": True, "maxParallelUpgrades": 256, "maxUnavailable": "25%"},
    }
    assert cp["spec"]["rollout"] == {"enabled": True, "canary": 1, "waves": ["10%"], "observeSeconds": 1}
