"""The port's sharded replica ``tpu_operator_torch/e2e/shard_replica.py``
held against the reference's ``tests/scripts/shard_replica.py``.

* One replica alone, on each side against that side's KubeSim: the line
  it prints, the ``/debug/vars`` shards block it serves (it owns every
  shard and the full pass), and a clean exit on SIGTERM.
* ``fleet_converge --replicas 2 --kill-leader`` at 8 nodes on both
  sides (reference first, then the port): equal key sets and equal
  steady fields, the journal-seeded failover with no re-list and no
  write among them.
* The port's driver starts each replica by module path, and a replica
  that dies fails the run with its stderr tail in the line, with every
  other replica stopped.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from tests.test_torch_fleet_converge import (
    DRIVER_ENV,
    REPO,
    assert_same_flags,
    assert_steady_equal,
    driver_command,
    run_pair,
)

REPLICATED = ["--nodes", "8", "--replicas", "2", "--kill-leader"]
STEADY = ("ok", "nodes", "replicas", "shards", "owned_counts", "failover_steady")
WAIT_S = 60


def failover_view(line: dict) -> dict:
    """The steady facts of a replicated line: how many shards each live
    replica owns and the failover block's verdicts."""
    fo = line.get("failover") or {}
    return {
        **line,
        "owned_counts": sorted(len(v) for v in (line.get("owners") or {}).values()),
        "failover_steady": {
            "journal_seeded": fo.get("journal_seeded"),
            "relists": fo.get("relists"),
            "writes_during_failover": fo.get("writes_during_failover"),
            "killed_is_leader": fo.get("killed_leader") == line.get("leader"),
            "new_owner_differs": fo.get("new_owner") not in (None, fo.get("killed_leader")),
        },
    }


@pytest.fixture(scope="module")
def replicated():
    pair = run_pair("fleet_converge", REPLICATED)
    for side in pair.values():
        side["line"] = failover_view(side["line"])
    return pair


def test_replicated_key_sets_equal(replicated):
    ref, port = replicated["reference"]["line"], replicated["port"]["line"]
    assert set(port) == set(ref)
    assert set(port["failover"]) == set(ref["failover"])


def test_replicated_steady_fields_equal(replicated):
    assert_steady_equal(replicated, STEADY)


def test_replicated_failover_is_journal_seeded_on_both(replicated):
    for side in ("reference", "port"):
        got = replicated[side]
        assert got["rc"] == 0 and got["line"]["ok"] is True, f"{side}: {got['line']}\n{got['stderr']}"
        fo = got["line"]["failover"]
        assert fo["journal_seeded"] is True and fo["relists"] == 0 and fo["writes_during_failover"] == 0
        assert got["line"]["owned_counts"] == [2, 2]


def _side_modules(side):
    if side == "reference":
        from tpu_operator.kube import kubesim, testing
    else:
        from tpu_operator_torch.kube import kubesim, testing
    return kubesim, testing


def _debug_shards(probe: int):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{probe}/debug/vars", timeout=3) as r:
            return json.loads(r.read()).get("shards")
    except Exception:
        return None


def _one_replica(side: str, tmp_path) -> dict:
    from tpu_operator_torch.e2e.fleet_converge import _free_port

    kubesim, testing = _side_modules(side)
    server = kubesim.KubeSimServer(kubesim.KubeSim()).start()
    proc = None
    try:
        client = kubesim.make_client(server.port)
        testing.seed_cluster(client, "tpu-operator", node_names=("node-a", "node-b"))
        probe = _free_port()
        env = {k: v for k, v in os.environ.items() if k not in DRIVER_ENV}
        env["JAX_PLATFORMS"] = "cpu"
        err = open(tmp_path / f"{side}.stderr", "wb")
        proc = subprocess.Popen(
            driver_command(side, "shard_replica") + [
                "--port", str(server.port), "--shards", "2", "--probe-port", str(probe),
                "--warm-state", str(tmp_path / f"{side}-warm.json"), "--identity", f"{side}-replica",
            ],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
        )
        err.close()
        # the line comes once the signal handlers are in place: SIGTERM
        # before it would kill the replica instead of stopping it
        first = []
        reader = threading.Thread(target=lambda: first.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(WAIT_S)
        shards = None
        deadline = time.monotonic() + WAIT_S
        while first and time.monotonic() < deadline and proc.poll() is None:
            shards = _debug_shards(probe)
            if shards and sorted(shards.get("owned") or []) == [0, 1] and shards.get("owns_full_pass"):
                break
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=WAIT_S)
        out = "".join(first) + rest
        return {
            "rc": proc.returncode,
            "line": json.loads(out.strip().splitlines()[0]) if out.strip() else None,
            "shards": shards,
            "probe": probe,
            "stderr": (tmp_path / f"{side}.stderr").read_text(errors="replace")[-3000:],
        }
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()


def test_one_replica_owns_every_shard_and_stops_cleanly_on_both(tmp_path):
    got = {side: _one_replica(side, tmp_path) for side in ("reference", "port")}
    for side, g in got.items():
        assert g["rc"] == 0, f"{side}: {g}"
        # the identity is the pod name with the replica's own suffix
        assert re.fullmatch(rf"{side}-replica_[0-9a-f]+", g["line"]["replica"]), g
        assert g["line"]["probe_port"] == g["probe"] and set(g["line"]) == {"replica", "probe_port"}, g
        assert sorted(g["shards"]["owned"]) == [0, 1] and g["shards"]["owns_full_pass"] is True, g
    # the /debug/vars shards block keeps the reference's schema
    assert set(got["port"]["shards"]) == set(got["reference"]["shards"])


def test_flags_are_the_reference_flags():
    assert_same_flags("shard_replica")


def test_replicas_start_by_module_path():
    from tpu_operator_torch.e2e import fleet_converge

    cmd = fleet_converge.replica_command(1234, 4, 2, 5678, "/w.json", "replica-0")
    assert cmd[:3] == [sys.executable, "-m", "tpu_operator_torch.e2e.shard_replica"]
    assert cmd[3:] == [
        "--port", "1234", "--shards", "4", "--max-shards", "2", "--lease-s", "3",
        "--probe-port", "5678", "--warm-state", "/w.json", "--identity", "replica-0",
    ]
    assert not any(part.endswith(".py") for part in cmd)


def test_a_dead_replica_fails_the_run_with_its_stderr_tail(monkeypatch, capsys):
    """Two replicas, the second started with a flag its parser refuses:
    the run fails at once, the line names the dead replica with its exit
    code and the tail of its stderr, and the live replica is stopped."""
    from tpu_operator_torch.e2e import fleet_converge

    for name in DRIVER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OPERATOR_NAMESPACE", "tpu-operator")
    monkeypatch.setenv("UNIT_TEST", "true")
    monkeypatch.setenv("WRITE_PIPELINE_DEPTH", "4")
    real_command = fleet_converge.replica_command

    def command(*a):
        cmd = real_command(*a)
        return cmd + ["--no-such-flag"] if cmd[-1] == "replica-1" else cmd

    started = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        proc = real_popen(*a, **kw)
        started.append(proc)
        return proc

    monkeypatch.setattr(fleet_converge, "replica_command", command)
    monkeypatch.setattr(subprocess, "Popen", popen)
    rc = fleet_converge.main(["--nodes", "2", "--replicas", "2", "--timeout", "120"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["ok"] is False
    assert set(line["replica_failures"]) == {"1"}
    failure = line["replica_failures"]["1"]
    assert failure["rc"] == 2
    assert "unrecognized arguments: --no-such-flag" in failure["stderr_tail"]
    assert len(started) == 2 and all(p.returncode is not None for p in started)
