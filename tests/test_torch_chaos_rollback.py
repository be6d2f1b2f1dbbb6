"""The port's bad-driver roll under chaos, ``tests/test_chaos_soak.py``'s
``test_soak_bad_version_roll_rolls_back_to_old_version`` with every one of
its assertions, run under the port's lock-order watchdog.

A seeded bad driver version (validator readings at 0.4 of the card's) is
registered mid-run and the fleet target flipped to it (``driver_roll``)
while joins, preemptions, card faults and allocation churn are in flight.
The health-gated canary cohort must report the degraded TFLOPS, the
orchestrator must roll back by itself, and the soak must settle with every
node on the old driver, zero invariant violations, at most the canary's
two hosts admitted, a ``rollout-rollback`` flight dump naming the
evidence, and no lock-order cycle. A node whose first admission found it
already on the bad driver (a join, or a remediation restart that recreated
its driver pod from the bad template) was admitted only to be rolled back;
the soak names it apart with what it did and does not count it.
"""

import os

os.environ.setdefault("OPERATOR_NAMESPACE", "tpu-operator")
os.environ.setdefault("UNIT_TEST", "true")

from tpu_operator_torch.analysis import lockwatch  # noqa: E402
from tpu_operator_torch.chaos.soak import SoakRunner  # noqa: E402
from tpu_operator_torch.obs import flight  # noqa: E402


def test_soak_bad_version_roll_rolls_back_to_old_version(tmp_path, monkeypatch):
    monkeypatch.setattr(flight.RECORDER, "dir", str(tmp_path))
    flight.RECORDER.clear()  # this file's dumps only, none rate-limited by an earlier one
    lockwatch.reset()
    with lockwatch.watching(strict=False):
        report = SoakRunner(
            nodes=12,
            slice_pairs=2,
            seed=5,
            duration_s=8.0,
            bad_version_roll=True,
            settle_timeout_s=180.0,
        ).run()
        watched = lockwatch.stats()
    lockwatch.reset()
    assert watched["enabled"] and watched["cycles"] == 0, watched
    assert report["converged_before_chaos"], report
    assert report["events_executed"] == len(report["trace"]["events"])
    kinds = {e["kind"] for e in report["trace"]["events"]}
    assert {"bad_version", "driver_roll"} <= kinds
    assert report["settled"], report.get("settle_blockers", report.get("violations"))
    assert report["violations"] == [], report["violations"]
    assert report["ok"], {k: v for k, v in report.items() if k not in ("trace", "alloc")}
    # the rollback happened and is on the durable ledger
    record = report.get("rollout_record")
    assert record and record["state"] == "rolled-back", record
    assert record["evidence"], record
    assert report["rollout"]["rollbacks_total"] >= 1, report["rollout"]
    # zero wave-2 admissions: every admitted node sits inside the canary
    # cohort (1 slice = at most 2 member hosts)
    assert len(report.get("rollout_nodes_admitted", [])) <= 2, report["rollout_nodes_admitted"]
    # nodes rolled back after coming up on the bad driver outside the roll
    # (a join, or a remediation restart that recreated the driver pod from
    # the bad template) are named apart, each with what it did
    rolled_back = report["rollout_nodes_rolled_back"]
    assert not set(rolled_back) & set(report["rollout_nodes_admitted"]), rolled_back
    assert all("first admitted while running" in why for why in rolled_back.values()), rolled_back
    assert any("rollout-rollback" in p for p in report["flight_dumps"]), report["flight_dumps"]
