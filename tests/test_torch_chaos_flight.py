"""Chaos post-mortem capture on the port (``tests/test_chaos_flight.py``'s
2 cases): a forced disruption-budget violation — real re-partition
admissions by the port's ``SliceRepartitionController`` checked by the
port's ``InvariantChecker`` under a lowered cap — produces a flight dump
whose timeline names the violating admissions; a clean soak reports an
empty ``flight_dumps`` list."""

import json
import os
import time
from types import SimpleNamespace

os.environ.setdefault("OPERATOR_NAMESPACE", "tpu-operator")
os.environ.setdefault("UNIT_TEST", "true")

from tpu_operator_torch.chaos import soak  # noqa: E402
from tpu_operator_torch.chaos.soak import InvariantChecker, SoakRunner  # noqa: E402
from tpu_operator_torch.controllers.repartition import SliceRepartitionController  # noqa: E402
from tpu_operator_torch.kube.client import FakeClient  # noqa: E402
from tpu_operator_torch.kube.testing import make_gpu_node  # noqa: E402
from tpu_operator_torch.obs import flight  # noqa: E402

NS = "tpu-operator"


def _fleet(n=3):
    return FakeClient(
        [{"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}}]
        + [make_gpu_node(f"fv-{i}") for i in range(n)]
    )


def test_forced_budget_violation_dump_names_the_admissions(tmp_path):
    flight.RECORDER.dir = str(tmp_path)
    flight.RECORDER.min_interval_s = 0.0
    flight.RECORDER.clear()
    dumps_before = flight.RECORDER.dumps_total

    client = _fleet(3)
    nodes = client.list("v1", "Node", copy=True)
    # the real controller admits all three single-host slices under its
    # own generous cap, each admission a budget.admit flight event
    spec = SimpleNamespace(
        config=SimpleNamespace(name="layouts", default=soak.REPARTITION_PROFILE),
        max_unavailable="100%",
    )
    summary = SliceRepartitionController(client).reconcile(nodes, spec, NS)
    assert summary.rolling_slices == 3, summary

    # the soak's checker audits the same cluster under a cap of 1
    checker = InvariantChecker(client, NS, max_unavailable="1", grace_s=0.0)
    checker.check_once()
    time.sleep(0.01)
    checker.check_once()
    assert any(v.startswith("budget:cap") for v in checker.violations), checker.violations

    assert flight.RECORDER.dumps_total == dumps_before + 1
    path = flight.RECORDER.last_dump_path
    assert path and os.path.exists(path)
    with open(path) as f:
        dump = json.load(f)
    assert dump["reason"].startswith("invariant-budget")
    violation = next(e for e in dump["events"] if e["kind"] == "invariant.violation")
    assert violation["key"] == "budget:cap"
    admits = [e for e in dump["events"] if e["kind"] == "budget.admit" and e.get("owner") == "repartition"]
    admitted_nodes = {e["node"] for e in admits}
    assert admitted_nodes == {"fv-0", "fv-1", "fv-2"}
    for name in admitted_nodes:
        assert name in violation["detail"], (name, violation["detail"])
    assert all(e["layout"] == soak.REPARTITION_PROFILE for e in admits)


def test_soak_report_lists_flight_dumps(tmp_path):
    """A clean small soak reports an empty ``flight_dumps`` list (the key
    exists for red runs to fill)."""
    flight.RECORDER.dir = str(tmp_path)
    flight.RECORDER.clear()
    report = SoakRunner(
        nodes=4,
        slice_pairs=1,
        seed=3,
        duration_s=1.0,
        churn=False,
        repartition=False,
        converge_timeout_s=90.0,
        settle_timeout_s=90.0,
    ).run()
    assert "flight_dumps" in report
    assert report["ok"], report
    assert report["flight_dumps"] == [], report["flight_dumps"]
