"""The port's fleet-lifecycle chaos soak (``tpu_operator_torch/chaos``),
``tests/test_chaos_soak.py``'s fast soaks at seeds 5 and 1.

Each runs the port's whole rig on a small fleet — the operator from
``main.build_manager`` + ``wire_event_sources`` over KubeSim's HTTP, the
simulated kubelet, the ``schedsim`` churn engine — through every event kind
(joins, some forming new 2-host slices, preemptions, card kills, flaps and
restores, apiserver faults, a partition window, one live re-partition to
``all-1x2``), with every assertion of the reference's test: zero invariant
violations, a clean allocation drain, a fleet that settles READY, and an
executed trace that is the seed's schedule, which is also the reference's
schedule for that seed through ``convert.chaos_trace_from_reference``.
With ``GPU_LOCKWATCH=1`` the file runs under the port's lock-order
watchdog and fails on any cycle. The runner stops every operator, server,
kubelet and engine it started, whatever the outcome.
"""

import os

import pytest

os.environ.setdefault("OPERATOR_NAMESPACE", "tpu-operator")
os.environ.setdefault("UNIT_TEST", "true")

from tpu_operator.chaos.schedule import ChaosSchedule as RefChaosSchedule  # noqa: E402
from tpu_operator_torch import convert  # noqa: E402
from tpu_operator_torch.analysis import lockwatch  # noqa: E402
from tpu_operator_torch.chaos import soak  # noqa: E402
from tpu_operator_torch.chaos.schedule import ChaosSchedule  # noqa: E402
from tpu_operator_torch.chaos.soak import SoakRunner  # noqa: E402

FLEET = [f"soak-{i}" for i in range(12)]


@pytest.fixture(scope="module", autouse=True)
def _lockwatch_if_asked():
    if not lockwatch.requested():
        yield
        return
    with lockwatch.watching():
        yield


@pytest.mark.parametrize("seed", (5, 1))
def test_soak_fast_zero_invariant_violations(seed):
    report = SoakRunner(nodes=12, slice_pairs=2, seed=seed, duration_s=8.0).run()
    assert report["converged_before_chaos"], report
    assert report["events_executed"] == len(report["trace"]["events"])
    assert report["settled"], report.get("violations")
    assert report["violations"] == [], report["violations"]
    assert report["ok"], report
    # replayability: the executed trace is exactly the seed's schedule,
    # and the reference's schedule for the seed
    ported = ChaosSchedule(seed, 8.0, FLEET, repartition_profiles=[soak.REPARTITION_PROFILE]).trace()
    assert report["trace"] == ported
    reference = RefChaosSchedule(seed, 8.0, FLEET, repartition_profiles=["balanced-2x2"]).trace()
    assert convert.chaos_trace_from_reference(reference) == report["trace"]
    # the churn engine actually lived through the lifecycle
    assert report["alloc"]["allocations_total"] > 0
    assert report["alloc_drain"]["chips_held"] == 0
