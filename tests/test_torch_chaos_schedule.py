"""The port's seeded chaos schedules (``tpu_operator_torch/chaos/schedule.py``)
against the JAX package's.

The port's generator draws from its RNG exactly as the reference's, so one
seed gives the reference's trace under ``convert.chaos_trace_from_reference``
(the driver roll ``libtpu_roll`` → ``driver_roll``, the re-partition
profile ``balanced-2x2`` → ``all-1x2``, the soak's bad version). The
committed ``tests/cases/chaos_trace_seed5.json`` is read (not copied) and
converted; a property runs both generators over seeds, fleet sizes and the
``rollout`` knob. Tolerance: exact equality.
"""

import json
import os

from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_operator.chaos import schedule as ref_schedule
from tpu_operator.chaos import soak as ref_soak
from tpu_operator_torch import convert
from tpu_operator_torch.chaos import soak
from tpu_operator_torch.chaos.schedule import TRACE_VERSION, ChaosEvent, ChaosSchedule

FLEET = [f"soak-{i}" for i in range(12)]
PROFILES = [soak.REPARTITION_PROFILE]
REF_PROFILES = ["balanced-2x2"]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cases", "chaos_trace_seed5.json")


def schedule(seed, duration_s=8.0, fleet=FLEET):
    return ChaosSchedule(seed, duration_s, fleet, repartition_profiles=PROFILES)


def test_schedule_is_deterministic_and_round_trips():
    a, b = schedule(5), schedule(5)
    assert a.trace() == b.trace(), "same seed must yield the same schedule"
    assert schedule(6).trace() != a.trace()
    assert ChaosSchedule.from_trace(a.trace()).trace() == a.trace()
    assert a.trace()["version"] == TRACE_VERSION == ref_schedule.TRACE_VERSION
    ev = ChaosEvent.from_doc(a.trace()["events"][0])
    assert ev.to_doc() == a.trace()["events"][0]


def test_recorded_reference_trace_is_the_ports_seed5_schedule():
    """The reference's committed seed-5 trace, converted, is what the
    port's generator makes from seed 5, and every event kind the soak
    advertises is in it."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    ported = ChaosSchedule(
        int(golden["seed"]),
        float(golden["duration_s"]),
        list(golden["initial_nodes"]),
        repartition_profiles=PROFILES,
    ).trace()
    assert convert.chaos_trace_from_reference(golden) == ported
    assert {e["kind"] for e in ported["events"]} == {
        "join",
        "preempt",
        "kill_chips",
        "restore",
        "flap",
        "fault",
        "partition",
        "repartition",
    }


def test_bad_version_roll_trace_matches_the_references():
    """The soak's bad-version knob on both sides: the same events, the
    roll renamed ``driver_roll`` and the versions through the table; the
    port's trace goes back to the reference's unchanged."""
    rollout = {"version": ref_soak.SoakRunner().bad_version, "tflops_factor": 0.4}
    ref = ref_schedule.ChaosSchedule(5, 8.0, FLEET, repartition_profiles=REF_PROFILES, rollout=rollout).trace()
    ported = ChaosSchedule(
        5,
        8.0,
        FLEET,
        repartition_profiles=PROFILES,
        rollout={"version": soak.SoakRunner().bad_version, "tflops_factor": 0.4},
    ).trace()
    assert convert.CHAOS_VERSIONS[rollout["version"]] == soak.BAD_VERSION
    kinds = [e["kind"] for e in ported["events"]]
    assert "driver_roll" in kinds and "bad_version" in kinds and "libtpu_roll" not in kinds
    assert convert.chaos_trace_from_reference(ref) == ported
    assert convert.chaos_trace_to_reference(ported) == ref
    assert convert.chaos_trace_to_reference(convert.chaos_trace_from_reference(ref)) == ref


@settings(max_examples=60, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n_nodes=st.integers(0, 40),
    duration_s=st.sampled_from([1.0, 4.0, 8.0, 20.0]),
    roll=st.one_of(
        st.none(),
        st.fixed_dictionaries(
            {
                "version": st.sampled_from(sorted(convert.CHAOS_VERSIONS) + ["2025.2.0"]),
                "tflops_factor": st.sampled_from([0.25, 0.4, 1.0]),
                "crashloop": st.booleans(),
            }
        ),
    ),
    repartition=st.booleans(),
)
def test_reference_trace_converted_is_the_ports(seed, n_nodes, duration_s, roll, repartition):
    """Over seeds, fleet sizes and the ``rollout`` knob: the reference's
    trace, converted, is the port's trace from the same knobs (versions
    and profiles through ``convert``'s tables)."""
    fleet = [f"node-{i}" for i in range(n_nodes)]
    ref = ref_schedule.ChaosSchedule(
        seed, duration_s, fleet, repartition_profiles=REF_PROFILES if repartition else None, rollout=roll
    ).trace()
    port_roll = None
    if roll is not None:
        port_roll = dict(roll, version=convert.CHAOS_VERSIONS.get(roll["version"], roll["version"]))
    ported = ChaosSchedule(
        seed, duration_s, fleet, repartition_profiles=PROFILES if repartition else None, rollout=port_roll
    ).trace()
    assert convert.chaos_trace_from_reference(ref) == ported
    assert convert.chaos_trace_to_reference(ported) == ref
