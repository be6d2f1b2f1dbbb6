"""The port's allocation-churn driver ``tpu_operator_torch/e2e/alloc_churn.py``
held against the reference's ``tests/scripts/alloc_churn.py``.

Both drivers run at 16 nodes and 600 allocations a minute with a 5 s
churn window, as subprocesses, the reference first and the port after
it. Their lines must have equal key sets and equal steady fields
(``STEADY``, read off three reference runs at this size), and both must
say ``ok``. The rate floor is set to 300 a minute: the reference's
default of 1000 is above what 600 a minute can reach.

The reference's engine now and then counts a partial gang under load
(a lifecycle eviction between two members' admissions); the port rolls
such a gang back as failed. Where the reference's line shows
``partial_gang_violations`` > 0, its ``ok`` and that field are not
compared; the port's must still be 0.
"""

import pytest

from tests.test_torch_fleet_converge import assert_same_flags, assert_steady_equal, run_pair

ARGS = ["--nodes", "16", "--rate", "600", "--min-rate", "300", "--churn-floor-s", "5"]
STEADY = (
    "ok", "nodes", "converged", "remediation_active", "recovered_after_wave", "double_allocations",
    "partial_gang_violations", "invariant_violations", "chips_leaked",
)
# the reference's engine race shows in these two fields alone
RACE_FIELDS = ("ok", "partial_gang_violations")
# no wave: the remediation condition of ok cannot hold
NO_WAVE_ARGS = ["--nodes", "4", "--victims", "0", "--rate", "600", "--min-rate", "0", "--churn-floor-s", "1"]


def _reference_raced(pair) -> bool:
    return pair["reference"]["line"].get("partial_gang_violations", 0) > 0


@pytest.fixture(scope="module")
def churn():
    return run_pair("alloc_churn", ARGS)


def test_key_sets_equal(churn):
    ref, port = churn["reference"]["line"], churn["port"]["line"]
    assert set(port) == set(ref), (sorted(set(ref) - set(port)), sorted(set(port) - set(ref)))


def test_steady_fields_equal(churn):
    fields = [f for f in STEADY if not (_reference_raced(churn) and f in RACE_FIELDS)]
    assert_steady_equal(churn, fields)


def test_port_holds_every_invariant_under_the_wave(churn):
    port = churn["port"]
    line = port["line"]
    assert port["rc"] == 0 and line["ok"] is True, f"{line}\n{port['stderr']}"
    assert line["converged"] and line["remediation_active"] and line["recovered_after_wave"]
    assert line["double_allocations"] == 0 and line["partial_gang_violations"] == 0
    assert line["invariant_violations"] == 0 and line["chips_leaked"] == 0
    assert line["alloc_total"] > 0 and line["pods_created"] > 0


def test_reference_passes_unless_its_engine_raced(churn):
    ref = churn["reference"]
    if _reference_raced(churn):
        assert ref["line"]["double_allocations"] == 0 and ref["line"]["chips_leaked"] == 0
    else:
        assert ref["rc"] == 0 and ref["line"]["ok"] is True, f"{ref['line']}\n{ref['stderr']}"


def test_ok_needs_the_remediation_wave():
    """With no victim the remediation condition cannot hold: both drivers
    converge, allocate, hold every invariant, and still say not ok."""
    pair = run_pair("alloc_churn", NO_WAVE_ARGS)
    for side in ("reference", "port"):
        line = pair[side]["line"]
        assert pair[side]["rc"] == 1 and line["ok"] is False, f"{side}: {line}"
        assert line["converged"] is True and line["remediation_active"] is False
        assert line["double_allocations"] == 0 and line["chips_leaked"] == 0
    assert_steady_equal(pair, [f for f in STEADY if not (_reference_raced(pair) and f in RACE_FIELDS)])


def test_flags_are_the_reference_flags():
    assert_same_flags("alloc_churn")
