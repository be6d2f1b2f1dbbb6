"""Cases that run on both packages, one pytest case a side.

A suite parametrises its cases with ``BY_SIDE`` and runs each case's
script through ``hold``: the script runs on the case's own side and makes
the reference's assertions there, in that side's names, and returns its
outcomes in the port's names. The port's case then holds its outcome equal
to the reference's on the same inputs: the reference's case, when it ran
earlier in this process, left its outcome here; otherwise the port's case
runs the reference's script itself first. So each side counts as a case,
and no port case passes without the comparison.
"""

import os

import pytest

SIDE_NAMES = ("reference", "port")
BY_SIDE = pytest.mark.parametrize("side", SIDE_NAMES)

_OUTCOMES = {}


def _case_without_side(side):
    """The running case's id with ``side`` taken out of its parameters."""
    case = os.environ.get("PYTEST_CURRENT_TEST", "").rsplit(" ", 1)[0]
    base, bracket, params = case.partition("[")
    return base, tuple(p for p in params.rstrip("]").split("-") if p != side) if bracket else ()


def hold(sides, side, script, *args):
    """``script(sides[side], *args)``; on the port's side its outcome must
    equal the reference's (tolerance: exact equality). Returns the
    outcome."""
    key = (_case_without_side(side), script.__module__, script.__qualname__, repr(args))
    seen = _OUTCOMES.setdefault(key, {})
    seen[side] = script(sides[side], *args)
    if side == "port":
        if "reference" not in seen:
            seen["reference"] = script(sides["reference"], *args)
        assert seen["reference"] == seen["port"], seen
    return seen[side]
