"""The port's structural-schema validator (``cfg/schema_validate.py``)
against the JAX package's, on the 11 cases of
``tests/test_schema_validate.py``: scalar types, bool is not an integer,
int-or-string, the unanchored pattern, enums and bounds, unknown and
required fields, typed maps, array items with their paths, nested paths,
the generated CRD's round trip and a CRD without the asked version.

Each case runs on each package (``two_sided.hold``) with the reference's
assertions made on each side. The rule cases give both validators the
same schemas and objects, and the problem lists must be equal word for
word. The round trip takes each side's own ``crdgen.build_crd()`` and
sample CR, and edits the CR at the same paths (the driver's section under
its name in the rename table, ``KEY_RENAMES``); the reference's problems
must be the port's after ``tests/test_torch_api.py``'s
``reference_problem_as_port``. Tolerance: exact equality.
"""

import copy
from types import SimpleNamespace

import pytest
import yaml

from tests.test_torch_api import reference_problem_as_port
from tests.two_sided import BY_SIDE, hold
from tpu_operator.cfg import crdgen as ref_crdgen
from tpu_operator.cfg import schema_validate as ref_sv
from tpu_operator.kube import testing as ref_testing
from tpu_operator_torch.api.v1.clusterpolicy_types import KEY_RENAMES
from tpu_operator_torch.cfg import crdgen, schema_validate as sv
from tpu_operator_torch.kube import testing

SIDES = {
    "reference": SimpleNamespace(name="reference", sv=ref_sv, crdgen=ref_crdgen, testing=ref_testing,
                                 driver="libtpu", port=reference_problem_as_port),
    "port": SimpleNamespace(name="port", sv=sv, crdgen=crdgen, testing=testing,
                            driver=KEY_RENAMES[("spec", "libtpu")], port=lambda p: p),
}


def judged(side, cases):
    """Each ``(schema, obj, fragment)``: ``fragment`` None must validate
    clean; otherwise one problem must contain it. Returns the problems."""
    out = []
    for schema, obj, fragment in cases:
        problems = side.sv.validate(schema, obj)
        if fragment is None:
            assert problems == [], (obj, problems)
        else:
            assert any(fragment in p for p in problems), (fragment, problems)
        out.append(problems)
    return out


INT_OR_PCT = {"x-kubernetes-int-or-string": True, "pattern": r"^\d+%?$"}
NAMED = {"type": "object", "properties": {"name": {"type": "string"}}, "required": ["name"]}
NAMED_PRESERVE = {"type": "object", "properties": {"name": {"type": "string"}},
                  "x-kubernetes-preserve-unknown-fields": True}
ENUM = {"type": "string", "enum": ["OnDelete", "RollingUpdate"]}

RULES = {
    "test_scalar_types": [
        ({"type": "string"}, "x", None), ({"type": "string"}, 3, "expected string"),
        ({"type": "integer"}, 3, None), ({"type": "integer"}, 3.5, "expected integer"),
        ({"type": "number"}, 3.5, None), ({"type": "number"}, 3, None),
        ({"type": "boolean"}, True, None), ({"type": "boolean"}, "true", "expected boolean")],
    "test_bool_is_not_an_integer": [
        ({"type": "integer"}, True, "expected integer"), ({"type": "number"}, False, "expected number"),
        ({"x-kubernetes-int-or-string": True}, True, "int-or-string")],
    "test_int_or_string": [
        (INT_OR_PCT, 3, None), (INT_OR_PCT, "25%", None), (INT_OR_PCT, "abc", "does not match"),
        (INT_OR_PCT, 3.5, "int-or-string"), ({"x-kubernetes-int-or-string": True}, "anything", None)],
    "test_pattern_is_unanchored_like_the_apiserver": [
        ({"type": "string", "pattern": "b+"}, "abc", None),
        ({"type": "string", "pattern": "^b+$"}, "abc", "does not match")],
    "test_enum_and_bounds": [
        (ENUM, "OnDelete", None), (ENUM, "Never", "not in"),
        ({"type": "integer", "minimum": 1, "maximum": 65535}, 8080, None),
        ({"type": "integer", "minimum": 1}, 0, "below minimum"),
        ({"type": "integer", "maximum": 65535}, 70000, "above maximum")],
    "test_object_unknown_fields_and_required": [
        (NAMED, {"name": "x"}, None), (NAMED, {"name": "x", "nmae": "typo"}, "unknown field"),
        (NAMED, {}, "missing required"), (NAMED_PRESERVE, {"anything": 1}, None)],
    "test_typed_map_additional_properties": [
        ({"type": "object", "additionalProperties": {"type": "string"}}, {"a": "x", "b": "y"}, None),
        ({"type": "object", "additionalProperties": {"type": "string"}}, {"a": 1}, "expected string")],
}


@BY_SIDE
def test_scalar_types(side):
    hold(SIDES, side, judged, RULES["test_scalar_types"])


@BY_SIDE
def test_bool_is_not_an_integer(side):
    """Python's bool subclasses int; the apiserver's type check does not."""
    hold(SIDES, side, judged, RULES["test_bool_is_not_an_integer"])


@BY_SIDE
def test_int_or_string(side):
    hold(SIDES, side, judged, RULES["test_int_or_string"])


@BY_SIDE
def test_pattern_is_unanchored_like_the_apiserver(side):
    hold(SIDES, side, judged, RULES["test_pattern_is_unanchored_like_the_apiserver"])


@BY_SIDE
def test_enum_and_bounds(side):
    hold(SIDES, side, judged, RULES["test_enum_and_bounds"])


@BY_SIDE
def test_object_unknown_fields_and_required(side):
    hold(SIDES, side, judged, RULES["test_object_unknown_fields_and_required"])


@BY_SIDE
def test_typed_map_additional_properties(side):
    hold(SIDES, side, judged, RULES["test_typed_map_additional_properties"])


@BY_SIDE
def test_array_items_with_paths(side):
    def script(side):
        s = {"type": "array", "items": {"type": "object", "properties": {"key": {"type": "string"}}}}
        assert side.sv.validate(s, [{"key": "a"}, {"key": "b"}]) == []
        problems = side.sv.validate(s, [{"key": "a"}, {"key": 2}], path="spec.tolerations")
        assert problems and "spec.tolerations[1].key" in problems[0], problems
        return problems

    hold(SIDES, side, script)


@BY_SIDE
def test_nested_path_reporting(side):
    def script(side):
        s = {"type": "object",
             "properties": {"libtpu": {"type": "object", "properties": {"version": {"type": "string"}}}}}
        problems = side.sv.validate(s, {"libtpu": {"version": 1}})
        assert problems[0].startswith("libtpu.version:"), problems
        return problems

    hold(SIDES, side, script)


@BY_SIDE
def test_generated_crd_round_trip(side):
    """The side's generated CRD admits its sample CR and rejects a typo'd
    field, a bad enum and a bad int-or-string."""

    def script(side):
        crd = side.crdgen.build_crd()
        with open(side.testing.sample_clusterpolicy_path()) as f:
            cr = yaml.safe_load(f)
        assert side.sv.validate_cr(crd, cr) == []

        typo = copy.deepcopy(cr)
        typo["spec"]["devicePlugin"]["verison"] = "oops"
        bad_enum = copy.deepcopy(cr)
        bad_enum["spec"]["operator"]["defaultRuntime"] = "rkt"
        bad_pct = copy.deepcopy(cr)
        bad_pct["spec"][side.driver]["upgradePolicy"] = {"maxUnavailable": "lots"}
        out = []
        for obj, word in ((typo, "verison"), (bad_enum, "rkt"), (bad_pct, "lots")):
            problems = side.sv.validate_cr(crd, obj)
            assert any(word in p for p in problems), (word, problems)
            out.append(sorted(side.port(p) for p in problems))
        return out

    hold(SIDES, side, script)


@BY_SIDE
def test_crd_schema_missing_version(side):
    def script(side):
        with pytest.raises(KeyError) as err:
            side.sv.crd_schema({"spec": {"versions": [{"name": "v2"}]}})
        return err.type.__name__

    hold(SIDES, side, script)
