"""OpenAPI v3 structural-schema validation.

The port's copy of ``tpu_operator/cfg/schema_validate.py``, as it is: the
enforcement half of ``crdgen``. It implements the subset of OpenAPI v3
validation that the generated CRD uses — types, enums, patterns, numeric
bounds, typed maps (``additionalProperties``) and
``x-kubernetes-preserve-unknown-fields`` — so both ``gpuop-cfg validate``
and the test apiserver (``kube/kubesim.py``) reject a malformed CR exactly
where a real apiserver would: at admission. Defaulting (``default_cr``)
runs before validation (``validate_cr``), the apiserver's order, which
KubeSim's admission keeps.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List


def validate(schema: Dict[str, Any], obj: Any, path: str = "") -> List[str]:
    """Validate ``obj`` against an openAPIV3Schema node; returns problems
    (empty = valid). ``path`` is the JSON path prefix for messages."""
    problems: List[str] = []
    where = path or "<root>"

    if schema.get("x-kubernetes-preserve-unknown-fields") and "type" not in schema:
        return problems

    if schema.get("x-kubernetes-int-or-string"):
        # apiserver semantics: integer or string ONLY (floats rejected);
        # `pattern` applies to the string arm
        if isinstance(obj, bool) or not isinstance(obj, (int, str)):
            return [f"{where}: expected int-or-string, got {type(obj).__name__}"]
        if isinstance(obj, str):
            pat = schema.get("pattern")
            if pat and not re.search(pat, obj):
                problems.append(f"{where}: {obj!r} does not match {pat!r}")
        return problems

    t = schema.get("type")
    if t == "object":
        if not isinstance(obj, dict):
            return [f"{where}: expected object, got {type(obj).__name__}"]
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        preserve = schema.get("x-kubernetes-preserve-unknown-fields", False)
        for key, value in obj.items():
            child = f"{path}.{key}" if path else key
            if key in props:
                problems += validate(props[key], value, child)
            elif isinstance(addl, dict):
                problems += validate(addl, value, child)
            elif props and not preserve and addl is None:
                # structural schemas prune unknown fields; flag them so
                # `cfg validate` catches typos the apiserver would drop
                problems.append(f"{child}: unknown field")
        for req in schema.get("required", []):
            if req not in obj:
                problems.append(f"{where}: missing required field {req!r}")
    elif t == "array":
        if not isinstance(obj, list):
            return [f"{where}: expected array, got {type(obj).__name__}"]
        item_schema = schema.get("items", {})
        for i, item in enumerate(obj):
            problems += validate(item_schema, item, f"{path}[{i}]")
    elif t == "string":
        if not isinstance(obj, str):
            return [f"{where}: expected string, got {type(obj).__name__}"]
        pat = schema.get("pattern")
        if pat and not re.search(pat, obj):
            # k8s applies `pattern` unanchored (re.search semantics);
            # the generated patterns anchor themselves with ^...$
            problems.append(f"{where}: {obj!r} does not match {pat!r}")
    elif t == "boolean":
        if not isinstance(obj, bool):
            return [f"{where}: expected boolean, got {type(obj).__name__}"]
    elif t == "integer":
        if isinstance(obj, bool) or not isinstance(obj, int):
            return [f"{where}: expected integer, got {type(obj).__name__}"]
    elif t == "number":
        if isinstance(obj, bool) or not isinstance(obj, (int, float)):
            return [f"{where}: expected number, got {type(obj).__name__}"]

    if "enum" in schema and obj not in schema["enum"]:
        problems.append(
            f"{where}: {obj!r} not in {schema['enum']}"
        )
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            problems.append(f"{where}: {obj} below minimum {schema['minimum']}")
        if "maximum" in schema and obj > schema["maximum"]:
            problems.append(f"{where}: {obj} above maximum {schema['maximum']}")
    return problems


def apply_defaults(schema: Dict[str, Any], obj: Any) -> None:
    """Structural-schema defaulting, in place (apiserver semantics:
    defaulting happens at decode time, BEFORE validation, and applies
    only inside objects that are present in the payload — an absent
    sub-object does not get materialized just because its children have
    defaults)."""
    if schema.get("type") == "object" and isinstance(obj, dict):
        props = schema.get("properties", {})
        for key, prop_schema in props.items():
            if key not in obj and "default" in prop_schema:
                import copy

                obj[key] = copy.deepcopy(prop_schema["default"])
            if key in obj:
                apply_defaults(prop_schema, obj[key])
        addl = schema.get("additionalProperties")
        if isinstance(addl, dict):
            for value in obj.values():
                apply_defaults(addl, value)
    elif schema.get("type") == "array" and isinstance(obj, list):
        item_schema = schema.get("items", {})
        for item in obj:
            apply_defaults(item_schema, item)


def default_cr(crd: Dict[str, Any], cr_obj: Dict[str, Any]) -> None:
    """Apply the CRD's schema defaults to a CR in place (metadata is the
    apiserver's own domain and is skipped, matching ``validate_cr``)."""
    schema = crd_schema(crd)
    for key, prop_schema in schema.get("properties", {}).items():
        if key == "metadata":
            continue
        if key not in cr_obj and "default" in prop_schema:
            import copy

            cr_obj[key] = copy.deepcopy(prop_schema["default"])
        if key in cr_obj:
            apply_defaults(prop_schema, cr_obj[key])


def crd_schema(crd: Dict[str, Any], version: str = "v1") -> Dict[str, Any]:
    """Extract the openAPIV3Schema for ``version`` from a CRD manifest."""
    for v in crd.get("spec", {}).get("versions", []):
        if v.get("name") == version:
            return v.get("schema", {}).get("openAPIV3Schema", {})
    raise KeyError(f"CRD has no version {version!r}")


def validate_cr(crd: Dict[str, Any], cr_obj: Dict[str, Any]) -> List[str]:
    """Validate a CR object against its CRD the way the apiserver would;
    ``metadata`` is validated by the apiserver's own rules, not the CRD
    schema, so it is skipped here."""
    schema = crd_schema(crd)
    trimmed = {k: v for k, v in cr_obj.items() if k != "metadata"}
    return validate(schema, trimmed)
