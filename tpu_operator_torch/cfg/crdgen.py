"""CRD manifest generation from the ClusterPolicy dataclasses.

The port's copy of ``tpu_operator/cfg/crdgen.py``: the dataclasses of
``api/v1/clusterpolicy_types.py`` are the single source of truth and the
openAPI v3 schema is derived from their type hints, so spec fields can
never drift from the decoder. The enums and bounds are the reference's
exactly; the CRD equals the reference's with the rename table of
``clusterpolicy_types`` applied to its property names and defaults.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt


# Typed toleration items (the hand-maintained nvidia.com CRD schema types
# tolerations fully rather than preserve-unknown-fields)
TOLERATION_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "key": {"type": "string"},
        "operator": {"type": "string", "enum": ["Exists", "Equal"]},
        "value": {"type": "string"},
        "effect": {
            "type": "string",
            "enum": ["NoSchedule", "PreferNoSchedule", "NoExecute"],
        },
        # plain int64 like the k8s core type: negative values are legal
        # (documented as "treated as 0"), so no minimum here
        "tolerationSeconds": {"type": "integer"},
    },
}

# Validation enrichment keyed by the serialized field name. The decoder
# stays permissive (Python dataclasses); the apiserver enforces these at
# admission — a malformed CR is rejected before it reaches the operator.
_FIELD_RULES: Dict[str, Dict[str, Any]] = {
    "imagePullPolicy": {"enum": ["Always", "IfNotPresent", "Never"]},
    "updateStrategy": {"enum": ["RollingUpdate", "OnDelete"]},
    "defaultRuntime": {"enum": ["docker", "containerd", "crio"]},
    "defaultWorkload": {"enum": ["container", "vm-passthrough"]},
    # k8s intstr convention: `maxUnavailable: 1` (int) and `"25%"` are
    # both valid; the pattern constrains the string arm only
    "maxUnavailable": {
        "x-kubernetes-int-or-string": True,
        "pattern": r"^\d+%?$",
    },
    "timeoutSeconds": {"minimum": 0},
    "maxParallelUpgrades": {"minimum": 0},
    # remediation FSM knobs: the breaker threshold is int-or-percent like
    # maxUnavailable; attempts/backoff are plain non-negative integers
    "systemicThreshold": {
        "x-kubernetes-int-or-string": True,
        "pattern": r"^\d+%?$",
    },
    "maxAttempts": {"minimum": 0},
    "backoffSeconds": {"minimum": 0},
    # rollout stage sizes are int-or-percent of the fleet's slices, like
    # maxUnavailable; the health-gate knobs are plain bounded integers
    "canary": {
        "x-kubernetes-int-or-string": True,
        "pattern": r"^\d+%?$",
    },
    "waves": {
        "items": {
            "x-kubernetes-int-or-string": True,
            "pattern": r"^\d+%?$",
        }
    },
    "observeSeconds": {"minimum": 0},
    "tflopsDegradedPct": {"minimum": 0, "maximum": 100},
    "membwDegradedPct": {"minimum": 0, "maximum": 100},
    "allocP99DegradedPct": {"minimum": 0},
    "hostPort": {"minimum": 1, "maximum": 65535},
    "tolerations": {"items": TOLERATION_SCHEMA},
    # k8s Quantities: `cpu: 2` and `cpu: "2"` are both valid, so these
    # maps take int-or-string values, not plain strings
    "limits": {
        "additionalProperties": {"x-kubernetes-int-or-string": True}
    },
    "requests": {
        "additionalProperties": {"x-kubernetes-int-or-string": True}
    },
}


def _schema_for(tp) -> Dict[str, Any]:
    tp = cpt._unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if origin in (list, typing.List):
        (item,) = typing.get_args(tp) or (Any,)
        return {"type": "array", "items": _schema_for(item)}
    if origin in (dict, typing.Dict):
        args = typing.get_args(tp)
        # typed maps (labels/annotations/nodeSelector/...): enforce
        # string values instead of preserve-unknown-fields
        if args and args[1] is str:
            return {
                "type": "object",
                "additionalProperties": {"type": "string"},
            }
        return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
    if dataclasses.is_dataclass(tp):
        return _dataclass_schema(tp)
    if tp is str:
        return {"type": "string"}
    if tp is bool:
        return {"type": "boolean"}
    if tp is int:
        return {"type": "integer"}
    if tp is float:
        return {"type": "number"}
    return {"x-kubernetes-preserve-unknown-fields": True}


def _dataclass_schema(cls) -> Dict[str, Any]:
    hints = typing.get_type_hints(cls)
    props = {}
    for f in dataclasses.fields(cls):
        key = cpt._field_key(f)
        schema = _schema_for(hints[f.name])
        rules = _FIELD_RULES.get(key)
        if rules:
            if rules.get("x-kubernetes-int-or-string"):
                # int-or-string replaces the schema wholesale: a `type`
                # key would make the structural schema invalid
                schema = dict(rules)
            else:
                for rk, rv in rules.items():
                    if rk == "items":
                        if schema.get("type") == "array":
                            schema["items"] = rv
                        continue
                    if rk in ("minimum", "maximum") and schema.get(
                        "type"
                    ) not in ("integer", "number"):
                        continue  # bounds only apply to numerics
                    schema[rk] = rv
        # per-field overrides declared on the dataclass win over the table
        for meta_key in ("enum", "minimum", "maximum", "pattern"):
            if meta_key in f.metadata:
                schema[meta_key] = f.metadata[meta_key]
        doc = f.metadata.get("doc")
        if doc:
            schema["description"] = doc
        # structural-schema defaulting: the dataclass scalar defaults ARE
        # the defaults the decoder would apply, so stamping them into the
        # schema makes the apiserver materialize them at admission —
        # kubectl get then shows the effective config. k8s semantics:
        # defaults apply only within objects present in the payload, which
        # matches the decoder (absent sub-spec => absent defaults).
        if (
            f.default is not dataclasses.MISSING
            and isinstance(f.default, (str, int, float, bool))
            and f.default != ""
        ):
            schema["default"] = f.default
        props[key] = schema
    return {"type": "object", "properties": props}


def build_crd() -> Dict[str, Any]:
    spec_schema = _dataclass_schema(cpt.ClusterPolicySpec)
    status_schema = _dataclass_schema(cpt.ClusterPolicyStatus)
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": consts.CRD_NAME},
        "spec": {
            "group": consts.GROUP,
            "names": {
                "kind": consts.CLUSTER_POLICY_KIND,
                "listKind": "ClusterPolicyList",
                "plural": "clusterpolicies",
                "singular": "clusterpolicy",
            },
            "scope": "Cluster",
            "versions": [
                {
                    "name": "v1",
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "additionalPrinterColumns": [
                        {
                            "jsonPath": ".status.state",
                            "name": "Status",
                            "type": "string",
                        },
                        {
                            "jsonPath": ".metadata.creationTimestamp",
                            "name": "Age",
                            "type": "date",
                        },
                    ],
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "apiVersion": {"type": "string"},
                                "kind": {"type": "string"},
                                "metadata": {"type": "object"},
                                "spec": spec_schema,
                                "status": status_schema,
                            },
                        }
                    },
                }
            ],
        },
    }


def render_crd_yaml() -> str:
    import yaml

    return yaml.safe_dump(build_crd(), sort_keys=False)
