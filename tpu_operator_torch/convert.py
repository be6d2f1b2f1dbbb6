"""numpy arrays in, tensors out, and back; global arrays into each rank's
shard; the JAX package's ClusterPolicy into the port's, and back.

Carries state between the JAX side and the port: inputs are made once in
numpy and handed to both. The multi-device workloads take the JAX
package's global arrays (its parameters and inputs before ``device_put``)
and give each rank the block its ``NamedSharding`` would have put on that
device (``shard``, ``burnin_shards``). bfloat16 travels as its raw 16-bit pattern
(``int16`` view), so this module needs no ``ml_dtypes``: a numpy bf16
array is recognised by its dtype name, and the way back returns the raw
bits unless the caller names the numpy bf16 dtype to view them as.

The control plane's state is its ClusterPolicy: ``clusterpolicy_from_reference``
and ``clusterpolicy_to_reference`` carry a CR (plain dicts, as YAML gives
them) across through the rename table of
``api/v1/clusterpolicy_types.py``, and ``crd_from_reference`` does the same
for a CRD manifest (property names, defaults and the descriptions'
accelerator words; enums and bounds stay as they are).

The objects around it cross through ``operand_app_from_reference`` (the
``OPERAND_APPS`` table, a per-variant suffix kept), ``pod_from_reference``
(resource requests and limits ``google.com/tpu`` to ``nvidia.com/gpu``,
an operand's ``app`` label and name), ``object_from_reference``, which
converts any object by its kind (a node's capacity, allocatable,
operator labels and the upgrade FSM's annotations; a DaemonSet's name, ``app`` labels and node selector, the
validator's and the driver's init containers and the status files), and
``warm_journal_from_reference``, which maps every informer snapshot of a
warm journal through it; the app, pod, object and journal converters have
their way back.

Two reference names have no fixed counterpart and cross through a table
the caller gives (``variants``, reference generation to card variant, e.g.
``{"v5e": "h100-sxm"}``): the value of the generation label on a node and
on a driver DaemonSet, and the suffix of a per-generation driver
DaemonSet (``tpu-libtpu-daemonset-v5e`` is ``gpu-driver-daemonset-h100-sxm``).
Without the table they cross unchanged. The rollout ledger on a
ClusterPolicy (``consts.ROLLOUT_STATE_ANNOTATION``) crosses with its
driver kind renamed (``libtpu`` is ``driver``).

A chaos soak's replayable trace (``chaos/schedule.py``) crosses through
``chaos_trace_from_reference`` and back: the driver roll's event kind
(``CHAOS_KINDS``), the re-partition profile (``CHAOS_PROFILES``, the
reference's TPU layout to the card slice manager's) and the bad version
(``CHAOS_VERSIONS``, the reference soak's to the port soak's); node names,
times and every other argument stay as they are.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.api.v1 import clusterpolicy_types as cpt


def to_torch(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A tensor holding ``arr``'s values; bf16 arrays keep every bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """``t`` as a numpy array on the host. A bf16 tensor comes back as its
    ``uint16`` bit pattern, or viewed as ``bf16_dtype`` when one is given
    (e.g. ``ml_dtypes.bfloat16`` on the JAX side)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy()


def shard(arr: np.ndarray, axis: int, index: int, parts: int) -> np.ndarray:
    """Block ``index`` of ``arr`` cut into ``parts`` equal blocks along
    ``axis``: the device ``index`` of a mesh axis of size ``parts`` holds it
    under a ``PartitionSpec`` naming that axis at ``axis``."""
    size = arr.shape[axis]
    if size % parts:
        raise ValueError(f"axis {axis} of size {size} does not split into {parts}")
    step = size // parts
    block = [slice(None)] * arr.ndim
    block[axis] = slice(index * step, (index + 1) * step)
    return arr[tuple(block)]


def burnin_shards(params: dict, data, dp: int, tp: int, rank: int):
    """The burn-in rank ``(rank // tp, rank % tp)``'s slices of the
    reference's ``params`` (``w1`` column-parallel, ``P(None, "tp")``;
    ``w2`` row-parallel, ``P("tp", None)``) and of ``data`` ``(x, y)``
    (batch over ``dp``, ``P("dp", None)``)."""
    d, t = rank // tp, rank % tp
    x, y = data
    return (
        {"w1": shard(params["w1"], 1, t, tp), "w2": shard(params["w2"], 0, t, tp)},
        (shard(x, 0, d, dp), shard(y, 0, d, dp)),
    )


Path = Tuple[str, ...]


def _renamer(forward: bool):
    """(key renames by source-side path, a value renamer ``(path, value)``)
    for one direction of the rename table."""
    if forward:
        keys = dict(cpt.KEY_RENAMES)
        values = dict(cpt.VALUE_RENAMES)
        path_values = {p: dict(m) for p, m in cpt.PATH_VALUE_RENAMES.items()}
        prefixes = dict(cpt.PREFIX_RENAMES)
    else:
        keys = {p[:-1] + (new,): p[-1] for p, new in cpt.KEY_RENAMES.items()}
        values = {new: old for old, new in cpt.VALUE_RENAMES.items()}
        path_values = {}
        for p, m in cpt.PATH_VALUE_RENAMES.items():
            ported = tuple(cpt.KEY_RENAMES.get(p[: i + 1], s) for i, s in enumerate(p))
            path_values[ported] = {new: old for old, new in m.items()}
        prefixes = {new: old for old, new in cpt.PREFIX_RENAMES.items()}

    def value(path: Path, v: Any) -> Any:
        if not isinstance(v, str):
            return v
        if v in path_values.get(path, {}):
            return path_values[path][v]
        if v in values:
            return values[v]
        for old, new in prefixes.items():
            if v.startswith(old):
                return new + v[len(old):]
        return v

    return keys, value


def _rename_tree(tree: Any, path: Path, keys: Dict[Path, str], value: Callable) -> Any:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            child = path + (k,)
            out[keys[child] if child in keys else value((), k)] = _rename_tree(v, child, keys, value)
        return out
    if isinstance(tree, list):
        return [_rename_tree(v, path, keys, value) for v in tree]
    return value(path, tree)


# the rollout ledger's driver kind: the reference's KIND_LIBTPU, the port's KIND_DRIVER
ROLLOUT_KINDS = {"libtpu": "driver"}


def _rollout_record(obj: Dict[str, Any], forward: bool) -> Dict[str, Any]:
    """``obj`` with the rollout ledger's kind renamed (a garbled ledger
    crosses as it is)."""
    ann = (obj.get("metadata") or {}).get("annotations") or {}
    raw = ann.get(consts.ROLLOUT_STATE_ANNOTATION)
    if not raw:
        return obj
    try:
        rec = json.loads(raw)
    except (ValueError, TypeError):
        return obj
    kinds = ROLLOUT_KINDS if forward else {new: old for old, new in ROLLOUT_KINDS.items()}
    if isinstance(rec, dict) and rec.get("kind") in kinds:
        rec["kind"] = kinds[rec["kind"]]
        ann[consts.ROLLOUT_STATE_ANNOTATION] = json.dumps(rec, sort_keys=True)
    return obj


def clusterpolicy_from_reference(obj: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's ClusterPolicy object as the port's: sub-specs,
    image names, the driver's paths and the accelerator's names renamed,
    and the rollout ledger's kind."""
    return _rollout_record(_rename_tree(obj, (), *_renamer(True)), True)


def clusterpolicy_to_reference(obj: Dict[str, Any]) -> Dict[str, Any]:
    """The port's ClusterPolicy object as the JAX package's (the inverse of
    ``clusterpolicy_from_reference``)."""
    return _rollout_record(_rename_tree(obj, (), *_renamer(False)), False)


def _text(s: str) -> str:
    for old, new in cpt.TEXT_RENAMES:
        s = s.replace(old, new)
    return s


def _schema_from_reference(schema: Dict[str, Any], path: Path, keys, value) -> Dict[str, Any]:
    out = {}
    for k, v in schema.items():
        if k == "properties":
            out[k] = {
                keys.get(path + (name,), name): _schema_from_reference(sub, path + (name,), keys, value)
                for name, sub in v.items()
            }
        elif k in ("items", "additionalProperties") and isinstance(v, dict):
            out[k] = _schema_from_reference(v, path, keys, value)
        elif k == "default":
            out[k] = _rename_tree(v, path, keys, value)
        elif k == "description":
            out[k] = _text(v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def crd_from_reference(crd: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's CRD manifest as the port's: each version's schema
    with the CR's renames applied to property names and defaults and the
    accelerator's words to descriptions."""
    keys, value = _renamer(True)
    out = copy.deepcopy(crd)
    for version in out.get("spec", {}).get("versions", []):
        schema = version.get("schema", {})
        if "openAPIV3Schema" in schema:
            schema["openAPIV3Schema"] = _schema_from_reference(schema["openAPIV3Schema"], (), keys, value)
    return out


# the reference's accelerator names on pods, nodes and DaemonSets
REF_TPU_RESOURCE = "google.com/tpu"
REF_TPU_SUBSLICE_PREFIX = "google.com/tpu-"
REF_LIBTPU_VERSION_LABEL = f"{consts.TFD_LABEL_PREFIX}libtpu-version"


def _map_app(app: str, table: Dict[str, str]) -> str:
    """``app`` through ``table``, the longest key that is ``app`` or its
    prefix before a ``-<suffix>`` (a per-variant DaemonSet) winning."""
    for old in sorted(table, key=len, reverse=True):
        if app == old or app.startswith(old + "-"):
            return table[old] + app[len(old):]
    return app


def operand_app_from_reference(app: str) -> str:
    """A reference operand DaemonSet's ``app`` label as the port's."""
    return _map_app(app, consts.OPERAND_APPS)


def operand_app_to_reference(app: str) -> str:
    """The port's operand ``app`` label as the reference's."""
    return _map_app(app, {new: old for old, new in consts.OPERAND_APPS.items()})


def _resource(name: str, forward: bool) -> str:
    if forward:
        if name == REF_TPU_RESOURCE:
            return consts.GPU_RESOURCE
        if name.startswith(REF_TPU_SUBSLICE_PREFIX):
            return consts.MIG_RESOURCE_PREFIX + name[len(REF_TPU_SUBSLICE_PREFIX):]
        return name
    if name == consts.GPU_RESOURCE:
        return REF_TPU_RESOURCE
    if name.startswith(consts.MIG_RESOURCE_PREFIX):
        return REF_TPU_SUBSLICE_PREFIX + name[len(consts.MIG_RESOURCE_PREFIX):]
    return name


def _rename_keys(d: Dict[str, Any], fn: Callable[[str], str]) -> Dict[str, Any]:
    return {fn(k): v for k, v in d.items()}


# operator label keys that name the driver: the reference's to the port's
LABEL_KEYS = {
    REF_LIBTPU_VERSION_LABEL: consts.DRIVER_VERSION_LABEL,
    consts.DEPLOY_LABEL_PREFIX + "libtpu": consts.DEPLOY_LABEL_PREFIX + consts.COMPONENT_DRIVER,
    f"{consts.GROUP}/libtpu-upgrade-state": consts.UPGRADE_STATE_LABEL,
    f"{consts.GROUP}/libtpu-upgrade.skip": consts.UPGRADE_SKIP_LABEL,
    f"{consts.GROUP}/libtpu-upgrade-drain.skip": consts.UPGRADE_SKIP_DRAIN_LABEL,
}
# the upgrade FSM's node annotations that name the driver: the reference's
# to the port's
ANNOTATION_KEYS = {
    f"{consts.GROUP}/libtpu-upgrade-retries": consts.UPGRADE_RETRY_ANNOTATION,
    f"{consts.GROUP}/libtpu-previous-version": consts.UPGRADE_PREVIOUS_VERSION_ANNOTATION,
    f"{consts.GROUP}/libtpu-upgrade-state-since": consts.UPGRADE_STATE_SINCE_ANNOTATION,
    f"{consts.GROUP}/libtpu-upgrade.node-initial-state.unschedulable": consts.UPGRADE_INITIAL_STATE_ANNOTATION,
    f"{consts.GROUP}/libtpu-upgrade-enabled": consts.UPGRADE_ENABLED_ANNOTATION,
}
# the validator's and the driver's init containers, and the status files:
# the reference's to the port's
INIT_CONTAINERS = {
    "libtpu-validation": "driver-validation",
    "runtime-validation": "toolkit-validation",
    "jax-validation": "cuda-validation",
    "libtpu-manager": "driver-manager",
}
STATUS_FILES = {
    ".libtpu-ctr-ready": consts.STATUS_FILE_DRIVER_CTR,
    "libtpu-ready": consts.STATUS_FILE_DRIVER,
    "runtime-ready": consts.STATUS_FILE_TOOLKIT,
    "jax-ready": consts.STATUS_FILE_CUDA,
}


def _table(table: Dict[str, str], forward: bool) -> Dict[str, str]:
    return dict(table) if forward else {new: old for old, new in table.items()}


def _variant(value: str, variants: Optional[Dict[str, str]], forward: bool) -> str:
    if not variants:
        return value
    return _table(variants, forward).get(value, value)


def _driver_app(app: str, variants: Optional[Dict[str, str]], forward: bool) -> str:
    """A per-generation driver DaemonSet's name or app with its suffix
    through ``variants`` (any other name unchanged)."""
    base = consts.DRIVER_APP if forward else "tpu-libtpu-daemonset"
    if variants and app.startswith(base + "-"):
        return f"{base}-{_variant(app[len(base) + 1:], variants, forward)}"
    return app


def _rename_labels(labels: Dict[str, Any], forward: bool, variants=None) -> None:
    for old, new in _table(LABEL_KEYS, forward).items():
        if old in labels:
            labels[new] = labels.pop(old)
    if consts.GENERATION_LABEL in labels:
        labels[consts.GENERATION_LABEL] = _variant(labels[consts.GENERATION_LABEL], variants, forward)


def _labels(meta: Dict[str, Any], forward: bool, rename: bool = False, variants=None) -> None:
    """The ``app`` label and the operator's label keys of ``meta``; with
    ``rename``, an operand's name too (``<app>`` or ``<app>-<node>``)."""
    labels = meta.get("labels")
    if not labels:
        return
    app = operand_app_from_reference if forward else operand_app_to_reference
    if "app" in labels:
        mapped = _driver_app(app(labels["app"]), variants, forward)
        if rename and mapped != labels["app"] and "name" in meta:
            meta["name"] = _driver_app(app(meta["name"]), variants, forward)
        labels["app"] = mapped
    _rename_labels(labels, forward, variants)


def _pod(pod: Dict[str, Any], forward: bool) -> Dict[str, Any]:
    out = copy.deepcopy(pod)
    _labels(out.get("metadata", {}), forward, rename=True)
    for container in (out.get("spec", {}).get("containers") or []):
        res = container.get("resources") or {}
        for bucket in ("limits", "requests"):
            if res.get(bucket):
                res[bucket] = _rename_keys(res[bucket], lambda k: _resource(k, forward))
    return out


def pod_from_reference(pod: Dict[str, Any]) -> Dict[str, Any]:
    """A reference pod as the port's: ``google.com/tpu`` requests and
    limits become ``nvidia.com/gpu`` (subslices ``nvidia.com/mig-*``), and
    an operand pod's ``app`` label and name the port's."""
    return _pod(pod, True)


def pod_to_reference(pod: Dict[str, Any]) -> Dict[str, Any]:
    """The port's pod as the reference's (the inverse of
    ``pod_from_reference``)."""
    return _pod(pod, False)


def _node(node: Dict[str, Any], forward: bool, variants=None) -> Dict[str, Any]:
    out = copy.deepcopy(node)
    meta = out.get("metadata", {})
    _labels(meta, forward, variants=variants)
    ann = meta.get("annotations")
    if ann:
        for old, new in _table(ANNOTATION_KEYS, forward).items():
            if old in ann:
                ann[new] = ann.pop(old)
    status = out.get("status") or {}
    for field in ("capacity", "allocatable"):
        if status.get(field):
            status[field] = _rename_keys(status[field], lambda k: _resource(k, forward))
    return out


_STATUS_PATH = re.compile(re.escape(consts.VALIDATION_DIR) + r"/([\w.-]+)")


def _status_files(text: str, forward: bool) -> str:
    """The barrier files named in a shell command."""
    table = _table(STATUS_FILES, forward)
    return _STATUS_PATH.sub(lambda m: f"{consts.VALIDATION_DIR}/{table.get(m.group(1), m.group(1))}", text)


def _daemonset(ds: Dict[str, Any], forward: bool, variants=None) -> Dict[str, Any]:
    out = copy.deepcopy(ds)
    meta = out.get("metadata", {})
    _labels(meta, forward, rename=True, variants=variants)
    spec = out.get("spec") or {}
    match = (spec.get("selector") or {}).get("matchLabels")
    if match:
        app = match.get("app")
        _labels({"labels": match}, forward, variants=variants)
        if not (meta.get("labels") or {}).get("app") and meta.get("name") == app:
            # an unlabelled DaemonSet named by its selector's app
            meta["name"] = match["app"]
    tmpl = spec.get("template") or {}
    _labels(tmpl.get("metadata") or {}, forward, variants=variants)
    pod_spec = tmpl.get("spec") or {}
    if pod_spec.get("nodeSelector"):
        _rename_labels(pod_spec["nodeSelector"], forward, variants)
    names = _table(INIT_CONTAINERS, forward)
    for c in pod_spec.get("initContainers") or []:
        c["name"] = names.get(c.get("name"), c.get("name"))
    for c in (pod_spec.get("initContainers") or []) + (pod_spec.get("containers") or []):
        pre_stop = ((c.get("lifecycle") or {}).get("preStop") or {}).get("exec") or {}
        if pre_stop.get("command"):
            pre_stop["command"] = [_status_files(part, forward) for part in pre_stop["command"]]
    return out


def _object_converter(kind: str, forward: bool, variants=None) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    if kind == consts.CLUSTER_POLICY_KIND:
        return clusterpolicy_from_reference if forward else clusterpolicy_to_reference
    if kind == "Pod":
        return lambda o: _pod(o, forward)
    if kind == "Node":
        return lambda o: _node(o, forward, variants)
    if kind == "DaemonSet":
        return lambda o: _daemonset(o, forward, variants)
    return copy.deepcopy


def object_from_reference(obj: Dict[str, Any], variants: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """One reference object as the port's, by its kind: a ClusterPolicy,
    pod, node or DaemonSet through its converter, any other kind copied.
    ``variants`` maps the reference's generations to card variants."""
    return _object_converter(obj.get("kind", ""), True, variants)(obj)


def object_to_reference(obj: Dict[str, Any], variants: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The port's object as the reference's (the inverse of
    ``object_from_reference``)."""
    return _object_converter(obj.get("kind", ""), False, variants)(obj)


def _journal(payload: Dict[str, Any], forward: bool) -> Dict[str, Any]:
    out = copy.deepcopy(payload)
    for key, snap in (out.get("informers") or {}).items():
        fn = _object_converter(key.partition("|")[2], forward)
        snap["objects"] = [fn(o) for o in snap.get("objects") or []]
    return out


def warm_journal_from_reference(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A warm journal the reference wrote (``WarmJournal.load``'s payload)
    as the port's: every informer snapshot's objects through the
    converters above, the ClusterPolicy through
    ``clusterpolicy_from_reference``. Resume resourceVersions, the render
    cache and the apply-set membership stay as they are."""
    return _journal(payload, True)


def warm_journal_to_reference(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The port's warm journal as the reference's (the inverse of
    ``warm_journal_from_reference``)."""
    return _journal(payload, False)


# a chaos trace's names: the driver roll's kind, the soak's re-partition
# profile and its bad version (chaos/soak.py REPARTITION_PROFILE, BAD_VERSION)
CHAOS_KINDS = {"libtpu_roll": "driver_roll"}
CHAOS_PROFILES = {"balanced-2x2": "all-1x2"}
CHAOS_VERSIONS = {"2025.9.9-bad": "550.163.01"}


def _chaos_trace(doc: Dict[str, Any], forward: bool) -> Dict[str, Any]:
    kinds = _table(CHAOS_KINDS, forward)
    profiles = _table(CHAOS_PROFILES, forward)
    versions = _table(CHAOS_VERSIONS, forward)
    out = copy.deepcopy(doc)
    for ev in out.get("events") or []:
        ev["kind"] = kinds.get(ev["kind"], ev["kind"])
        args = ev.get("args") or {}
        if "profile" in args:
            args["profile"] = profiles.get(args["profile"], args["profile"])
        if "version" in args:
            args["version"] = versions.get(args["version"], args["version"])
    return out


def chaos_trace_from_reference(doc: Dict[str, Any]) -> Dict[str, Any]:
    """A chaos trace the reference's ``ChaosSchedule.trace()`` wrote as the
    port's: event kinds through ``CHAOS_KINDS``, ``profile`` arguments
    through ``CHAOS_PROFILES`` and ``version`` arguments through
    ``CHAOS_VERSIONS`` (anything outside the tables unchanged)."""
    return _chaos_trace(doc, True)


def chaos_trace_to_reference(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The port's chaos trace as the reference's (the inverse of
    ``chaos_trace_from_reference``)."""
    return _chaos_trace(doc, False)
