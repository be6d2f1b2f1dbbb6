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
converts any object by its kind (a node's capacity, allocatable and
driver-version label; a DaemonSet's name and ``app`` labels), and
``warm_journal_from_reference``, which maps every informer snapshot of a
warm journal through it; the app, pod and journal converters have their
way back.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Tuple

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


def clusterpolicy_from_reference(obj: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's ClusterPolicy object as the port's: sub-specs,
    image names, the driver's paths and the accelerator's names renamed."""
    return _rename_tree(obj, (), *_renamer(True))


def clusterpolicy_to_reference(obj: Dict[str, Any]) -> Dict[str, Any]:
    """The port's ClusterPolicy object as the JAX package's (the inverse of
    ``clusterpolicy_from_reference``)."""
    return _rename_tree(obj, (), *_renamer(False))


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


def _labels(meta: Dict[str, Any], forward: bool, rename: bool = False) -> None:
    """The ``app`` label and the driver's version label of ``meta``; with
    ``rename``, an operand's name too (``<app>`` or ``<app>-<node>``)."""
    labels = meta.get("labels")
    if not labels:
        return
    app = operand_app_from_reference if forward else operand_app_to_reference
    if "app" in labels:
        mapped = app(labels["app"])
        if rename and mapped != labels["app"] and "name" in meta:
            meta["name"] = app(meta["name"])
        labels["app"] = mapped
    old, new = (REF_LIBTPU_VERSION_LABEL, consts.DRIVER_VERSION_LABEL)
    if not forward:
        old, new = new, old
    if old in labels:
        labels[new] = labels.pop(old)


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


def _node(node: Dict[str, Any], forward: bool) -> Dict[str, Any]:
    out = copy.deepcopy(node)
    _labels(out.get("metadata", {}), forward)
    status = out.get("status") or {}
    for field in ("capacity", "allocatable"):
        if status.get(field):
            status[field] = _rename_keys(status[field], lambda k: _resource(k, forward))
    return out


def _daemonset(ds: Dict[str, Any], forward: bool) -> Dict[str, Any]:
    out = copy.deepcopy(ds)
    _labels(out.get("metadata", {}), forward, rename=True)
    spec = out.get("spec") or {}
    match = (spec.get("selector") or {}).get("matchLabels")
    if match:
        _labels({"labels": match}, forward)
    _labels((spec.get("template") or {}).get("metadata") or {}, forward)
    return out


def _object_converter(kind: str, forward: bool) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    if kind == consts.CLUSTER_POLICY_KIND:
        return clusterpolicy_from_reference if forward else clusterpolicy_to_reference
    if kind == "Pod":
        return lambda o: _pod(o, forward)
    if kind == "Node":
        return lambda o: _node(o, forward)
    if kind == "DaemonSet":
        return lambda o: _daemonset(o, forward)
    return copy.deepcopy


def object_from_reference(obj: Dict[str, Any]) -> Dict[str, Any]:
    """One reference object as the port's, by its kind: a ClusterPolicy,
    pod, node or DaemonSet through its converter, any other kind copied."""
    return _object_converter(obj.get("kind", ""), True)(obj)


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
