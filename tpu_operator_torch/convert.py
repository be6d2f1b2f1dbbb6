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
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

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
