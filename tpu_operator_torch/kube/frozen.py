"""Read-only views for the informer store — the zero-copy read contract.

The port's copy of ``tpu_operator/kube/frozen.py``, as it is.

The reference's read path serves ``Get``/``List`` straight out of
client-go's shared watch cache, which hands every caller the SAME stored
object and relies on the convention that cached objects are never
mutated (controller-runtime cache docs; DeepCopy is explicit and
caller-paid). Our first cut deep-copied every object on every read to
make mutation safe — at fleet scale that copy tax dominates a reconcile
pass (BENCH_r05: 389.7 ms/pass at 1000 nodes, mostly ``copy.deepcopy``
of ~8k cached pods and 1k nodes per selector list).

This module gives the convention teeth instead of paying the tax:

* ``freeze(obj)`` builds a private, recursively read-only copy
  (``FrozenDict``/``FrozenList``) for the store — built once at watch
  ingest, shared by every read;
* any mutation of a frozen view raises ``FrozenObjectError`` — the
  write guard is ALWAYS on, so an unaudited mutator fails loudly in
  tests (the tier-1 suite runs entirely behind it) rather than silently
  corrupting shared cache state in production;
* writers opt into a private mutable copy with ``copy=True`` on
  ``get``/``list`` (the informer thaws for them) or by calling
  ``thaw(view)`` on a view they already hold.

The frozen types subclass ``dict``/``list`` so every read-side idiom
(``isinstance(x, dict)`` field walks, ``json.dumps``, ``==``,
iteration, ``sorted``) works unchanged at native speed; only the
mutating methods are overridden. ``copy.deepcopy``/``copy.copy`` of a
view deliberately produce PLAIN mutable structures — deep-copying a
cached object is exactly the "I want my own copy" intent.
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "FrozenDict",
    "FrozenList",
    "FrozenObjectError",
    "freeze",
    "thaw",
    "is_frozen",
]


class FrozenObjectError(TypeError):
    """Mutation attempted on a shared cached view.

    The object came from the informer cache without ``copy=True``; it is
    shared by every other reader (and IS the cache's state). Re-read
    with ``copy=True`` or ``thaw()`` it before mutating.
    """


def _blocked(name: str):
    def method(self, *a, **kw):
        raise FrozenObjectError(
            f"{type(self).__name__}.{name}(): this object is a shared "
            f"read-only view from the informer cache; pass copy=True to "
            f"get/list (or thaw() the view) before mutating"
        )

    method.__name__ = name
    return method


class FrozenDict(dict):
    """Dict whose mutators raise; reads are inherited (native speed)."""

    __slots__ = ()

    __setitem__ = _blocked("__setitem__")
    __delitem__ = _blocked("__delitem__")
    __ior__ = _blocked("__ior__")
    clear = _blocked("clear")
    pop = _blocked("pop")
    popitem = _blocked("popitem")
    update = _blocked("update")

    def setdefault(self, key, default=None):
        # reading an existing key through setdefault is a common
        # steady-state idiom (``meta.setdefault("labels", {})``); only
        # the inserting case is a mutation
        if key in self:
            return dict.__getitem__(self, key)
        raise FrozenObjectError(
            f"FrozenDict.setdefault({key!r}): would insert into a shared "
            f"read-only view from the informer cache; pass copy=True to "
            f"get/list (or thaw() the view) before mutating"
        )

    # "give me my own copy" intents produce PLAIN mutable structures
    def __deepcopy__(self, memo):
        return thaw(self)

    def __copy__(self):
        return dict(self)

    def copy(self):
        return dict(self)

    def __reduce__(self):
        # pickling a view must not smuggle frozen types across process
        # boundaries (multiprocessing, debug dumps)
        return (_rebuild_plain, (thaw(self),))


class FrozenList(list):
    """List whose mutators raise; reads are inherited (native speed)."""

    __slots__ = ()

    __setitem__ = _blocked("__setitem__")
    __delitem__ = _blocked("__delitem__")
    __iadd__ = _blocked("__iadd__")
    __imul__ = _blocked("__imul__")
    append = _blocked("append")
    clear = _blocked("clear")
    extend = _blocked("extend")
    insert = _blocked("insert")
    pop = _blocked("pop")
    remove = _blocked("remove")
    reverse = _blocked("reverse")
    sort = _blocked("sort")

    def __deepcopy__(self, memo):
        return thaw(self)

    def __copy__(self):
        return list(self)

    def copy(self):
        return list(self)

    def __reduce__(self):
        return (_rebuild_plain, (thaw(self),))


def _rebuild_plain(obj):
    return obj


def freeze(obj: Any) -> Any:
    """Recursively copy ``obj`` into read-only form. The result shares
    nothing with the input, so the store owns its structure outright."""
    if type(obj) is dict or type(obj) is FrozenDict:
        return FrozenDict((k, freeze(v)) for k, v in obj.items())
    if type(obj) is list or type(obj) is FrozenList:
        return FrozenList(freeze(v) for v in obj)
    if isinstance(obj, dict):
        return FrozenDict((k, freeze(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return FrozenList(freeze(v) for v in obj)
    return obj  # str/int/float/bool/None: immutable already


def thaw(obj: Any) -> Any:
    """Recursively copy ``obj`` (frozen or plain) into plain mutable
    dicts/lists — the explicit-copy path for read-modify-write callers."""
    if isinstance(obj, dict):
        return {k: thaw(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [thaw(v) for v in obj]
    return obj


def is_frozen(obj: Any) -> bool:
    return isinstance(obj, (FrozenDict, FrozenList))
