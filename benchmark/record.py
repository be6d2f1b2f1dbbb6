"""The program's kernel builders, wrapped to record what the entry ran.

The probes draw their inputs from fixed seeds of their own and build their
kernels through module-level builders (``flashattn.make_flash_fn``,
``membw.make_dma_copy_fn``, ``matmul.make_matmul_step``). Inside
``recording``, every function such a builder makes keeps the builder's
arguments and its first call's inputs and output, so that one call of the
cell's entry can be held against the plain reference at the widths it ran.
"""

from __future__ import annotations

import importlib
import inspect
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional


@dataclass
class Build:
    """One function a builder made, and what it did."""

    builder: str
    args: dict  # the builder's arguments, defaults applied
    first: Optional[tuple] = None  # (positional inputs, output) of the first call


def _wrap(real, name: str, builds: list):
    signature = inspect.signature(real)

    def build(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        made = real(*args, **kwargs)
        entry = Build(name, dict(bound.arguments))
        builds.append(entry)
        fn = made[0] if isinstance(made, tuple) else made

        def call(*a, **kw):
            out = fn(*a, **kw)
            if entry.first is None:
                entry.first = (a, out)
            return out

        return (call, *made[1:]) if isinstance(made, tuple) else call

    return build


@contextmanager
def recording(builders):
    """Record the builders ``[(module path, attribute), ...]`` while open;
    yields the list of ``Build`` they make, in order."""
    builds, saved = [], []
    try:
        for path, attr in builders:
            module = importlib.import_module(path)
            real = getattr(module, attr)
            saved.append((module, attr, real))
            setattr(module, attr, _wrap(real, attr, builds))
        yield builds
    finally:
        for module, attr, real in reversed(saved):
            setattr(module, attr, real)


def off_widths(builds: list, expected: int, wanted) -> int:
    """Called builds whose builder and arguments ``wanted`` refuses, plus
    how far the number of called builds is from ``expected``."""
    called = [b for b in builds if b.first is not None]
    return sum(not wanted(b.builder, b.args) for b in called) + abs(expected - len(called))
