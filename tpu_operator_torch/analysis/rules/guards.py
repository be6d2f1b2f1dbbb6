"""guarded-by — inferred lock/attribute consistency within a class.

Contract encoded: the breaker/pipeline thread-safety discipline —
when a class owns a ``threading.Lock``/``RLock``, the mutable state it
protects is whatever the class itself mutates under ``with self._lock``.
Any OTHER mutation of those same attributes outside a lock block in the
same class is a latent race: two threads interleaving a guarded and an
unguarded write.

Inference, per class owning at least one lock:

1. collect every attribute the class WRITES (assignment, augmented
   assignment, ``del``, or an in-place container mutator like
   ``.append``/``.pop``/``.update``) under a held lock, outside
   ``__init__``/``__new__`` — that is the guarded set, tagged with the
   lock(s) it was seen under;
2. flag writes to guarded attributes with no lock held. ``__init__`` is
   exempt (the object is not yet shared); closures reset the held set
   (they run on other threads).

Unlocked READS of guarded attributes are only flagged with
``guarded_by_strict_reads = true``: single-word reads of counters and
flags are GIL-atomic and idiomatic here (the breaker's lock-free fast
path is deliberate and documented) — flagging them would bury the
write findings that matter.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule
from tpu_operator_torch.analysis.rules import (
    MUTATOR_METHODS,
    ClassLocks,
    Rule,
    collect_class_locks,
    dotted,
    root_self_attr,
)
from tpu_operator_torch.analysis.rules.heldwalk import HeldWalker

INIT_METHODS = {"__init__", "__new__", "__init_subclass__"}

# (attr, line, held, method)
_Access = Tuple[str, int, Tuple[str, ...], str]


class _AccessCollector(HeldWalker):
    def __init__(self, resolve, lock_attrs: Set[str], method: str):
        super().__init__(resolve)
        self.lock_attrs = lock_attrs
        self.method = method
        self.writes: List[_Access] = []
        self.reads: List[_Access] = []

    def _note_write(self, attr: Optional[str], node: ast.AST, held):
        if attr is not None and attr not in self.lock_attrs:
            self.writes.append((attr, node.lineno, held, self.method))

    def on_node(self, node: ast.AST, held) -> None:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                self._note_targets(target, node, held)
        elif isinstance(node, ast.AugAssign):
            self._note_targets(node.target, node, held)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                self._note_write(root_self_attr(target), node, held)
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in MUTATOR_METHODS
            ):
                self._note_write(root_self_attr(func.value), node, held)
        elif isinstance(node, ast.Attribute) and isinstance(
            node.ctx, ast.Load
        ):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr not in self.lock_attrs
            ):
                self.reads.append((node.attr, node.lineno, held, self.method))

    def _note_targets(self, target: ast.AST, node: ast.AST, held) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._note_targets(elt, node, held)
            return
        self._note_write(root_self_attr(target), node, held)


class GuardedByRule(Rule):
    id = "guarded-by"

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        findings: List[Finding] = []
        for cls in [
            n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)
        ]:
            findings.extend(self._check_class(cls, mod, config))
        return findings

    def _check_class(
        self, cls: ast.ClassDef, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        locks = collect_class_locks(cls)
        if not locks.locks:
            return []

        def resolve(expr: ast.AST) -> Optional[str]:
            path = dotted(expr)
            if path and path.startswith("self."):
                return locks.resolve(path[len("self.") :])
            return None

        writes: List[_Access] = []
        reads: List[_Access] = []
        suffix = config.locked_method_suffix
        for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
            if fn.name in INIT_METHODS:
                continue
            collector = _AccessCollector(resolve, locks.all_attrs, fn.name)
            # caller-holds-lock convention: a *_locked method runs with
            # the owning lock already held
            initial = ("<caller>",) if suffix and fn.name.endswith(suffix) else ()
            collector.walk_function(fn, initial)
            writes.extend(collector.writes)
            reads.extend(collector.reads)

        guarded: Dict[str, Set[str]] = {}
        for attr, _line, held, _m in writes:
            if held:
                guarded.setdefault(attr, set()).update(held)

        findings: List[Finding] = []
        for attr, line, held, method in writes:
            if held or attr not in guarded:
                continue
            under = "/".join(sorted(guarded[attr]))
            findings.append(
                Finding(
                    self.id,
                    mod.relpath,
                    line,
                    f"'{attr}' is written under '{under}' elsewhere in "
                    f"{cls.name} but written here with no lock held",
                    scope=f"{cls.name}.{method}",
                )
            )
        if config.guarded_by_strict_reads:
            for attr, line, held, method in reads:
                if held or attr not in guarded:
                    continue
                under = "/".join(sorted(guarded[attr]))
                findings.append(
                    Finding(
                        self.id,
                        mod.relpath,
                        line,
                        f"'{attr}' is guarded by '{under}' in {cls.name} "
                        f"but read here with no lock held",
                        scope=f"{cls.name}.{method}",
                    )
                )
        return findings
