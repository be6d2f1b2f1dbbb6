"""Rule registry + shared AST helpers.

Every rule encodes one contract the repo already states in docs or
enforces by hand-written tests; the catalog with the contract each rule
comes from is the reference's ``docs/analysis.md``. Rules are pure AST
walkers: no imports of the code under analysis, no execution. The port's
copy of ``tpu_operator/analysis/rules/``: the same six rules in the same
order, the package's name its only change (``layering.PKG``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule

LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "Lock",
    "RLock",
}
CONDITION_FACTORIES = {"threading.Condition", "Condition"}

# method names that mutate the common stdlib containers in place
MUTATOR_METHODS = {
    "append",
    "appendleft",
    "extend",
    "extendleft",
    "insert",
    "pop",
    "popitem",
    "popleft",
    "remove",
    "clear",
    "add",
    "discard",
    "update",
    "setdefault",
    "sort",
    "reverse",
}


class Rule:
    id = ""

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        return []

    def finalize(self, config: AnalysisConfig) -> List[Finding]:
        return []


def dotted(node: ast.AST) -> Optional[str]:
    """``self._lock`` / ``threading.Lock`` / ``time.sleep`` for pure
    Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_self_attr(node: ast.AST) -> Optional[str]:
    """First attribute hanging off ``self`` at the base of an
    Attribute/Subscript chain: ``self._chains[key].append`` → ``_chains``."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        node = node.value
    return None


def root_name(node: ast.AST) -> Optional[ast.AST]:
    """Base Name/Call of an Attribute/Subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node


class ClassLocks:
    """Lock-typed attributes a class owns, plus Condition aliases.

    ``self._idle = threading.Condition(self._lock)`` means ``with
    self._idle`` acquires ``_lock`` — the alias map folds the condition
    attribute onto the lock it wraps. A bare ``threading.Condition()``
    owns an internal lock, so the condition attribute is itself a lock
    node.
    """

    def __init__(self) -> None:
        self.locks: Dict[str, int] = {}  # attr -> decl line
        self.rlocks: Set[str] = set()
        self.alias: Dict[str, str] = {}  # cond attr -> lock attr

    def resolve(self, attr: str) -> Optional[str]:
        if attr in self.locks:
            return attr
        return self.alias.get(attr)

    @property
    def all_attrs(self) -> Set[str]:
        return set(self.locks) | set(self.alias)


def collect_class_locks(cls: ast.ClassDef) -> ClassLocks:
    out = ClassLocks()
    pending_conds: List[Tuple[str, Optional[str], int]] = []
    for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call
            ):
                continue
            call_path = dotted(node.value.func)
            for target in node.targets:
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    continue
                if call_path in LOCK_FACTORIES:
                    out.locks[target.attr] = node.lineno
                    if call_path and call_path.endswith("RLock"):
                        out.rlocks.add(target.attr)
                elif call_path in CONDITION_FACTORIES:
                    arg_attr = None
                    if node.value.args:
                        a = dotted(node.value.args[0])
                        if a and a.startswith("self."):
                            arg_attr = a[len("self.") :]
                    pending_conds.append((target.attr, arg_attr, node.lineno))
    for cond_attr, wrapped, line in pending_conds:
        if wrapped is not None and wrapped in out.locks:
            out.alias[cond_attr] = wrapped
        else:
            # a Condition over its own (or an unresolvable) lock is a
            # lock node in its own right
            out.locks[cond_attr] = line
            out.rlocks.add(cond_attr)  # Condition's default lock is an RLock
    return out


def collect_module_locks(tree: ast.Module) -> Dict[str, int]:
    """Module-level ``_corr_lock = threading.Lock()`` style globals."""
    out: Dict[str, int] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and dotted(node.value.func) in LOCK_FACTORIES
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = node.lineno
    return out


def iter_class_functions(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, ast.FunctionDef):
            yield node


def build_rules(config: AnalysisConfig) -> List[Rule]:
    from tpu_operator_torch.analysis.rules.blocking import LockBlockingRule
    from tpu_operator_torch.analysis.rules.frozenview import FrozenViewRule
    from tpu_operator_torch.analysis.rules.guards import GuardedByRule
    from tpu_operator_torch.analysis.rules.layering import LayeringRule
    from tpu_operator_torch.analysis.rules.lockorder import LockOrderRule
    from tpu_operator_torch.analysis.rules.metricsfed import MetricsFedRule

    return [
        LayeringRule(),
        GuardedByRule(),
        LockOrderRule(),
        LockBlockingRule(),
        FrozenViewRule(),
        MetricsFedRule(),
    ]
