"""frozen-view — mutation of zero-copy informer read results.

Contract encoded: the informer read discipline (docs/cache.md) — informer
``get``/``list`` return SHARED frozen views (``kube/frozen.py``);
writers opt in explicitly via ``copy=True`` or ``thaw()``. Mutating a
view raises ``FrozenObjectError`` at runtime *if* the code path runs
against the cached client — but paths exercised only against FakeClient
or live reads hide the bug until production. This rule finds the shape
statically.

Per-function taint tracking, deliberately simple and in-order:

* ``x = <recv>.get/list/list_scoped/get_or_none(...)`` taints ``x``
  when the receiver looks informer-backed (``frozen_receivers`` regex,
  default ``client|cache|informer|store``) and the call does not pass
  ``copy=True``;
* taint propagates through subscripts/attributes of tainted names,
  ``.get/.items/.values/.keys`` calls on them, and ``for`` loop
  variables iterating a tainted expression (elements of a frozen list
  are frozen);
* ``thaw(x)``, ``deepcopy(x)``, ``dict(x)``, ``list(x)`` launder the
  taint; any other reassignment clears it;
* flagged: assignment/augmented-assignment/``del`` into a subscript or
  attribute rooted at a tainted name, and in-place container mutators
  (``.update``, ``.append``, ``.pop``, ``.setdefault``, ...) called on
  one — plus the same rooted directly at an unassigned frozen call.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule
from tpu_operator_torch.analysis.rules import MUTATOR_METHODS, Rule, dotted, root_name

FROZEN_CALLS = {"get", "list", "list_scoped", "get_or_none"}
PROPAGATING_CALLS = {"get", "items", "values", "keys"}
LAUNDERING_CALLS = {"thaw", "deepcopy", "dict", "list", "sorted", "copy"}


class _FnChecker:
    def __init__(self, rule_id: str, mod: ParsedModule, config: AnalysisConfig, scope: str):
        self.rule_id = rule_id
        self.mod = mod
        self.scope = scope
        self.recv_re = re.compile(config.frozen_receivers, re.IGNORECASE)
        self.config = config
        # var name -> origin description
        self.tainted: Dict[str, str] = {}
        self.findings: List[Finding] = []

    # -- taint sources -------------------------------------------------
    def _frozen_call_origin(self, node: ast.AST) -> Optional[str]:
        """Origin text when ``node`` is an informer read without
        copy=True, else None."""
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in FROZEN_CALLS
        ):
            return None
        recv = dotted(node.func.value) or ""
        if not self.recv_re.search(recv):
            return None
        for kw in node.keywords:
            if kw.arg == "copy" and (
                isinstance(kw.value, ast.Constant) and kw.value.value
            ):
                return None
        return f"{recv}.{node.func.attr}() at line {node.lineno}"

    def _taint_of(self, node: ast.AST) -> Optional[str]:
        """Origin if evaluating ``node`` yields a frozen view."""
        origin = self._frozen_call_origin(node)
        if origin is not None:
            return origin
        if isinstance(node, ast.Name):
            return self.tainted.get(node.id)
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            base = root_name(node)
            if isinstance(base, ast.Name):
                return self.tainted.get(base.id)
            if isinstance(base, ast.Call):
                return self._frozen_call_origin(base)
            return None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            func = node.func
            if func.attr in LAUNDERING_CALLS:
                return None
            if func.attr in PROPAGATING_CALLS:
                return self._taint_of(func.value)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id in LAUNDERING_CALLS:
                return None
        return None

    # -- mutation checks -----------------------------------------------
    def _check_mutation_target(self, target: ast.AST, line: int) -> None:
        """A store/delete INTO a subscript/attribute of a frozen view."""
        if not isinstance(target, (ast.Subscript, ast.Attribute)):
            return
        base = root_name(target)
        origin = None
        if isinstance(base, ast.Name):
            origin = self.tainted.get(base.id)
            what = base.id
        elif isinstance(base, ast.Call):
            origin = self._frozen_call_origin(base)
            what = "<informer read>"
        else:
            return
        if origin is not None:
            self.findings.append(
                Finding(
                    self.rule_id,
                    self.mod.relpath,
                    line,
                    f"mutates zero-copy informer view '{what}' "
                    f"(from {origin}) — read with copy=True or thaw() first",
                    scope=self.scope,
                )
            )

    def _check_expr(self, node: Optional[ast.AST]) -> None:
        """Find mutator-method calls on tainted roots anywhere in an
        expression tree."""
        if node is None:
            return
        for sub in ast.walk(node):
            if not (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in MUTATOR_METHODS
            ):
                continue
            base = root_name(sub.func.value)
            origin = None
            if isinstance(base, ast.Name):
                origin = self.tainted.get(base.id)
                what = base.id
            elif isinstance(base, ast.Call):
                origin = self._frozen_call_origin(base)
                what = "<informer read>"
            else:
                continue
            # .pop() on a dict/list mutates; but .get/.items on the same
            # object do not — MUTATOR_METHODS already encodes that split
            if origin is not None:
                self.findings.append(
                    Finding(
                        self.rule_id,
                        self.mod.relpath,
                        sub.lineno,
                        f"calls .{sub.func.attr}() on zero-copy informer "
                        f"view '{what}' (from {origin}) — read with "
                        f"copy=True or thaw() first",
                        scope=self.scope,
                    )
                )

    # -- taint updates -------------------------------------------------
    def _assign_names(self, target: ast.AST, origin: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            if origin is not None:
                self.tainted[target.id] = origin
            else:
                self.tainted.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_names(elt, origin)

    # -- statement walk ------------------------------------------------
    def run(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = _FnChecker(
                self.rule_id, self.mod, self.config,
                f"{self.scope}.{stmt.name}",
            )
            inner.run(stmt.body)
            self.findings.extend(inner.findings)
            return
        if isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                self._stmt(sub)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            value = stmt.value
            self._check_expr(value)
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            )
            for target in targets:
                self._check_mutation_target(target, stmt.lineno)
            origin = self._taint_of(value) if value is not None else None
            for target in targets:
                self._assign_names(target, origin)
            return
        if isinstance(stmt, ast.AugAssign):
            self._check_expr(stmt.value)
            self._check_mutation_target(stmt.target, stmt.lineno)
            return
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                self._check_mutation_target(target, stmt.lineno)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._check_expr(stmt.iter)
            self._assign_names(stmt.target, self._taint_of(stmt.iter))
            self.run(stmt.body)
            self.run(stmt.orelse)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._check_expr(stmt.test)
            self.run(stmt.body)
            self.run(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._check_expr(item.context_expr)
            self.run(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.run(stmt.body)
            for handler in stmt.handlers:
                self.run(handler.body)
            self.run(stmt.orelse)
            self.run(stmt.finalbody)
            return
        # Expr, Return, Raise, Assert, ...
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._check_expr(child)


class FrozenViewRule(Rule):
    id = "frozen-view"

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        checker = _FnChecker(self.id, mod, config, mod.modname or mod.relpath)
        checker.run(mod.tree.body)
        return checker.findings
