"""lock-blocking — blocking calls made while a lock is held.

Contract encoded: locks in this codebase bound CRITICAL SECTIONS, not
I/O. A thread that sleeps, blocks on a ``WriteFuture.result()``, drains
a pipeline, or performs a client/gRPC round-trip while holding a lock
convoys every other thread needing that lock behind an unbounded wait —
the shape behind both the write pipeline's stall-watchdog trips and classic
holding-the-informer-lock-across-a-LIST bugs.

Flagged under a held lock:

* calls whose dotted path is in ``blocking_functions`` (default
  ``time.sleep``; a bare ``sleep`` counts when the module does
  ``from time import sleep``);
* method calls named in ``blocking_methods`` (default ``result``,
  ``drain``, ``join_all``, ``urlopen``, ``getresponse``) plus ``wait``
  / ``wait_for`` — EXCEPT on the held lock's own condition, which is
  the one correct lock-releasing wait
  (``with self._cond: self._cond.wait()``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule
from tpu_operator_torch.analysis.rules import (
    Rule,
    collect_class_locks,
    collect_module_locks,
    dotted,
)
from tpu_operator_torch.analysis.rules.heldwalk import HeldWalker

COND_WAITS = {"wait", "wait_for"}


class _BlockingCollector(HeldWalker):
    def __init__(self, resolve, config: AnalysisConfig, bare_sleep: bool):
        super().__init__(resolve)
        self.config = config
        self.bare_sleep = bare_sleep
        # (line, description, held)
        self.hits: List[Tuple[int, str, Tuple[str, ...]]] = []

    def on_node(self, node: ast.AST, held) -> None:
        if not held or not isinstance(node, ast.Call):
            return
        path = dotted(node.func)
        if path in self.config.blocking_functions or (
            self.bare_sleep and path == "sleep"
        ):
            self.hits.append((node.lineno, f"{path}()", held))
            return
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
            if name in COND_WAITS:
                # the held lock's own condition-wait releases the lock —
                # that is the idiom, not a violation
                if self.resolve(node.func.value) in held:
                    return
                self.hits.append((node.lineno, f".{name}()", held))
            elif name in self.config.blocking_methods:
                self.hits.append((node.lineno, f".{name}()", held))


class LockBlockingRule(Rule):
    id = "lock-blocking"

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        prefix = mod.modname.rsplit(".", 1)[-1] if mod.modname else mod.relpath
        module_locks = collect_module_locks(mod.tree)
        bare_sleep = any(
            isinstance(n, ast.ImportFrom)
            and n.module == "time"
            and any(a.name == "sleep" for a in n.names)
            for n in ast.walk(mod.tree)
        )

        def module_resolve(expr: ast.AST) -> Optional[str]:
            path = dotted(expr)
            if path in module_locks:
                return f"{prefix}.{path}"
            return None

        findings: List[Finding] = []
        class_nodes = set()
        for cls in [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]:
            for child in ast.walk(cls):
                class_nodes.add(id(child))
            locks = collect_class_locks(cls)

            def resolve(expr: ast.AST, _locks=locks, _cls=cls):
                path = dotted(expr)
                if path and path.startswith("self."):
                    attr = _locks.resolve(path[len("self.") :])
                    if attr is not None:
                        return f"{prefix}.{_cls.name}.{attr}"
                return module_resolve(expr)

            for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
                findings.extend(
                    self._collect(
                        fn, resolve, mod, config, bare_sleep,
                        f"{cls.name}.{fn.name}",
                    )
                )
        for fn in [
            n
            for n in ast.walk(mod.tree)
            if isinstance(n, ast.FunctionDef) and id(n) not in class_nodes
        ]:
            findings.extend(
                self._collect(fn, module_resolve, mod, config, bare_sleep, fn.name)
            )
        return findings

    def _collect(
        self, fn, resolve, mod, config, bare_sleep, scope
    ) -> List[Finding]:
        collector = _BlockingCollector(resolve, config, bare_sleep)
        suffix = config.locked_method_suffix
        initial = (
            ("<caller>",)
            if suffix and getattr(fn, "name", "").endswith(suffix)
            else ()
        )
        collector.walk_function(fn, initial)
        return [
            Finding(
                self.id,
                mod.relpath,
                line,
                f"blocking call {desc} while holding "
                f"{'/'.join(sorted(set(held)))}",
                scope=scope,
            )
            for line, desc, held in collector.hits
        ]
