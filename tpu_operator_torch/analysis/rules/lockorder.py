"""lock-order — static acquisition-order graph over nested ``with``.

Contract encoded: the write pipeline / batch lanes / gang coordinator /
breaker stack is deadlock-free because lock acquisition follows a
consistent partial order. Every textually nested acquisition
(``with self._a: ... with self._b:``) contributes a directed edge
``a → b``; a cycle in the package-wide graph means two code paths
acquire the same pair of locks in opposite orders — a potential
deadlock even if the chaos suites never happened to interleave it.

Nodes are canonicalized per lock DECLARATION (``Class._attr`` /
``module._global``), not per instance: two instances of one class
acquired in inconsistent orders is exactly the hazard worth flagging.
Acquisitions that nest across call boundaries are invisible statically
— the runtime half (``analysis/lockwatch.py``) covers those inside the
chaos suites.

A nested re-acquisition of the SAME non-reentrant ``threading.Lock``
is flagged immediately (guaranteed self-deadlock, no graph needed).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tpu_operator_torch.analysis.config import AnalysisConfig
from tpu_operator_torch.analysis.engine import Finding, ParsedModule
from tpu_operator_torch.analysis.rules import (
    Rule,
    collect_class_locks,
    collect_module_locks,
    dotted,
)
from tpu_operator_torch.analysis.rules.heldwalk import HeldWalker

# edge -> first witness (path, line)
_Edges = Dict[Tuple[str, str], Tuple[str, int]]


class _EdgeCollector(HeldWalker):
    def __init__(self, resolve, relpath: str, rlocks: Set[str]):
        super().__init__(resolve)
        self.relpath = relpath
        self.rlocks = rlocks
        self.edges: _Edges = {}
        self.self_deadlocks: List[Tuple[str, int]] = []

    def on_acquire(self, with_node, held_before, acquired) -> None:
        # a multi-item `with self._a, self._b:` acquires left-to-right —
        # earlier items order before later ones exactly like nesting
        for i, (lock, expr) in enumerate(acquired):
            outers = list(held_before) + [a for a, _ in acquired[:i]]
            for outer in outers:
                if outer == lock:
                    if lock not in self.rlocks:
                        self.self_deadlocks.append((lock, with_node.lineno))
                    continue
                self.edges.setdefault(
                    (outer, lock), (self.relpath, with_node.lineno)
                )


class LockOrderRule(Rule):
    id = "lock-order"

    def __init__(self) -> None:
        self.edges: _Edges = {}

    def visit_module(
        self, mod: ParsedModule, config: AnalysisConfig
    ) -> List[Finding]:
        prefix = mod.modname.rsplit(".", 1)[-1] if mod.modname else mod.relpath
        module_locks = collect_module_locks(mod.tree)
        rlock_nodes: Set[str] = set()

        # module-level code outside classes
        def module_resolve(expr: ast.AST) -> Optional[str]:
            path = dotted(expr)
            if path in module_locks:
                return f"{prefix}.{path}"
            return None

        findings: List[Finding] = []
        classes = [
            n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)
        ]
        class_nodes: Set[int] = set()
        for cls in classes:
            for child in ast.walk(cls):
                class_nodes.add(id(child))
            locks = collect_class_locks(cls)
            for attr in locks.rlocks:
                rlock_nodes.add(f"{prefix}.{cls.name}.{attr}")

            def resolve(expr: ast.AST, _locks=locks, _cls=cls):
                path = dotted(expr)
                if path and path.startswith("self."):
                    attr = _locks.resolve(path[len("self.") :])
                    if attr is not None:
                        return f"{prefix}.{_cls.name}.{attr}"
                return module_resolve(expr)

            for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
                findings.extend(
                    self._collect(fn, resolve, mod, rlock_nodes, f"{cls.name}.{fn.name}")
                )

        # module-level functions (not inside any class)
        for fn in [
            n
            for n in ast.walk(mod.tree)
            if isinstance(n, ast.FunctionDef) and id(n) not in class_nodes
        ]:
            findings.extend(
                self._collect(fn, module_resolve, mod, rlock_nodes, fn.name)
            )
        return findings

    def _collect(
        self, fn, resolve, mod: ParsedModule, rlock_nodes: Set[str], scope: str
    ) -> List[Finding]:
        collector = _EdgeCollector(resolve, mod.relpath, rlock_nodes)
        collector.walk_function(fn)
        for edge, witness in collector.edges.items():
            self.edges.setdefault(edge, witness)
        out = []
        for lock, line in collector.self_deadlocks:
            out.append(
                Finding(
                    self.id,
                    mod.relpath,
                    line,
                    f"nested re-acquisition of non-reentrant lock "
                    f"'{lock}' — guaranteed self-deadlock",
                    scope=scope,
                )
            )
        return out

    def finalize(self, config: AnalysisConfig) -> List[Finding]:
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        findings: List[Finding] = []
        for scc in _sccs(adj):
            if len(scc) < 2:
                continue
            cycle = sorted(scc)
            witness_edges = sorted(
                (a, b, *self.edges[(a, b)])
                for (a, b) in self.edges
                if a in scc and b in scc
            )
            where = ", ".join(
                f"{a}->{b} at {path}:{line}" for a, b, path, line in witness_edges
            )
            path, line = witness_edges[0][2], witness_edges[0][3]
            findings.append(
                Finding(
                    self.id,
                    path,
                    line,
                    f"potential deadlock: lock-order cycle "
                    f"[{' <-> '.join(cycle)}] ({where})",
                    scope="lock-graph",
                )
            )
        # reset for potential re-runs within one process
        self.edges = {}
        return findings


def _sccs(adj: Dict[str, Set[str]]) -> List[Set[str]]:
    """Iterative Tarjan."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[Set[str]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj[nxt]))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                out.append(scc)
    return out
