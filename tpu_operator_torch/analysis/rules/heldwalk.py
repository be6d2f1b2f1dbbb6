"""Shared lock-scope AST walker.

Walks a function body tracking which locks are statically held at each
node: ``with self._lock:`` pushes, leaving the block pops, and entering
a nested ``def``/``lambda`` RESETS the held set (a closure defined
under a lock does not execute under it — the manager's watchdog monitor
is exactly that shape). ``guards``, ``lockorder`` and ``blocking`` are
all views over this one traversal.
"""

from __future__ import annotations

import ast
from typing import Callable, List, Optional, Tuple

# resolve(context_expr) -> canonical lock name or None
Resolver = Callable[[ast.AST], Optional[str]]


class HeldWalker:
    """Subclass and override ``on_node`` / ``on_acquire``."""

    def __init__(self, resolve: Resolver):
        self.resolve = resolve

    # hooks ------------------------------------------------------------
    def on_node(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        pass

    def on_acquire(
        self,
        with_node: ast.With,
        held_before: Tuple[str, ...],
        acquired: List[Tuple[str, ast.expr]],
    ) -> None:
        """Called once per ``with`` that acquires at least one known
        lock, BEFORE its body is walked."""

    # traversal --------------------------------------------------------
    def walk_function(
        self, fn: ast.AST, initial: Tuple[str, ...] = ()
    ) -> None:
        """``initial`` seeds the held set — the caller-holds-lock
        (``*_locked``) convention passes a pseudo-lock here."""
        body = getattr(fn, "body", [])
        for stmt in body:
            self._walk(stmt, initial)

    def _walk(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[Tuple[str, ast.expr]] = []
            for item in node.items:
                self._walk(item.context_expr, held)
                lock = self.resolve(item.context_expr)
                if lock is not None:
                    acquired.append((lock, item.context_expr))
                if item.optional_vars is not None:
                    self._walk(item.optional_vars, held)
            if acquired and isinstance(node, ast.With):
                self.on_acquire(node, held, acquired)
            inner = held + tuple(lock for lock, _ in acquired)
            self.on_node(node, held)
            for stmt in node.body:
                self._walk(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.on_node(node, held)
            for dec in node.decorator_list:
                self._walk(dec, held)
            for stmt in node.body:
                self._walk(stmt, ())
            return
        if isinstance(node, ast.Lambda):
            self.on_node(node, held)
            self._walk(node.body, ())
            return
        self.on_node(node, held)
        for child in ast.iter_child_nodes(node):
            self._walk(child, held)
