"""``lint-unlocked-shared-state``: read-modify-write on shared attributes
without the owning lock, in modules that actually run threads.

The rule of ``horovod_tpu/analysis/lints/locks.py``, unchanged: it does
not depend on idiom.  Scope: modules importing ``threading`` whose
classes (or module body) start a ``Thread``.  Inside such a class, an
augmented assignment to a ``self`` attribute (``self._n += 1`` -- a
non-atomic read-modify-write) must sit under a ``with self...lock...``
block; the timeline registry, elastic coordinator and prefetcher all
follow that discipline, and this rule keeps new counters honest.
Plain assignments are exempt: a single store is atomic under the GIL
and is the documented poll pattern in ``data/prefetch.py``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..findings import Finding
from .base import LintContext, LintRule, SourceFile


def _is_thread_start(node: ast.AST) -> bool:
    """A ``threading.Thread(...)`` / ``Thread(...)`` construction."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread":
        return True
    return isinstance(fn, ast.Name) and fn.id == "Thread"


def _mentions_lock(node: ast.AST) -> bool:
    """A context-manager expression that names a lock (``self._lock``,
    ``self._cv``, ``_registry_lock`` ...)."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name and any(tok in name.lower()
                        for tok in ("lock", "_cv", "cond", "mutex")):
            return True
    return False


class _MethodScan(ast.NodeVisitor):
    """Walk one method body tracking whether we're under a lock ``with``."""

    def __init__(self):
        self.unlocked: List[ast.AugAssign] = []
        self._depth = 0

    def visit_With(self, node: ast.With) -> None:
        locked = any(_mentions_lock(item.context_expr)
                     for item in node.items)
        if locked:
            self._depth += 1
        self.generic_visit(node)
        if locked:
            self._depth -= 1

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        t = node.target
        if (self._depth == 0 and isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"):
            self.unlocked.append(node)
        self.generic_visit(node)

    # Nested defs get their own method scan via the class walk; don't
    # descend here (their lock context is their own).
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


class UnlockedSharedStateRule(LintRule):
    id = "lint-unlocked-shared-state"
    severity = "error"
    description = ("augmented assignment to a self attribute outside a "
                   "lock, in a class that runs a thread (non-atomic "
                   "read-modify-write on shared state)")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings = []
        for sf in ctx.files:
            if "threading" not in sf.source:
                continue
            findings.extend(self._scan_file(sf))
        return findings

    def _scan_file(self, sf: SourceFile) -> List[Finding]:
        out = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            runs_thread = any(_is_thread_start(sub)
                              for sub in ast.walk(node))
            if not runs_thread:
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                scan = _MethodScan()
                for stmt in item.body:
                    scan.visit(stmt)
                for aug in scan.unlocked:
                    attr = aug.target.attr  # type: ignore[union-attr]
                    out.append(self.finding(
                        sf, f"{node.name}.{item.name}:{attr}",
                        f"self.{attr} is read-modify-written outside a "
                        f"lock in threaded class {node.name}; wrap the "
                        "update in the owning lock",
                        line=aug.lineno))
        return out
