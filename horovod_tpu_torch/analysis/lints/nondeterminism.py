"""``lint-nondeterminism-in-step``: wall-clock / host-RNG reads inside
captured or compiled step bodies.

Counterpart of ``horovod_tpu/analysis/lints/nondeterminism.py``, where
"traced" means a ``jax.jit`` / ``shard_map`` / ``scan`` body.  Here it
means **captured into a CUDA graph or compiled**: the body of a ``with
torch.cuda.graph(...)`` block; a function passed to
``torch.cuda.make_graphed_callables``, ``torch.compile`` or
``torch.jit.trace`` / ``script``; and every function those bodies call
by name (``f(...)`` or ``self.f(...)``) in the same module, transitively.
A replay repeats the one host value baked in at capture -- and if ranks
capture independently, a DIFFERENT value per rank, which desyncs every
numeric path downstream.  The same calls are flagged as in the JAX rule
(``time.*``, ``datetime.now``, ``random.*``, ``np.random.*``);
``torch.Generator`` draws are fine, as ``jax.random`` is (a generator
registered with the graph advances on every replay).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from ..findings import Finding
from .base import LintContext, LintRule

# Entry points whose first (or fn=/model=) argument is captured or
# compiled.
_CAPTURE_ENTRY_ATTRS = {"make_graphed_callables", "compile", "trace",
                        "script"}

_TIME_ATTRS = {"time", "perf_counter", "monotonic", "process_time",
               "time_ns", "perf_counter_ns", "monotonic_ns"}
_DATETIME_ATTRS = {"now", "utcnow", "today"}


def _root_name(node: ast.AST) -> str:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def _attr_chain(node: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _nondeterminism(call: ast.Call) -> str:
    """Non-empty description when ``call`` reads host time/RNG."""
    chain = _attr_chain(call.func)
    if len(chain) < 2:
        return ""
    root, attrs = chain[0], chain[1:]
    root_l = root.lower().lstrip("_")
    leaf = attrs[-1]
    if root_l in ("time",) and leaf in _TIME_ATTRS:
        return f"wall-clock read {'.'.join(chain)}()"
    if root_l in ("datetime",) and leaf in _DATETIME_ATTRS:
        return f"wall-clock read {'.'.join(chain)}()"
    if root_l in ("random",):
        return f"host RNG {'.'.join(chain)}()"
    if root_l in ("np", "numpy") and len(attrs) >= 2 \
            and attrs[0] == "random":
        return f"host RNG {'.'.join(chain)}()"
    return ""


def _is_graph_block(node: ast.With) -> bool:
    """A ``with torch.cuda.graph(...)`` (or ``cuda.graph`` / ``graph``
    imported from it) block."""
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain[-1:] == ["graph"] and (len(chain) == 1
                                            or chain[-2] == "cuda"):
                return True
    return False


def _entry_names(tree: ast.AST) -> Set[str]:
    """Function NAMES passed to capture / compile entry points."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain or chain[-1] not in _CAPTURE_ENTRY_ATTRS:
            continue
        if chain[-1] in ("trace", "script") and "jit" not in chain:
            continue
        if chain[-1] == "compile" and chain[0] != "torch":
            continue
        cands = list(node.args[:1])
        cands += [kw.value for kw in node.keywords
                  if kw.arg in ("fn", "func", "model", "obj", "callables")]
        for arg in cands:
            if isinstance(arg, ast.Name):
                names.add(arg.id)
            elif (isinstance(arg, ast.Call)
                  and isinstance(arg.func, ast.Name)
                  and arg.func.id == "partial" and arg.args
                  and isinstance(arg.args[0], ast.Name)):
                names.add(arg.args[0].id)
    return names


def _called_names(nodes) -> Set[str]:
    """Names called as ``f(...)`` or ``self.f(...)`` under ``nodes``."""
    out: Set[str] = set()
    for root in nodes:
        for sub in ast.walk(root):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if isinstance(fn, ast.Name):
                out.add(fn.id)
            elif isinstance(fn, ast.Attribute) and \
                    isinstance(fn.value, ast.Name) and fn.value.id == "self":
                out.add(fn.attr)
    return out


def captured_regions(tree: ast.AST) -> List[Tuple[str, List[ast.AST]]]:
    """``[(label, statements)]`` captured or compiled in this module:
    each graph block (labelled ``graph@<line>``) and each function
    reached from a block or an entry point by name."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    regions: List[Tuple[str, List[ast.AST]]] = []
    todo = set(_entry_names(tree))
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and _is_graph_block(node):
            regions.append((f"graph@{node.lineno}", list(node.body)))
            todo |= _called_names(node.body)
    done: Set[str] = set()
    while todo:
        name = todo.pop()
        if name in done or name not in defs:
            continue
        done.add(name)
        for fn in defs[name]:
            regions.append((name, [fn]))
            todo |= _called_names([fn])
    return regions


class NondeterminismInStepRule(LintRule):
    id = "lint-nondeterminism-in-step"
    severity = "error"
    description = ("wall-clock or host-RNG call inside a CUDA-graph capture "
                   "or a compiled function (bakes a per-rank host value "
                   "into every replay)")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for sf in ctx.files:
            seen = set()
            for label, nodes in captured_regions(sf.tree):
                for root in nodes:
                    for sub in ast.walk(root):
                        if not isinstance(sub, ast.Call) or \
                                sub.lineno in seen:
                            continue
                        why = _nondeterminism(sub)
                        if why:
                            seen.add(sub.lineno)
                            findings.append(self.finding(
                                sf, f"{label}:{sub.lineno}",
                                f"{why} inside captured/compiled code "
                                f"({label}); thread the value in as a "
                                "tensor or draw from a torch.Generator",
                                line=sub.lineno))
        return findings
