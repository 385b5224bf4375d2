"""``lint-collective-outside-planner``: raw ``torch.distributed``
collectives in library code.

Counterpart of ``horovod_tpu/analysis/lints/planner.py``.  Every
cross-rank collective in library code must route through
``horovod_tpu_torch.collectives.ops`` (which resolves process sets,
applies wire codecs, counts the call and keeps the plan accountable) --
a raw ``dist.all_reduce`` in a feature module bypasses reduce-op
semantics, process-set membership, the exchange counters AND the step
auditor's plan model.  The exchange layer itself (``collectives/``,
``adasum/``) is exempt: it is where the raw calls are supposed to live.

A call or a bare reference (``dist.P2POp(dist.isend, ...)``) counts
through any alias of ``torch.distributed``: ``import torch.distributed
as d``, ``from torch import distributed``, ``torch.distributed.<op>``
after ``import torch``, and a name imported from it (``from
torch.distributed import all_reduce as ar``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from ..findings import Finding
from .base import LintContext, LintRule

_EXACT = frozenset({"send", "recv", "isend", "irecv", "reduce"})
_PREFIXES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
             "broadcast", "gather", "scatter")

# Directories (repo-relative prefixes) owning the raw calls.
_EXCHANGE_LAYER = ("horovod_tpu_torch/collectives/",
                   "horovod_tpu_torch/adasum/")

_DIST = "torch.distributed"


def is_collective_name(name: str) -> bool:
    return name in _EXACT or name.startswith(_PREFIXES)


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _aliases(tree: ast.AST):
    """``(module aliases, {local name: collective})``: the dotted names
    bound to ``torch.distributed`` anywhere in the module, and the names
    imported from it that are collectives."""
    mods: Set[str] = set()
    names: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _DIST:
                    mods.add(a.asname or _DIST)
                elif a.name == "torch" or a.name.startswith("torch."):
                    # ``import torch`` (or a submodule) binds ``torch``:
                    # ``torch.distributed`` is reachable through it.
                    if a.asname is None:
                        mods.add(_DIST)
                    elif a.name == "torch":
                        mods.add(f"{a.asname}.distributed")
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    mods.add(a.asname or "distributed")
                elif node.module == _DIST and is_collective_name(a.name):
                    names[a.asname or a.name] = a.name
    return mods, names


class CollectiveOutsidePlannerRule(LintRule):
    id = "lint-collective-outside-planner"
    severity = "error"
    description = ("raw torch.distributed collective invoked outside the "
                   "exchange layer (bypasses ops-layer process-set/codec "
                   "resolution, the exchange counters and the plan audit)")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for sf in ctx.files:
            if sf.relpath.startswith(_EXCHANGE_LAYER):
                continue
            mods, names = _aliases(sf.tree)
            if not mods and not names:
                continue
            seen = set()
            for node in ast.walk(sf.tree):
                op = None
                if isinstance(node, ast.Attribute) and \
                        is_collective_name(node.attr) and \
                        _dotted(node.value) in mods:
                    if isinstance(node.ctx, ast.Store):
                        continue
                    op = node.attr
                elif isinstance(node, ast.Name) and node.id in names and \
                        isinstance(node.ctx, ast.Load):
                    op = names[node.id]
                if op is None or (op, node.lineno) in seen:
                    continue
                seen.add((op, node.lineno))
                findings.append(self.finding(
                    sf, f"dist.{op}:{node.lineno}",
                    f"direct torch.distributed.{op} outside the exchange "
                    "layer; route through horovod_tpu_torch.collectives.ops",
                    line=node.lineno))
        return findings
