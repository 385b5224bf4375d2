"""``lint-leg-derivation-outside-planner``: ad-hoc exchange-leg
structure built outside the planner.

Counterpart of ``horovod_tpu/analysis/lints/legplan.py``.  Every
exchange leg the runtime executes (and every tag the span
recorder and trace auditor see) must come from ONE source of truth: the
:class:`~horovod_tpu_torch.controller.fusion.ExchangePlan` IR produced by
``plan_exchange``.  A module that constructs ``ExchangeLeg`` rows by
hand, or passes a string literal where a planned leg row belongs
(``note_leg("...")``, ``leg="..."``), is deriving exchange structure in
a second place -- the executed legs, the auditor's expected multiset and
the span timeline can then silently disagree.  The planner itself
(``horovod_tpu_torch/controller/fusion.py``) and the span normalizer
(``horovod_tpu_torch/timeline/spans.py``) are exempt: the former is
where the rows are made, the latter is where string tags are legally
absorbed.  The
recorder's host-side timing API (``rec.span(..., leg=...)`` /
``rec.add(..., leg=...)``) is also exempt: those strings label wall-
clock attribution of host events and never claim wire bytes, so they
are not exchange structure.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..findings import Finding
from .base import LintContext, LintRule

# Files (repo-relative prefixes) allowed to build leg rows / eat tags.
_PLANNER_LAYER = ("horovod_tpu_torch/controller/fusion.py",
                  "horovod_tpu_torch/timeline/spans.py")


def _is_str_literal(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


class LegDerivationOutsidePlannerRule(LintRule):
    id = "lint-leg-derivation-outside-planner"
    severity = "error"
    description = ("exchange-leg structure (ExchangeLeg row or string "
                   "leg tag) built outside controller/fusion.py; derive "
                   "legs from plan_exchange so executors, auditor and "
                   "spans stay on one IR")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for sf in ctx.files:
            if sf.relpath.startswith(_PLANNER_LAYER):
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                name = func.attr if isinstance(func, ast.Attribute) \
                    else func.id if isinstance(func, ast.Name) else None
                if name == "ExchangeLeg":
                    findings.append(self.finding(
                        sf, f"ExchangeLeg:{node.lineno}",
                        "ExchangeLeg constructed outside the planner; "
                        "add/extend a plan family in controller/fusion.py "
                        "and take the row from plan_exchange",
                        line=node.lineno))
                    continue
                if name == "note_leg" and node.args \
                        and _is_str_literal(node.args[0]):
                    findings.append(self.finding(
                        sf, f"note_leg:{node.lineno}",
                        "note_leg called with a string tag; pass the "
                        "planned ExchangeLeg row from plan_exchange "
                        "instead of re-deriving the tag/payload here",
                        line=node.lineno))
                    continue
                if name in ("span", "add"):
                    continue  # recorder timing API: host labels, no bytes
                for kw in node.keywords:
                    if kw.arg == "leg" and _is_str_literal(kw.value):
                        findings.append(self.finding(
                            sf, f"leg=:{node.lineno}",
                            "string literal passed as leg=; thread the "
                            "planned ExchangeLeg row (or its .tag) from "
                            "plan_exchange instead",
                            line=node.lineno))
        return findings
