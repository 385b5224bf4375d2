"""Layer-2 lint framework: AST rules over the ``horovod_tpu_torch/`` tree.

Counterpart of ``horovod_tpu/analysis/lints/base.py``.  Each rule is a
:class:`LintRule` reporting
:class:`~horovod_tpu_torch.analysis.findings.Finding` rows against
repo-relative paths.  The :class:`LintContext` parses every package
source file once and shares the ASTs across rules; docs are exposed for
registry-style rules (env vars must appear in ``docs/api.md`` or
README's port table).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence

from ..findings import Finding


@dataclasses.dataclass
class SourceFile:
    relpath: str       # repo-relative, forward slashes
    source: str
    tree: ast.AST


class LintContext:
    """Parsed view of the package tree (plus docs) the rules run over."""

    def __init__(self, pkg_dir: Optional[str] = None,
                 repo_root: Optional[str] = None):
        if pkg_dir is None:
            pkg_dir = os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.pkg_dir = pkg_dir
        self.repo_root = repo_root or os.path.dirname(pkg_dir)
        self.files: List[SourceFile] = []
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                with open(path) as f:
                    source = f.read()
                rel = os.path.relpath(path, self.repo_root).replace(
                    os.sep, "/")
                self.files.append(SourceFile(
                    relpath=rel, source=source,
                    tree=ast.parse(source, filename=rel)))

    def read_doc(self, relpath: str) -> Optional[str]:
        path = os.path.join(self.repo_root, relpath)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()


class LintRule:
    """Base rule: subclasses set ``id``/``severity``/``description`` and
    implement :meth:`run`."""
    id: str = ""
    severity: str = "error"
    description: str = ""

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, sf_or_path, ident: str, message: str,
                line: Optional[int] = None) -> Finding:
        path = sf_or_path.relpath if isinstance(sf_or_path, SourceFile) \
            else sf_or_path
        return Finding(rule=self.id, severity=self.severity, path=path,
                       ident=ident, message=message, line=line)


def all_rules() -> List[LintRule]:
    from .envreg import EnvRegistryRule
    from .kernel_tests import KernelParityTestRule
    from .legplan import LegDerivationOutsidePlannerRule
    from .locks import UnlockedSharedStateRule
    from .nondeterminism import NondeterminismInStepRule
    from .planner import CollectiveOutsidePlannerRule
    return [UnlockedSharedStateRule(), NondeterminismInStepRule(),
            CollectiveOutsidePlannerRule(),
            LegDerivationOutsidePlannerRule(), EnvRegistryRule(),
            KernelParityTestRule()]


def run_lints(pkg_dir: Optional[str] = None,
              repo_root: Optional[str] = None,
              rules: Optional[Sequence[LintRule]] = None) -> List[Finding]:
    """Run every (or the given) lint rule over the package tree."""
    ctx = LintContext(pkg_dir=pkg_dir, repo_root=repo_root)
    findings: List[Finding] = []
    for rule in (rules if rules is not None else all_rules()):
        findings.extend(rule.run(ctx))
    findings.sort(key=lambda f: (f.path, f.line or 0, f.rule, f.ident))
    return findings


def rule_catalogue() -> Dict[str, str]:
    """``{rule id: description}`` for docs/CLI help."""
    return {r.id: r.description for r in all_rules()}
