"""Finding model and baseline suppression for the static-analysis plane.

Counterpart of ``horovod_tpu/analysis/findings.py``.  Every check in
:mod:`horovod_tpu_torch.analysis` -- the recording step auditor and the
AST repo lints -- reports :class:`Finding` rows.  A finding is
addressed by ``(rule, path, ident)``: the rule id, the file (or audited
config) it lives in, and a *stable identifier* (env-var name, enclosing
function, bucket index) that survives line-number drift.  Accepted
findings are suppressed through a baseline file whose every entry must
carry a one-line justification; an entry that stops matching anything is
itself reported, so the baseline cannot silently rot.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis result: a rule violation at a location.

    ``path`` is repo-relative for lints and the audited config name
    (e.g. ``step:powersgd_ef``) for step-audit findings; ``line`` is the
    source line for lints and ``None`` for step-audit findings, where
    ``ident`` carries the record or plan-leg address instead.
    """
    rule: str
    severity: str
    path: str
    ident: str
    message: str
    line: Optional[int] = None

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.ident)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule} {self.severity} {loc} [{self.ident}] " \
               f"{self.message}"


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    ident: str        # "*" matches any ident
    justification: str
    lineno: int

    def matches(self, f: Finding) -> bool:
        return (self.rule == f.rule and self.path == f.path
                and self.ident in ("*", f.ident))


def default_baseline_path() -> str:
    """``baseline.txt`` beside this module (the repo root's
    ``analysis_baseline.txt`` is the JAX tree's)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


def load_baseline(path: Optional[str] = None) -> List[BaselineEntry]:
    """Parse a baseline file: ``rule path ident  # justification`` per
    line.  The justification is REQUIRED -- an entry without one is a
    format error (a suppression nobody can defend should not exist)."""
    if path is None:
        path = default_baseline_path()
    if not os.path.exists(path):
        return []
    entries = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            body, sep, just = line.partition("#")
            just = just.strip()
            fields = body.split()
            if len(fields) != 3 or not sep or not just:
                raise ValueError(
                    f"{path}:{lineno}: baseline entries are "
                    f"'rule path ident  # justification' (justification "
                    f"required), got {raw.rstrip()!r}")
            entries.append(BaselineEntry(fields[0], fields[1], fields[2],
                                         just, lineno))
    return entries


def apply_baseline(findings: Sequence[Finding],
                   baseline: Iterable[BaselineEntry],
                   baseline_path: str = "<baseline>",
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed); a baseline entry that
    matched nothing is appended to ``kept`` as a warning so stale
    suppressions surface instead of lingering."""
    baseline = list(baseline)
    used = [False] * len(baseline)
    kept, suppressed = [], []
    for f in findings:
        hit = None
        for i, e in enumerate(baseline):
            if e.matches(f):
                hit = i
                break
        if hit is None:
            kept.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    for e, u in zip(baseline, used):
        if not u:
            kept.append(Finding(
                rule="analysis-stale-baseline", severity=WARNING,
                path=baseline_path, line=e.lineno,
                ident=f"{e.rule}:{e.path}:{e.ident}",
                message="baseline entry matched no finding; delete it "
                        f"(justification was: {e.justification!r})"))
    return kept, suppressed


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


def render_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "(no findings)"
    return "\n".join(f.render() for f in findings)
