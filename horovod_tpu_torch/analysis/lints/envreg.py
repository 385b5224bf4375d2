"""``lint-undocumented-env``: the env-var registry rule.

Counterpart of ``horovod_tpu/analysis/lints/envreg.py``, with the same
scan: any ``_env(...)`` / ``_env_bool/int/float(...)`` call site and any
literal ``os.environ`` access of a ``HOROVOD_`` / ``HVD_TPU_`` name
contributes a variable, and each must appear with its ``HOROVOD_``
spelling in the registry.  The registry is ``docs/api.md`` (the JAX
package's knobs, which the port shares) plus the table rows (lines
starting with ``|``) of README's port section, for the variables only
the port reads.  An env knob nobody can discover is a support burden.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

from ..findings import Finding
from .base import LintContext, LintRule

_ENV_CALL = re.compile(
    r'_env(?:_bool|_int|_float)?\(\s*"([A-Z][A-Z0-9_]*)"')
# Literal os.environ reads of a fully-prefixed name.  Writes (launcher
# code exporting identity to children) count too: the variable is part
# of the public surface either way.
_ENV_LITERAL = re.compile(
    r'(?:os\.environ(?:\.get)?[\[(]\s*|getenv\(\s*)"'
    r'(?:HOROVOD_|HVD_TPU_)([A-Z][A-Z0-9_]*)"')

DOC_PATH = "docs/api.md"
README_PATH = "README.md"
PORT_SECTION = "## PyTorch/CUDA port"


def scan_env_vars(ctx: LintContext) -> Dict[str, List[str]]:
    """``{canonical_name: [repo-relative file, ...]}`` for every
    HOROVOD_* env var read in the package (canonical = prefix-less)."""
    hits: Dict[str, List[str]] = {}
    for sf in ctx.files:
        names = set(_ENV_CALL.findall(sf.source)) \
            | set(_ENV_LITERAL.findall(sf.source))
        for name in sorted(names):
            hits.setdefault(name, []).append(sf.relpath)
    return hits


def port_table(readme: Optional[str]) -> str:
    """The table rows of README's port section (from its heading to the
    next ``## `` heading), ``""`` without one."""
    if not readme:
        return ""
    rows, inside = [], False
    for line in readme.splitlines():
        if line.startswith("## "):
            inside = line.startswith(PORT_SECTION)
            continue
        if inside and line.lstrip().startswith("|"):
            rows.append(line)
    return "\n".join(rows)


def read_env_vars(pkg_dir: str,
                  repo_root: Optional[str] = None) -> Dict[str, List[str]]:
    """Standalone scan over an arbitrary package dir (test fixtures)."""
    return scan_env_vars(LintContext(pkg_dir=pkg_dir, repo_root=repo_root))


class EnvRegistryRule(LintRule):
    id = "lint-undocumented-env"
    severity = "error"
    description = ("HOROVOD_* env var read in the package but absent "
                   "from the docs/api.md registry and README's port table")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        doc = ctx.read_doc(DOC_PATH)
        if doc is None:
            return [self.finding(DOC_PATH, "missing",
                                 f"{DOC_PATH} not found; the env registry "
                                 "has nowhere to live")]
        doc += "\n" + port_table(ctx.read_doc(README_PATH))
        hits = scan_env_vars(ctx)
        if not hits:
            return [self.finding("horovod_tpu_torch", "empty-scan",
                                 "scanner found no env reads -- the regex "
                                 "rotted")]
        findings = []
        for name, files in sorted(hits.items()):
            if "HOROVOD_" + name not in doc:
                findings.append(self.finding(
                    files[0], name,
                    f"HOROVOD_{name} is read in {', '.join(files)} but "
                    f"has no row in {DOC_PATH} or in {README_PATH}'s "
                    "port table"))
        return findings
