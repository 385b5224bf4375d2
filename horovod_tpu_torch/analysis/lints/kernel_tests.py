"""``lint-kernel-needs-parity-test``: every ported kernel family needs
its source and a parity test module.

Counterpart of ``horovod_tpu/analysis/lints/pallas_tests.py``.  A CUDA
kernel has no interpreter mode: on the CPU tier the only coverage a
family gets before the card is its wrapper's plain PyTorch version held
against the JAX package, so a wrapper module without such a test first
executes in production.  For ``ops/registry.py::KERNEL_CONTRACTS`` the
rule requires:

- each family's ``source`` to exist;
- each ``ops/csrc/*.cu`` to be some family's source (a kernel no family
  names has no launch counter and no contract);
- for each family, a ``tests/test_torch_*<stem>*.py`` that imports its
  wrapper module ``ops/<stem>.py`` (the module of its ``site``), as
  ``horovod_tpu_torch.ops.<stem>`` or ``from horovod_tpu_torch.ops
  import ... <stem>``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from ..findings import Finding
from .base import LintContext, LintRule, SourceFile

REGISTRY = "ops/registry.py"
CSRC = "ops/csrc"


def _contracts(sf: SourceFile) -> Dict[str, Tuple[dict, int]]:
    """``{family: (contract, line)}`` from the registry's literal
    ``KERNEL_CONTRACTS`` dict."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "KERNEL_CONTRACTS"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                out[ast.literal_eval(k)] = (ast.literal_eval(v), k.lineno)
            return out
    return {}


def test_sources(ctx: LintContext) -> Dict[str, str]:
    """``{filename: source}`` for every ``tests/test_*.py``."""
    tests_dir = os.path.join(ctx.repo_root, "tests")
    out: Dict[str, str] = {}
    if not os.path.isdir(tests_dir):
        return out
    for fname in sorted(os.listdir(tests_dir)):
        if fname.startswith("test_") and fname.endswith(".py"):
            with open(os.path.join(tests_dir, fname)) as f:
                out[fname] = f.read()
    return out


def _stem(contract: dict) -> Optional[str]:
    """The wrapper module's stem: ``ops.<stem>.<function>`` of the site."""
    parts = str(contract.get("site", "")).split()[0].split(".")
    return parts[1] if len(parts) >= 3 and parts[0] == "ops" else None


class KernelParityTestRule(LintRule):
    id = "lint-kernel-needs-parity-test"
    severity = "error"
    description = ("kernel family without its source, a CUDA source no "
                   "family names, or a family whose wrapper module no "
                   "tests/test_torch_*<module>*.py imports")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        pkg = os.path.relpath(ctx.pkg_dir, ctx.repo_root).replace(os.sep,
                                                                  "/")
        reg = next((sf for sf in ctx.files
                    if sf.relpath == f"{pkg}/{REGISTRY}"), None)
        if reg is None:
            return []
        contracts = _contracts(reg)
        findings: List[Finding] = []
        named = set()
        for family, (c, line) in sorted(contracts.items()):
            src = str(c.get("source", ""))
            named.add(src)
            if not os.path.exists(os.path.join(ctx.repo_root, src)):
                findings.append(self.finding(
                    reg, f"{family}:source",
                    f"kernel family {family!r} names source {src!r}, which "
                    "does not exist", line=line))
        csrc = os.path.join(ctx.pkg_dir, CSRC)
        for fname in sorted(os.listdir(csrc)) if os.path.isdir(csrc) else ():
            rel = f"{pkg}/{CSRC}/{fname}"
            if fname.endswith(".cu") and rel not in named:
                findings.append(self.finding(
                    rel, f"{fname}:unnamed",
                    f"{rel} is no kernel family's source in {REGISTRY}; "
                    "register it (and count its launches) or delete it"))
        tests = test_sources(ctx)
        for family, (c, line) in sorted(contracts.items()):
            stem = _stem(c)
            if stem is None:
                findings.append(self.finding(
                    reg, f"{family}:site",
                    f"kernel family {family!r} has no 'ops.<module>."
                    f"<function>' site", line=line))
                continue
            dotted = f"{pkg}.ops.{stem}".replace("/", ".")
            from_ops = re.compile(
                rf"from\s+{re.escape(pkg.replace('/', '.'))}\.ops\s+import"
                rf"[^\n]*\b{re.escape(stem)}\b")
            covered = any(
                fname.startswith("test_torch_") and stem in fname
                and (dotted in src or from_ops.search(src))
                for fname, src in tests.items())
            if not covered:
                findings.append(self.finding(
                    reg, family,
                    f"no tests/test_torch_*{stem}*.py imports {dotted}, the "
                    f"wrapper of kernel family {family!r}; a CUDA kernel is "
                    "CPU-covered only through its plain version's parity "
                    "test", line=line))
        return findings
