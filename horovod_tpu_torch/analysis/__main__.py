"""CLI / CI gate: ``python -m horovod_tpu_torch.analysis [mode] [options]``.

Counterpart of ``python -m horovod_tpu.analysis``, with its modes, exit
code and output.  Modes (default ``--all``):

- ``--lint``: AST rules over the ``horovod_tpu_torch/`` source tree;
- ``--step-audit``: audit the reference step configurations in
  recording worlds of ``--world`` ranks on ``--device`` (plain DP, ZeRO-1,
  powersgd+EF, microbatches=2; the serving tp-decode step at full tp and
  on the post-shrink size, and the verify step; the 3-D trio -- TP,
  TP+ZeRO-1, TP+pipeline+micro -- on their own 2x2x2 meshes; then the
  hierarchical trio -- plain hier, hier+ZeRO-1, hier+EF-on-DCN -- with
  the world re-opened as a two-level layout of the same ranks) and
  cross-check emitted collectives against their plans;
- ``--all``: both.

``--device`` defaults as ``init()`` does: ``cuda``, and an error when
no GPU is visible; ``--device cpu`` audits on the CPU.

Findings matching ``horovod_tpu_torch/analysis/baseline.txt``
(``--baseline`` to override) are suppressed; exit status is 1 when
unsuppressed ERROR findings remain and 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List


def _parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="Static collective-consistency analysis "
                    "(step audit + repo lints).")
    parser.add_argument("--lint", action="store_true",
                        help="run the AST repo lints")
    parser.add_argument("--step-audit", action="store_true",
                        help="audit the reference step configs")
    parser.add_argument("--all", action="store_true",
                        help="run both layers (default)")
    parser.add_argument("--baseline", default=None, metavar="PATH",
                        help="baseline suppression file (default: "
                             "baseline.txt beside this module)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as JSON instead of text")
    parser.add_argument("--world", type=int, default=8,
                        help="ranks of the step audit's recording world "
                             "(default 8)")
    parser.add_argument("--device", default=None,
                        help="device of the audited steps (default: "
                             "init()'s, cuda; 'cpu' to audit on the CPU)")
    args = parser.parse_args(argv)
    if not (args.lint or args.step_audit or args.all):
        args.all = True
    if args.all:
        args.lint = args.step_audit = True
    return args


def _run_step_audit(world: int, device):
    """Audit the reference configs on ``device``: the flat pass, then the
    hierarchical configs on a two-level layout of the same ranks."""
    from .trace_audit import (HIER_CONFIGS, PARALLEL3D_CONFIGS,
                              SERVING_CONFIGS, audit_standard_configs)
    reports = audit_standard_configs(world=world, device=device)
    reports.update(audit_standard_configs(SERVING_CONFIGS, world=world,
                                          device=device))
    if world >= 8:
        reports.update(audit_standard_configs(PARALLEL3D_CONFIGS,
                                              world=world, device=device))
    if world >= 4 and world % 2 == 0:
        reports.update(audit_standard_configs(HIER_CONFIGS, world=world,
                                              device=device))
    return reports


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    from .findings import (Finding, apply_baseline, default_baseline_path,
                           errors, load_baseline, render_findings)

    findings: List[Finding] = []
    summaries = {}
    if args.step_audit:
        from ..core.device import resolve_device
        device = resolve_device(args.device)
        for config, report in _run_step_audit(args.world, device).items():
            findings.extend(report.findings)
            summaries[config] = report.summary
            if not args.as_json:
                print(report.render())
    if args.lint:
        from .lints import run_lints
        findings.extend(run_lints())

    baseline_path = args.baseline
    try:
        baseline = load_baseline(baseline_path)
    except ValueError as exc:
        print(f"baseline error: {exc}", file=sys.stderr)
        return 2
    kept, suppressed = apply_baseline(
        findings, baseline,
        baseline_path=os.path.relpath(
            baseline_path or default_baseline_path()))

    if args.as_json:
        print(json.dumps({
            "findings": [f.__dict__ for f in kept],
            "suppressed": [f.__dict__ for f in suppressed],
            "step_audit": summaries,
        }, indent=2, sort_keys=True))
    else:
        if kept:
            print(render_findings(kept))
        n_err = len(errors(kept))
        print(f"analysis: {n_err} error(s), "
              f"{len(kept) - n_err} warning(s), "
              f"{len(suppressed)} baseline-suppressed")
    return 1 if errors(kept) else 0


if __name__ == "__main__":
    sys.exit(main())
