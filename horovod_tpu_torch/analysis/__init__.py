"""Static collective-consistency analysis for horovod_tpu_torch.

Counterpart of ``horovod_tpu/analysis``.  Two layers, one CLI:

- **step audit** (:mod:`.trace_audit`): run a step once on every rank of
  a recording world (the ``fake`` backend: collectives move nothing),
  record the collectives each rank dispatches, and cross-check them
  against the fusion/arena plan -- plus desync (two ranks' sequences
  differing), collectives inside kernel wrappers, and the per-device
  fence policy;
- **repo lints** (:mod:`.lints`): AST rules over the port's source
  (unlocked shared state in threaded modules, host nondeterminism in
  captured or compiled step bodies, raw collectives outside the exchange
  layer, leg rows built outside the planner, the env-var registry, the
  kernel families' parity tests).

CLI: ``python -m horovod_tpu_torch.analysis [--step-audit|--lint|--all]``;
exit code 1 when unsuppressed error findings remain.  Accepted findings
live in ``baseline.txt`` beside this module, one justified entry per
line.  The JAX ``audit-donation`` check has no counterpart: the port's
steps update in place and take no ``donate``.
"""

from .findings import (ERROR, WARNING, Finding, apply_baseline,
                       default_baseline_path, errors, load_baseline,
                       render_findings)
from .lints import read_env_vars, rule_catalogue, run_lints
from .stepmodel import ExpectedExchange, ExpectedOp, expected_exchange
from .trace_audit import (HIER_CONFIGS, PARALLEL3D_CONFIGS, SERVING_CONFIGS,
                          STANDARD_CONFIGS, AuditReport,
                          audit_standard_configs, audit_step,
                          build_standard_config)

__all__ = [
    "ERROR", "WARNING", "Finding", "apply_baseline",
    "default_baseline_path", "errors", "load_baseline", "render_findings",
    "read_env_vars", "rule_catalogue", "run_lints",
    "ExpectedExchange", "ExpectedOp", "expected_exchange",
    "HIER_CONFIGS", "PARALLEL3D_CONFIGS", "SERVING_CONFIGS",
    "STANDARD_CONFIGS", "AuditReport", "audit_standard_configs",
    "audit_step", "build_standard_config",
]
