"""AST repo lints (layer 2 of the static-analysis plane), over the
``horovod_tpu_torch/`` tree."""

from .base import (LintContext, LintRule, all_rules, rule_catalogue,
                   run_lints)
from .envreg import EnvRegistryRule, read_env_vars, scan_env_vars
from .kernel_tests import KernelParityTestRule
from .legplan import LegDerivationOutsidePlannerRule
from .locks import UnlockedSharedStateRule
from .nondeterminism import NondeterminismInStepRule
from .planner import CollectiveOutsidePlannerRule

__all__ = [
    "LintContext", "LintRule", "all_rules", "rule_catalogue", "run_lints",
    "EnvRegistryRule", "read_env_vars", "scan_env_vars",
    "UnlockedSharedStateRule", "NondeterminismInStepRule",
    "CollectiveOutsidePlannerRule", "LegDerivationOutsidePlannerRule",
    "KernelParityTestRule",
]
