"""Silent-data-corruption (SDC) guard: the in-step screen's policy.

The port's counterpart of ``horovod_tpu/core/guard.py``.  A flipped bit
or a NaN passes through every collective (the exchange does not check
values), poisons the error-feedback residuals and is committed for good.
This module is the host half of the defense:

* ``HOROVOD_GUARD=auto|1|0`` decides, when a train step is BUILT,
  whether it screens the gradients: a global nonfinite count and squared
  norm (``training._guard_screen_vec``, summed over the ranks in one
  extra 8-byte allreduce), and on a poisoned step the OLD parameters,
  optimizer state, error-feedback residuals and BatchNorm statistics
  kept bit for bit (``training._guard_select``).
* :class:`GuardPolicy` consumes each step's ``[nonfinite, grad_norm,
  skipped]`` row on the host, feeds the ``horovod_guard_*`` metric
  family, and raises :class:`~horovod_tpu_torch.core.exceptions.
  SustainedAnomalyError` after ``HOROVOD_GUARD_STREAK`` consecutive
  skips, so the elastic loop rolls the snapshot ledger back instead of
  spinning on a poisoned input.

``auto`` (the default) arms the guard only when corruption is plausibly
in play -- a corruption chaos kind (``bitflip`` / ``nan``) installed,
the desync checks on, the snapshot ledger on -- so a default step runs
no screen.  Latency and availability chaos kinds (``slow``, ``kill``,
...) do not arm it: they cannot corrupt values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .exceptions import SustainedAnomalyError

_TRUE = ("1", "on", "true", "yes")
_FALSE = ("0", "off", "false", "no")


def _config():
    from .state import global_state
    return global_state().config


def resolve_mode(config=None) -> bool:
    """Should a step built now screen its gradients?  ``1`` / ``0``
    force it; ``auto`` arms it when a corruption chaos kind is installed
    or any of ``check_desync`` / ``desync_check_steps`` /
    ``snapshot_steps`` is on.  Read once per step build, as in the JAX
    package (where the screen is part of the traced program)."""
    cfg = _config() if config is None else config
    mode = (getattr(cfg, "guard", "auto") or "auto").strip().lower() \
        if cfg is not None else "auto"
    if mode in _TRUE:
        return True
    if mode in _FALSE:
        return False
    if mode != "auto":
        raise ValueError(f"HOROVOD_GUARD must be auto|1|0, got {mode!r}")
    if cfg is None:
        return False
    if cfg.check_desync or cfg.desync_check_steps > 0 \
            or cfg.snapshot_steps > 0:
        return True
    from ..elastic import chaos
    return chaos.corruption_armed()


def step_guard(config=None) -> Tuple[bool, float]:
    """``(enabled, norm_limit)`` for the train-step builders."""
    cfg = _config() if config is None else config
    enabled = resolve_mode(cfg)
    limit = float(getattr(cfg, "guard_norm_limit", 0.0) or 0.0) \
        if cfg is not None else 0.0
    return enabled, limit


class GuardPolicy:
    """Host-side consumer of the guard rows.

    ``observe`` takes a step's ``[nonfinite, grad_norm, skipped]`` row
    (or the ``[k, 3]`` rows of a steps-per-execution window), updates the
    ``horovod_guard_*`` metrics and tracks the consecutive-skip streak.
    A streak reaching ``streak_limit`` raises
    :class:`SustainedAnomalyError`: skipping alone is not recovering the
    run, and the rollback ledger must engage.
    """

    def __init__(self, streak_limit: int = 3):
        self.streak_limit = max(1, int(streak_limit))
        self.streak = 0
        self.steps = 0
        self.skipped = 0

    def observe(self, rows) -> int:
        """Consume guard rows; returns how many steps were skipped."""
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        from ..timeline import metrics as _metrics
        reg = _metrics.registry()
        steps_c = reg.counter(
            "horovod_guard_steps_total",
            "Train steps screened by the SDC guard")
        skip_c = reg.counter(
            "horovod_guard_skipped_total",
            "Optimizer updates skipped by the SDC guard (poisoned steps)")
        skipped_here = 0
        last_norm = None
        for row in rows:
            self.steps += 1
            steps_c.inc()
            if float(row[2]) > 0.0:
                self.skipped += 1
                self.streak += 1
                skipped_here += 1
                skip_c.inc()
            else:
                self.streak = 0
            last_norm = float(row[1])
        if last_norm is not None:
            reg.gauge(
                "horovod_guard_grad_norm",
                "Global gradient-magnitude screen from the last guarded "
                "step (-1 when nonfinite)").set(
                last_norm if np.isfinite(last_norm) else -1.0)
        reg.gauge(
            "horovod_guard_streak",
            "Consecutive guard-skipped steps (rollback trips at "
            "HOROVOD_GUARD_STREAK)").set(float(self.streak))
        if self.streak >= self.streak_limit:
            raise SustainedAnomalyError(self.streak)
        return skipped_here


_policy: Optional[GuardPolicy] = None


def policy() -> GuardPolicy:
    """The process-wide policy (streak limit from the config)."""
    global _policy
    if _policy is None:
        cfg = _config()
        _policy = GuardPolicy(
            streak_limit=getattr(cfg, "guard_streak", 3) if cfg else 3)
    return _policy


def reset() -> None:
    """Drop the policy: the next :func:`policy` reads the config again
    (``init()``; tests)."""
    global _policy
    _policy = None
