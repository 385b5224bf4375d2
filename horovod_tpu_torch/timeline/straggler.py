"""Straggler attribution over per-step span summaries.

The port's copy of ``horovod_tpu/timeline/straggler.py``.

The reference answers "which rank is late" with the timeline plus the
stall-check warning; at pod scale the question needs per-leg attribution
too.  :class:`StragglerMonitor` consumes the compact per-step summaries
the :class:`~horovod_tpu_torch.timeline.spans.SpanRecorder` emits -- locally
on every rank, and (under ``HOROVOD_TRACE_SYNC=1``) cross-rank on rank 0
via the KV trace plane -- and keeps:

* a per-rank step-wall EWMA; lateness = EWMA minus the fleet-fastest
  EWMA, the straggler is the rank with the largest lateness;
* per-step skew (slowest minus fastest wall among ranks that reported
  the step), fed into a histogram;
* the straggler's *dominant span kind* (dispatch gap vs exchange vs
  fence vs compute), naming WHERE the late rank spends its step.

Exports through the metrics registry::

    horovod_straggler_rank                  gauge
    horovod_straggler_lateness_seconds      gauge
    horovod_straggler_rank_wall_seconds     gauge{rank=...}
    horovod_step_skew_seconds               histogram
    horovod_step_skew_last_seconds          gauge

and logs a stall warning when a rank that has reported before goes
silent for longer than ``HOROVOD_STALL_CHECK_TIME_SECONDS`` (the same
knob the core stall inspector honours).

A controller attaches an *eviction hook*
(:meth:`StragglerMonitor.add_eviction_hook`): when the straggler's
lateness EWMA crosses the hook's threshold the callback fires once per
rank (latched), outside the monitor lock, and the controller answers by
draining that rank and calling :meth:`StragglerMonitor.evict` so
attribution continues over the survivors instead of pinning the dead
EWMA as straggler forever.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from .spans import dominant_span

logger = logging.getLogger("horovod_tpu_torch.timeline")

#: Skew histogram bounds (seconds): sub-ms jitter up to multi-second
#: stalls.
SKEW_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                5.0, 30.0)

#: Per-step observation window kept for skew computation.
_STEP_RING = 128


class StragglerMonitor:
    """Per-rank lateness EWMAs + per-step skew over span summaries."""

    def __init__(self, world: int = 1, alpha: float = 0.3,
                 stall_check_time: float = 60.0):
        self.world = max(1, int(world))
        self.alpha = float(alpha)
        self.stall_check_time = float(stall_check_time)
        self._lock = threading.Lock()
        self._ewma: Dict[int, float] = {}          # rank -> wall EWMA (s)
        self._last_summary: Dict[int, dict] = {}   # rank -> newest summary
        self._last_seen: Dict[int, float] = {}     # rank -> monotonic ts
        self._steps: "OrderedDict[int, Dict[int, float]]" = OrderedDict()
        self._warned_stalled: set = set()
        self.observations = 0
        self._evict_hooks: list = []   # (threshold_s, callback)
        self._evict_fired: set = set()  # ranks a hook already fired for
        self._evict_streak: tuple = (None, 0)  # (rank, consecutive evals)

    # -- ingestion --------------------------------------------------------
    def observe(self, summary: dict, now: Optional[float] = None) -> None:
        """Feed one per-step summary (any rank's).  Never raises."""
        try:
            rank = int(summary["rank"])
            step = int(summary["step"])
            wall = float(summary["wall_s"])
        except (KeyError, TypeError, ValueError):
            return
        mono = time.monotonic() if now is None else float(now)
        with self._lock:
            self.observations += 1
            prev = self._ewma.get(rank)
            self._ewma[rank] = wall if prev is None else \
                self.alpha * wall + (1.0 - self.alpha) * prev
            self._last_summary[rank] = summary
            self._last_seen[rank] = mono
            if rank in self._warned_stalled:
                self._warned_stalled.discard(rank)
            walls = self._steps.setdefault(step, {})
            walls[rank] = wall
            while len(self._steps) > _STEP_RING:
                self._steps.popitem(last=False)
            skew = (max(walls.values()) - min(walls.values())
                    if len(walls) >= 2 else None)
        self._export(skew)
        self._check_stalled(mono)
        self._check_eviction()

    # -- eviction hook (serving control plane) ----------------------------
    def add_eviction_hook(self, threshold_s: float, callback) -> None:
        """Fire ``callback(rank, lateness_s)`` once per rank when that
        rank SUSTAINS a lateness EWMA >= ``threshold_s``.

        Sustained means the rank stayed the over-threshold straggler
        through ``world`` consecutive evaluations (one evaluation per
        ``observe``), i.e. a full round of fleet reports.  Summaries
        arrive one rank at a time, so mid-round the EWMAs are unevenly
        updated and a shared transient (a recompile spike decaying out)
        makes each rank in turn look late -- the streak requirement
        filters that rotation, a genuinely slow rank keeps the flag
        while everyone else reports.  Callbacks run outside the monitor
        lock (they may call back into :meth:`evict` / :meth:`report`)
        and fire once per rank (latched)."""
        self._evict_hooks.append((float(threshold_s), callback))

    def evict(self, rank: int) -> None:
        """Forget a rank the controller removed from the fleet so the
        lateness attribution tracks the survivors.  The per-rank hook
        latch stays set -- an evicted rank is never re-flagged."""
        with self._lock:
            self._ewma.pop(rank, None)
            self._last_summary.pop(rank, None)
            self._last_seen.pop(rank, None)
            self._warned_stalled.discard(rank)
            for walls in self._steps.values():
                walls.pop(rank, None)
        if self._evict_streak[0] == rank:
            self._evict_streak = (None, 0)

    def _check_eviction(self) -> None:
        if not self._evict_hooks:
            return
        rep = self.report()
        rank = rep["straggler_rank"]
        lateness = float(rep["lateness_s"])
        min_thr = min(t for t, _ in self._evict_hooks)
        if rank is None or lateness < min_thr:
            self._evict_streak = (None, 0)
            return
        prev_rank, streak = self._evict_streak
        streak = streak + 1 if rank == prev_rank else 1
        self._evict_streak = (rank, streak)
        if rank in self._evict_fired or streak < self.world:
            return
        fired = False
        for threshold_s, callback in self._evict_hooks:
            if lateness >= threshold_s:
                fired = True
                try:
                    callback(rank, lateness)
                except Exception:  # hooks must never break the feed
                    logger.exception(
                        "straggler eviction hook failed for rank %d",
                        rank)
        if fired:
            self._evict_fired.add(rank)

    # -- metrics ----------------------------------------------------------
    def _export(self, skew: Optional[float]) -> None:
        try:
            from . import metrics as _metrics
            reg = _metrics.registry()
            rep = self.report()
            if rep["straggler_rank"] is not None:
                reg.gauge(
                    "horovod_straggler_rank",
                    "Rank with the largest step-wall EWMA lateness"
                ).set(float(rep["straggler_rank"]))
                reg.gauge(
                    "horovod_straggler_lateness_seconds",
                    "Straggler's EWMA step wall minus the fastest "
                    "rank's (0 on a single-rank feed)"
                ).set(float(rep["lateness_s"]))
                wall_fam = reg.gauge(
                    "horovod_straggler_rank_wall_seconds",
                    "Per-rank step-wall EWMA as observed by the "
                    "straggler monitor", labelnames=("rank",))
                for r, ewma in rep["per_rank_wall_s"].items():
                    wall_fam.labels(rank=str(r)).set(ewma)
            if skew is not None:
                reg.histogram(
                    "horovod_step_skew_seconds",
                    "Per-step wall-time skew across ranks (slowest "
                    "minus fastest)", buckets=SKEW_BUCKETS
                ).observe(float(skew))
                reg.gauge(
                    "horovod_step_skew_last_seconds",
                    "Most recent per-step cross-rank wall skew"
                ).set(float(skew))
        except Exception:  # metrics must never break the feed
            pass

    def _check_stalled(self, mono: float) -> None:
        if self.stall_check_time <= 0:
            return
        with self._lock:
            stale = [(r, mono - t) for r, t in self._last_seen.items()
                     if mono - t > self.stall_check_time
                     and r not in self._warned_stalled]
            for r, _ in stale:
                self._warned_stalled.add(r)
        for r, age in stale:
            logger.warning(
                "straggler monitor: rank %d has published no step "
                "summary for %.1fs (HOROVOD_STALL_CHECK_TIME_SECONDS="
                "%.0f) -- possible stalled or wedged rank", r, age,
                self.stall_check_time)

    # -- reporting --------------------------------------------------------
    def report(self) -> dict:
        """Current attribution: straggler rank, its lateness, dominant
        span kind, and the latest skew sample."""
        with self._lock:
            if not self._ewma:
                return {"straggler_rank": None, "lateness_s": 0.0,
                        "dominant_span": None, "skew_s": 0.0,
                        "per_rank_wall_s": {}}
            fastest = min(self._ewma.values())
            rank = max(self._ewma, key=lambda r: self._ewma[r])
            lateness = self._ewma[rank] - fastest
            last = self._last_summary.get(rank, {})
            skew = 0.0
            for walls in reversed(self._steps.values()):
                if len(walls) >= 2:
                    skew = max(walls.values()) - min(walls.values())
                    break
            return {
                "straggler_rank": rank,
                "lateness_s": lateness,
                "dominant_span": dominant_span(last),
                "skew_s": skew,
                "per_rank_wall_s": dict(sorted(self._ewma.items())),
            }

    def render(self) -> str:
        """Human-readable one-screen report (the CLI's footer)."""
        rep = self.report()
        if rep["straggler_rank"] is None:
            return "straggler: no observations"
        lines = [
            f"straggler: rank {rep['straggler_rank']} "
            f"(+{rep['lateness_s'] * 1e3:.2f} ms vs fastest, dominant "
            f"span: {rep['dominant_span']}, last skew "
            f"{rep['skew_s'] * 1e3:.2f} ms)"]
        for r, w in rep["per_rank_wall_s"].items():
            marker = "  <-- straggler" if r == rep["straggler_rank"] else ""
            lines.append(f"  rank {r}: ewma {w * 1e3:8.2f} ms{marker}")
        return "\n".join(lines)
