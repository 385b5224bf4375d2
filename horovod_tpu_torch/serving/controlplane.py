"""The serving control plane: the fleet scaler.

Counterpart of ``horovod_tpu/serving/controlplane.py``'s
:class:`FleetScaler` (``:525-616``): a controller that watches a fleet's
SLO signals summed across its decode engines (queue depth, the windowed
TTFT p99, occupancy), decides through :class:`~.policy.FleetPolicy` and,
on a sustained breach, commissions a whole decode engine under live
traffic (``fleet.add_decode_worker``).  Every decision lands in the
``horovod_fleet_*`` metric families and as a ``ctl`` span.

The reference's per-engine :class:`ServingControlPlane` resizes one
engine's tensor-parallel decode mesh; the port has no tp > 1 (ROADMAP
item 1.12), so on one card its ladder is ``[1]`` and it raises.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..timeline import metrics as _metrics
from ..timeline import spans as _spans
from .policy import Decision, FleetPolicy, FleetSample

__all__ = ["FleetScaler", "ServingControlPlane"]


class ServingControlPlane:
    """Not ported: it resizes the tensor-parallel decode mesh, which
    needs ``parallel/tp.py`` (ROADMAP item 1.12)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ServingControlPlane resizes the tensor-parallel decode mesh "
            "and waits for tp > 1 (ROADMAP item 1.12); a fleet grows by "
            "whole engines through FleetScaler")


class FleetScaler:
    """Grow-by-adding-capacity controller for a disaggregated fleet.

    The fleet is duck-typed -- anything with ``schedulers()`` (name ->
    scheduler), ``num_engines`` and ``add_decode_worker(reason)`` -- so
    this module never imports :mod:`.fleet`.  TTFT p99 is windowed
    fleet-wide: every engine observes into the one
    ``horovod_serving_ttft_seconds`` histogram, and the scaler keeps a
    snapshot so each tick sees only the TTFTs since the last.
    """

    def __init__(self, fleet, policy: Optional[FleetPolicy] = None):
        self.fleet = fleet
        self.policy = policy or FleetPolicy()
        self.decisions: List[dict] = []
        self.slo_violation_s = 0.0
        self._last_tick = 0.0
        self._ttft_base: Any = None
        reg = _metrics.registry()
        self._m_decisions = reg.counter(
            "horovod_fleet_decisions_total",
            "Fleet scaler decisions by action", labelnames=("action",))
        self._m_violation = reg.counter(
            "horovod_fleet_slo_violation_seconds_total",
            "Cumulative seconds the fleet spent outside its SLO")
        self._m_ttft_p99 = reg.gauge(
            "horovod_fleet_ttft_p99_seconds",
            "Fleet-wide windowed TTFT p99 seen by the scaler")

    def _fleet_p99(self) -> Optional[float]:
        scheds = list(self.fleet.schedulers().values())
        if not scheds:
            return None
        snap_fn = getattr(scheds[0]._m_ttft, "snapshot", None)
        if snap_fn is None:
            return None
        curr = snap_fn()
        win = _metrics.histogram_window(curr, self._ttft_base)
        self._ttft_base = curr
        return _metrics.histogram_quantile(win, 0.99)

    def sample(self, now_s: float) -> FleetSample:
        scheds = self.fleet.schedulers()
        queued = sum(len(s.queue) for s in scheds.values())
        occ = (float(np.mean([s.occupancy for s in scheds.values()]))
               if scheds else 0.0)
        p99 = self._fleet_p99()
        self._m_ttft_p99.set(p99 or 0.0)
        return FleetSample(now_s=now_s, queue_depth=queued,
                           ttft_p99_s=p99, occupancy=occ,
                           engines=self.fleet.num_engines)

    def tick(self, now_s: float) -> Decision:
        cfg = self.policy.config
        if now_s - self._last_tick < cfg.interval_s:
            return Decision("hold", "interval")
        sample = self.sample(now_s)
        violated = (sample.queue_depth >= cfg.queue_high
                    or (sample.ttft_p99_s is not None
                        and sample.ttft_p99_s > cfg.ttft_slo_s))
        if violated:
            dt = max(now_s - self._last_tick, 0.0)
            self.slo_violation_s += dt
            self._m_violation.inc(dt)
        self._last_tick = now_s

        decision = self.policy.decide(sample)
        self._m_decisions.labels(action=decision.action).inc()
        self.decisions.append({
            "now_s": round(now_s, 4), "action": decision.action,
            "reason": decision.reason,
            "target_size": decision.target_size,
            "queue_depth": sample.queue_depth,
            "ttft_p99_s": sample.ttft_p99_s})
        if decision.is_hold:
            return decision
        with _spans.recorder().span(
                "ctl", name=f"fleet:{decision.action}",
                leg=f"ctl/{decision.action}/{decision.reason}"):
            self.fleet.add_decode_worker(decision.reason)
        self.policy.mark_applied(decision, now_s)
        return decision
