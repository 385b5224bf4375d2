"""Hysteresis/cooldown scale policy for the serving control plane.

Counterpart of ``horovod_tpu/serving/policy.py``, whole: plain numbers,
no mesh.  :class:`ScalePolicy` moves the per-engine control plane
(:class:`~.controlplane.ServingControlPlane`) along the tp ladder of its
ranks (``valid_tp_sizes``), and :class:`FleetPolicy` drives the fleet
scaler (:class:`~.controlplane.FleetScaler`).

The policy is the *brain* of the serving control plane: it
looks at one :class:`SLOSample` at a time (queue depth, windowed TTFT
p99, batch occupancy, fleet health) and emits a :class:`Decision`.  It
is deliberately free of any mesh machinery so it can be unit-tested
with plain numbers and swapped out (the control plane accepts any object
with ``decide``/``mark_applied``).

Decision precedence, highest first:

1. **Mandatory shrink** -- a rank in the serving mesh is dead (chaos
   ``kill@`` or a real preemption).  Bypasses hysteresis and cooldown:
   there is no point debouncing a dead device.
2. **Straggler eviction** -- the :class:`StragglerMonitor` eviction hook
   latched a rank whose lateness EWMA crossed the threshold.  Also
   bypasses cooldown; hysteresis lives in the EWMA itself.
3. **Voluntary grow** -- queue depth or TTFT p99 breached the SLO for
   ``hysteresis`` consecutive samples and the cooldown has elapsed.
4. **Voluntary shrink** -- occupancy stayed under the low-water mark
   with an empty queue for ``hysteresis`` consecutive samples, cooldown
   elapsed.

Targets only ever move along the *valid tp ladder*: sizes that divide
``num_heads``, ``num_kv_heads`` and ``ffn_hidden`` (the
``build_decode_step`` contract), capped by the surviving healthy device
count and the ``HOROVOD_CTL_MIN_TP``/``HOROVOD_CTL_MAX_TP`` envelope.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..core.config import _env_float, _env_int

__all__ = [
    "PolicyConfig",
    "SLOSample",
    "Decision",
    "ScalePolicy",
    "valid_tp_sizes",
    "FleetPolicyConfig",
    "FleetSample",
    "FleetPolicy",
]


def valid_tp_sizes(config, max_devices: int) -> list:
    """Power-of-two tp sizes <= ``max_devices`` accepted by
    ``build_decode_step`` for ``config`` (head/kv-head/ffn divisibility)."""
    sizes = []
    s = 1
    while s <= max_devices:
        if (config.num_heads % s == 0 and config.num_kv_heads % s == 0
                and config.ffn_hidden % s == 0):
            sizes.append(s)
        s *= 2
    return sizes


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs for :class:`ScalePolicy`; see ``from_env`` for the
    ``HOROVOD_CTL_*`` spellings."""

    interval_s: float = 0.25       # controller sampling cadence
    ttft_slo_s: float = 0.5        # TTFT p99 objective over the window
    queue_high: int = 8            # queue depth that counts as overload
    occupancy_low: float = 0.25    # occupancy under this + empty queue =
                                   # underload
    hysteresis: int = 2            # consecutive breach samples required
    cooldown_s: float = 1.0        # min seconds between voluntary moves
    evict_lateness_s: float = 0.25  # straggler EWMA eviction threshold
    drain_steps: int = 16          # decode-step budget for graceful drain
    min_tp: int = 1
    max_tp: int = 8

    @classmethod
    def from_env(cls) -> "PolicyConfig":
        d = cls()
        return cls(
            interval_s=_env_float("CTL_INTERVAL_S", d.interval_s),
            ttft_slo_s=_env_float("CTL_TTFT_SLO_S", d.ttft_slo_s),
            queue_high=_env_int("CTL_QUEUE_HIGH", d.queue_high),
            occupancy_low=_env_float("CTL_OCC_LOW", d.occupancy_low),
            hysteresis=_env_int("CTL_HYSTERESIS", d.hysteresis),
            cooldown_s=_env_float("CTL_COOLDOWN_S", d.cooldown_s),
            evict_lateness_s=_env_float("CTL_EVICT_LATENESS_S",
                                        d.evict_lateness_s),
            drain_steps=_env_int("CTL_DRAIN_STEPS", d.drain_steps),
            min_tp=_env_int("CTL_MIN_TP", d.min_tp),
            max_tp=_env_int("CTL_MAX_TP", d.max_tp),
        )


@dataclasses.dataclass(frozen=True)
class SLOSample:
    """One controller observation window, all host-side numbers."""

    now_s: float
    queue_depth: int
    ttft_p99_s: Optional[float]    # None when the window saw no TTFTs
    occupancy: float               # mean active-slot fraction, 0..1
    mesh_size: int
    mesh_ranks: Tuple[int, ...]    # global device ids serving right now
    healthy: Tuple[int, ...]       # global device ids still usable
    dead_ranks: Tuple[int, ...] = ()
    evict_candidate: Optional[Tuple[int, float]] = None  # (rank, lateness)
    # Radix prefix-cache hit rate 0..1 (None when the cache is off):
    # a policy can weigh a scale-down differently when most prefill is
    # being absorbed by cached pages.
    prefix_hit_rate: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Decision:
    action: str                    # "hold" | "grow" | "shrink" | "evict"
    reason: str
    target_size: Optional[int] = None
    evict_rank: Optional[int] = None

    @property
    def is_hold(self) -> bool:
        return self.action == "hold"


class ScalePolicy:
    """Hysteresis + cooldown debouncing around the valid-tp ladder."""

    def __init__(self, config: PolicyConfig, valid_sizes: Sequence[int]):
        self.config = config
        self.valid_sizes = sorted(
            s for s in valid_sizes
            if config.min_tp <= s <= config.max_tp)
        if not self.valid_sizes:
            raise ValueError(
                f"no valid tp sizes in [{config.min_tp}, {config.max_tp}] "
                f"from {sorted(valid_sizes)}")
        self._breach_high = 0
        self._breach_low = 0
        self._last_action_s = float("-inf")
        self._evicted = set()

    # -- ladder helpers ---------------------------------------------------
    def _fit(self, limit: int) -> Optional[int]:
        """Largest valid size <= ``limit``, or None."""
        ok = [s for s in self.valid_sizes if s <= limit]
        return ok[-1] if ok else None

    def _next_up(self, size: int, limit: int) -> Optional[int]:
        ok = [s for s in self.valid_sizes if size < s <= limit]
        return ok[0] if ok else None

    def _next_down(self, size: int) -> Optional[int]:
        ok = [s for s in self.valid_sizes if s < size]
        return ok[-1] if ok else None

    # -- the decision function --------------------------------------------
    def decide(self, s: SLOSample) -> Decision:
        cfg = self.config

        # 1. Dead rank in the serving mesh: mandatory resize onto the
        # survivors (possibly same size, if spare healthy devices exist).
        dead_in_mesh = [r for r in s.dead_ranks if r in s.mesh_ranks]
        if dead_in_mesh:
            target = self._fit(len(s.healthy))
            if target is None:
                return Decision("hold", "rank-dead:no-viable-size")
            return Decision("shrink", "rank-dead", target_size=target)

        # 2. Straggler eviction latched by the monitor hook.
        if s.evict_candidate is not None:
            rank, lateness = s.evict_candidate
            if rank in s.mesh_ranks and rank not in self._evicted:
                target = self._fit(len(s.healthy) - 1)
                if target is not None:
                    self._evicted.add(rank)
                    return Decision(
                        "evict",
                        f"straggler-lateness:{lateness:.3f}s",
                        target_size=target, evict_rank=rank)

        # 3/4. Voluntary moves: hysteresis counters + cooldown.
        overload = (s.queue_depth >= cfg.queue_high
                    or (s.ttft_p99_s is not None
                        and s.ttft_p99_s > cfg.ttft_slo_s))
        underload = (s.occupancy <= cfg.occupancy_low
                     and s.queue_depth == 0)
        self._breach_high = self._breach_high + 1 if overload else 0
        self._breach_low = self._breach_low + 1 if underload else 0

        cooled = s.now_s - self._last_action_s >= cfg.cooldown_s
        if self._breach_high >= cfg.hysteresis and cooled:
            target = self._next_up(s.mesh_size, len(s.healthy))
            if target is not None:
                return Decision("grow", "slo-breach", target_size=target)
        if self._breach_low >= cfg.hysteresis and cooled:
            target = self._next_down(s.mesh_size)
            if target is not None:
                return Decision("shrink", "underload", target_size=target)
        return Decision("hold", "steady")

    def mark_applied(self, decision: Decision, now_s: float) -> None:
        """Controller feedback: a decision was executed -- restart the
        cooldown clock and clear the breach counters."""
        if decision.is_hold:
            return
        self._last_action_s = now_s
        self._breach_high = 0
        self._breach_low = 0


# -- fleet-level policy (disaggregated serving) ----------------------------

@dataclasses.dataclass(frozen=True)
class FleetPolicyConfig:
    """Knobs for :class:`FleetPolicy` -- the fleet-level analogue of
    :class:`PolicyConfig`.  Where the per-engine policy moves ONE
    engine along the tp ladder, the fleet policy adds WHOLE decode
    engines (grow-by-adding-capacity); it never shrinks, because
    retiring an engine under live sessions is a migration problem the
    operator triggers explicitly."""

    interval_s: float = 0.25       # fleet controller cadence
    queue_high: int = 8            # fleet-wide queued requests = overload
    ttft_slo_s: float = 0.5        # fleet TTFT p99 objective
    hysteresis: int = 2            # consecutive breach samples required
    cooldown_s: float = 1.0        # min seconds between engine adds
    max_engines: int = 4           # hard capacity ceiling

    @classmethod
    def from_env(cls) -> "FleetPolicyConfig":
        d = cls()
        return cls(
            interval_s=_env_float("FLEET_INTERVAL_S", d.interval_s),
            queue_high=_env_int("FLEET_QUEUE_HIGH", d.queue_high),
            ttft_slo_s=_env_float("FLEET_TTFT_SLO_S", d.ttft_slo_s),
            hysteresis=_env_int("FLEET_HYSTERESIS", d.hysteresis),
            cooldown_s=_env_float("FLEET_COOLDOWN_S", d.cooldown_s),
            max_engines=_env_int("FLEET_MAX_ENGINES", d.max_engines),
        )


@dataclasses.dataclass(frozen=True)
class FleetSample:
    """One fleet-controller observation: sums/percentiles across every
    registered decode engine."""

    now_s: float
    queue_depth: int               # total queued across engines
    ttft_p99_s: Optional[float]    # fleet-wide windowed p99 (None = none)
    occupancy: float               # mean occupancy across engines
    engines: int                   # decode engines currently registered


class FleetPolicy:
    """Add-only engine scaling with the same hysteresis + cooldown
    debouncing :class:`ScalePolicy` uses -- a transient arrival burst
    must not commission hardware."""

    def __init__(self, config: Optional[FleetPolicyConfig] = None):
        self.config = config or FleetPolicyConfig.from_env()
        self._breach = 0
        self._last_action_s = float("-inf")

    def decide(self, s: FleetSample) -> Decision:
        cfg = self.config
        overload = (s.queue_depth >= cfg.queue_high
                    or (s.ttft_p99_s is not None
                        and s.ttft_p99_s > cfg.ttft_slo_s))
        self._breach = self._breach + 1 if overload else 0
        cooled = s.now_s - self._last_action_s >= cfg.cooldown_s
        if (self._breach >= cfg.hysteresis and cooled
                and s.engines < cfg.max_engines):
            return Decision("add-engine", "fleet-slo-breach",
                            target_size=s.engines + 1)
        return Decision("hold", "steady")

    def mark_applied(self, decision: Decision, now_s: float) -> None:
        if decision.is_hold:
            return
        self._last_action_s = now_s
        self._breach = 0
