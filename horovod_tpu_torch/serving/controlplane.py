"""The serving control plane: the SLO-driven tp autoscaler and the fleet
scaler.

Counterpart of ``horovod_tpu/serving/controlplane.py``.
:class:`ServingControlPlane` closes the loop around one
:class:`~.engine.ServingEngine` on a tensor-parallel rank mesh: it
*samples* the SLO signals (queue depth, the windowed TTFT p99, batch
occupancy), *decides* through :class:`~.policy.ScalePolicy` (hysteresis
and cooldown), and *acts* by resizing the decode mesh through
:func:`~horovod_tpu_torch.elastic.run_loop.apply_resize`, the sequence
the elastic training loop runs after a re-rendezvous.  Transitions are
graceful: a **drain** (admission paused, every slot ``draining``, the
old mesh decoding for ``drain_steps`` so near-done requests finish
bitwise), then **suspend and re-prefill** (the rest freed and
re-prefilled from prompt + emitted tokens on the new mesh), and
**eviction** (a ``kill@`` rank resized away at once; a ``slow@`` rank
evicted when the :class:`~horovod_tpu_torch.timeline.straggler.
StragglerMonitor`'s lateness EWMA crosses ``HOROVOD_CTL_EVICT_LATENESS_S``).
Every decision lands in the ``horovod_ctl_*`` metric families and as a
``ctl`` span (legs ``ctl/<action>/<reason>``).

Where the reference runs one process over ``devices``, the port runs
one process a rank: ``ranks=`` (default: every rank of the world) stands
for ``devices=``, the mesh is the first ``size`` healthy of them
(``build_parallel_mesh(ranks=..., tp=size)``), and every rank of the
world builds the plane and calls :meth:`ServingControlPlane.serve`, in
lock-step (:mod:`.lockstep`): only the world's rank 0 reads the clock,
the policy, the chaos faults and the straggler monitor, and every loop
turn (and drain step) ends in its header, which carries the decision and
the fired faults.  A resize registers the new mesh's process sets on
every rank of the world, in the same order.  A rank outside the mesh
runs no decode step but keeps the scheduler, the pages' bookkeeping and
each request's tokens, so a grow can hand it any request.  Chaos faults
fire **virtually**, as in the reference (:class:`_VirtualFaults`): a
``kill`` marks the rank dead and the mesh leaves it, but its process
keeps running the loop (it never exits), and ``slow`` inflates the
rank's step walls fed to the monitor.

:class:`FleetScaler` (the reference's ``:525-616``) watches a fleet's
SLO signals summed across its decode engines, decides through
:class:`~.policy.FleetPolicy` and, on a sustained breach, commissions a
whole decode engine under live traffic (``fleet.add_decode_worker``),
each decision in the ``horovod_fleet_*`` families and a ``ctl`` span.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.state import global_state
from ..timeline import metrics as _metrics
from ..timeline import spans as _spans
from ..timeline.straggler import StragglerMonitor
from .engine import ServingEngine, ServingReport, _pct
from .policy import (Decision, FleetPolicy, FleetSample, PolicyConfig,
                     ScalePolicy, SLOSample, valid_tp_sizes)
from .scheduler import Request

__all__ = ["ControlPlaneReport", "FleetScaler", "ServingControlPlane"]


class _VirtualFaults:
    """The chaos spec over the plane's ranks: the injector's parser and
    its deterministic ``rank=any`` resolution, but never its ``on_step``
    (a real ``kill`` would ``os._exit(137)``).  Faults are keyed on the
    decode-step index and fired by the plane itself."""

    def __init__(self, spec: Optional[str], world: int):
        self.faults: list = []
        if spec:
            from ..elastic.chaos import ChaosInjector
            # rank=-1 matches no fault, so an on_step call could never
            # fire one for real.
            self.faults = ChaosInjector(spec, rank=-1, size=world).faults

    def due(self, step: int) -> List[int]:
        """The indices of the faults due at ``step``, latched fired."""
        out = [i for i, f in enumerate(self.faults)
               if not f.fired and f.step <= step]
        for i in out:
            self.faults[i].fired = True
        return out


class _MeshResizeState:
    """The elastic ``State`` carrier handed to ``apply_resize``:
    ``resize`` swaps the serving mesh, ``on_reset`` restores the
    suspended requests and reopens admission.  ``apply_resize`` logs a
    failed ``resize`` and goes on to ``on_reset``; here that failure is
    raised there instead, so no request is re-prefilled onto a mesh
    that did not come up."""

    def __init__(self, plane: "ServingControlPlane"):
        self._plane = plane
        self._error: Optional[BaseException] = None

    def resize(self, old_size: int, new_size: int):
        try:
            return self._plane._do_resize(old_size, new_size)
        except Exception as e:
            self._error = e
            raise

    def on_reset(self) -> None:
        if self._error is not None:
            raise self._error
        self._plane._on_reset()


@dataclasses.dataclass
class ControlPlaneReport:
    """One drill's outcome around the serving report.  ``lost_requests``
    must be 0: every admissible request completed on the mesh it started
    on or was re-prefilled and completed on a later one."""

    serving: ServingReport
    mesh_size_initial: int
    mesh_size_final: int
    decisions: List[dict]
    decision_counts: Dict[str, int]
    resizes: int
    evicted_ranks: List[int]
    dead_ranks: List[int]
    drained_completed: int
    drained_reprefilled: int
    drain_leaked_pages: int
    slo_violation_s: float
    lost_requests: int

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["serving"] = self.serving.as_dict()
        return d


class ServingControlPlane:
    """The autoscaling controller around one :class:`ServingEngine`.

    ``ranks``: the plane's ranks (default every rank of the world; the
    reference's ``devices``); the decode mesh is always the first
    ``size`` *healthy* of them, so kills and evictions shrink the pool
    and the policy's ladder (``valid_tp_sizes``) adapts.  ``policy``:
    any object with ``decide(sample)`` / ``mark_applied(decision,
    now_s)`` (tests script it); only rank 0 calls it.  ``engine_kwargs``
    go to the engine (``device=``, ``slots=``, ...).  Every rank of the
    world constructs the plane with the same arguments."""

    def __init__(self, config, params, *, ranks=None,
                 initial_tp: Optional[int] = None,
                 policy=None, policy_config: Optional[PolicyConfig] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 chaos_spec: Optional[str] = None, **engine_kwargs):
        self.config = config
        self.ranks = [int(r) for r in (
            ranks if ranks is not None else range(global_state().size))]
        self.policy_cfg = policy_config or PolicyConfig.from_env()
        sizes = valid_tp_sizes(config, len(self.ranks))
        self.policy = policy if policy is not None else ScalePolicy(
            self.policy_cfg, sizes)
        allowed = [s for s in sizes
                   if self.policy_cfg.min_tp <= s <= self.policy_cfg.max_tp]
        if initial_tp is None:
            initial_tp = allowed[-1] if allowed else sizes[-1]
        # Indices into ``ranks`` (the reference's device indices; the
        # chaos spec's ranks).
        self.healthy: List[int] = list(range(len(self.ranks)))
        self.mesh_ranks: List[int] = self.healthy[:initial_tp]
        self.dead: set = set()
        self.evicted: List[int] = []
        self.engine = ServingEngine(config, params,
                                    mesh=self._mesh(self.mesh_ranks),
                                    **engine_kwargs)
        self.monitor = monitor if monitor is not None else StragglerMonitor(
            world=len(self.ranks))
        self.monitor.add_eviction_hook(self.policy_cfg.evict_lateness_s,
                                       self._note_evict_candidate)
        self._evict_candidate: Optional[Tuple[int, float]] = None
        self._faults = _VirtualFaults(chaos_spec, len(self.ranks))
        self._slow: Dict[int, float] = {}   # rank -> per-step inflation
        self._handled_dead: set = set()
        self._pending: Optional[Tuple[List[int], List[Request]]] = None
        self._monitor_warmup = 1  # the first step on a mesh warms it up

        reg = _metrics.registry()
        self._m_decisions = reg.counter(
            "horovod_ctl_decisions_total",
            "Serving control-plane decisions by action",
            labelnames=("action",))
        self._m_resizes = reg.counter(
            "horovod_ctl_resizes_total",
            "Decode-mesh resizes executed by the control plane",
            labelnames=("direction",))
        self._m_evictions = reg.counter(
            "horovod_ctl_evictions_total",
            "Ranks removed from the serving fleet by the control plane",
            labelnames=("reason",))
        self._m_drained = reg.counter(
            "horovod_ctl_drained_requests_total",
            "In-flight requests carried through a resize, by drain path",
            labelnames=("path",))
        self._m_violation = reg.counter(
            "horovod_ctl_slo_violation_seconds_total",
            "Seconds the sampled SLO (TTFT p99 / queue depth) was in "
            "violation")
        self._m_mesh_size = reg.gauge(
            "horovod_ctl_mesh_size",
            "Current decode-mesh tensor-parallel size")
        self._m_healthy = reg.gauge(
            "horovod_ctl_healthy_ranks",
            "Devices the control plane still considers usable")
        self._m_ttft_p99 = reg.gauge(
            "horovod_ctl_ttft_p99_seconds",
            "Windowed TTFT p99 as sampled by the control plane")
        self._m_prefix_hit = reg.gauge(
            "horovod_ctl_prefix_hit_rate",
            "Radix prefix-cache hit rate as sampled by the control "
            "plane (0 when the cache is off)")
        self._m_mesh_size.set(len(self.mesh_ranks))
        self._m_healthy.set(len(self.healthy))

        # Drill bookkeeping (reset per serve()).
        self.decisions: List[dict] = []
        self._stats: Dict[str, Any] = {}

    @property
    def _leads(self) -> bool:
        """This rank reads the clock, policy, faults and monitor: the
        world's rank 0, or the only rank."""
        ls = self.engine._ls
        return ls is None or ls.leader

    # -- mesh helpers ------------------------------------------------------
    def _mesh(self, idx: Sequence[int]):
        """The tp mesh over the plane's ranks ``idx`` (collective over
        the world: every rank builds it)."""
        from ..parallel.mesh import build_parallel_mesh
        return build_parallel_mesh(ranks=[self.ranks[i] for i in idx],
                                   tp=len(idx))

    # -- monitor hook ------------------------------------------------------
    def _note_evict_candidate(self, rank: int, lateness_s: float) -> None:
        self._evict_candidate = (int(rank), float(lateness_s))

    # -- chaos (virtual firing) --------------------------------------------
    def _fire_faults(self, step: int) -> None:
        """Rank 0: fire the faults due at ``step``; the others apply
        them from the turn's header."""
        due = self._faults.due(step)
        if self.engine._ls is not None:
            self.engine._ls.note_faults(due)
        self._apply_faults(due)

    def _apply_faults(self, indices) -> None:
        rec = _spans.recorder()
        for i in indices:
            f = self._faults.faults[i]
            f.fired = True
            _metrics.registry().counter(
                "horovod_chaos_faults_total",
                "Faults fired by the chaos injector").inc()
            rec.add("ctl", 0.0, leg=f"ctl/fault/{f.kind}")
            if f.kind == "kill":
                if f.rank in self.healthy:
                    self.healthy.remove(f.rank)
                self.dead.add(f.rank)
                self._slow.pop(f.rank, None)
                # Forget its EWMA now: a dead rank stops reporting, and
                # a frozen stale EWMA would otherwise read as lateness.
                self.monitor.evict(f.rank)
                self._m_healthy.set(len(self.healthy))
            elif f.kind == "slow":
                # A degraded device, not a hiccup: the rank stays slow
                # until the monitor's EWMA gets it evicted.
                self._slow[f.rank] = float(f.secs)

    def _feed_monitor(self, step: int, step_s: float) -> None:
        if self._monitor_warmup > 0:
            # The first step on a (re)built mesh warms it up; its wall
            # says nothing about rank behavior.
            self._monitor_warmup -= 1
            return
        for r in self.mesh_ranks:
            if r in self.dead:
                continue  # a dead rank publishes nothing
            self.monitor.observe({
                "rank": r, "step": step, "t0_us": 0.0,
                "wall_s": step_s + self._slow.get(r, 0.0),
                "spans": {}, "legs": {}})

    # -- decode step (shared by the main loop and the drain) ---------------
    def _decode_once(self, now) -> float:
        # The engine's own round, so occupancy and TTFT bookkeeping stay
        # truthful.  The plane always runs plain decode: a draining mesh
        # is about to lose ranks, and a wider verify buys nothing there.
        return self.engine.decode_once(self._stats, now)

    # -- controller tick ---------------------------------------------------
    def _sample(self, now_s: float) -> SLOSample:
        sched = self.engine.scheduler
        p99 = None
        snap_fn = getattr(sched._m_ttft, "snapshot", None)
        if snap_fn is not None:
            curr = snap_fn()
            win = _metrics.histogram_window(curr, self._stats["ttft_base"])
            self._stats["ttft_base"] = curr
            p99 = _metrics.histogram_quantile(win, 0.99)
        prefix = getattr(self.engine, "_prefix", None)
        hit_rate = prefix.hit_rate if prefix is not None else None
        return SLOSample(
            now_s=now_s, queue_depth=len(sched.queue), ttft_p99_s=p99,
            occupancy=sched.occupancy, mesh_size=len(self.mesh_ranks),
            mesh_ranks=tuple(self.mesh_ranks),
            healthy=tuple(self.healthy),
            dead_ranks=tuple(sorted(self.dead)),
            evict_candidate=self._evict_candidate,
            prefix_hit_rate=hit_rate)

    def _decide(self, now_s: float) -> Optional[dict]:
        """Rank 0's tick: ``None`` inside the sampling interval, else the
        sample's SLO reading and the policy's decision."""
        st = self._stats
        if now_s - st["last_tick"] < self.policy_cfg.interval_s:
            return None
        sample = self._sample(now_s)
        violated = (sample.queue_depth >= self.policy_cfg.queue_high
                    or (sample.ttft_p99_s is not None
                        and sample.ttft_p99_s > self.policy_cfg.ttft_slo_s))
        return {"now_s": now_s, "violated": violated,
                "viol_s": max(now_s - st["last_tick"], 0.0),
                "p99": sample.ttft_p99_s, "hit": sample.prefix_hit_rate,
                "decision": self.policy.decide(sample)}

    def _tick(self, now) -> None:
        """End a loop turn: rank 0 decides, the header carries the
        decision (and the turn's faults and tokens) to every rank, and
        every rank records and applies it."""
        eng = self.engine
        ls = eng._ls
        tick = None
        if self._leads:
            tick = self._decide(now() if ls is None else ls.fresh())
        if ls is not None:
            hdr = eng.sync(tick)
            if not ls.leader:
                self._apply_faults(hdr["faults"])
                t = hdr["tick"]
                if t is not None:
                    t["decision"] = Decision(t.pop("action"),
                                             t.pop("reason"),
                                             target_size=t.pop(
                                                 "target_size"),
                                             evict_rank=t.pop("evict_rank"))
                tick = t
        if tick is None:
            return
        st = self._stats
        now_s = tick["now_s"]
        self._m_ttft_p99.set(tick["p99"] or 0.0)
        self._m_prefix_hit.set(tick["hit"] or 0.0)
        if tick["violated"]:
            st["slo_violation_s"] += tick["viol_s"]
            self._m_violation.inc(tick["viol_s"])
        st["last_tick"] = now_s
        decision = tick["decision"]
        self._m_decisions.labels(action=decision.action).inc()
        self.decisions.append({
            "step": st["decode_steps"], "now_s": round(now_s, 4),
            "action": decision.action, "reason": decision.reason,
            "target_size": decision.target_size,
            "evict_rank": decision.evict_rank})
        rec = _spans.recorder()
        self._evict_candidate = None  # consumed by this decision
        if decision.is_hold:
            rec.add("ctl", 0.0, leg="ctl/hold")
            return
        with rec.span("ctl", name=f"decision:{decision.action}",
                      leg=f"ctl/{decision.action}/{decision.reason}"):
            self._apply(decision, now)
        if self._leads:
            self.policy.mark_applied(decision, now_s)

    # -- decision execution ------------------------------------------------
    def _apply(self, decision: Decision, now) -> None:
        if decision.evict_rank is not None:
            r = decision.evict_rank
            if r in self.healthy:
                self.healthy.remove(r)
            self.evicted.append(r)
            self.monitor.evict(r)
            self._slow.pop(r, None)
            self._m_evictions.labels(reason="straggler").inc()
            self._m_healthy.set(len(self.healthy))
        if decision.reason.startswith("rank-dead"):
            for r in sorted(self.dead - self._handled_dead):
                self._handled_dead.add(r)
                self.monitor.evict(r)
                self._m_evictions.labels(reason="dead").inc()
        # A dead rank invalidates the old mesh: no completion drain,
        # straight to suspend + re-prefill on the survivors.  A grow adds
        # capacity now.  Only a voluntary shrink (and a straggler
        # eviction, whose old mesh is merely slow) earns the budget.
        hard = decision.reason.startswith("rank-dead")
        budget = 0 if (hard or decision.action == "grow") \
            else self.policy_cfg.drain_steps
        self._transition(decision, now, drain_budget=budget,
                         decode_ok=not hard)

    def _transition(self, decision: Decision, now, *,
                    drain_budget: int, decode_ok: bool) -> None:
        eng = self.engine
        sched = eng.scheduler
        st = self._stats
        old_ranks = list(self.mesh_ranks)
        new_ranks = self.healthy[:decision.target_size]

        sched.pause_admission()
        for slot in list(sched.active):
            sched.mark_draining(slot)
        done_before = len(st["completed"])
        steps = 0
        while sched.active and decode_ok and steps < drain_budget:
            self._decode_once(now)
            eng.sync()        # a drain step ends in a header too
            steps += 1
        finished = len(st["completed"]) - done_before
        st["drained_completed"] += finished
        if finished:
            self._m_drained.labels(path="completed").inc(finished)

        suspended = [sched.suspend(slot) for slot in sorted(sched.active)]
        st["drained_reprefilled"] += len(suspended)
        # Exact-release check: suspension freed every slot's pages, so a
        # sweep over the old pool must recover nothing.
        st["drain_leaked_pages"] += eng.cache.release_all()

        self._pending = (new_ranks, suspended)
        from ..elastic.run_loop import apply_resize
        if len(new_ranks) == len(old_ranks):
            # Same size, other ranks (a spare for a dead or evicted one):
            # apply_resize's size gate would skip the swap, so rebuild
            # first; it still runs on_reset.
            self._rebuild(new_ranks, direction="swap")
        apply_resize(_MeshResizeState(self), len(old_ranks),
                     len(new_ranks))

    def _do_resize(self, old_size: int, new_size: int) -> str:
        new_ranks, _ = self._pending
        direction = "grow" if new_size > old_size else "shrink"
        self._rebuild(new_ranks, direction=direction)
        return (f"serving mesh {direction} {old_size} -> {new_size} "
                f"(ranks {list(new_ranks)})")

    def _rebuild(self, new_ranks: List[int], *, direction: str) -> None:
        # Ranks leaving the mesh stop reporting; forget their EWMAs so a
        # stale-fast spare does not inflate everyone else's lateness.
        for r in set(self.mesh_ranks) - set(new_ranks):
            self.monitor.evict(r)
        self.mesh_ranks = list(new_ranks)
        self.engine.rebuild_mesh(self._mesh(new_ranks))
        self._monitor_warmup = 1  # the next step warms the new mesh
        self._m_resizes.labels(direction=direction).inc()
        self._m_mesh_size.set(len(new_ranks))
        self._stats["resizes"] += 1

    def _on_reset(self) -> None:
        if self._pending is None:
            return
        _, suspended = self._pending
        self._pending = None
        eng = self.engine
        sched = eng.scheduler
        st = self._stats
        for req in suspended:
            slot = sched.restore(req)
            st["last_tokens"][slot] = eng.re_prefill(slot, req)
            st["adapter_ids"][slot] = req.adapter_id
            self._m_drained.labels(path="reprefill").inc()
        sched.resume_admission()

    # -- the closed loop ---------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request]) -> ControlPlaneReport:
        """Run the request stream to completion under the control loop.
        At world > 1 every rank calls it with the same requests and
        returns the same report."""
        eng = self.engine
        sched = eng.scheduler
        ls = eng._ls
        mesh_size_initial = len(self.mesh_ranks)
        pending = sorted(requests, key=lambda r: r.arrival_s)
        rejected = 0
        waiting: List[Request] = []
        for req in pending:
            if req.prompt_len + req.max_new_tokens > eng.max_len:
                rejected += 1
                sched._m_requests.labels(event="rejected").inc()
            else:
                waiting.append(req)

        start = time.monotonic()
        skip = [0.0]

        def now() -> float:
            return time.monotonic() - start + skip[0]

        if ls is not None:
            ls.reset()
            now = ls.now
        snap_fn = getattr(sched._m_ttft, "snapshot", None)
        self.decisions = []
        self._stats = eng.new_state()
        self._stats.update({
            "last_tick": 0.0, "slo_violation_s": 0.0,
            "drained_completed": 0, "drained_reprefilled": 0,
            "drain_leaked_pages": 0, "resizes": 0,
            "ttft_base": snap_fn() if snap_fn is not None else None})
        st = self._stats
        forwards0 = eng._forwards
        i = 0

        while True:
            while i < len(waiting) and waiting[i].arrival_s <= now():
                sched.submit(waiting[i])
                i += 1
            if not sched.has_work():
                if i >= len(waiting):
                    break
                if ls is None:
                    gap = waiting[i].arrival_s - now()
                    if gap > 0:
                        skip[0] += gap
                elif ls.leader:
                    gap = waiting[i].arrival_s - ls.fresh()
                    if gap > 0:
                        ls.skip += gap
                self._tick(now)
                continue

            for slot, req in sched.admit(now()):
                st["prefills"] += 1
                first = eng._do_prefill(slot, req, torch.tensor(
                    np.asarray(req.prompt), dtype=torch.long,
                    device=eng.device))
                req.tokens.append(first)
                eng.note_first_token(slot, req, now)
                st["last_tokens"][slot] = first
                st["adapter_ids"][slot] = req.adapter_id
                if req.finished:
                    st["completed"].append(sched.release(slot, now()))

            if sched.active:
                step = st["decode_steps"] + 1
                if self._leads:
                    self._fire_faults(step)
                step_s = self._decode_once(now)
                if self._leads:
                    self._feed_monitor(step, step_s)
            self._tick(now)

        wall_s = max(time.monotonic() - start if ls is None else ls.wall,
                     1e-9)
        completed = st["completed"]
        new_tokens = sum(len(r.tokens) for r in completed)
        ttfts = [r.ttft_s for r in completed if r.ttft_s is not None]
        lats = [lat for r in completed for lat in r.token_latencies]
        serving = ServingReport(
            num_requests=len(requests), completed=len(completed),
            rejected=rejected,
            prompt_tokens=sum(r.prompt_len for r in completed),
            new_tokens=new_tokens, wall_s=wall_s,
            decode_steps=st["decode_steps"], prefills=st["prefills"],
            tokens_per_s=new_tokens / wall_s,
            ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
            token_latency_p50_s=_pct(lats, 50),
            token_latency_p99_s=_pct(lats, 99),
            mean_occupancy=(float(np.mean(st["occ_samples"]))
                            if st["occ_samples"] else 0.0),
            prefill_forwards=eng._forwards - forwards0)
        counts: Dict[str, int] = {}
        for d in self.decisions:
            counts[d["action"]] = counts.get(d["action"], 0) + 1
        return ControlPlaneReport(
            serving=serving,
            mesh_size_initial=mesh_size_initial,
            mesh_size_final=len(self.mesh_ranks),
            decisions=list(self.decisions),
            decision_counts=counts,
            resizes=st["resizes"],
            evicted_ranks=list(self.evicted),
            dead_ranks=sorted(self.dead),
            drained_completed=st["drained_completed"],
            drained_reprefilled=st["drained_reprefilled"],
            drain_leaked_pages=st["drain_leaked_pages"],
            slo_violation_s=st["slo_violation_s"],
            lost_requests=(len(requests) - rejected - len(completed)))


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
        """Sample, decide and apply (one process: :meth:`decide` then
        :meth:`apply`)."""
        decision = self.decide(now_s)
        self.apply(decision, now_s)
        return decision

    def decide(self, now_s: float) -> Decision:
        """Sample the fleet and decide, recording the decision (but a
        hold inside the interval) in ``decisions``; the fleet is not
        changed.  In lock-step only the leader decides: the record rides
        the turn's header, every other rank takes it (:meth:`adopt`), and
        every rank carries it out (:meth:`apply`)."""
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
        return decision

    def adopt(self, record: dict, slo_violation_s: float) -> Decision:
        """A rank other than the leader: take the leader's decision
        record and violation total from the header; returns the
        decision to :meth:`apply`."""
        self.decisions.append(dict(record))
        self.slo_violation_s = float(slo_violation_s)
        return Decision(record["action"], record["reason"],
                        record["target_size"])

    def apply(self, decision: Decision, now_s: float) -> None:
        """Carry a decision out: commission a decode engine (a hold does
        nothing)."""
        if decision.is_hold:
            return
        with _spans.recorder().span(
                "ctl", name=f"fleet:{decision.action}",
                leg=f"ctl/{decision.action}/{decision.reason}"):
            self.fleet.add_decode_worker(decision.reason)
        self.policy.mark_applied(decision, now_s)
