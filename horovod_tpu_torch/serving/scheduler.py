"""Continuous-batching request scheduler.

Counterpart of ``horovod_tpu/serving/scheduler.py``; pure Python, ported
as is.  The decode step has a FIXED batch shape (``slots`` sequences),
so throughput is a slot-occupancy game: the scheduler admits queued
requests into free slots the moment one opens, recycles a slot the
instant its request finishes, and gates admission on KV page
availability (:meth:`PagedKVCache.can_admit`), so an admitted request
can always run to completion.

Lifecycle: ``queued -> prefill -> decode -> done`` (plus the
``handoff``/``draining``/``suspended`` states the reference's fleet and
control plane use).  Every transition feeds the metrics registry:
``horovod_serving_requests_total{event}``,
``horovod_serving_tokens_total{phase}``, queue-depth / occupancy /
slot-state gauges, TTFT and per-token latency histograms, and the
per-tenant SLO families.  :class:`TenantClass` weights drive
stride-scheduled admission when tenant classes are configured; with
none the scheduler is strict FIFO.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..timeline.metrics import registry as _registry

# Per-token decode latencies sit well under the default step buckets'
# sweet spot; extend the low end so p50 lands inside a bucket.
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One SLO class in the multi-tenant scheduler.

    ``weight`` drives stride-scheduled admission (a tenant's share of
    admitted prefill+decode work is proportional to its weight under
    contention); ``max_share`` caps the fraction of decode slots the
    tenant may hold while OTHER tenants are queued (an adversarial
    flood cannot starve the batch); ``ttft_slo_s`` is the class's TTFT
    p99 budget -- the fairness gate."""

    name: str
    weight: float = 1.0
    ttft_slo_s: float = 1.0
    max_share: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if not 0.0 < self.max_share <= 1.0:
            raise ValueError(
                f"tenant {self.name}: max_share must be in (0, 1]")


def parse_tenant_classes(spec: str) -> Dict[str, TenantClass]:
    """``"name:weight[:ttft_slo_s[:max_share]],..."`` -> class map
    (the ``HOROVOD_TENANT_CLASSES`` wire format)."""
    out: Dict[str, TenantClass] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split(":")
        name = parts[0]
        weight = float(parts[1]) if len(parts) > 1 else 1.0
        slo = float(parts[2]) if len(parts) > 2 else 1.0
        share = float(parts[3]) if len(parts) > 3 else 1.0
        out[name] = TenantClass(name=name, weight=weight,
                                ttft_slo_s=slo, max_share=share)
    return out


@dataclasses.dataclass
class Request:
    """One inference request moving through the serving lifecycle."""

    rid: int
    prompt: np.ndarray                 # int32 [t]
    max_new_tokens: int
    adapter_id: int = 0
    arrival_s: float = 0.0             # open-loop arrival offset
    # queued|prefill|handoff|decode|draining|done
    state: str = "queued"
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    token_latencies: List[float] = dataclasses.field(default_factory=list)
    tenant: str = "default"            # SLO class (TenantClass.name)
    session_id: Optional[int] = None   # multi-turn warm-KV session key
    # Load-generator engine affinity hint (per-engine arrival skew in
    # fleet traffic shapes); None = the router decides freely.
    engine_hint: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s


class ContinuousBatchScheduler:
    """Admit/evict requests into a fixed-shape decode batch."""

    def __init__(self, slots: int, cache=None, token_budget: int = 1,
                 tenants: Optional[Dict[str, TenantClass]] = None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if token_budget < 1:
            raise ValueError(
                f"token_budget must be >= 1, got {token_budget}")
        self.slots = slots
        self.cache = cache
        # Worst-case tokens a slot can append in ONE step: 1 for plain
        # decode, k+1 under speculative decoding (k drafts + the
        # target's own token).  Admission must price this in or a
        # full-acceptance burst can oversubscribe KV pages mid-step.
        self.token_budget = token_budget
        self.queue: "collections.deque[Request]" = collections.deque()
        self.active: dict[int, Request] = {}
        self._free_slots = list(range(slots - 1, -1, -1))  # pop() -> 0, 1...
        self.admitting = True
        # Multi-tenant SLO classes: empty means single-tenant strict
        # FIFO, byte for byte.  With classes,
        # admission is stride-scheduled per tenant (weighted fair) and
        # per-tenant occupancy caps apply under contention.
        self.tenants: Dict[str, TenantClass] = dict(tenants or {})
        self._tenant_pass: Dict[str, float] = {}
        self._tenants_seen = {"default"} | set(self.tenants)
        reg = _registry()
        self._m_requests = reg.counter(
            "horovod_serving_requests_total",
            "Serving request lifecycle transitions", labelnames=("event",))
        self._m_tokens = reg.counter(
            "horovod_serving_tokens_total",
            "Tokens processed by the serving engine", labelnames=("phase",))
        self._m_queue = reg.gauge(
            "horovod_serving_queue_depth", "Requests waiting for a slot")
        self._m_occ = reg.gauge(
            "horovod_serving_batch_occupancy",
            "Live fraction of the fixed decode batch (0..1)")
        self._m_ttft = reg.histogram(
            "horovod_serving_ttft_seconds", "Time to first token",
            buckets=LATENCY_BUCKETS)
        self._m_tok_lat = reg.histogram(
            "horovod_serving_token_latency_seconds",
            "Per-output-token latency", buckets=LATENCY_BUCKETS)
        self._m_slot_states = reg.gauge(
            "horovod_serving_slot_states",
            "Decode-batch slots by lifecycle state",
            labelnames=("state",))
        self._m_spec = reg.counter(
            "horovod_serving_spec_tokens_total",
            "Speculative-decoding draft tokens by outcome",
            labelnames=("outcome",))
        # Per-tenant SLO families, registered alongside the slot-state
        # gauges so the control plane's policies can read them.
        self._m_ttft_tenant = reg.histogram(
            "horovod_serving_ttft_by_tenant_seconds",
            "Time to first token per SLO class",
            buckets=LATENCY_BUCKETS, labelnames=("tenant",))
        self._m_tenant_occ = reg.gauge(
            "horovod_serving_tenant_occupancy",
            "Decode-batch slot fraction held per SLO class",
            labelnames=("tenant",))
        self._m_tenant_queue = reg.gauge(
            "horovod_serving_tenant_queue_depth",
            "Requests waiting for a slot per SLO class",
            labelnames=("tenant",))

    # -- state gauges ------------------------------------------------------
    @property
    def occupancy(self) -> float:
        return len(self.active) / self.slots

    @property
    def draining_slots(self) -> List[int]:
        return [s for s, r in self.active.items() if r.state == "draining"]

    @property
    def handoff_slots(self) -> List[int]:
        """Slots whose prompt K/V is computed but still in flight from
        a remote prefill worker (disaggregated serving)."""
        return [s for s, r in self.active.items() if r.state == "handoff"]

    def _update_gauges(self) -> None:
        self._m_queue.set(len(self.queue))
        self._m_occ.set(self.occupancy)
        draining = len(self.draining_slots)
        handoff = len(self.handoff_slots)
        self._m_slot_states.labels(state="draining").set(draining)
        self._m_slot_states.labels(state="handoff").set(handoff)
        self._m_slot_states.labels(state="active").set(
            len(self.active) - draining - handoff)
        self._m_slot_states.labels(state="free").set(len(self._free_slots))
        for tname in self._tenants_seen:
            self._m_tenant_occ.labels(tenant=tname).set(
                sum(1 for r in self.active.values()
                    if r.tenant == tname) / self.slots)
            self._m_tenant_queue.labels(tenant=tname).set(
                sum(1 for r in self.queue if r.tenant == tname))

    # -- tenant fairness ---------------------------------------------------
    def _tclass(self, name: str) -> TenantClass:
        return self.tenants.get(name) or TenantClass(name=name)

    def _pick_index(self) -> int:
        """Index into ``queue`` of the next admission candidate.

        Single-tenant: 0 -- strict FIFO, the head blocks (no
        head-of-line bypass, TTFT ordering stays honest).  With tenant
        classes: stride scheduling over each tenant's FIFO head -- the
        tenant with the lowest weight-normalized virtual pass goes
        next, skipping tenants at their ``max_share`` occupancy cap
        while others wait.  -1 when every waiting tenant is capped."""
        if not self.tenants:
            return 0
        heads: Dict[str, int] = {}
        for qi, req in enumerate(self.queue):
            if req.tenant not in heads:
                heads[req.tenant] = qi
        active_by: Dict[str, int] = {}
        for r in self.active.values():
            active_by[r.tenant] = active_by.get(r.tenant, 0) + 1
        best = None
        for tname, qi in heads.items():
            tc = self._tclass(tname)
            cap = max(1, math.ceil(tc.max_share * self.slots))
            if len(heads) > 1 and active_by.get(tname, 0) >= cap:
                continue
            key = (self._tenant_pass.get(tname, 0.0), qi)
            if best is None or key < best[0]:
                best = (key, qi)
        return -1 if best is None else best[1]

    # -- transitions -------------------------------------------------------
    def submit(self, req: Request) -> None:
        """queued: request enters the wait queue (arrival already
        happened from the load generator's point of view)."""
        if req.prompt_len < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        req.state = "queued"
        self.queue.append(req)
        if req.tenant not in self._tenants_seen:
            self._tenants_seen.add(req.tenant)
        if self.tenants and req.tenant not in self._tenant_pass:
            # A late-joining tenant starts at the current minimum pass,
            # not zero -- stride scheduling's no-catchup-monopoly rule.
            self._tenant_pass[req.tenant] = min(
                self._tenant_pass.values(), default=0.0)
        self._m_requests.labels(event="submitted").inc()
        self._update_gauges()

    def admit(self, now_s: float) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots while pages allow.

        Single-tenant: FIFO, the head of the queue blocks (no
        head-of-line bypass -- keeps TTFT ordering honest under
        overload).  With tenant classes the candidate comes from
        :meth:`_pick_index` (weighted fair, occupancy-capped) and that
        CANDIDATE blocks on pages -- ordering stays honest per class.
        Returns ``(slot, request)`` pairs the engine must now prefill.
        """
        out: List[Tuple[int, Request]] = []
        if not self.admitting:
            self._update_gauges()
            return out
        while self.queue and self._free_slots:
            qi = self._pick_index()
            if qi < 0:
                break
            req = self.queue[qi]
            # + token_budget: room for a full step's worth of generated
            # tokens beyond the prompt (1 plain, k+1 speculative).
            if self.cache is not None and not self.cache.can_admit(
                    req.prompt_len + self.token_budget):
                break
            del self.queue[qi]
            slot = self._free_slots.pop()
            req.slot = slot
            req.state = "prefill"
            req.admit_s = now_s
            self.active[slot] = req
            if self.tenants:
                tc = self._tclass(req.tenant)
                self._tenant_pass[req.tenant] = \
                    self._tenant_pass.get(req.tenant, 0.0) \
                    + (req.prompt_len + self.token_budget) / tc.weight
            self._m_requests.labels(event="admitted").inc()
            out.append((slot, req))
        self._update_gauges()
        return out

    def note_handoff(self, req: Request) -> None:
        """prefill -> handoff: a remote prefill worker computed the
        prompt's K/V and its pages are in flight over the KV plane; the
        slot is occupied but NOT decodable until the import lands
        (:meth:`note_prefill` completes the transition)."""
        req.state = "handoff"
        self._m_requests.labels(event="handoff").inc()
        self._update_gauges()

    def note_prefill(self, req: Request, now_s: float) -> None:
        """prefill done: the prompt's KV is resident and the first token
        sampled -- the request joins the decode batch."""
        req.state = "decode"
        req.first_token_s = now_s
        self._m_tokens.labels(phase="prefill").inc(req.prompt_len)
        self._m_tokens.labels(phase="decode").inc()  # the sampled token
        self._m_ttft.observe(max(now_s - req.arrival_s, 0.0))
        self._m_ttft_tenant.labels(tenant=req.tenant).observe(
            max(now_s - req.arrival_s, 0.0))
        # The handoff -> decode transition must surface immediately:
        # the router/control plane count handoff slots as
        # not-yet-decodable capacity.
        self._update_gauges()

    def note_decode_token(self, req: Request, latency_s: float) -> None:
        self._m_tokens.labels(phase="decode").inc()
        self._m_tok_lat.observe(max(latency_s, 0.0))
        req.token_latencies.append(latency_s)

    def note_spec(self, proposed: int, accepted: int) -> None:
        """Account one speculative round: ``proposed`` draft tokens went
        into the verify step, ``accepted`` of them survived (the
        target's bonus token is decode-phase accounting, not a draft).
        Exported as ``horovod_serving_spec_tokens_total{outcome}``."""
        if accepted > proposed:
            raise ValueError(
                f"accepted {accepted} > proposed {proposed}")
        self._m_spec.labels(outcome="proposed").inc(proposed)
        self._m_spec.labels(outcome="accepted").inc(accepted)

    def _release(self, slot: int) -> None:
        """The ONE place a slot and its KV pages return to the pool --
        completion (:meth:`release`) and drain (:meth:`suspend`) both
        land here, so the refcounted page release (shared prefix pages
        decrement; the last holder frees) cannot diverge between
        paths."""
        self._free_slots.append(slot)
        if self.cache is not None:
            self.cache.free_slot(slot)

    def release(self, slot: int, now_s: float, *,
                completed: bool = True) -> Request:
        """done: recycle the slot (and its KV pages) immediately."""
        req = self.active.pop(slot)
        req.state = "done"
        req.done_s = now_s
        req.slot = -1
        self._release(slot)
        self._m_requests.labels(
            event="completed" if completed else "evicted").inc()
        self._update_gauges()
        return req

    # -- drain lifecycle (elastic control plane) ---------------------------
    def pause_admission(self) -> None:
        """Stop moving queued requests into slots (drain is starting).
        Queued requests keep accumulating and admit again on resume."""
        self.admitting = False
        self._update_gauges()

    def resume_admission(self) -> None:
        self.admitting = True
        self._update_gauges()

    def mark_draining(self, slot: int) -> Request:
        """decode -> draining: the slot finishes its request but admits
        no successor; the mesh under it is about to change."""
        req = self.active[slot]
        req.state = "draining"
        self._m_requests.labels(event="draining").inc()
        self._update_gauges()
        return req

    def suspend(self, slot: int) -> Request:
        """draining -> suspended: pull the request out of the batch with
        its progress intact (prompt + emitted tokens) and free the
        slot's KV pages.  The request is NOT done -- it must be
        restored and re-prefilled on the surviving mesh."""
        req = self.active.pop(slot)
        req.state = "suspended"
        req.slot = -1
        self._release(slot)
        self._m_requests.labels(event="suspended").inc()
        self._update_gauges()
        return req

    def restore(self, req: Request) -> int:
        """suspended -> decode on the post-resize mesh: assign a free
        slot; the engine re-prefills prompt + emitted tokens into it."""
        if not self._free_slots:
            raise RuntimeError(
                f"no free slot to restore request {req.rid}")
        slot = self._free_slots.pop()
        req.slot = slot
        req.state = "decode"
        self.active[slot] = req
        self._m_requests.labels(event="reprefill").inc()
        self._update_gauges()
        return slot

    def has_work(self) -> bool:
        return bool(self.queue or self.active)
