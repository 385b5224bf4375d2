"""Disaggregated serving fleet: prefill workers + decode workers.

Counterpart of ``horovod_tpu/serving/fleet.py``.  Prefill is compute
bound (one product over the whole prompt); decode reads the resident KV
for one token a step.  The fleet splits them: prefill workers run
:func:`~.decode.prefill_forward` and export the finished pages; decode
workers import them into their own :class:`~.kvcache.PagedKVCache` and
never spend a step on prompt math.  Here every worker is on the one
card, in one process: the split is of the work and of the pools, and the
pages still travel as :mod:`.kvwire` payloads over a rendezvous KV plane
(:class:`~horovod_tpu_torch.run.http_kv.RendezvousServer` /
``KVClient`` chunked PUT/GET on 127.0.0.1).  The f32 wire tier is
bitwise, and a slot's logits do not depend on the rest of its batch, so
a fleet's streams are bitwise a colocated engine's.

Handoff on the decode side::

    queued -> prefill -> handoff -> decode -> done

``handoff``: admission gave the request a slot and the fleet sent its
prompt to a prefill worker; the slot is out of the decode batch until
its pages are imported (one loop iteration later, like a network hop).

A dead prefill worker degrades, never wedges: its un-imported objects
are reaped, the decode worker finds no manifest and prefills the prompt
itself (``handoffs_local``); the stream stays right, only the offload is
lost.

The clock: workers stand for separate hosts, so an iteration that keeps
prefill worker A busy 3 ms and decode worker B 5 ms is 5 ms of fleet
time.  The loop keeps the engines' virtual clock and rebates the
serialized rest of each iteration (``skip -= iter_real - max(per-host
busy)``): tokens/s against modelled concurrent wall, from real kernel
times.

A tensor-parallel decode worker (``ServingEngine(mesh=)`` at world > 1):
every rank of the world builds the same fleet and calls :meth:`
ServingFleet.serve` with the same requests, and the loop runs in
lock-step (:mod:`.lockstep`).  The world's rank 0, the leader, reads the
clock, runs the prefill workers and publishes each handoff to the KV
plane, and (with a scaler) decides.  Every decode engine steps on a lane
of one header, which ends each loop turn and carries what the other
ranks cannot compute: the clock, the engines' first-token times and
tokens, the turn's handoff tickets (first token and byte count; the key
is ``r{rid}``) and the scaler's decision.  Routing, admissions,
migration and the fallback of a dead publisher's handoffs follow from
these on every rank alike.  Every rank GETs each payload and imports it
into its own kv heads of the pool; the leader deletes an object only
after the header's ``ack`` count shows that every rank imported it.  A
decode engine's mesh must cover the world.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..core.state import global_state
from ..timeline import spans as _spans
from ..timeline.metrics import registry as _registry
from .controlplane import FleetScaler
from .decode import greedy_sample, prefill_forward
from .engine import ServingEngine, _pct
from .kvwire import decode_kv, encode_kv, import_pages, wire_tier
from .lockstep import LockStep
from .policy import Decision
from .router import FleetRouter
from .scheduler import Request

__all__ = ["HandoffTicket", "PrefillWorker", "DecodeWorker",
           "ServingFleet", "FleetReport"]

_SCOPE = "pages"


@dataclasses.dataclass
class HandoffTicket:
    """One published prefill: all the decode side needs to join the
    request (the pages are in the KV plane under ``key``)."""

    rid: int
    key: str
    first: int                 # greedy first token (the prefill's argmax)
    nbytes: int                # framed payload size on the wire
    worker: str                # prefill worker that produced it
    published_s: float         # virtual-clock publish instant


class PrefillWorker:
    """Prompt-only worker: runs the prefill forward, frames the K/V
    through :mod:`.kvwire` and publishes it as a chunked KV object.  Its
    forward is the colocated engine's whole-prompt prefill (same dtype,
    same ``lora_alpha``), so the first token and every exported byte are
    what that engine computes."""

    def __init__(self, name: str, config, params, kv, *, page_size: int,
                 dtype=torch.float32, tier: Optional[str] = None,
                 device=None, lora_alpha: float = 16.0):
        self.name = name
        self.config = config
        self.params = params
        self.kv = kv
        self.page_size = int(page_size)
        self.dtype = dtype
        self.tier = tier or wire_tier()
        self.device = resolve_device(device)
        self.lora_alpha = float(lora_alpha)
        self.alive = True
        self.prefills = 0
        self.busy_s = 0.0

    @torch.no_grad()
    def run(self, req: Request, prompt_dev, now_s: float) -> HandoffTicket:
        """Prefill ``req``'s prompt and publish its pages; returns the
        ticket the decode side imports against."""
        if not self.alive:
            raise RuntimeError(f"prefill worker {self.name} is dead")
        t0 = time.monotonic()
        with _spans.recorder().span("dispatch", name="fleet_prefill",
                                    leg="serving_fleet_prefill"):
            logits, kl, vl = prefill_forward(
                self.params, self.config, prompt_dev.to(self.device)[None],
                dtype=self.dtype, lora_alpha=self.lora_alpha)
            first = int(greedy_sample(logits[:, -1, :])[0])
            buf = encode_kv(kl[:, 0], vl[:, 0], page_size=self.page_size,
                            tier=self.tier)
        key = f"r{req.rid}"
        self.kv.put_large(_SCOPE, key, buf)
        self.busy_s += time.monotonic() - t0
        self.prefills += 1
        return HandoffTicket(rid=req.rid, key=key, first=first,
                             nbytes=len(buf), worker=self.name,
                             published_s=now_s)


class DecodeWorker:
    """One decode engine, its per-run state and the import path."""

    def __init__(self, name: str, engine: ServingEngine, kv):
        self.name = name
        self.engine = engine
        self.kv = kv
        self.busy_s = 0.0
        self.st: Dict[str, Any] = engine.new_state()

    @property
    def scheduler(self):
        return self.engine.scheduler

    def complete_handoff(self, slot: int, req: Request,
                         ticket: HandoffTicket, now,
                         delete: bool = True) -> Optional[int]:
        """Import a published payload into ``slot`` and join the request
        into the decode batch.  Returns the bytes imported, or None when
        the object is gone (its publisher died and was reaped): the
        caller then falls back to :meth:`local_prefill`.  ``delete``
        False leaves the object on the plane (lock-step: the leader
        deletes it once every rank has imported it)."""
        t0 = time.monotonic()
        with _spans.recorder().span("dispatch", name="handoff_import",
                                    leg="serving_handoff_import"):
            buf = self.kv.get_large(_SCOPE, ticket.key)
            if buf is None:
                return None
            import_pages(self.engine.cache, slot, decode_kv(buf))
            self.engine._join_decode(self.st, slot, req, ticket.first, now)
        if delete:
            self.kv.delete_large(_SCOPE, ticket.key)
        self.busy_s += time.monotonic() - t0
        return len(buf)

    def local_prefill(self, slot: int, req: Request, prompt_dev,
                      now) -> None:
        """Fallback: prefill the prompt here, as a colocated engine."""
        t0 = time.monotonic()
        first = self.engine._do_prefill(slot, req, prompt_dev)
        self.engine._join_decode(self.st, slot, req, first, now)
        self.busy_s += time.monotonic() - t0

    def decode_step(self, now) -> float:
        t0 = time.monotonic()
        self.engine.decode_once(self.st, now)
        dt = time.monotonic() - t0
        self.busy_s += dt
        return dt


@dataclasses.dataclass
class FleetReport:
    """One fleet run's outcome."""

    num_requests: int
    completed: int
    rejected: int
    prompt_tokens: int
    new_tokens: int
    wall_s: float                      # modelled concurrent wall
    tokens_per_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    decode_steps: int
    engines: int                       # decode engines at the end
    handoffs_streamed: int
    handoffs_local: int
    migrated: int
    kv_bytes_out: int
    kv_bytes_in: int
    slo_violation_s: float
    leaked_pages: Dict[str, int]       # per decode engine, all 0
    refcounts_balanced: bool
    per_engine_completed: Dict[str, int]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServingFleet:
    """Router + prefill workers + decode workers on one virtual clock."""

    def __init__(self, prefill_workers: Sequence[PrefillWorker],
                 decode_workers: Sequence[DecodeWorker], kv, *,
                 router: Optional[FleetRouter] = None,
                 scaler_policy=None,
                 engine_factory: Optional[Callable[[], ServingEngine]]
                 = None):
        if not decode_workers:
            raise ValueError("a fleet needs at least one decode worker")
        self.prefill_workers = list(prefill_workers)
        self.decode = {w.name: w for w in decode_workers}
        self.kv = kv
        self.router = router or FleetRouter()
        for name, w in self.decode.items():
            self.router.register(name, w.scheduler)
        self.engine_factory = engine_factory
        self.scaler = (FleetScaler(self, policy=scaler_policy)
                       if scaler_policy is not None else None)
        # Lock-step over the world (module docstring): one header a loop
        # turn, a lane for every decode engine the fleet may hold.
        self._ls: Optional[LockStep] = None
        engines = [w.engine for w in decode_workers]
        if any(e._ls is not None for e in engines):
            lanes = max(len(engines), self.scaler.policy.config.max_engines
                        if self.scaler is not None else 0)
            slots = engines[0].slots
            if any(e.slots != slots or e.spec_decode for e in engines):
                raise ValueError("a lock-step fleet's decode engines share "
                                 "one slot count and decode one token a "
                                 "step (no speculation)")
            self._ls = LockStep(slots, 1, lanes=lanes,
                                blob_words=64 + 4 * lanes * slots)
            for i, e in enumerate(engines):
                e._ls = self._ls.lane(i)
        self.migrated = 0
        self._rr = 0  # round-robin cursor over the alive prefill workers
        self._in_flight: List[dict] = []
        reg = _registry()
        self._m_handoffs = reg.counter(
            "horovod_fleet_handoffs_total",
            "Prefill->decode handoffs by outcome (streamed = imported "
            "over the KV plane, local = fallback prefill on the decode "
            "engine)", labelnames=("outcome",))
        self._m_kv_bytes = reg.counter(
            "horovod_fleet_kv_bytes_total",
            "Framed KV-page bytes moved over the rendezvous plane",
            labelnames=("direction",))
        self._m_handoff_lat = reg.histogram(
            "horovod_fleet_handoff_latency_seconds",
            "Publish-to-import latency of streamed handoffs")
        self._m_migrated = reg.counter(
            "horovod_fleet_migrated_total",
            "Queued requests migrated to a freshly commissioned decode "
            "engine")

    # -- the FleetScaler's duck type ---------------------------------------
    def schedulers(self) -> Dict[str, Any]:
        return {n: w.scheduler for n, w in self.decode.items()}

    @property
    def num_engines(self) -> int:
        return len(self.decode)

    def add_decode_worker(self, reason: str = "manual") -> str:
        """Commission a decode engine under live traffic: built by
        ``engine_factory``, registered with the router, and seeded with
        half of the most loaded sibling's queue (its newest arrivals;
        requests already in slots stay put)."""
        if self.engine_factory is None:
            raise RuntimeError(
                "fleet has no engine_factory; cannot add capacity")
        name = f"decode{len(self.decode)}"
        worker = DecodeWorker(name, self.engine_factory(), self.kv)
        if self._ls is not None:
            worker.engine._ls = self._ls.lane(len(self.decode))
        self.decode[name] = worker
        self.router.register(name, worker.scheduler)
        donor = max((w for n, w in self.decode.items() if n != name),
                    key=lambda w: len(w.scheduler.queue))
        moved = 0
        dq, nq = donor.scheduler.queue, worker.scheduler.queue
        for _ in range(len(dq) // 2):
            nq.append(dq.pop())
            moved += 1
        donor.scheduler._update_gauges()
        worker.scheduler._update_gauges()
        self.migrated += moved
        self._m_migrated.inc(moved)
        _spans.recorder().add("ctl", 0.0, leg=f"ctl/add-engine/{reason}")
        return name

    def kill_prefill(self, name: str) -> int:
        """Chaos: a prefill host dies.  Its published but unimported
        objects are reaped from the KV plane, so the decode side takes
        the lost-object fallback.  Returns the tickets reaped.  In
        lock-step every rank calls it at the same turn: each marks the
        handoffs lost, the leader reaps the objects."""
        reaped = 0
        leader = self._ls is None or self._ls.leader
        for w in self.prefill_workers:
            if w.name == name and w.alive:
                w.alive = False
                for h in self._in_flight:
                    if h["worker"] == name and not h["done"]:
                        if leader:
                            self.kv.delete_large(_SCOPE, f"r{h['req'].rid}")
                        h["reaped"] = True
                        reaped += 1
        return reaped

    def _alive_prefill(self) -> List[PrefillWorker]:
        return [w for w in self.prefill_workers if w.alive]

    # -- the serve loop ----------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request], *,
              kill_prefill_at_step: Optional[int] = None,
              kill_prefill_name: Optional[str] = None) -> FleetReport:
        """Run the open-loop stream across the fleet to completion.  In
        lock-step (a tp decode worker: module docstring) every rank calls
        it with the same arguments and returns the same report, its
        times the leader's."""
        ls = self._ls
        if ls is not None:
            world = global_state().size
            for name, w in self.decode.items():
                mesh = w.engine.mesh
                if mesh is None or mesh.size != world:
                    raise ValueError(
                        f"decode worker {name!r}: a lock-step fleet takes "
                        f"decode engines whose mesh covers the world of "
                        f"{world} (ServingEngine(mesh=) over every rank)")
        leader = ls is None or ls.leader
        pending = sorted(requests, key=lambda r: r.arrival_s)
        cap = min(w.engine.max_len for w in self.decode.values())
        feed = [r for r in pending
                if r.prompt_len + r.max_new_tokens <= cap]
        rejected = len(pending) - len(feed)
        device = next(iter(self.decode.values())).engine.device
        fi = 0
        # Worker state outlives serve() (sessions may span runs); the
        # report covers this run only.
        base_completed = {n: len(w.st["completed"])
                          for n, w in self.decode.items()}
        base_steps = {n: w.st["decode_steps"]
                      for n, w in self.decode.items()}
        base_migrated = self.migrated

        start = time.monotonic()
        skip = 0.0

        def now() -> float:
            return time.monotonic() - start + skip

        if ls is not None:
            ls.reset()
            now = ls.now     # noqa: F811 - the leader's clock, per turn

        prompts_dev: Dict[int, Any] = {}
        # Streamed handoffs: dispatched (this iteration) -> imported
        # (the next) -> done.
        self._in_flight = []
        streamed = local = kv_out = kv_in = 0
        overhead = 0.0   # serialized-in-driver time rebated each iteration
        step = 0
        unacked: List[str] = []    # imported keys the leader may delete
        leader_overhead = 0.0      # the leader's rebates, from the header

        def note_local() -> None:
            nonlocal local
            local += 1
            self._m_handoffs.labels(outcome="local").inc()

        def end_turn(dispatched: List[dict], imported: int,
                     decided: Optional[dict]) -> None:
            """Lock-step: the turn's header, then what it carries."""
            nonlocal kv_out, leader_overhead
            if ls.leader:
                ls.attach(json.dumps({
                    "t": [[d["ticket"].first, d["ticket"].nbytes]
                          for d in dispatched],
                    "d": decided, "n": now(), "o": overhead,
                    "v": self.scaler.slo_violation_s
                    if self.scaler is not None else 0.0}).encode())
            hdr = ls.exchange(ack=imported)
            for w in self.decode.values():
                w.engine._drain_quarantined()
            blob = json.loads(hdr["blob"])
            if hdr["ack"] != imported * global_state().size:
                raise RuntimeError(
                    f"lock-step fleet: {hdr['ack']} imports acknowledged, "
                    f"{imported} on each of {global_state().size} ranks")
            if ls.leader:
                for key in unacked:
                    self.kv.delete_large(_SCOPE, key)
            unacked.clear()
            if not ls.leader:
                for d, (first, nbytes) in zip(dispatched, blob["t"]):
                    d["ticket"] = HandoffTicket(
                        rid=d["req"].rid, key=f"r{d['req'].rid}",
                        first=int(first), nbytes=int(nbytes),
                        worker=d["worker"], published_s=d["published_s"])
                    kv_out += int(nbytes)
            record = blob["d"]
            if record is not None:
                decision = Decision(record["action"], record["reason"],
                                    record["target_size"])
                if not ls.leader:
                    decision = self.scaler.adopt(record, blob["v"])
                self.scaler.apply(decision, blob["n"])
            leader_overhead = blob["o"]

        while True:
            step += 1
            iter_t0 = time.monotonic()
            busy: Dict[str, float] = {}

            def charge(host: str, t0: float) -> None:
                busy[host] = busy.get(host, 0.0) + time.monotonic() - t0

            # 1. Arrivals: route each due request to a decode engine.
            while fi < len(feed) and feed[fi].arrival_s <= now():
                req = feed[fi]
                fi += 1
                prompts_dev[req.rid] = torch.tensor(
                    req.prompt, dtype=torch.long, device=device)
                engine, _reason = self.router.route(req)
                self.decode[engine].scheduler.submit(req)

            # 2. Chaos fault.
            if kill_prefill_at_step is not None \
                    and step == kill_prefill_at_step:
                self.kill_prefill(kill_prefill_name
                                  or self.prefill_workers[0].name)

            # 3. Import last iteration's pages.
            imported = 0
            for h in self._in_flight:
                w = self.decode[h["engine"]]
                t0 = time.monotonic()
                got = None if h.get("reaped") else w.complete_handoff(
                    h["slot"], h["req"], h["ticket"], now,
                    delete=ls is None)
                if got is None:
                    if ls is not None and not h.get("reaped"):
                        raise RuntimeError(
                            f"lock-step fleet: handoff {h['ticket'].key} "
                            f"is gone from the KV plane")
                    w.local_prefill(h["slot"], h["req"],
                                    prompts_dev[h["req"].rid], now)
                    note_local()
                else:
                    kv_in += got
                    imported += 1
                    if ls is not None:
                        unacked.append(h["ticket"].key)
                    self._m_kv_bytes.labels(direction="in").inc(got)
                    streamed += 1
                    self._m_handoffs.labels(outcome="streamed").inc()
                    if leader:
                        self._m_handoff_lat.observe(
                            max(now() - h["ticket"].published_s, 0.0))
                prompts_dev.pop(h["req"].rid, None)
                h["done"] = True
                charge(h["engine"], t0)
            self._in_flight = []

            # 4. Admissions: a new slot goes to handoff, or to a local
            # prefill when no prefill worker is alive.
            dispatch: List[dict] = []
            for name, w in self.decode.items():
                for slot, req in w.scheduler.admit(now()):
                    if self._alive_prefill():
                        w.scheduler.note_handoff(req)
                        dispatch.append({"engine": name, "slot": slot,
                                         "req": req})
                    else:
                        t0 = time.monotonic()
                        w.local_prefill(slot, req, prompts_dev.pop(req.rid),
                                        now)
                        note_local()
                        charge(name, t0)

            # 5. Prefills, round-robin over the alive workers (on the
            # leader; the other ranks take the tickets from the header).
            for d in dispatch:
                workers = self._alive_prefill()
                pw = workers[self._rr % len(workers)]
                self._rr += 1
                d["worker"], d["published_s"] = pw.name, now()
                d["ticket"] = None
                if leader:
                    t0 = time.monotonic()
                    d["ticket"] = pw.run(d["req"], prompts_dev[d["req"].rid],
                                         now())
                    kv_out += d["ticket"].nbytes
                    self._m_kv_bytes.labels(direction="out").inc(
                        d["ticket"].nbytes)
                    charge(f"prefill:{pw.name}", t0)
                d["done"] = False
                self._in_flight.append(d)

            # 6. One decode round per engine with live decode slots.
            for name, w in self.decode.items():
                if w.engine._decode_slots():
                    busy[name] = busy.get(name, 0.0) + w.decode_step(now)

            # 7. The fleet controller (in lock-step the leader decides;
            # every rank applies the decision from the header).
            decided = None
            if self.scaler is not None:
                if ls is None:
                    self.scaler.tick(now())
                elif ls.leader:
                    n = len(self.scaler.decisions)
                    self.scaler.decide(now())
                    if len(self.scaler.decisions) > n:
                        decided = self.scaler.decisions[-1]

            # 8. Clock rebate: the hosts ran concurrently, so the fleet
            # aged by the busiest host's time this iteration.
            iter_real = time.monotonic() - iter_t0
            model = min(max(busy.values(), default=0.0), iter_real)
            overhead += iter_real - model
            if ls is None:
                skip -= iter_real - model
            elif ls.leader:
                ls.skip -= iter_real - model
                end_turn(dispatch, imported, decided)
            else:
                end_turn(dispatch, imported, decided)

            if not (self._in_flight or any(
                    w.scheduler.has_work() for w in self.decode.values())):
                if fi >= len(feed):
                    break
                if ls is None:
                    gap = feed[fi].arrival_s - now()
                    if gap > 0:
                        skip += gap
                else:
                    # Idle: the leader fast-forwards its clock to the next
                    # arrival; one more header brings it to every rank.
                    if ls.leader:
                        gap = feed[fi].arrival_s - ls.fresh()
                        if gap > 0:
                            ls.skip += gap
                    ls.exchange()

        if ls is None:
            wall_s = max(time.monotonic() - start - overhead, 1e-9)
        else:
            wall_s = max(ls.wall - leader_overhead, 1e-9)
        # The leak gate, per decode engine: drop the prefix tree's own
        # references, then every page must come back.
        leaked: Dict[str, int] = {}
        balanced = True
        per_engine: Dict[str, int] = {}
        completed: List[Request] = []
        for name, w in self.decode.items():
            if w.engine._prefix is not None:
                w.engine._prefix.drop_all()
            leaked[name] = w.engine.cache.release_all()
            balanced = balanced and w.engine.cache.refcounts_balanced()
            done = w.st["completed"][base_completed.get(name, 0):]
            per_engine[name] = len(done)
            completed.extend(done)

        new_tokens = sum(len(r.tokens) for r in completed)
        ttfts = [r.ttft_s for r in completed if r.ttft_s is not None]
        return FleetReport(
            num_requests=len(requests), completed=len(completed),
            rejected=rejected,
            prompt_tokens=sum(r.prompt_len for r in completed),
            new_tokens=new_tokens, wall_s=wall_s,
            tokens_per_s=new_tokens / wall_s,
            ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
            decode_steps=sum(w.st["decode_steps"] - base_steps.get(n, 0)
                             for n, w in self.decode.items()),
            engines=len(self.decode),
            handoffs_streamed=streamed, handoffs_local=local,
            migrated=self.migrated - base_migrated,
            kv_bytes_out=kv_out, kv_bytes_in=kv_in,
            slo_violation_s=(self.scaler.slo_violation_s
                             if self.scaler else 0.0),
            leaked_pages=leaked, refcounts_balanced=balanced,
            per_engine_completed=per_engine)
