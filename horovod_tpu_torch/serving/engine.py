"""Serving engine front-end: prefetch -> prefill -> continuous decode.

Counterpart of ``horovod_tpu/serving/engine.py``.  One object owns the
data plane on one device: the paged KV cache, the continuous-batching
scheduler, prefill (flash forward kernel) and the decode step (paged
decode kernel).  A producer thread stages each upcoming prompt onto the
device while the engine is still decoding, so admission never waits on
a host-to-device copy.

Knobs (constructor argument, else environment, as in the reference):

* ``HOROVOD_SERVING_SLOTS`` -- decode batch slots (default 8)
* ``HOROVOD_SERVING_PAGE_SIZE`` -- KV page length in tokens (default 16)
* ``HOROVOD_SERVING_MAX_LEN`` -- per-sequence cap (default: model max)
* ``HOROVOD_SERVING_PREFETCH`` -- request prefetch depth (default 2)
* ``HOROVOD_TENANT_CLASSES`` -- per-tenant SLO classes

Not ported yet, and refused with ``NotImplementedError`` when asked for
(by argument or by ``HOROVOD_SPEC_DECODE`` / ``HOROVOD_PREFILL_CHUNK`` /
``HOROVOD_KV_COMPRESS`` / ``HOROVOD_PREFIX_CACHE``): speculative
decoding, chunked prefill, fp8 KV pages, the prefix cache, LoRA banks.

Two clocks, as in the reference: a VIRTUAL clock that fast-forwards
idle gaps in the open-loop arrival schedule (TTFT is measured against
it) and the wall clock for throughput.  The decode loop keeps the
reference's sync point: the sampled tokens come back to the host after
every step.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import _env, _env_bool, _env_int
from ..core.device import resolve_device
from ..timeline import metrics as _metrics
from ..timeline import spans as _spans
from .decode import build_decode_step, greedy_sample, prefill_forward
from .kvcache import CacheConfig, PagedKVCache
from .scheduler import (ContinuousBatchScheduler, Request,
                        parse_tenant_classes)


class _Stop:
    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


class RequestPrefetcher:
    """Stage upcoming requests' prompts onto the device ahead of
    admission: bounded queue, daemon producer, sentinel-carried errors,
    context-manager close.  Yields ``(request, device_prompt)`` in
    arrival order."""

    def __init__(self, requests: Sequence[Request], depth: int = 2,
                 device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(list(requests),),
            name="serving-prefetch", daemon=True)
        self._thread.start()

    def _produce(self, requests):
        try:
            for req in requests:
                if self._closed.is_set():
                    return
                dev = torch.tensor(np.asarray(req.prompt), dtype=torch.long,
                                   device=self._device)
                while not self._closed.is_set():
                    try:
                        self._q.put((req, dev), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._q.put(_Stop())
        except BaseException as e:  # surfaced in the consumer
            self._q.put(_Stop(e))

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _Stop):
            if item.error is not None:
                raise item.error
            raise StopIteration
        return item

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclasses.dataclass
class ServingReport:
    """Aggregate result of one ``serve()`` run."""

    num_requests: int
    completed: int
    rejected: int
    prompt_tokens: int
    new_tokens: int
    wall_s: float
    decode_steps: int
    prefills: int
    tokens_per_s: float
    ttft_p50_s: float
    ttft_p99_s: float
    token_latency_p50_s: float
    token_latency_p99_s: float
    mean_occupancy: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


def _refuse(flag: bool, what: str) -> None:
    if flag:
        raise NotImplementedError(
            f"{what} is not ported to the PyTorch/CUDA package yet (see "
            "ROADMAP: serving features left out of slice 1)")


class ServingEngine:
    """Continuous-batching inference over one Llama-family model on one
    device.  ``params`` is the flat param dict
    (:func:`~horovod_tpu_torch.models.init_llama_params` or
    :func:`~horovod_tpu_torch.models.params_from_jax`) already on
    ``device``; ``device`` defaults to ``cuda``."""

    def __init__(self, config, params, *, device=None, slots: int = 0,
                 page_size: int = 0, max_len: int = 0,
                 dtype=torch.float32, adapters=None,
                 prefetch_depth: int = 0,
                 spec_decode: Optional[bool] = None,
                 prefill_chunk: int = -1,
                 kv_compress: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None, tenants=None):
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        _refuse(adapters is not None, "serving LoRA banks")
        _refuse(_env_bool("SPEC_DECODE") if spec_decode is None
                else bool(spec_decode), "speculative decoding")
        _refuse((_env_int("PREFILL_CHUNK", 0) if prefill_chunk < 0
                 else prefill_chunk) > 0, "chunked prefill")
        _refuse(_env_bool("KV_COMPRESS") if kv_compress is None
                else bool(kv_compress), "fp8 KV-cache compression")
        _refuse(_env_bool("PREFIX_CACHE") if prefix_cache is None
                else bool(prefix_cache), "the prefix cache")
        self.slots = slots or _env_int("SERVING_SLOTS", 8)
        self.page_size = page_size or _env_int("SERVING_PAGE_SIZE", 16)
        self.max_len = max_len or _env_int("SERVING_MAX_LEN",
                                           config.max_seq_len)
        self.prefetch_depth = prefetch_depth or _env_int(
            "SERVING_PREFETCH", 2)
        if tenants is None:
            spec = _env("TENANT_CLASSES")
            tenants = parse_tenant_classes(spec) if spec else None
        self.dtype = dtype
        self.cache_config = CacheConfig(
            num_layers=config.num_layers,
            num_kv_heads=config.num_kv_heads, head_dim=config.head_dim,
            slots=self.slots, page_size=self.page_size,
            max_len=self.max_len,
            dtype=str(dtype).replace("torch.", ""))
        self.cache = PagedKVCache(self.cache_config, self.device)
        self.scheduler = ContinuousBatchScheduler(
            self.slots, self.cache, token_budget=1, tenants=tenants)
        self.step = build_decode_step(
            config, slots=self.slots, page_size=self.page_size,
            pages_per_slot=self.cache_config.pages_per_slot, dtype=dtype)

    def _prefill(self, tokens):
        return prefill_forward(self.params, self.config, tokens,
                               dtype=self.dtype)

    # -- one-request helpers ----------------------------------------------
    def _do_prefill(self, slot: int, req: Request, prompt_dev) -> int:
        with _spans.recorder().span("dispatch", name="prefill",
                                    leg="serving_prefill"):
            logits, kl, vl = self._prefill(prompt_dev[None])
            self.cache.write_prefill(slot, kl[:, 0], vl[:, 0])
            first = int(greedy_sample(logits[:, -1, :])[0])
        return first

    def _join_decode(self, st: Dict[str, Any], slot: int, req: Request,
                     first: int, now) -> None:
        req.tokens.append(first)
        self.scheduler.note_prefill(req, now())
        st["last_tokens"][slot] = first
        if req.finished:
            self._release(st, slot, now)

    def _release(self, st: Dict[str, Any], slot: int, now) -> None:
        st["completed"].append(self.scheduler.release(slot, now()))

    def _decode_slots(self) -> List[int]:
        return [s for s, r in self.scheduler.active.items()
                if r.state not in ("prefill", "handoff")]

    def _quarantine_logits(self, st: Dict[str, Any], slot: int,
                           req: Request) -> None:
        """A slot produced nonfinite logits: never stream a token sampled
        from them.  Rebuild its context from the request's own tokens and
        retry the same position next round."""
        _metrics.registry().counter(
            "horovod_guard_serving_reprefills_total",
            "Decode rounds where a slot's nonfinite logits were "
            "quarantined by re-prefilling its context").inc()
        st["last_tokens"][slot] = self.re_prefill(slot, req)

    # -- one decode round --------------------------------------------------
    def decode_once(self, st: Dict[str, Any], now) -> float:
        """One continuous-batching decode step over the live slots."""
        sched = self.scheduler
        cache = self.cache
        slots = self._decode_slots()
        for slot in slots:
            cache.reserve(slot, int(cache.lengths[slot]) + 1)
        active = np.zeros((self.slots,), bool)
        active[slots] = True
        tokens = torch.tensor(st["last_tokens"], dtype=torch.long,
                              device=self.device)
        positions = cache.lengths_device().long()
        t0 = time.monotonic()
        logits, cache.k, cache.v = self.step(
            self.params, cache.k, cache.v, tokens, positions,
            cache.table_device(),
            torch.tensor(active, device=self.device))
        sampled = greedy_sample(logits).cpu().numpy()  # sync point
        # Per-slot screen: one reduced scalar per row (a sum propagates
        # any NaN/Inf in the vocab axis), fetched with the sample.
        finite = torch.isfinite(logits.sum(-1)).cpu().numpy()
        step_s = time.monotonic() - t0
        st["decode_steps"] += 1
        st["occ_samples"].append(sched.occupancy)
        for slot in slots:
            req = sched.active[slot]
            if not finite[slot]:
                self._quarantine_logits(st, slot, req)
                continue
            tok = int(sampled[slot])
            req.tokens.append(tok)
            cache.lengths[slot] += 1
            st["last_tokens"][slot] = tok
            sched.note_decode_token(req, step_s)
            if req.finished or int(cache.lengths[slot]) >= self.max_len:
                self._release(st, slot, now)
        return step_s

    def re_prefill(self, slot: int, req: Request) -> int:
        """Rebuild a request's KV from its prompt + emitted tokens (all
        but the last, which the next decode step consumes); returns that
        next input token."""
        if not req.tokens:
            raise ValueError(f"request {req.rid} has no emitted tokens")
        full = np.concatenate([np.asarray(req.prompt, np.int64),
                               np.asarray(req.tokens[:-1], np.int64)])
        with _spans.recorder().span("dispatch", name="reprefill",
                                    leg="serving_reprefill"):
            _, kl, vl = self._prefill(
                torch.tensor(full, device=self.device)[None])
            self.cache.write_prefill(slot, kl[:, 0], vl[:, 0])
        return int(req.tokens[-1])

    # -- the serve loop ----------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request]) -> ServingReport:
        """Run the open-loop request stream to completion."""
        sched = self.scheduler
        pending = sorted(requests, key=lambda r: r.arrival_s)
        rejected = 0
        admissible = []
        for req in pending:
            if req.prompt_len + req.max_new_tokens > self.max_len:
                rejected += 1
                sched._m_requests.labels(event="rejected").inc()
            else:
                admissible.append(req)

        start = time.monotonic()
        skip = 0.0

        def now() -> float:
            return time.monotonic() - start + skip

        st: Dict[str, Any] = {
            "completed": [], "occ_samples": [], "decode_steps": 0,
            "prefills": 0,
            "last_tokens": np.zeros((self.slots,), np.int64)}
        completed: List[Request] = st["completed"]
        prompts_dev: Dict[int, Any] = {}

        with RequestPrefetcher(admissible, self.prefetch_depth,
                               self.device) as feed:
            fetched = next(feed, None)
            while True:
                # Pull every request whose arrival time has passed.
                while fetched is not None and \
                        fetched[0].arrival_s <= now():
                    req, dev = fetched
                    prompts_dev[req.rid] = dev
                    sched.submit(req)
                    fetched = next(feed, None)
                if not sched.has_work():
                    if fetched is None:
                        break
                    # Idle: fast-forward the virtual clock to the next
                    # arrival instead of sleeping.
                    gap = fetched[0].arrival_s - now()
                    if gap > 0:
                        skip += gap
                    continue

                for slot, req in sched.admit(now()):
                    dev = prompts_dev.pop(req.rid)
                    first = self._do_prefill(slot, req, dev)
                    st["prefills"] += 1
                    self._join_decode(st, slot, req, first, now)

                if not self._decode_slots():
                    continue
                self.decode_once(st, now)

        wall_s = max(time.monotonic() - start, 1e-9)
        new_tokens = sum(len(r.tokens) for r in completed)
        ttfts = [r.ttft_s for r in completed if r.ttft_s is not None]
        lats = [lat for r in completed for lat in r.token_latencies]
        return ServingReport(
            num_requests=len(requests), completed=len(completed),
            rejected=rejected,
            prompt_tokens=sum(r.prompt_len for r in completed),
            new_tokens=new_tokens, wall_s=wall_s,
            decode_steps=int(st["decode_steps"]),
            prefills=int(st["prefills"]),
            tokens_per_s=new_tokens / wall_s,
            ttft_p50_s=_pct(ttfts, 50), ttft_p99_s=_pct(ttfts, 99),
            token_latency_p50_s=_pct(lats, 50),
            token_latency_p99_s=_pct(lats, 99),
            mean_occupancy=(float(np.mean(st["occ_samples"]))
                            if st["occ_samples"] else 0.0))
