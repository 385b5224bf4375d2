"""Serving engine front-end: prefetch -> prefill -> continuous decode.

Counterpart of ``horovod_tpu/serving/engine.py``.  One object owns the
data plane: the paged KV cache, the continuous-batching scheduler,
prefill (flash forward kernel) and the decode step (paged decode
kernel), on one device or over a tensor-parallel mesh (``mesh=``, a
:class:`~horovod_tpu_torch.parallel.mesh.RankMesh` with a ``tp`` axis).
A producer thread stages each upcoming prompt onto the device while the
engine is still decoding, so admission never waits on a host-to-device
copy.

On a mesh each rank holds its kv heads of the pool
(:func:`~.kvcache.cache_sharding`) and its shard of the decode params
(:func:`~.decode.decode_param_specs`, cut once a mesh); the full param
dict stays on every rank for prefill, which runs replicated as in the
reference.  :meth:`ServingEngine.rebuild_mesh` moves the decode plane to
another mesh (a fresh pool, the same scheduler).  At world > 1 the ranks
run in lock-step (:mod:`.lockstep`): rank 0 reads the clock and every
loop turn ends in one header from it.

Knobs (constructor argument, else environment, as in the reference):

* ``HOROVOD_SERVING_SLOTS`` -- decode batch slots (default 8)
* ``HOROVOD_SERVING_PAGE_SIZE`` -- KV page length in tokens (default 16)
* ``HOROVOD_SERVING_MAX_LEN`` -- per-sequence cap (default: model max)
* ``HOROVOD_SERVING_PREFETCH`` -- request prefetch depth (default 2)
* ``HOROVOD_SPEC_DECODE`` -- speculative decoding on/off (default off)
* ``HOROVOD_SPEC_K`` -- draft tokens a speculative round (default 4)
* ``HOROVOD_PREFILL_CHUNK`` -- chunked-prefill chunk length in tokens
  (default 0: whole-prompt prefill)
* ``HOROVOD_KV_COMPRESS`` -- fp8 cold KV pages (default off)
* ``HOROVOD_PREFIX_CACHE`` -- the radix prefix cache over the page pool
  (default off): a prompt that hits a cached prefix attaches the matched
  pages (refcounted, copy-on-write) and prefills only its tail
* ``HOROVOD_SESSION_TTL_STEPS`` -- engine steps a session's warm context
  stays pinned without reuse (default 512)
* ``HOROVOD_TENANT_CLASSES`` -- per-tenant SLO classes

LoRA banks (``adapters=``, :func:`~.decode.stack_adapters`): each
request's ``adapter_id`` picks its adapter, gathered per slot inside the
decode step, so requests of different adapters share one decode batch
over one base.  Speculative decoding (:meth:`ServingEngine.spec_round`):
a drafter (:mod:`.spec`, default :class:`~.spec.NgramDrafter`) proposes
``spec_k`` tokens a slot and one verify step of width ``spec_k + 1``
scores them; the stream is plain greedy decode's.

Chunked prefill (``prefill_chunk``): a prompt longer than a chunk is
prefilled one chunk a loop iteration (:meth:`ServingEngine._advance_chunks`,
leg ``serving_prefill_chunk``), each chunk attending over the K/V of the
ones before it, so the decode batch keeps stepping while a long prompt
fills in.  fp8 KV pages (``kv_compress``): the cache compresses cold
pages on demand and the decode and verify steps read them through the
e4m3 variant of the decode kernel.  The prefix cache (``prefix_cache``):
:class:`~.kvcache.PrefixCache` over the pool, with sessions pinned at
``session_ttl_steps``.

As in the reference, LoRA banks refuse speculation, fp8 pages and the
prefix cache.  Unlike it, they also refuse chunked prefill, and a chunk
gets the engine's ``lora_alpha``: the reference's chunk path calls
``prefill_forward`` without the banks and without ``lora_alpha``
(``horovod_tpu/serving/engine.py:266-269``), so a banked engine would
prefill long prompts on the bare base, and in-tree adapters would get
alpha 16 whatever the engine was given (ROADMAP §3).

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
from ..core.state import global_state
from ..parallel.tp import shard_params
from ..timeline import metrics as _metrics
from ..timeline import spans as _spans
from .decode import (TP_AXIS, build_decode_step, build_verify_step,
                     decode_param_specs, greedy_sample, prefill_forward)
from .kvcache import (CacheConfig, PagedKVCache, PrefixCache,
                      cache_sharding)
from .lockstep import LockStep
from .scheduler import (ContinuousBatchScheduler, Request,
                        parse_tenant_classes)
from .spec import NgramDrafter


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
    # Speculative decoding (zero when it is off).
    spec_rounds: int = 0
    proposed_tokens: int = 0
    accepted_tokens: int = 0
    acceptance_rate: float = 0.0
    # Prefix cache (zero when it is off).
    prefix_queries: int = 0
    prefix_hits: int = 0
    prefix_hit_rate: float = 0.0
    prefill_tokens_cached: int = 0
    # Fraction of prompt tokens whose prefill was skipped (matched pages
    # attached instead of computed).
    prefill_flops_avoided: float = 0.0
    session_resumes: int = 0
    # Prefill forward passes (whole prompts, prefix tails, chunks and
    # re-prefills): each runs the flash forward once a layer.
    prefill_forwards: int = 0
    prefill_chunks: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


class ServingEngine:
    """Continuous-batching inference over one Llama-family model.
    ``params`` is the flat param dict
    (:func:`~horovod_tpu_torch.models.init_llama_params` or
    :func:`~horovod_tpu_torch.models.params_from_jax`) already on
    ``device``; ``device`` defaults to ``init()``'s on a mesh, else to
    ``cuda``.  ``mesh``: ``None`` for one device, else a rank mesh whose
    ``tp`` axis splits the decode step (every rank of the world builds
    the engine and calls :meth:`serve`).  ``adapters``: banked
    LoRA leaves (:func:`~.decode.stack_adapters`) on ``device``, each
    request's ``Request.adapter_id`` choosing its adapter (the
    reference's ``adapter_ids=`` argument, which it never reads, is not
    taken); ``lora_alpha`` is the adapters' alpha, which also applies to
    in-tree ``lora_a``/``lora_b`` leaves, in chunks too.  The other
    knobs: see the module docstring."""

    def __init__(self, config, params, *, mesh=None, device=None,
                 slots: int = 0, page_size: int = 0, max_len: int = 0,
                 dtype=torch.float32, adapters=None,
                 lora_alpha: float = 16.0, prefetch_depth: int = 0,
                 spec_decode: Optional[bool] = None, spec_k: int = 0,
                 drafter=None, prefill_chunk: int = -1,
                 kv_compress: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 session_ttl_steps: int = 0, tenants=None):
        if device is None and mesh is not None:
            device = global_state().device
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.spec_decode = (_env_bool("SPEC_DECODE") if spec_decode is None
                            else bool(spec_decode))
        self.spec_k = spec_k or _env_int("SPEC_K", 4)
        self.prefill_chunk = (_env_int("PREFILL_CHUNK", 0)
                              if prefill_chunk < 0 else prefill_chunk)
        self.kv_compress = (_env_bool("KV_COMPRESS") if kv_compress is None
                            else bool(kv_compress))
        self.prefix_cache = (_env_bool("PREFIX_CACHE")
                             if prefix_cache is None else bool(prefix_cache))
        self.session_ttl_steps = session_ttl_steps or _env_int(
            "SESSION_TTL_STEPS", 512)
        if self.spec_decode and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if adapters is not None and self.spec_decode:
            raise NotImplementedError(
                "speculative decoding with LoRA banks is not wired; "
                "run adapters through plain decode")
        if adapters is not None and self.kv_compress:
            raise NotImplementedError(
                "fp8 KV compression with LoRA banks is not wired")
        if adapters is not None and self.prefix_cache:
            raise NotImplementedError(
                "prefix cache with LoRA banks is not wired: cached K/V "
                "is keyed by tokens only, but LoRA'd wk/wv make K/V "
                "adapter-dependent")
        if adapters is not None and self.prefill_chunk > 0:
            raise NotImplementedError(
                "chunked prefill with LoRA banks is not wired: a chunk "
                "would prefill on the bare base (the reference's chunk "
                "path drops the banks); prefill adapters whole")
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
        self.adapters = adapters
        self.lora_alpha = lora_alpha
        self.cache_config = CacheConfig(
            num_layers=config.num_layers,
            num_kv_heads=config.num_kv_heads, head_dim=config.head_dim,
            slots=self.slots, page_size=self.page_size,
            max_len=self.max_len,
            dtype=str(dtype).replace("torch.", ""),
            compress=self.kv_compress)
        self.verify_step = None
        self._place(mesh)
        # Admission prices the widest step a slot can take: k drafts +
        # the target's bonus token under speculation, else 1.
        budget = self.spec_k + 1 if self.spec_decode else 1
        self.scheduler = ContinuousBatchScheduler(
            self.slots, self.cache, token_budget=budget, tenants=tenants)
        # The radix prefix cache installs itself as the cache's reclaim
        # callback: page pressure demotes or evicts cached prefixes
        # before admission fails.
        self._prefix: Optional[PrefixCache] = None
        if self.prefix_cache:
            self._prefix = PrefixCache(
                self.cache, session_ttl_steps=self.session_ttl_steps)
        self.drafter = None
        if self.spec_decode:
            self.drafter = drafter if drafter is not None \
                else NgramDrafter()
        # Lock-step over the world (module docstring): one header a
        # loop turn from rank 0.
        self._ls: Optional[LockStep] = None
        if mesh is not None and global_state().size > 1:
            self._ls = LockStep(self.slots, budget)
        # In-progress chunked prefills: slot -> {req, dev, pos, start,
        # past}.  Their slots stay in state "prefill", out of the decode
        # batch, until the last chunk lands.
        self._chunking: Dict[int, Dict[str, Any]] = {}
        self._forwards = 0
        # Slots whose nonfinite logits wait for the turn's header before
        # their re-prefill (lock-step: every rank re-prefills together).
        self._quarantined: List[tuple] = []

    # -- the decode plane on a mesh -----------------------------------------
    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape[TP_AXIS])

    def _place(self, mesh) -> None:
        """Build the decode plane on ``mesh``: this rank's share of the
        pool, its shard of the decode params (the full dict itself at tp
        1) and the decode and verify steps."""
        self.mesh = mesh
        self.in_mesh = mesh is None or bool(
            (mesh.ranks == global_state().rank).any())
        self.mesh_root = 0 if mesh is None else int(mesh.ranks.min())
        self.cache = PagedKVCache(
            self.cache_config, self.device if mesh is None
            else cache_sharding(mesh, TP_AXIS, self.device))
        tp = self.tp
        if tp == 1:
            self.decode_params = self.params
        elif self.in_mesh:
            self.decode_params = shard_params(
                self.params, decode_param_specs(self.params, TP_AXIS),
                mesh.axis_index(TP_AXIS), tp)
        else:
            self.decode_params = None
        kw = dict(slots=self.slots, page_size=self.page_size,
                  pages_per_slot=self.cache_config.pages_per_slot,
                  dtype=self.dtype, compress=self.kv_compress)
        self.step = build_decode_step(
            self.config, mesh, with_lora=self.adapters is not None,
            lora_alpha=self.lora_alpha, **kw)
        if self.spec_decode:
            self.verify_step = build_verify_step(
                self.config, mesh, width=self.spec_k + 1, **kw)

    def rebuild_mesh(self, mesh) -> None:
        """Move the decode plane onto another tp mesh.

        The cache layout is mesh-size invariant (``CacheConfig.layout``),
        so a resize is a fresh pool with the new kv-head split, the same
        scheduler (the queue and the requests in flight survive), a
        fresh prefix cache over the new pool, and rebuilt decode and
        verify steps whose ``_meta`` records ``resized_from``.  Prefill
        runs on the full params and carries over; suspended requests are
        re-prefilled onto the new pool (:meth:`re_prefill`).  Every rank
        of the world calls it, with the same mesh."""
        old_tp = self.tp
        self.cache = None
        self.decode_params = None
        self._place(mesh)
        self.scheduler.cache = self.cache
        if self._prefix is not None:
            self._prefix = PrefixCache(
                self.cache, session_ttl_steps=self.session_ttl_steps)
        self.step._meta["resized_from"] = old_tp
        if self.verify_step is not None:
            self.verify_step._meta["resized_from"] = old_tp

    def _prefill(self, tokens, req: Request, past=None):
        """One prefill forward: the whole prompt with the request's
        adapter, or (``past``) a chunk or prefix tail continuing cached
        K/V, with the engine's ``lora_alpha`` for in-tree adapters."""
        self._forwards += 1
        if past is not None:
            return prefill_forward(self.params, self.config, tokens,
                                   dtype=self.dtype, past=past,
                                   lora_alpha=self.lora_alpha)
        aid = req.adapter_id if self.adapters is not None else None
        return prefill_forward(self.params, self.config, tokens,
                               dtype=self.dtype, adapters=self.adapters,
                               adapter_id=aid, lora_alpha=self.lora_alpha)

    # -- one-request helpers ----------------------------------------------
    def _begin_prefill(self, st: Dict[str, Any], slot: int, req: Request,
                       dev, now) -> None:
        """Admit one request into its slot: match the prompt against the
        prefix cache (attach the matched pages, no compute), then prefill
        the rest -- in chunks when it is longer than one."""
        matched, entries = 0, ()
        if self._prefix is not None:
            matched, entries = self._prefix.match(req.prompt)
            st["prefix_queries"] += 1
            if matched:
                st["prefix_hits"] += 1
                st["prefill_cached"] += matched
                self.cache.attach_pages(slot, entries, matched)
            st["prefill_computed"] += req.prompt_len - matched
            if req.session_id is not None and \
                    self._prefix.touch_session(req.session_id) and matched:
                st["session_resumes"] += 1
        st["prefills"] += 1
        if 0 < self.prefill_chunk < req.prompt_len - matched:
            # A long tail: one chunk a loop iteration, decode between; a
            # matched prefix seeds the running past from its pages.
            past = self.cache.gather_pages(entries) if matched else None
            self._chunking[slot] = {"req": req, "dev": dev, "pos": matched,
                                    "start": matched, "past": past}
        else:
            first = self._do_prefill(slot, req, dev, matched=matched,
                                     entries=entries)
            self._join_decode(st, slot, req, first, now)

    def _do_prefill(self, slot: int, req: Request, prompt_dev,
                    matched: int = 0, entries: Sequence = ()) -> int:
        with _spans.recorder().span("dispatch", name="prefill",
                                    leg="serving_prefill"):
            if matched:
                # A prefix hit: only the tail runs, over the cached
                # pages as past K/V.
                past = self.cache.gather_pages(entries)
                logits, kl, vl = self._prefill(prompt_dev[matched:][None],
                                               req, past=past)
                self.cache.write_prefill(slot, kl[:, 0, matched:],
                                         vl[:, 0, matched:], start=matched)
            else:
                logits, kl, vl = self._prefill(prompt_dev[None], req)
                self.cache.write_prefill(slot, kl[:, 0], vl[:, 0])
            first = int(greedy_sample(logits[:, -1, :])[0])
        return first

    def _advance_chunks(self, st: Dict[str, Any], now) -> None:
        """Push each chunked prefill on by one chunk.  The last chunk's
        full-context K/V is scattered once, so chunked and whole prefill
        leave the same cache layout."""
        for slot in list(self._chunking):
            c = self._chunking[slot]
            req: Request = c["req"]
            chunk = c["dev"][c["pos"]:c["pos"] + self.prefill_chunk]
            with _spans.recorder().span("dispatch", name="prefill_chunk",
                                        leg="serving_prefill_chunk"):
                logits, kl, vl = self._prefill(chunk[None], req,
                                               past=c["past"])
            st["prefill_chunks"] += 1
            c["past"] = (kl, vl)
            c["pos"] += int(chunk.shape[0])
            if c["pos"] < req.prompt_len:
                continue
            del self._chunking[slot]
            start = c["start"]
            self.cache.write_prefill(slot, kl[:, 0, start:],
                                     vl[:, 0, start:], start=start)
            first = int(greedy_sample(logits[:, -1, :])[0])
            self._join_decode(st, slot, req, first, now)

    def _join_decode(self, st: Dict[str, Any], slot: int, req: Request,
                     first: int, now) -> None:
        """Prefill done (whole or last chunk): the first token is
        sampled and the request joins the decode batch; its full prompt
        pages go into the prefix tree and its session is pinned."""
        req.tokens.append(first)
        self.note_first_token(slot, req, now)
        st["last_tokens"][slot] = first
        st["adapter_ids"][slot] = req.adapter_id
        if self._prefix is not None:
            self._prefix.insert(req.prompt, slot)
            if req.session_id is not None:
                self._prefix.pin_session(req.session_id, req.prompt)
        if self.drafter is not None:
            self.drafter.on_admit(slot, req)
        if req.finished:
            self._release(st, slot, now)

    def note_first_token(self, slot: int, req: Request, now) -> None:
        """A request's first token was sampled: it joins the decode
        batch at ``now()`` (in lock-step, at rank 0's reading, which the
        other ranks take from the turn's header)."""
        ls = self._ls
        if ls is None:
            self.scheduler.note_prefill(req, now())
            return
        t = ls.stamp_first(slot)
        self.scheduler.note_prefill(req, t)
        if t is None:
            ls.defer(lambda hdr: self.scheduler.note_first_token(
                req, hdr["first"][slot]))

    def _release(self, st: Dict[str, Any], slot: int, now) -> None:
        if self.drafter is not None:
            self.drafter.on_release(slot)
        st["completed"].append(self.scheduler.release(slot, now()))

    def _decode_slots(self) -> List[int]:
        """Live slots minus chunking prefills and in-flight handoffs
        (neither has its context resident yet)."""
        return [s for s, r in self.scheduler.active.items()
                if r.state not in ("prefill", "handoff")]

    def _quarantine_logits(self, st: Dict[str, Any], slot: int,
                           req: Request) -> None:
        """A slot produced nonfinite logits: never stream a token sampled
        from them.  Rebuild its context from the request's own tokens and
        retry the same position next round."""
        if self._ls is not None:
            # In lock-step the re-prefill waits for the turn's header:
            # the leader reaches this before it, the others after, and
            # a re-prefill may sum over the tp set.
            self._quarantined.append((st, slot, req))
            return
        self._reprefill_quarantined(st, slot, req)

    def _reprefill_quarantined(self, st: Dict[str, Any], slot: int,
                               req: Request) -> None:
        _metrics.registry().counter(
            "horovod_guard_serving_reprefills_total",
            "Decode rounds where a slot's nonfinite logits were "
            "quarantined by re-prefilling its context").inc()
        st["last_tokens"][slot] = self.re_prefill(slot, req)

    def sync(self, tick: Optional[dict] = None) -> Optional[dict]:
        """End a loop turn: in lock-step, the header exchange (rank 0's
        clock, times, tokens, and ``tick``, the control plane's), then
        the quarantined re-prefills; ``None`` on one rank."""
        if self._ls is None:
            return None
        hdr = self._ls.exchange(tick)
        self._drain_quarantined()
        return hdr

    def _drain_quarantined(self) -> None:
        """The re-prefills the turn's header released (lock-step)."""
        quarantined, self._quarantined = self._quarantined, []
        for args in quarantined:
            self._reprefill_quarantined(*args)

    def _step_out(self, step, tokens, active, width: int,
                  extra: tuple) -> tuple:
        """Run ``step`` on this rank (a rank outside the mesh runs none)
        and return ``(sampled, finite, step_s)``: the tokens from the
        logits, the mesh's lowest rank's when rank 0 is outside the mesh
        (lock-step).  ``step_s`` is the wall around both."""
        cache = self.cache
        sampled = finite = None
        t0 = time.monotonic()
        if self.in_mesh:
            logits, cache.k, cache.v = step(
                self.decode_params, cache.k, cache.v,
                torch.tensor(tokens, device=self.device),
                cache.lengths_device().long(), cache.table_device(),
                torch.tensor(active, device=self.device), *extra)
            sampled = greedy_sample(logits).cpu().numpy()  # sync point
            # Per-slot screen: one reduced scalar a row (a sum propagates
            # any NaN/Inf in the vocab axis), fetched with the sample.
            red = (-1,) if width == 1 else (-2, -1)
            finite = torch.isfinite(logits.sum(red)).cpu().numpy()
        ls = self._ls
        if ls is not None and not (self.mesh.ranks == 0).any():
            shape = (self.slots,) if width == 1 else (self.slots, width)
            sampled, finite = ls.tokens_from(self.mesh_root, sampled,
                                             finite, shape)
        return sampled, finite, time.monotonic() - t0

    def _after_step(self, fn, sampled, finite, step_s, width: int) -> None:
        """Handle a step's tokens: ``fn(sampled, finite, step_s)`` now on
        one rank and on the lock-step leader (which sends them with the
        header), else when the header arrives, with the leader's
        ``step_s`` (and its tokens on a rank outside the mesh)."""
        ls = self._ls
        if ls is None:
            fn(sampled, finite, step_s)
            return
        if ls.leader:
            ls.note_step(step_s, sampled, finite)
            fn(sampled, finite, step_s)
            return
        shape = (self.slots,) if width == 1 else (self.slots, width)

        def later(hdr):
            toks = hdr["tokens"][:int(np.prod(shape))].reshape(shape)
            if sampled is not None and self.mesh_root == 0 and \
                    not np.array_equal(toks, sampled):
                raise RuntimeError(
                    "lock-step: this rank's sampled tokens differ from "
                    "rank 0's; the tp logits are not replicated")
            fn(toks if sampled is None else sampled,
               hdr["finite"] if finite is None else finite, hdr["step_s"])
        ls.defer(later)

    # -- one decode round --------------------------------------------------
    def decode_once(self, st: Dict[str, Any], now) -> float:
        """One continuous-batching decode step over the live slots."""
        sched = self.scheduler
        cache = self.cache
        slots = self._decode_slots()
        for slot in slots:
            length = int(cache.lengths[slot])
            cache.reserve(slot, length + 1, writable_from=length)
        active = np.zeros((self.slots,), bool)
        active[slots] = True
        extra = cache.compress_operands() if self.kv_compress else ()
        if self.adapters is not None:
            extra += (self.adapters, torch.tensor(st["adapter_ids"],
                                                  device=self.device))
        sampled, finite, step_s = self._step_out(
            self.step, np.asarray(st["last_tokens"], np.int64), active, 1,
            extra)
        st["decode_steps"] += 1
        st["occ_samples"].append(sched.occupancy)

        def emit(sampled, finite, step_s):
            for slot in slots:
                req = sched.active[slot]
                if not finite[slot]:
                    self._quarantine_logits(st, slot, req)
                    continue
                tok = int(sampled[slot])
                req.tokens.append(tok)
                self.cache.lengths[slot] += 1
                st["last_tokens"][slot] = tok
                sched.note_decode_token(req, step_s)
                if req.finished or \
                        int(self.cache.lengths[slot]) >= self.max_len:
                    self._release(st, slot, now)
        self._after_step(emit, sampled, finite, step_s, 1)
        return step_s

    def spec_round(self, st: Dict[str, Any], now) -> float:
        """One speculative round: draft k, verify k + 1 wide, accept the
        longest agreeing prefix per slot.

        Every emitted token is the TARGET's argmax (column j's logits
        condition on the accepted prefix only), so the stream is plain
        decode's; the drafter changes only how many tokens a round
        emits.  Rejected draft K/V stays above the rolled-back length:
        masked, as on a recycled page.
        """
        sched = self.scheduler
        cache = self.cache
        k = self.spec_k
        width = k + 1
        slots = self._decode_slots()
        reqs = {s: sched.active[s] for s in slots}
        base = {s: int(cache.lengths[s]) for s in slots}
        for s in slots:
            # Room for the round's widest write, capped at the slot's
            # allotment (columns past max_len go to the scratch page).
            cache.reserve(s, min(base[s] + width, self.max_len),
                          writable_from=base[s])
        drafts = self.drafter.propose(reqs, k, np.array(st["last_tokens"]))
        tokens_in = np.zeros((self.slots, width), np.int64)
        tokens_in[:, 0] = st["last_tokens"]
        tokens_in[:, 1:] = drafts
        active = np.zeros((self.slots,), bool)
        active[slots] = True
        extra = cache.compress_operands() if self.kv_compress else ()
        # A nonfinite column anywhere in the window disqualifies the
        # slot's round (the agreeing-prefix walk would condition on it).
        sampled, finite, step_s = self._step_out(
            self.verify_step, tokens_in, active, width, extra)
        st["decode_steps"] += 1
        st["spec_rounds"] += 1
        st["occ_samples"].append(sched.occupancy)

        def accept(sampled, finite, step_s):
            for s in slots:
                req = reqs[s]
                if not finite[s]:
                    self._quarantine_logits(st, s, req)
                    continue
                # Draft j survives iff every earlier draft did and it
                # equals the target's argmax at its position.
                m = 0
                while m < k and drafts[s, m] == sampled[s, m]:
                    m += 1
                emit = min(m + 1, req.max_new_tokens - len(req.tokens),
                           self.max_len - base[s])
                accepted = max(emit - 1, 0)
                st["proposed"] += k
                st["accepted"] += accepted
                sched.note_spec(k, accepted)
                for j in range(emit):
                    req.tokens.append(int(sampled[s, j]))
                    sched.note_decode_token(req, step_s / max(emit, 1))
                self.cache.lengths[s] = base[s] + emit
                st["last_tokens"][s] = req.tokens[-1]
                self.drafter.observe(s, req, accepted)
                if req.finished or \
                        int(self.cache.lengths[s]) >= self.max_len:
                    self._release(st, s, now)
        self._after_step(accept, sampled, finite, step_s, width)
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
                torch.tensor(full, device=self.device)[None], req)
            self.cache.write_prefill(slot, kl[:, 0], vl[:, 0])
        if self.drafter is not None:
            self.drafter.re_prefill(slot, req)
        return int(req.tokens[-1])

    # -- the serve loop ----------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request]) -> ServingReport:
        """Run the open-loop request stream to completion.  At world > 1
        every rank calls it with the same requests and returns the same
        report (lock-step: rank 0's clock and times)."""
        sched = self.scheduler
        ls = self._ls
        if ls is not None and self.mesh.size != global_state().size:
            raise ValueError(
                f"serve() at world > 1 takes a mesh of every rank (it has "
                f"{self.mesh.size} of {global_state().size}); the control "
                f"plane keeps ranks outside its mesh in step")
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

        if ls is not None:
            ls.reset()
            now = ls.now
        st = self.new_state()
        completed: List[Request] = st["completed"]
        prompts_dev: Dict[int, Any] = {}
        self._chunking.clear()
        forwards0 = self._forwards

        with RequestPrefetcher(admissible, self.prefetch_depth,
                               self.device) as feed:
            fetched = next(feed, None)
            while True:
                if self._prefix is not None:
                    # The session-TTL clock ticks every iteration, idle
                    # ones included, so pins always expire.
                    self._prefix.tick()
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
                    if ls is None:
                        gap = fetched[0].arrival_s - now()
                        if gap > 0:
                            skip += gap
                    elif ls.leader:
                        gap = fetched[0].arrival_s - ls.fresh()
                        if gap > 0:
                            ls.skip += gap
                    self.sync()
                    continue

                for slot, req in sched.admit(now()):
                    self._begin_prefill(st, slot, req,
                                        prompts_dev.pop(req.rid), now)
                if self._chunking:
                    self._advance_chunks(st, now)
                # One round over the decode batch: a k-draft verify when
                # speculating, else one plain single-token step.
                if self._decode_slots():
                    if self.spec_decode:
                        self.spec_round(st, now)
                    else:
                        self.decode_once(st, now)
                self.sync()

        wall_s = max(time.monotonic() - start if ls is None else ls.wall,
                     1e-9)
        new_tokens = sum(len(r.tokens) for r in completed)
        ttfts = [r.ttft_s for r in completed if r.ttft_s is not None]
        lats = [lat for r in completed for lat in r.token_latencies]
        proposed, accepted = int(st["proposed"]), int(st["accepted"])
        pq, ph = int(st["prefix_queries"]), int(st["prefix_hits"])
        cached, computed = int(st["prefill_cached"]), \
            int(st["prefill_computed"])
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
                            if st["occ_samples"] else 0.0),
            spec_rounds=int(st["spec_rounds"]), proposed_tokens=proposed,
            accepted_tokens=accepted,
            acceptance_rate=(accepted / proposed if proposed else 0.0),
            prefix_queries=pq, prefix_hits=ph,
            prefix_hit_rate=(ph / pq if pq else 0.0),
            prefill_tokens_cached=cached,
            prefill_flops_avoided=(cached / (cached + computed)
                                   if cached + computed else 0.0),
            session_resumes=int(st["session_resumes"]),
            prefill_forwards=self._forwards - forwards0,
            prefill_chunks=int(st["prefill_chunks"]))

    def new_state(self) -> Dict[str, Any]:
        """A fresh per-run state dict for :meth:`decode_once` and the
        prefill helpers (``serve`` and the fleet's decode workers)."""
        return {
            "completed": [], "occ_samples": [], "decode_steps": 0,
            "prefills": 0, "prefill_chunks": 0, "spec_rounds": 0,
            "proposed": 0, "accepted": 0, "prefix_queries": 0,
            "prefix_hits": 0, "prefill_cached": 0, "prefill_computed": 0,
            "session_resumes": 0,
            "last_tokens": np.zeros((self.slots,), np.int64),
            "adapter_ids": np.zeros((self.slots,), np.int64)}
