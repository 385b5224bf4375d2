"""Speculative-decoding drafters.

Counterpart of ``horovod_tpu/serving/spec.py``.  Each speculative round
is a cheap PROPOSE pass (k draft tokens a slot) and one verify call of
the target (:func:`~horovod_tpu_torch.serving.decode.build_verify_step`,
width ``k + 1``).  The engine accepts each slot's longest draft prefix
that agrees with the target's own argmaxes, plus the target's token at
the first disagreement, so the emitted stream is plain greedy decode's
whatever the drafter proposes; the drafter only moves throughput.

* :class:`NgramDrafter` -- prompt lookup on the host: propose what
  followed the most recent earlier occurrence of the current suffix
  n-gram in ``prompt + emitted``.  No device work.
* :class:`ModelDrafter` -- a small Llama (or the target's own weights)
  through its OWN paged cache and width-1 decode step on the same
  device.  Its cache stays one token behind the target's context, and a
  rejected draft is rolled back by the masking contract (entries above
  ``lengths`` are unreachable).

Both expose the hooks the engine drives: ``on_admit(slot, req)`` after
the target's prefill, ``propose(reqs, k, last_tokens)`` before each
verify, ``observe(slot, req, accepted)`` after it, ``on_release(slot)``
when the slot recycles and ``re_prefill(slot, req)`` when the target
rebuilt the slot's context.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device
from .decode import build_decode_step, greedy_sample, prefill_forward
from .kvcache import CacheConfig, PagedKVCache
from .scheduler import Request


class NgramDrafter:
    """Prompt-lookup drafting: no draft model, no device work.

    For each slot, search ``prompt + emitted`` (excluding the final
    token) backwards for the most recent earlier occurrence of the
    current ``ngram``-token suffix and propose the tokens that followed
    it; fall back to shorter suffixes, then to repeating the last token
    (the verify step needs a full ``[slots, k]`` block, and a wrong draft
    only costs acceptance).
    """

    def __init__(self, ngram: int = 2):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = ngram

    # -- engine hooks (stateless: everything lives on the request) -----
    def on_admit(self, slot: int, req: Request) -> None:
        pass

    def observe(self, slot: int, req: Request, accepted: int) -> None:
        pass

    def on_release(self, slot: int) -> None:
        pass

    def re_prefill(self, slot: int, req: Request) -> None:
        pass

    def propose(self, reqs: Dict[int, Request], k: int,
                last_tokens: np.ndarray) -> np.ndarray:
        out = np.zeros((last_tokens.shape[0], k), np.int32)
        for slot, req in reqs.items():
            ctx = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.tokens, np.int32)])
            out[slot] = self._lookup(ctx, k)
        return out

    def _lookup(self, ctx: np.ndarray, k: int) -> np.ndarray:
        n = len(ctx)
        for g in range(min(self.ngram, n - 1), 0, -1):
            suffix = ctx[n - g:]
            # Most recent earlier match (the suffix's own position is
            # excluded, so the continuation is not empty).
            for i in range(n - g - 1, -1, -1):
                if np.array_equal(ctx[i:i + g], suffix):
                    cont = ctx[i + g:i + g + k]
                    out = np.empty((k,), np.int32)
                    out[:len(cont)] = cont
                    out[len(cont):] = cont[-1]
                    return out
        return np.full((k,), ctx[-1], np.int32)


class ModelDrafter:
    """Draft with a Llama through its own paged cache on one device.

    The cache tracks the target's context minus its final token (that
    token is the round's first verify input, fed to the drafter as
    ``x0``).  A propose round feeds ``x0, d1 .. d_{k-1}``, writing their
    K/V at the write head; :meth:`observe` rolls the head back to the
    accepted prefix.  If plain decode ran in between, :meth:`propose`
    first catches the cache up token by token from the request's emitted
    stream.  ``steps`` and ``prefills`` count the drafter's own decode
    steps and prefills (each decode step launches the decode kernel
    once a layer on the card, each prefill the flash forward).
    """

    def __init__(self, config, params, *, slots: int, page_size: int,
                 max_len: int, dtype=torch.float32, device=None):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cache_config = CacheConfig(
            num_layers=config.num_layers,
            num_kv_heads=config.num_kv_heads, head_dim=config.head_dim,
            slots=slots, page_size=page_size, max_len=max_len,
            dtype=str(dtype).replace("torch.", ""))
        self.cache = PagedKVCache(self.cache_config, self.device)
        self.step = build_decode_step(
            config, slots=slots, page_size=page_size,
            pages_per_slot=self.cache_config.pages_per_slot, dtype=dtype)
        self.slots = slots
        self.max_len = max_len
        self.steps = 0
        self.prefills = 0
        self._round_base: Dict[int, tuple] = {}

    # -- engine hooks --------------------------------------------------
    def on_admit(self, slot: int, req: Request) -> None:
        self._prefill_ctx(slot, np.asarray(req.prompt, np.int64))

    def re_prefill(self, slot: int, req: Request) -> None:
        self.cache.free_slot(slot)
        ctx = np.concatenate([np.asarray(req.prompt, np.int64),
                              np.asarray(req.tokens[:-1], np.int64)])
        self._prefill_ctx(slot, ctx)

    def on_release(self, slot: int) -> None:
        self._round_base.pop(slot, None)
        self.cache.free_slot(slot)

    def observe(self, slot: int, req: Request, accepted: int) -> None:
        # The round wrote inputs (x0, d1 .. d_{k-1}); x0 and the first
        # ``accepted`` drafts are now context, the rest masked garbage.
        head = self._round_base.pop(slot, None)
        if head is None:
            return
        base, written = head
        self.cache.lengths[slot] = base + min(accepted + 1, written)

    def propose(self, reqs: Dict[int, Request], k: int,
                last_tokens: np.ndarray) -> np.ndarray:
        cache = self.cache
        self._catch_up(reqs)
        drafts = np.zeros((self.slots, k), np.int32)
        cur = np.zeros((self.slots,), np.int64)
        active = np.zeros((self.slots,), bool)
        base = np.zeros((self.slots,), np.int64)
        for slot, req in reqs.items():
            base[slot] = cache.lengths[slot]
            # A slot too near its cap cannot host k writes: its drafts
            # stay 0 (a wrong draft only costs acceptance).
            if base[slot] + k > self.max_len:
                continue
            cache.reserve(slot, int(base[slot]) + k)
            cur[slot] = req.tokens[-1]
            active[slot] = True
        if not active.any():
            return drafts
        for slot in reqs:
            if active[slot]:
                self._round_base[slot] = (int(base[slot]), k)
        table = cache.table_device()
        act = torch.tensor(active, device=self.device)
        for i in range(k):
            logits, cache.k, cache.v = self.step(
                self.params, cache.k, cache.v,
                torch.tensor(cur, device=self.device),
                torch.tensor(base + i, device=self.device), table, act)
            self.steps += 1
            sampled = greedy_sample(logits).cpu().numpy()
            drafts[:, i] = np.where(active, sampled, 0)
            cur = drafts[:, i].astype(np.int64)
        return drafts

    # -- internals -----------------------------------------------------
    def _prefill_ctx(self, slot: int, ctx: np.ndarray) -> None:
        self.cache.reserve(slot, len(ctx))
        _, kl, vl = prefill_forward(
            self.params, self.config,
            torch.tensor(ctx, device=self.device)[None], dtype=self.dtype)
        self.prefills += 1
        self.cache.write_prefill(slot, kl[:, 0], vl[:, 0])

    def _catch_up(self, reqs: Dict[int, Request]) -> None:
        cache = self.cache
        while True:
            feed: Dict[int, int] = {}
            for slot, req in reqs.items():
                need = req.prompt_len + len(req.tokens) - 1
                have = int(cache.lengths[slot])
                if have < min(need, self.max_len):
                    # The token at context position ``have``.
                    feed[slot] = int(
                        req.prompt[have] if have < req.prompt_len
                        else req.tokens[have - req.prompt_len])
            if not feed:
                return
            toks = np.zeros((self.slots,), np.int64)
            active = np.zeros((self.slots,), bool)
            for slot, tok in feed.items():
                cache.reserve(slot, int(cache.lengths[slot]) + 1)
                toks[slot] = tok
                active[slot] = True
            _, cache.k, cache.v = self.step(
                self.params, cache.k, cache.v,
                torch.tensor(toks, device=self.device),
                cache.lengths_device().long(), cache.table_device(),
                torch.tensor(active, device=self.device))
            self.steps += 1
            for slot in feed:
                cache.lengths[slot] += 1


__all__ = ["NgramDrafter", "ModelDrafter"]
