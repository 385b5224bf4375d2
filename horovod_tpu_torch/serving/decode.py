"""Llama prefill and single-token paged decode, in PyTorch.

Counterpart of ``horovod_tpu/serving/decode.py``:

* :func:`prefill_forward` -- full-context forward over a prompt that
  also returns the per-layer post-RoPE K/V ready to scatter into the
  paged cache; attention is the flash forward kernel
  (``ops/csrc/flash_fwd.cu``).  ``past=`` continues a chunked prefill:
  the chunk's queries attend over ``past ++ chunk`` keys (``tq < tk``,
  bottom-right causal).
* :func:`build_decode_step` -- the batched single-token step: per layer
  it writes the new token's K/V into its page, then attends over each
  slot's pages through the paged decode kernel
  (``ops/csrc/flash_decode.cu``), which reads the pool through the page
  table instead of gathering a per-slot view.

Every projection, the RoPE rotation and the in-step K/V write stay plain
PyTorch (``torch.matmul`` and indexing), as the JAX package leaves them
to XLA.  This slice serves on one device: tensor parallelism, LoRA
banks, the speculative verify width and fp8 KV pages raise
``NotImplementedError``.

Dtypes.  The JAX package keeps f32 master kernels and casts them to the
compute dtype inside every ``_dense`` call.  This port stores the
kernels in the serving dtype once (``init_llama_params(dtype=...)``, or
``params_from_jax(dtype=...)``) and casts nothing per call: the matmul
sees the same operands, so it is the same arithmetic.  The tied
embedding stays f32 for the f32 readout (``decode.py:496`` of the JAX
package), which runs in true f32: ``tied_readout`` holds TF32 off for
that product even where the caller turned
``torch.backends.cuda.matmul.allow_tf32`` on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..models.transformer import (LlamaConfig, default_positions, dense,
                                  rmsnorm, rotary_embedding, tied_readout)
from ..ops.attention import flash_attention, paged_decode_attention
from ..timeline import spans as _spans

Params = Dict[str, torch.Tensor]


def _layer(p: Params, li: int, name: str) -> torch.Tensor:
    return p[f"layer_{li}.{name}"]


@torch.no_grad()
def prefill_forward(params: Params, config: LlamaConfig, tokens,
                    positions=None, *, segment_ids=None,
                    dtype=torch.float32, past=None,
                    force_reference: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward a prompt batch, returning ``(logits, k_layers, v_layers)``.

    ``tokens``: ``[b, t]`` int.  ``logits``: f32 ``[b, t, vocab]``.
    ``k_layers``/``v_layers``: ``[num_layers, b, t_full, num_kv_heads,
    head_dim]`` post-RoPE, the layout :meth:`PagedKVCache.write_prefill`
    scatters.  ``past``: a ``(k_layers, v_layers)`` pair from earlier
    chunks; ``tokens`` is then the current chunk, ``positions`` default
    to its absolute offsets, and the returned K/V cover the full
    context.  ``force_reference=True`` runs attention through the plain
    version instead of the kernel.
    """
    cfg = config
    p = params
    b, t = tokens.shape
    t_past = 0 if past is None else int(past[0].shape[2])
    if past is not None and segment_ids is not None:
        raise NotImplementedError(
            "chunked prefill with segment_ids: pad isolation across the "
            "past/chunk seam is not modeled; chunk unpadded prompts")
    if positions is None:
        positions = default_positions(tokens) + t_past
    emb = p["tok_embed"]
    x = emb[tokens].to(dtype)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        h = rmsnorm(x, _layer(p, li, "attn_norm.scale"), dtype)
        q = dense(h, _layer(p, li, "attn.wq.kernel"), dtype)
        k = dense(h, _layer(p, li, "attn.wk.kernel"), dtype)
        v = dense(h, _layer(p, li, "attn.wv.kernel"), dtype)
        q = q.view(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
        k = k.view(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        v = v.view(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        if past is not None:
            # past K/V arrive in cache layout [b, t_past, H, D]: move time
            # back to the attention axis.
            k = torch.cat([past[0][li].transpose(1, 2).to(k.dtype), k], 2)
            v = torch.cat([past[1][li].transpose(1, 2).to(v.dtype), v], 2)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, segment_ids=segment_ids,
                            force_reference=force_reference)
        o = o.transpose(1, 2).reshape(b, t, -1)
        x = x + dense(o, _layer(p, li, "attn.wo.kernel"), dtype)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))

        h = rmsnorm(x, _layer(p, li, "mlp_norm.scale"), dtype)
        gate = dense(h, _layer(p, li, "mlp.w_gate.kernel"), dtype)
        up = dense(h, _layer(p, li, "mlp.w_up.kernel"), dtype)
        x = x + dense(F.silu(gate) * up, _layer(p, li, "mlp.w_down.kernel"),
                      dtype)

    logits = tied_readout(rmsnorm(x, p["final_norm.scale"], dtype), emb)
    return logits, torch.stack(ks), torch.stack(vs)


class ServingDecodeStep:
    """The batched single-token decode step.

    ``logits, k_pool, v_pool = step(params, k_pool, v_pool, tokens,
    positions, page_table, active)``: ``tokens``/``positions``/
    ``active`` are ``[slots]`` (current token, its absolute position ==
    the live length before this step, slot liveness), ``page_table`` is
    ``[slots, pages_per_slot]`` int32.  The pools are updated IN PLACE
    (and returned, for the reference's call shape).  Idle slots write
    their K/V to the scratch page and attend over zero keys, so their
    attention output is exactly zero; the engine discards their logits.
    Each call is timed into the span recorder under ``serving_decode``.
    """

    def __init__(self, config: LlamaConfig, *, slots: int, page_size: int,
                 pages_per_slot: int, dtype):
        self.config = config
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.dtype = dtype
        self.scratch = self.slots * self.pages_per_slot

    def __call__(self, params, k_pool, v_pool, tokens, positions,
                 page_table, active):
        with _spans.recorder().span("dispatch", name="serving",
                                    leg="serving_decode"):
            return self._step(params, k_pool, v_pool, tokens, positions,
                              page_table, active)

    @torch.no_grad()
    def _step(self, p: Params, k_pool, v_pool, tokens, positions,
              page_table, active):
        cfg, dtype = self.config, self.dtype
        s = tokens.shape[0]
        emb = p["tok_embed"]
        x = emb[tokens].to(dtype)[:, None, :]               # [S, 1, d]
        pos2 = positions[:, None]                           # [S, 1]
        rows = torch.arange(s, device=tokens.device)
        page = torch.where(active,
                           page_table[rows, positions // self.page_size],
                           self.scratch).long()
        off = (positions % self.page_size).long()
        lengths = torch.where(active, positions + 1, 0).to(torch.int32)
        for li in range(cfg.num_layers):
            h = rmsnorm(x, _layer(p, li, "attn_norm.scale"), dtype)
            q = dense(h, _layer(p, li, "attn.wq.kernel"), dtype)
            k = dense(h, _layer(p, li, "attn.wk.kernel"), dtype)
            v = dense(h, _layer(p, li, "attn.wv.kernel"), dtype)
            q = q.view(s, 1, cfg.num_heads, cfg.head_dim).transpose(1, 2)
            k = k.view(s, 1, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
            v = v.view(s, 1, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
            q = rotary_embedding(q, pos2, cfg.rope_theta)
            k = rotary_embedding(k, pos2, cfg.rope_theta)
            # In-step cache write: each slot's K/V lands at (page, off).
            k_pool[li, page, off] = k[:, :, 0, :].to(k_pool.dtype)
            v_pool[li, page, off] = v[:, :, 0, :].to(v_pool.dtype)
            o = paged_decode_attention(
                q.to(dtype).contiguous(), k_pool[li], v_pool[li],
                page_table, lengths)
            o = o.transpose(1, 2).reshape(s, 1, -1)
            x = x + dense(o, _layer(p, li, "attn.wo.kernel"), dtype)

            h = rmsnorm(x, _layer(p, li, "mlp_norm.scale"), dtype)
            gate = dense(h, _layer(p, li, "mlp.w_gate.kernel"), dtype)
            up = dense(h, _layer(p, li, "mlp.w_up.kernel"), dtype)
            act = (F.silu(gate) * up).to(dtype)
            x = x + dense(act, _layer(p, li, "mlp.w_down.kernel"), dtype)

        x = rmsnorm(x, p["final_norm.scale"], dtype)
        logits = tied_readout(x, emb)[:, 0, :]              # [S, vocab]
        return logits, k_pool, v_pool


def build_decode_step(config: LlamaConfig, *, slots: int, page_size: int,
                      pages_per_slot: int, dtype=torch.float32,
                      tp: int = 1, with_lora: bool = False, width: int = 1,
                      compress: bool = False) -> ServingDecodeStep:
    """The single-device, width-1 decode step (see
    :class:`ServingDecodeStep`).  ``tp > 1``, ``with_lora``, ``width >
    1`` (speculative verify) and ``compress`` (fp8 KV) are later
    slices and raise."""
    if tp != 1:
        raise NotImplementedError(
            "tensor-parallel decode (tp > 1) is not ported yet")
    if with_lora:
        raise NotImplementedError("per-slot LoRA banks are not ported yet")
    if width != 1:
        raise NotImplementedError(
            "the speculative verify step (width > 1, verify_attention) is "
            "not ported yet")
    if compress:
        raise NotImplementedError("fp8 KV pages are not ported yet")
    return ServingDecodeStep(config, slots=slots, page_size=page_size,
                             pages_per_slot=pages_per_slot, dtype=dtype)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic next token per row: argmax over the vocab (the
    first index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


__all__ = ["prefill_forward", "build_decode_step", "ServingDecodeStep",
           "greedy_sample"]
