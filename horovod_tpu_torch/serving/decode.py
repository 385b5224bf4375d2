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
  table instead of gathering a per-slot view.  On a tp mesh
  (:func:`decode_param_specs`) each rank runs ``num_heads / tp`` query
  heads over its ``num_kv_heads / tp`` kv heads of the pool, and the
  ``wo`` and ``w_down`` products are row-parallel: two ``Sum``
  allreduces a layer over the tp set
  (:func:`~horovod_tpu_torch.parallel.tp.row_parallel`), as the
  reference's ``shard_map`` body runs them.  ``with_lora=True`` takes
  banked adapters and a per-slot ``adapter_ids`` operand;
  ``compress=True`` takes the six e4m3 operands of a cache with fp8
  cold pages and attends through the kernel's e4m3 variant
  (:func:`~horovod_tpu_torch.ops.attention.paged_decode_attention_fp8`).
* :func:`build_verify_step` -- speculative decoding's width-``k + 1``
  step: the decode step once a column, column ``j`` attending as row
  ``j`` of :func:`~horovod_tpu_torch.ops.attention.verify_attention`
  (one decode-kernel call a row).
* :func:`stack_adapters` -- N adapters as one banked dict.

Every projection (LoRA terms included), the RoPE rotation and the
in-step K/V write stay plain PyTorch (``torch.matmul``, ``torch.bmm``
and indexing), as the JAX package leaves them to XLA.  In-tree
``lora_a``/``lora_b`` leaves apply in prefill and decode, as the JAX
``_dense`` / ``_node_lora`` apply them.  As in the reference, LoRA
(banks or in-tree leaves) is served at tp = 1 only.

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

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from ..models.transformer import (LlamaConfig, default_positions, dense,
                                  rmsnorm, rotary_embedding, tied_readout)
from ..ops.attention import (flash_attention, paged_decode_attention,
                             paged_decode_attention_fp8)
from ..parallel.tp import row_parallel, tp_param_specs
from ..timeline import spans as _spans

Params = Dict[str, torch.Tensor]

TP_AXIS = "tp"


def _layer(p: Params, li: int, name: str) -> torch.Tensor:
    return p[f"layer_{li}.{name}"]


def _dense_lora_only(x, lora_select, dtype, lora_alpha):
    """The adapter half of :func:`_dense`: ``(x @ a @ b) * alpha/r`` in
    the compute dtype.  ``lora_select`` is one adapter's ``[d_in, r]`` /
    ``[r, d_out]`` pair, or per-slot ``[s, d_in, r]`` / ``[s, r, d_out]``
    banks (slot ``s`` multiplies its own pair)."""
    a, b = lora_select
    scale = lora_alpha / a.shape[-1]
    xd = x.to(dtype)
    if a.dim() == 2:
        return (xd @ a.to(dtype) @ b.to(dtype)) * scale
    return torch.bmm(torch.bmm(xd, a.to(dtype)), b.to(dtype)) * scale


def _dense(x, kernel, dtype, lora_select=None, lora_alpha: float = 16.0):
    """``Dense.__call__`` replayed on one node of the flat param dict:
    ``x @ kernel`` in ``dtype``, plus the adapter term when
    ``lora_select`` holds a pair (:func:`_node_lora`)."""
    y = dense(x, kernel, dtype)
    if lora_select is not None:
        y = y + _dense_lora_only(x, lora_select, dtype, lora_alpha)
    return y


def _node_lora(p: Params, prefix: str, adapters=None, select=None):
    """The adapter pair of one ``Dense`` node: banked adapters
    (``adapters``, gathered by ``select``) first, else the in-tree
    ``<prefix>.lora_a`` / ``.lora_b`` leaves, else ``None``."""
    a_name, b_name = f"{prefix}.lora_a", f"{prefix}.lora_b"
    if adapters is not None and a_name in adapters:
        return select(adapters[a_name], adapters[b_name])
    if a_name in p:
        return p[a_name], p[b_name]
    return None


@torch.no_grad()
def prefill_forward(params: Params, config: LlamaConfig, tokens,
                    positions=None, *, segment_ids=None,
                    dtype=torch.float32, past=None, adapters=None,
                    adapter_id=None, lora_alpha: float = 16.0,
                    force_reference: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward a prompt batch, returning ``(logits, k_layers, v_layers)``.

    ``tokens``: ``[b, t]`` int.  ``logits``: f32 ``[b, t, vocab]``.
    ``k_layers``/``v_layers``: ``[num_layers, b, t_full, num_kv_heads,
    head_dim]`` post-RoPE, the layout :meth:`PagedKVCache.write_prefill`
    scatters.  ``past``: a ``(k_layers, v_layers)`` pair from earlier
    chunks; ``tokens`` is then the current chunk, ``positions`` default
    to its absolute offsets, and the returned K/V cover the full
    context.  ``adapters``/``adapter_id``: banked LoRA leaves
    (:func:`stack_adapters`) and the ONE adapter this prompt uses
    (prefill admits one request at a time); without them the in-tree
    ``lora_a``/``lora_b`` leaves apply, if any.  ``lora_alpha`` is the
    adapters' alpha (the dict does not carry it).
    ``force_reference=True`` runs attention through the plain version
    instead of the kernel.
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

    def select(a, bnk):
        return a[adapter_id], bnk[adapter_id]

    ks, vs = [], []
    for li in range(cfg.num_layers):
        def proj(h, name, _li=li):
            prefix = f"layer_{_li}.{name}"
            return _dense(h, p[f"{prefix}.kernel"], dtype,
                          _node_lora(p, prefix, adapters, select),
                          lora_alpha)

        h = rmsnorm(x, _layer(p, li, "attn_norm.scale"), dtype)
        q = proj(h, "attn.wq")
        k = proj(h, "attn.wk")
        v = proj(h, "attn.wv")
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
        x = x + proj(o, "attn.wo")
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))

        h = rmsnorm(x, _layer(p, li, "mlp_norm.scale"), dtype)
        gate = proj(h, "mlp.w_gate")
        up = proj(h, "mlp.w_up")
        x = x + proj(F.silu(gate) * up, "mlp.w_down")

    logits = tied_readout(rmsnorm(x, p["final_norm.scale"], dtype), emb)
    return logits, torch.stack(ks), torch.stack(vs)


_PROJS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate",
          "mlp.w_up", "mlp.w_down")


def decode_param_specs(params, tp_axis: str = TP_AXIS) -> Dict[str, tuple]:
    """``{name: spec}`` of the decode step's params over a tp mesh, the
    reference's ``PartitionSpec`` tree as tuples: the column kernels
    (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``) split on the output
    dim ``(None, tp_axis)``, the row kernels (``wo``, ``w_down``) on the
    input dim ``(tp_axis, None)``, everything else ``()`` --
    :func:`~horovod_tpu_torch.parallel.tp.tp_param_specs` with biases
    replicated, as the reference's decode specs keep them."""
    return {n: () if n.endswith(".bias") else spec
            for n, spec in tp_param_specs(params, axis=tp_axis).items()}


class ServingDecodeStep:
    """The batched single-token decode step.

    ``logits, k_pool, v_pool = step(params, k_pool, v_pool, tokens,
    positions, page_table, active[, kq, vq, kscale, vscale, ctable,
    cmask][, adapters, adapter_ids])``:
    ``tokens``/``positions``/``active`` are ``[slots]`` (current token,
    its absolute position == the live length before this step, slot
    liveness), ``page_table`` is ``[slots, pages_per_slot]`` int32.  The
    pools are updated IN PLACE (and returned, for the reference's call
    shape).  Idle slots write their K/V to the scratch page and attend
    over zero keys, so their attention output is exactly zero; the
    engine discards their logits.  ``logits``: f32 ``[slots, vocab]``.

    ``with_lora``: ``adapters`` is a banked dict
    (:func:`stack_adapters`) and ``adapter_ids`` ``[slots]`` picks each
    slot's adapter, gathered inside the step and applied as a batched
    product (``bmm``: slot ``s`` multiplies its own pair).  In-tree
    ``lora_a``/``lora_b`` leaves (no banks) take the same per-slot
    product, so a slot's arithmetic is the same whether its adapter
    comes from the tree or from a bank.

    ``compress``: the six operands of
    :meth:`~.kvcache.PagedKVCache.compress_operands` follow ``active``
    (the reference's order); a slot's pages that ``cmask`` marks are
    read from the e4m3 pool.  Each call is timed into the span recorder
    under ``serving_decode``.

    At ``tp > 1`` (``process_set``: this rank's tp set) ``params`` is
    this rank's shard (:func:`decode_param_specs`, cut by the engine
    once a mesh) and the pools hold its kv heads; a full dict raises on
    its shapes.  Each executed row-parallel sum notes its plan row
    (``plan``: :func:`~horovod_tpu_torch.controller.fusion.
    plan_exchange` ``("serving")``) in the span registry.  ``_meta``
    holds the reference's step description (``kind``, ``world``,
    ``tp``, ..., and ``resized_from`` after an engine's resize).
    """

    def __init__(self, config: LlamaConfig, *, slots: int, page_size: int,
                 pages_per_slot: int, dtype, with_lora: bool = False,
                 lora_alpha: float = 16.0, compress: bool = False,
                 tp: int = 1, process_set=None, plan=None,
                 meta: Optional[dict] = None):
        self.config = config
        self.tp = int(tp)
        self.process_set = process_set
        self.heads = config.num_heads // self.tp
        self.kv_heads = config.num_kv_heads // self.tp
        self.legs = tuple(plan.legs) if plan is not None else ()
        self._meta = dict(meta or {})
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.dtype = dtype
        self.with_lora = bool(with_lora)
        self.lora_alpha = float(lora_alpha)
        self.compress = bool(compress)
        self.scratch = self.slots * self.pages_per_slot
        # Each layer's (kernel, lora_a, lora_b) names a projection, built
        # once rather than in every step.
        self.names = [[tuple(f"layer_{li}.{n}.{leaf}"
                             for leaf in ("kernel", "lora_a", "lora_b"))
                       for n in _PROJS] for li in range(config.num_layers)]

    def split_extra(self, extra: tuple) -> tuple:
        """The operands after ``active`` -> ``(fp8, adapters,
        adapter_ids)``, refusing a set that does not match the build."""
        fp8 = None
        if self.compress:
            if len(extra) < 6:
                raise ValueError(
                    "a step built with compress=True takes the six "
                    "operands of PagedKVCache.compress_operands() after "
                    "active")
            fp8, extra = tuple(extra[:6]), extra[6:]
        if len(extra) not in (0, 2) or bool(extra) != self.with_lora:
            raise ValueError(
                "adapters/adapter_ids are the operands of a step built "
                "with_lora=True, and it needs them")
        adapters, ids = extra if extra else (None, None)
        return fp8, adapters, ids

    def __call__(self, params, k_pool, v_pool, tokens, positions,
                 page_table, active, *extra):
        fp8, adapters, adapter_ids = self.split_extra(extra)
        with _spans.recorder().span("dispatch", name="serving",
                                    leg="serving_decode"):
            return self._step(params, k_pool, v_pool, tokens, positions,
                              page_table, active, adapters, adapter_ids,
                              fp8)

    def check_shard(self, p: Params) -> None:
        """Refuse params that are not this rank's shard at ``tp > 1`` (a
        full dict would be multiplied wrongly), and LoRA leaves there."""
        if self.tp == 1:
            return
        if self.process_set is None:
            raise RuntimeError("this rank is not in the decode step's mesh")
        cfg = self.config
        want = {"attn.wq": (cfg.d_model, self.heads * cfg.head_dim),
                "attn.wo": (self.heads * cfg.head_dim, cfg.d_model),
                "mlp.w_down": (cfg.ffn_hidden // self.tp, cfg.d_model)}
        for name, shape in want.items():
            got = tuple(p[f"layer_0.{name}.kernel"].shape)
            if got != shape:
                raise ValueError(
                    f"a tp={self.tp} decode step takes this rank's shard "
                    f"of the params (decode_param_specs): layer_0.{name}."
                    f"kernel is {got}, want {shape}")
        if any(n.endswith(".lora_a") for n in p):
            raise NotImplementedError(
                "LoRA leaves are served at tp=1 only (a row-parallel "
                "adapter would need its own sum); shard requests, not "
                "adapters")

    def _weights(self, p: Params, li: int, adapters, ids, s: int):
        """Layer ``li``'s projections as ``(kernel, adapter pair or
        None)``: a banked pair gathered by ``ids``, else the in-tree
        leaves repeated over the ``s`` slots (the same per-slot
        product)."""
        out = []
        for kn, an, bn in self.names[li]:
            pair = None
            if adapters is not None and an in adapters:
                pair = adapters[an][ids], adapters[bn][ids]
            elif an in p:
                pair = tuple(p[n][None].expand(s, -1, -1).contiguous()
                             for n in (an, bn))
            out.append((p[kn], pair))
        return out

    @torch.no_grad()
    def _step(self, p: Params, k_pool, v_pool, tokens, positions,
              page_table, active, adapters=None, adapter_ids=None,
              fp8=None, legs=None):
        cfg, dtype, alpha = self.config, self.dtype, self.lora_alpha
        self.check_shard(p)
        legs = self.legs if legs is None else legs
        hd = cfg.head_dim
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
        ids = None if adapter_ids is None else adapter_ids.long()

        def proj(h, w):
            return _dense(h, w[0], dtype, w[1], alpha)

        def out_proj(x_in, w, leg):
            # The row-parallel closures: a Sum over the tp set, its plan
            # row noted once it ran.
            if self.tp == 1:
                return proj(x_in, w)
            y = row_parallel(x_in.to(dtype), w[0].to(dtype),
                             axis=self.process_set)
            _spans.note_leg(legs[leg])
            return y

        for li in range(cfg.num_layers):
            wq, wk, wv, wo, wg, wu, wd = self._weights(
                p, li, adapters, ids, s)
            h = rmsnorm(x, _layer(p, li, "attn_norm.scale"), dtype)
            q = proj(h, wq)
            k = proj(h, wk)
            v = proj(h, wv)
            q = q.view(s, 1, self.heads, hd).transpose(1, 2)
            k = k.view(s, 1, self.kv_heads, hd).transpose(1, 2)
            v = v.view(s, 1, self.kv_heads, hd).transpose(1, 2)
            q = rotary_embedding(q, pos2, cfg.rope_theta)
            k = rotary_embedding(k, pos2, cfg.rope_theta)
            # In-step cache write: each slot's K/V lands at (page, off).
            k_pool[li, page, off] = k[:, :, 0, :].to(k_pool.dtype)
            v_pool[li, page, off] = v[:, :, 0, :].to(v_pool.dtype)
            if fp8 is None:
                o = paged_decode_attention(
                    q.to(dtype).contiguous(), k_pool[li], v_pool[li],
                    page_table, lengths)
            else:
                kq, vq, ksc, vsc, ctable, cmask = fp8
                o = paged_decode_attention_fp8(
                    q.to(dtype).contiguous(), k_pool[li], v_pool[li],
                    page_table, lengths, kq[li], vq[li], ksc[li], vsc[li],
                    ctable, cmask)
            o = o.transpose(1, 2).reshape(s, 1, -1)
            x = x + out_proj(o, wo, 2 * li)

            h = rmsnorm(x, _layer(p, li, "mlp_norm.scale"), dtype)
            gate = proj(h, wg)
            up = proj(h, wu)
            act = (F.silu(gate) * up).to(dtype)
            x = x + out_proj(act, wd, 2 * li + 1)

        x = rmsnorm(x, p["final_norm.scale"], dtype)
        logits = tied_readout(x, emb)[:, 0, :]              # [S, vocab]
        return logits, k_pool, v_pool


class ServingVerifyStep:
    """Speculative decoding's verify step: ``width`` tokens a slot (the
    last sampled token, then ``width - 1`` drafts), scored as ``width``
    calls of the width-1 decode step, column ``j`` at ``positions + j``.

    ``logits, k_pool, v_pool = verify(params, k_pool, v_pool, tokens,
    positions, page_table, active[, kq, vq, kscale, vscale, ctable,
    cmask])`` with ``tokens`` ``[slots, width]`` and ``logits`` f32
    ``[slots, width, vocab]``; the e4m3 operands (a ``compress=True``
    build) go to every column.  Column ``j``'s
    attention reads ``lengths + j`` keys, row ``j`` of
    :func:`~horovod_tpu_torch.ops.attention.verify_attention`, and runs
    the plain step's shapes: a matmul over ``slots * width`` rows may take
    another algorithm than one over ``slots`` (cuBLAS and oneDNN choose by
    shape), so a wider product could flip a greedy stream at a near-tie.
    Here each column's logits are bitwise the plain step's.  Columns past
    the slot's ``max_len`` are idle (scratch page, zero keys); the engine
    never emits them.  Timed under ``serving_verify``.
    """

    def __init__(self, step: ServingDecodeStep, width: int, plan=None,
                 meta: Optional[dict] = None):
        self.step = step
        self.width = int(width)
        self.max_len = step.pages_per_slot * step.page_size
        self.legs = tuple(plan.legs) if plan is not None else ()
        self._meta = dict(meta or {})

    def __call__(self, params, k_pool, v_pool, tokens, positions,
                 page_table, active, *fp8):
        fp8, _, _ = self.step.split_extra(fp8)
        n = 2 * self.step.config.num_layers
        logits = []
        with _spans.recorder().span("dispatch", name="serving",
                                    leg="serving_verify"):
            for j in range(self.width):
                pos = positions + j
                live = active & (pos < self.max_len)
                out, k_pool, v_pool = self.step._step(
                    params, k_pool, v_pool, tokens[:, j],
                    torch.clamp(pos, max=self.max_len - 1), page_table,
                    live, fp8=fp8, legs=self.legs[j * n:(j + 1) * n])
                logits.append(out)
        return torch.stack(logits, 1), k_pool, v_pool


def build_decode_step(config: LlamaConfig, mesh=None, *, slots: int,
                      page_size: int, pages_per_slot: int,
                      dtype=torch.float32, with_lora: bool = False,
                      lora_alpha: float = 16.0, tp_axis: str = TP_AXIS,
                      width: int = 1, compress: bool = False):
    """The decode step (:class:`ServingDecodeStep`), or at ``width > 1``
    the verify step (:class:`ServingVerifyStep`), on one device
    (``mesh=None``) or over ``mesh``'s ``tp_axis`` (a
    :class:`~horovod_tpu_torch.parallel.mesh.RankMesh`; this rank's tp
    set runs the row-parallel sums).  ``compress`` takes the e4m3
    operands of a cache with fp8 cold pages.  As in the reference, LoRA
    banks raise at ``tp > 1`` and at ``width > 1``, and every head count
    and ``ffn_hidden`` must divide by tp."""
    from ..controller import fusion as _fusion
    from ..core.state import global_state
    from .kvcache import dtype_name
    cfg = config
    if mesh is not None and tp_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {tp_axis!r} axis: {mesh.axis_names}")
    tp = 1 if mesh is None else int(mesh.shape[tp_axis])
    for what, n in (("num_heads", cfg.num_heads),
                    ("num_kv_heads", cfg.num_kv_heads),
                    ("ffn_hidden", cfg.ffn_hidden)):
        if n % tp:
            raise ValueError(f"{what}={n} not divisible by tp={tp}")
    if with_lora and tp > 1:
        raise NotImplementedError(
            "per-slot LoRA banks are tp=1 only (a row-parallel adapter "
            "would need its own sum); shard requests, not adapters")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if with_lora and width > 1:
        raise NotImplementedError(
            "speculative verify with per-slot LoRA banks is not wired; "
            "serve adapters with plain decode")
    ps = None
    if tp > 1 and bool((mesh.ranks == global_state().rank).any()):
        ps = mesh.group(tp_axis)
    kind = "serving_decode" if width == 1 else "serving_verify"
    dt = dtype_name(dtype)
    plan = _fusion.plan_exchange(
        "serving", kind=kind, layers=cfg.num_layers, slots=slots,
        width=width, d_model=cfg.d_model, dtype=dt, axis=tp_axis)
    meta = {"kind": kind, "world": tp, "tp": tp,
            "num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "slots": int(slots), "dtype": dt, "lora": bool(with_lora),
            "compress": bool(compress)}
    step = ServingDecodeStep(config, slots=slots, page_size=page_size,
                             pages_per_slot=pages_per_slot, dtype=dtype,
                             with_lora=with_lora, lora_alpha=lora_alpha,
                             compress=compress, tp=tp, process_set=ps,
                             plan=plan if width == 1 else None,
                             meta=meta)
    if width == 1:
        return step
    return ServingVerifyStep(step, width, plan=plan,
                             meta=dict(meta, width=int(width)))


def build_verify_step(config: LlamaConfig, mesh=None, *, slots: int,
                      width: int, page_size: int, pages_per_slot: int,
                      dtype=torch.float32, tp_axis: str = TP_AXIS,
                      compress: bool = False) -> ServingVerifyStep:
    """The speculative-decoding verify step: one call scoring ``width``
    tokens a slot (the last sampled token plus ``width - 1`` drafter
    proposals), logits ``[slots, width, vocab]``.  The engine accepts
    each slot's longest draft prefix agreeing with the returned argmaxes,
    plus the target's own token at the first disagreement."""
    if width < 2:
        raise ValueError(
            f"verify step needs width >= 2 (got {width}); width 1 is "
            "plain decode -- use build_decode_step")
    return build_decode_step(config, mesh, slots=slots,
                             page_size=page_size,
                             pages_per_slot=pages_per_slot, dtype=dtype,
                             tp_axis=tp_axis, width=width,
                             compress=compress)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic next token per row: argmax over the vocab (the
    first index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def stack_adapters(param_dicts: Sequence[Params]) -> Params:
    """Pack N adapters into one banked dict: the ``lora_a``/``lora_b``
    entries of each flat dict (full model params or adapters only),
    stacked on a new leading ``n_adapters`` dim under their own names --
    the layout the decode step's per-slot ``adapter_ids`` gather and
    :func:`prefill_forward`'s ``adapter_id`` read."""
    if not param_dicts:
        raise ValueError("need at least one adapter dict")
    names = [n for n in param_dicts[0] if n.rsplit(".", 1)[-1] in
             ("lora_a", "lora_b")]
    if not names:
        raise ValueError("adapter dicts hold no lora_a/lora_b entries")
    return {n: torch.stack([d[n] for d in param_dicts]) for n in names}


__all__ = ["prefill_forward", "build_decode_step", "build_verify_step",
           "decode_param_specs", "ServingDecodeStep", "ServingVerifyStep",
           "greedy_sample", "stack_adapters"]
