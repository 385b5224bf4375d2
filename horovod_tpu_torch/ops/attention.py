"""Attention for the port: hand-written CUDA kernels + plain PyTorch.

Counterpart of ``horovod_tpu/ops/attention.py``.  Public functions keep
the JAX package's layouts and conventions so the two compare like with
like: ``q`` is ``(b, h, tq, d)``, ``k``/``v`` are ``(b, h_kv, tk, d)``
with ``h_kv`` dividing ``h`` (grouped-query attention: query head ``h``
reads kv head ``h // rep``); causal masking is bottom-right aligned;
segment ids restrict each query to keys with an equal id; a DEAD row
(no visible key) gives exactly zero; masked logits sit at the finite
``-1e30``.

Dispatch, for every function here: a CPU tensor takes the plain PyTorch
version (:func:`attention_reference` underneath); a CUDA tensor launches
the kernel, or the wrapper raises -- there is no fallback from the
kernel to the plain version.  ``force_reference=True`` is the one
explicit way to run the plain version on the GPU (tests and the chip
smoke use it to hold the kernels against it).

Kernels (``ops/csrc``):

* ``flash_fwd.cu`` -- :func:`flash_attention`'s forward, replacing
  ``_flash_fwd``.  Every sequence length goes through it: the kernel
  masks the ragged edge itself, so the JAX dispatcher's fallback to the
  reference for lengths with no 8-multiple block divisor (a 37-token
  prompt) has no counterpart here.
* ``flash_bwd.cu`` -- :func:`flash_attention`'s backward, replacing
  ``_flash_bwd``: :func:`flash_backward_dq` (``_dq_kernel``) and
  :func:`flash_backward_dkv` (``_dkv_kernel``, with the GQA group sum
  inside the kernel).  ``delta = rowsum(dO * O)`` is plain PyTorch, as
  the JAX package computes it outside Pallas.  The autograd function
  around :func:`flash_attention` saves ``q, k, v, o, lse`` and the
  segment ids; its backward runs the kernels on CUDA tensors and
  :func:`flash_attention_backward_reference` on CPU tensors.
* ``flash_decode.cu`` -- :func:`paged_decode_attention` (reads K/V
  through the page table) and :func:`decode_attention` (contiguous
  cache view), replacing ``_flash_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import registry
from ._build import check_launch, entry, stream

_NEG_INF = -1e30      # softmax mask value (finite: no NaN on empty rows)
_DEAD_LSE = 1e30      # logsumexp of a dead row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_DECODE_SPLIT_MIN = 256   # keys per split of the decode kernel, at least
_DECODE_MAX_SPLITS = 16


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _reference(q, k, v, *, causal, scale, segment_ids, kv_segment_ids):
    """Plain attention returning ``(out, lse)``; heads already match."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    alive = None
    if segment_ids is not None:
        if kv_segment_ids is None:
            if q.shape[2] != k.shape[2]:
                raise ValueError("kv_segment_ids is required when tq != tk")
            kv_segment_ids = segment_ids
        seg = segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        logits = logits.masked_fill(~seg, _NEG_INF)
        alive = logits.amax(-1, keepdim=True) > _NEG_INF / 2
    probs = torch.softmax(logits, dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    if alive is not None:
        # DEAD rows: zero output (not the uniform softmax a plain -inf
        # mask degenerates to), and lse pushed to +1e30 like the kernel.
        probs = torch.where(alive, probs, 0.0)
        lse = torch.where(alive[..., 0], lse, _DEAD_LSE)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(v.dtype), lse


def attention_reference(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        segment_ids=None, kv_segment_ids=None):
    """Plain attention. q, k, v: (batch, heads, seq, head_dim), equal
    head counts.  Causal masking is bottom-right aligned (``tq < tk``:
    query ``i`` attends keys ``0 .. tk - tq + i``); segment ids mask
    unequal pairs and DEAD rows give zero output.  Differentiable on any
    device through autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _reference(q, k, v, causal=causal, scale=scale,
                      segment_ids=segment_ids,
                      kv_segment_ids=kv_segment_ids)[0]


def _repeat_kv(q, k, v):
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    return k, v


# ---------------------------------------------------------------------------
# Wrapper checks
# ---------------------------------------------------------------------------


def _check_cuda(name: str, device: torch.device, dtype, *tensors):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: all tensors must be on {device}, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    if dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")


def _check_kv(name: str, q, k, v, kv_batch_dim: int):
    """K and V share one shape, whose batch and head_dim match q's."""
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name}: head_dim of k ({k.shape[-1]}) != "
                         f"q's ({q.shape[-1]})")
    if kv_batch_dim >= 0 and k.shape[kv_batch_dim] != q.shape[0]:
        raise ValueError(f"{name}: batch of k ({k.shape[kv_batch_dim]}) "
                         f"!= q's ({q.shape[0]})")


def _check_index(name: str, t: torch.Tensor, device, shape):
    if t.device != device or t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


# ---------------------------------------------------------------------------
# Flash attention forward
# ---------------------------------------------------------------------------


def _flash_fwd_cuda(q, k, v, qseg, kseg, *, scale: float, causal: bool):
    """Kernel A: ``(o, lse)`` for CUDA tensors."""
    _check_cuda("flash_attention", q.device, q.dtype, q, k, v)
    _check_kv("flash_attention", q, k, v, kv_batch_dim=0)
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention: empty sequence")
    if qseg is not None:
        _check_index("segment_ids", qseg, q.device, (b, tq))
        _check_index("kv_segment_ids", kseg, q.device, (b, tk))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    err = entry("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if qseg is None else qseg.data_ptr(),
        None if kseg is None else kseg.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, h_kv, tq, tk, d,
        _DTYPES[q.dtype], int(causal), float(scale), stream(q))
    check_launch("flash_fwd", err)
    registry.note_launch("flash")
    return o, lse


def _flash_forward(q, k, v, qseg, kseg, *, scale, causal):
    if q.device.type == "cpu":
        kr, vr = _repeat_kv(q, k, v)
        return _reference(q, kr, vr, causal=causal, scale=scale,
                          segment_ids=qseg, kv_segment_ids=kseg)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, qseg, kseg, scale=scale,
                               causal=causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward by kernel A (plain on the CPU); backward by the dq and
    dk/dv kernels (plain on the CPU), from the saved ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, scale, causal):
        o, lse = _flash_forward(q, k, v, qseg, kseg, scale=scale,
                                causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            scale=ctx.scale, segment_ids=qseg, kv_segment_ids=kseg)
        return dq, dk, dv, None, None, None, None


def _normalize_segments(q, k, segment_ids, kv_segment_ids):
    """Validated int32 ``(segment_ids, kv_segment_ids)``, or Nones."""
    tq, tk = q.shape[2], k.shape[2]
    if segment_ids is None:
        if kv_segment_ids is not None:
            raise ValueError("kv_segment_ids given without segment_ids")
        return None, None
    if kv_segment_ids is None:
        if tq != tk:
            raise ValueError(
                f"kv_segment_ids is required when tq != tk "
                f"({tq} != {tk})")
        kv_segment_ids = segment_ids
    if tuple(segment_ids.shape) != (q.shape[0], tq):
        raise ValueError(f"segment_ids must be (batch, {tq}), got "
                         f"{tuple(segment_ids.shape)}")
    if tuple(kv_segment_ids.shape) != (q.shape[0], tk):
        raise ValueError(f"kv_segment_ids must be (batch, {tk}), got "
                         f"{tuple(kv_segment_ids.shape)}")
    return (segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous())


def _check_shapes(q, k, causal):
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} not a multiple of "
                         f"kv heads {k.shape[1]}")
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(
            f"causal attention requires tq <= tk, got {q.shape[2]} > "
            f"{k.shape[2]}")


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    segment_ids=None, kv_segment_ids=None,
                    force_reference: bool = False,
                    return_lse: bool = False):
    """Fused attention. q: (b, h, t, d); k, v: (b, h_kv, s, d).

    ``causal=True`` requires ``t <= s`` and masks bottom-right aligned.
    ``segment_ids`` (``(b, t)`` int) restricts each query to keys with an
    equal id; ``kv_segment_ids`` (``(b, s)``) defaults to it when
    ``t == s``.  ``return_lse=True`` also returns the f32 logsumexp
    ``(b, h, t)`` (``+1e30`` on dead rows), the residual the backward
    reads.  Differentiable in ``q, k, v``: the backward runs the dq and
    dk/dv kernels on CUDA tensors; ``force_reference=True`` runs plain
    attention under autograd instead.
    """
    _check_shapes(q, k, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    segment_ids, kv_segment_ids = _normalize_segments(
        q, k, segment_ids, kv_segment_ids)
    if force_reference:
        kr, vr = _repeat_kv(q, k, v)
        o, lse = _reference(q, kr, vr, causal=causal, scale=scale,
                            segment_ids=segment_ids,
                            kv_segment_ids=kv_segment_ids)
    else:
        o, lse = _FlashAttention.apply(q, k, v, segment_ids, kv_segment_ids,
                                       float(scale), bool(causal))
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# Flash attention backward
# ---------------------------------------------------------------------------


def _bwd_probs(q, k, v, do, lse, delta, *, causal, scale, segment_ids,
               kv_segment_ids):
    """Plain ``(p, ds)`` per query head, f32 ``(b, h, tq, tk)``, and the
    repeated K/V: ``p = exp(s * scale - lse)`` on live pairs, 0 on masked
    ones (and on dead rows, whose ``lse`` is +1e30)."""
    kr, vr = _repeat_kv(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    tq, tk = s.shape[-2], s.shape[-1]
    live = None
    if causal:
        live = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        live = seg if live is None else live & seg
    p = torch.exp(s - lse[..., None])
    if live is not None:
        p = torch.where(live, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vr.float())
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, kr, vr


def _group_sum(x, h_kv):
    """``(b, h, t, d)`` per query head -> ``(b, h_kv, t, d)``."""
    b, h, t, d = x.shape
    return x.view(b, h_kv, h // h_kv, t, d).sum(2)


def _bwd_cuda_args(name, q, k, v, do, lse, delta, qseg, kseg):
    _check_cuda(name, q.device, q.dtype, q, k, v, do)
    _check_kv(name, q, k, v, kv_batch_dim=0)
    b, h, tq, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    for nm, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != (b, h, tq) or not t.is_contiguous()):
            raise ValueError(f"{name}: {nm} must be contiguous f32 "
                             f"{(b, h, tq)} on {q.device}")
    tk = k.shape[2]
    if qseg is not None:
        _check_index("segment_ids", qseg, q.device, (b, tq))
        _check_index("kv_segment_ids", kseg, q.device, (b, tk))
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if qseg is None else qseg.data_ptr(),
            None if kseg is None else kseg.data_ptr()]


def _bwd_dims(q, k, causal, scale):
    b, h, tq, d = q.shape
    return [b, h, k.shape[1], tq, k.shape[2], d, _DTYPES[q.dtype],
            int(causal), float(scale), stream(q)]


def flash_backward_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                      scale: Optional[float] = None, segment_ids=None,
                      kv_segment_ids=None, force_reference: bool = False):
    """``dq = sum_k ds K`` in q's dtype.  ``lse`` is the forward's f32
    logsumexp and ``delta = rowsum(dO * O)`` (both ``(b, h, tq)`` f32);
    segment ids as normalized by :func:`flash_attention` (int32)."""
    _check_shapes(q, k, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if force_reference or q.device.type == "cpu":
        _, ds, kr, _ = _bwd_probs(q, k, v, do, lse, delta, causal=causal,
                                  scale=scale, segment_ids=segment_ids,
                                  kv_segment_ids=kv_segment_ids)
        return torch.einsum("bhqk,bhkd->bhqd", ds, kr.float()).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward_dq: unsupported device {q.device}")
    args = _bwd_cuda_args("flash_backward_dq", q, k, v, do, lse, delta,
                          segment_ids, kv_segment_ids)
    dq = torch.empty_like(q)
    err = entry("flash_bwd_dq")(*args, dq.data_ptr(),
                                *_bwd_dims(q, k, causal, scale))
    check_launch("flash_bwd_dq", err)
    registry.note_launch("flash_bwd_dq")
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                       scale: Optional[float] = None, segment_ids=None,
                       kv_segment_ids=None, force_reference: bool = False):
    """``(dk, dv)`` in k's dtype: ``dv = sum_q p^T dO``, ``dk = sum_q
    ds^T Q``, summed over the query heads of each GQA group."""
    _check_shapes(q, k, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if force_reference or q.device.type == "cpu":
        p, ds, _, _ = _bwd_probs(q, k, v, do, lse, delta, causal=causal,
                                 scale=scale, segment_ids=segment_ids,
                                 kv_segment_ids=kv_segment_ids)
        h_kv = k.shape[1]
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
        return (_group_sum(dk, h_kv).to(k.dtype),
                _group_sum(dv, h_kv).to(v.dtype))
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_backward_dkv: unsupported device {q.device}")
    args = _bwd_cuda_args("flash_backward_dkv", q, k, v, do, lse, delta,
                          segment_ids, kv_segment_ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = entry("flash_bwd_dkv")(*args, dk.data_ptr(), dv.data_ptr(),
                                 *_bwd_dims(q, k, causal, scale))
    check_launch("flash_bwd_dkv", err)
    registry.note_launch("flash_bwd_dkv")
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = False,
                             scale: Optional[float] = None,
                             segment_ids=None, kv_segment_ids=None,
                             force_reference: bool = False):
    """``(dq, dk, dv)`` of :func:`flash_attention` from its saved ``o`` and
    ``lse``: ``delta = rowsum(dO * O)`` in f32, then the dq and dk/dv
    kernels (their plain versions on the CPU or with
    ``force_reference``)."""
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
              kv_segment_ids=kv_segment_ids,
              force_reference=force_reference)
    dq = flash_backward_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool = False,
                                       scale: Optional[float] = None,
                                       segment_ids=None,
                                       kv_segment_ids=None):
    """Plain ``(dq, dk, dv)`` from the saved ``lse``, by the kernels'
    formula (``_flash_bwd``'s): ``p = exp(s * scale - lse)``, ``ds = p *
    (dO V^T - delta) * scale``; dead rows (``lse = +1e30``) get exactly
    zero."""
    return flash_attention_backward(
        q, k, v, o, lse, do, causal=causal, scale=scale,
        segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        force_reference=True)


# ---------------------------------------------------------------------------
# Flash decoding
# ---------------------------------------------------------------------------


def decode_splits(capacity: int) -> tuple:
    """``(splits, keys per split)`` for a slot of ``capacity`` keys: at
    least ``_DECODE_SPLIT_MIN`` keys per split, at most
    ``_DECODE_MAX_SPLITS`` splits, split length a multiple of 32 (the
    kernel's key tile)."""
    per = max(_DECODE_SPLIT_MIN, -(-capacity // _DECODE_MAX_SPLITS))
    per = -(-per // 32) * 32
    return -(-capacity // per), per


def _decode_cuda(q, k, v, lengths, page_table, *, scale: float,
                 page_size: int, pps: int, strides: tuple):
    """Kernel B on CUDA tensors; ``page_table=None`` reads a contiguous
    ``(b, h_kv, s, d)`` view as one page per slot."""
    _check_cuda("decode_attention", q.device, q.dtype, q, k, v)
    # A contiguous view is batched by slot; a page pool is not.
    _check_kv("decode_attention", q, k, v,
              kv_batch_dim=-1 if page_table is not None else 0)
    b, h, _, d = q.shape
    h_kv = k.shape[-2] if page_table is not None else k.shape[1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    if h // h_kv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention: group size {h // h_kv} not "
                         f"in (1, 2, 4, 8)")
    _check_index("lengths", lengths, q.device, (b,))
    if page_table is not None:
        _check_index("page_table", page_table, q.device, (b, pps))
    splits, per = decode_splits(pps * page_size)
    o = torch.empty_like(q)
    m_part = torch.empty((b, h, splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, h, splits, d), dtype=torch.float32,
                           device=q.device)
    err = entry("flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if page_table is None else page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), b, h, h_kv, d,
        page_size, pps, *strides, splits, per, _DTYPES[q.dtype],
        float(scale), stream(q))
    check_launch("flash_decode", err)
    registry.note_launch("flash_decode")
    return o


def _check_decode_args(q, h_kv, lengths):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"decode attention expects a single-token query "
                         f"(b, h, 1, d), got {tuple(q.shape)}")
    if q.shape[1] % h_kv:
        raise ValueError(f"query heads {q.shape[1]} not a multiple of "
                         f"kv heads {h_kv}")
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"lengths must be ({q.shape[0]},), got "
                         f"{tuple(lengths.shape)}")


def _decode_reference(q, k, v, lengths, scale):
    k, v = _repeat_kv(q, k, v)
    s = k.shape[2]
    kv_seg = (torch.arange(s, device=q.device)[None, :]
              < lengths[:, None]).to(torch.int32)
    q_seg = torch.ones((q.shape[0], 1), dtype=torch.int32, device=q.device)
    return attention_reference(q, k, v, causal=False, scale=scale,
                               segment_ids=q_seg, kv_segment_ids=kv_seg)


def decode_attention(q, k, v, *, lengths, scale: Optional[float] = None,
                     force_reference: bool = False):
    """Single-token decode attention over a length-masked cache view.

    ``q``: ``(b, h, 1, d)``; ``k``/``v``: ``(b, h_kv, s, d)``, of which
    only the first ``lengths[i]`` positions of row ``i`` are live keys;
    ``lengths == 0`` gives exactly zero.  The length mask is the
    bottom-right causal mask for a one-token query, so none other is
    applied.
    """
    _check_decode_args(q, k.shape[1], lengths)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if force_reference or q.device.type == "cpu":
        return _decode_reference(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _, h_kv, s, d = k.shape
    return _decode_cuda(q, k, v, lengths, None, scale=float(scale),
                        page_size=s, pps=1, strides=(h_kv * s * d, d, s * d))


def gather_pages(pool_l, page_table):
    """``[num_pages + 1, page_size, h_kv, d]`` pool of one layer + a
    ``[slots, pps]`` page table -> the contiguous ``[slots, h_kv,
    pps * page_size, d]`` view the JAX decode step builds."""
    slots, pps = page_table.shape
    _, ps, h_kv, d = pool_l.shape
    view = pool_l[page_table.long()]          # [S, pps, ps, h_kv, d]
    return view.reshape(slots, pps * ps, h_kv, d).transpose(1, 2)


def paged_decode_attention(q, k_pool_l, v_pool_l, page_table, lengths, *,
                           scale: Optional[float] = None,
                           force_reference: bool = False):
    """Decode attention reading K/V through the page table.

    ``k_pool_l``/``v_pool_l``: one layer's pool ``[num_pages + 1,
    page_size, h_kv, d]``; ``page_table``: ``[slots, pps]`` int32;
    ``lengths``: ``[slots]`` int32.  The same function as
    :func:`decode_attention` on :func:`gather_pages` of the pools; the
    kernel folds the gather into its addressing and never builds that
    view.
    """
    _check_decode_args(q, k_pool_l.shape[2], lengths)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if force_reference or q.device.type == "cpu":
        return _decode_reference(q, gather_pages(k_pool_l, page_table),
                                 gather_pages(v_pool_l, page_table),
                                 lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    _, ps, h_kv, d = k_pool_l.shape
    return _decode_cuda(q, k_pool_l, v_pool_l, lengths, page_table,
                        scale=float(scale), page_size=ps,
                        pps=page_table.shape[1],
                        strides=(ps * h_kv * d, h_kv * d, d))


def attention_flops(b: int, h: int, tq: int, tk: int, d: int,
                    causal: bool, products: int = 2) -> float:
    """Multiply-add work over the pairs the mask keeps, counted as 2 FLOP
    each: ``products`` matrix products of depth ``d`` per kept pair and
    head -- 2 for the forward (``QK^T``, ``PV``), 3 for the dq kernel
    (``s``, ``dp``, ``ds K``), 4 for the dk/dv kernel (``s``, ``dp``,
    ``p^T dO``, ``ds^T Q``)."""
    if causal:
        off = tk - tq
        pairs = sum(min(tk, i + off + 1) for i in range(tq))
    else:
        pairs = tq * tk
    return 2.0 * products * b * h * pairs * d


__all__ = ["attention_reference", "flash_attention", "flash_backward_dq",
           "flash_backward_dkv", "flash_attention_backward",
           "flash_attention_backward_reference", "decode_attention",
           "paged_decode_attention", "gather_pages", "decode_splits",
           "attention_flops"]
