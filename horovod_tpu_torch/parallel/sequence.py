"""Sequence (context) parallelism: ring attention and Ulysses.

Counterpart of ``horovod_tpu/parallel/sequence.py``.  The sequence dim
of ``q``, ``k`` and ``v`` ``(b, h, t_l, d)`` is sharded over the set of
a mesh axis (``"sp"`` by default): rank ``r`` of the set holds positions
``[r * t_l, (r + 1) * t_l)``.

* :func:`ring_attention` (Liu et al., arXiv:2310.01889) -- plain
  PyTorch, as the JAX function (no kernel is involved): the K/V blocks
  go round the ring by :func:`~horovod_tpu_torch.collectives.ops.
  ppermute` while each rank's queries stay, and the blocks merge by an
  f32 online softmax (running max and sum of exponentials), so the full
  ``t x t`` score matrix never exists.  Causal masks use global
  positions (a block wholly in the future is computed and masked, so
  every rank runs the same graph); packed-sequence ``segment_ids`` ride
  the ring beside K/V.  The backward comes from autograd through the
  ppermutes' inverse shifts.
* :func:`ulysses_attention` (Jacobs et al., arXiv:2309.14509) -- two
  all_to_alls swap the sharding between the sequence and the heads, so
  the whole sequence is local for the port's ``flash_attention``
  (the kernels on the card) with ``heads / sp`` heads a rank; the
  segment ids are allgathered.  Needs ``heads % sp == 0``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..collectives.ops import alltoall, ppermute, step_allgather
from .mesh import SP_AXIS
from .tp import resolve_set

_NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, scale: Optional[float] = None,
                   axis=SP_AXIS, segment_ids=None,
                   mesh=None) -> torch.Tensor:
    """Attention over a sequence sharded on the ring of ``axis``; returns
    this rank's output shard ``(b, h, t_l, d)`` in q's dtype.

    ``segment_ids`` (this rank's ``(b, t_l)`` int shard): queries attend
    only keys of an equal id (one id vector serves both sides, so every
    row sees at least itself; the zero-output guard for a row with no
    live key is kept, as in the JAX function)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ps = resolve_set(axis, mesh)
    sp, my = ps.size(), ps.position()
    b, h, t_l, d = q.shape
    out_dtype = q.dtype
    qf = q.float() * scale
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    pos = torch.arange(t_l, device=q.device)
    q_pos = my * t_l + pos

    def merge_block(state, kb, vb, kseg_b, src):
        m, l, acc = state
        scores = torch.einsum("bhtd,bhsd->bhts", qf, kb.float())
        if causal:
            mask = q_pos[:, None] >= (src * t_l + pos)[None, :]
            scores = torch.where(mask[None, None], scores, _NEG_INF)
        if segment_ids is not None:
            smask = (segment_ids[:, None, :, None]
                     == kseg_b[:, None, None, :])
            scores = torch.where(smask, scores, _NEG_INF)
        new_m = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        l = l * correction + p.sum(-1)
        acc = (acc * correction[..., None]
               + torch.einsum("bhts,bhsd->bhtd", p, vb.float()))
        return new_m, l, acc

    m0 = torch.full((b, h, t_l), _NEG_INF, device=q.device)
    l0 = torch.zeros((b, h, t_l), device=q.device)
    acc0 = torch.zeros((b, h, t_l, d), device=q.device)
    state = merge_block((m0, l0, acc0), k, v, segment_ids, my)
    kb, vb, kseg_b = k, v, segment_ids
    for s in range(1, sp):
        kb = ppermute(kb, perm, process_set=ps)
        vb = ppermute(vb, perm, process_set=ps)
        if segment_ids is not None:
            kseg_b = ppermute(kseg_b, perm, process_set=ps)
        state = merge_block(state, kb, vb, kseg_b, (my - s) % sp)
    m, l, acc = state
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = acc / safe_l[..., None]
    if segment_ids is not None:
        out = torch.where((m <= _NEG_INF / 2)[..., None], 0.0, out)
    return out.to(out_dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, scale: Optional[float] = None,
                      axis=SP_AXIS, attn_fn=None, segment_ids=None,
                      mesh=None) -> torch.Tensor:
    """Ulysses attention: ``(b, h, t_l, d)`` sequence shards all_to_all'd
    to ``(b, h / sp, t, d)`` head shards, ``attn_fn(q, k, v, causal=,
    scale=[, segment_ids=])`` over the whole sequence (the port's
    ``flash_attention`` by default), and back.  ``segment_ids`` (this
    rank's ``(b, t_l)`` shard) is allgathered to the whole sequence."""
    if attn_fn is None:
        from ..ops.attention import flash_attention
        attn_fn = flash_attention
    ps = resolve_set(axis, mesh)
    sp = ps.size()
    if q.shape[1] % sp:
        raise ValueError(f"heads {q.shape[1]} not divisible by sp={sp}")

    def to_seq(x):
        return alltoall(x, process_set=ps, split_axis=1,
                        concat_axis=2).contiguous()

    kwargs = {}
    if segment_ids is not None:
        kwargs["segment_ids"] = step_allgather(segment_ids, dim=1,
                                               process_set=ps)
    o = attn_fn(to_seq(q), to_seq(k), to_seq(v), causal=causal,
                scale=scale, **kwargs)
    return alltoall(o, process_set=ps, split_axis=2, concat_axis=1)


__all__ = ["ring_attention", "ulysses_attention"]
