"""Adasum over ``torch.distributed``: vector-halving, distance-doubling.

Counterpart of ``horovod_tpu/adasum/xla.py``, in plain PyTorch (the JAX
version is XLA ops, no Pallas kernel).  Each level exchanges half of the
working segment with the XOR partner through paired ``isend`` / ``irecv``
and mixes with

    adasum(a, b) = (1 - a.b / (2 |a|^2)) a  +  (1 - a.b / (2 |b|^2)) b

where ``a`` is the lower-index group's vector.  The dot products are
taken in float32 whatever the wire dtype; the coefficients are computed
in float32 and cast to the wire dtype before mixing, as the JAX package
does.  A reverse distance-halving allgather rebuilds the whole vector.

Every rank must call :func:`adasum_allreduce` on the same sizes in the
same order: its point-to-point and gather calls pair up across ranks.

Not ported: the hierarchical two-level variant, the process-set
(``members=``) variant, and the fp8 wire codec.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_TOL = 1e-30


def _coefficients(dot, anormsq, bnormsq):
    """f32 mixing coefficients; a norm below ``_TOL`` keeps its vector
    as it is."""
    one = torch.ones_like(dot)
    acoeff = torch.where(anormsq < _TOL, one, 1.0 - dot / (2.0 * anormsq))
    bcoeff = torch.where(bnormsq < _TOL, one, 1.0 - dot / (2.0 * bnormsq))
    return acoeff, bcoeff


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mix two vectors; ``a`` is the lower-index group's value."""
    a32, b32 = a.float().reshape(-1), b.float().reshape(-1)
    acoeff, bcoeff = _coefficients(a32 @ b32, a32 @ a32, b32 @ b32)
    return acoeff.to(a.dtype) * a + bcoeff.to(b.dtype) * b


def adasum_local_tree(vectors):
    """Adasum of a list of tensors, no communication: the binary tree of
    ``adasum.reference.adasum_reference`` (level k combines groups whose
    bit k differs, lower-index group first)."""
    n = len(vectors)
    if n & (n - 1) != 0:
        raise ValueError(f"Adasum requires a power-of-two count, got {n}")
    if n == 1:
        return vectors[0]
    half = n // 2
    return adasum_pair(adasum_local_tree(vectors[:half]),
                       adasum_local_tree(vectors[half:]))


def _exchange(send: torch.Tensor, peer: int) -> torch.Tensor:
    """Swap ``send`` with ``peer``'s tensor of the same shape.  The send
    and the receive are posted together: a blocking send on both
    partners deadlocks on gloo."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                   dist.P2POp(dist.irecv, recv, peer)])
    for r in reqs:
        r.wait()
    return recv


def adasum_allreduce(x: torch.Tensor, group=None, members=None,
                     wire_codec=None) -> torch.Tensor:
    """Adasum of ``x`` over every rank of ``group`` (the default group
    when ``None``); a new tensor of x's shape and dtype.

    The rank count must be a power of two.  A world of one returns ``x``
    itself with no communication.  The flat vector is padded with zeros
    to a multiple of the rank count, so it halves evenly at every level;
    each level moves half of what the last did, O(n) bytes a rank in all,
    plus the 3 f32 partial dot products of every rank
    (``all_gather`` of an ``[n, 3]`` tensor) that the merged group sums.

    ``members`` (the process-set variant) and ``wire_codec="fp8"`` are
    not ported and raise ``NotImplementedError``.
    """
    if members is not None:
        raise NotImplementedError(
            "process-set Adasum (members=) is not ported (ROADMAP item 1.2)")
    if wire_codec is not None:
        raise NotImplementedError(
            f"the {wire_codec!r} Adasum wire codec is not ported (ROADMAP "
            f"item 1.9)")
    m = dist.get_world_size(group)
    if m & (m - 1) != 0:
        raise ValueError(f"Adasum requires a power-of-two member count, "
                         f"got {m}")
    if m == 1:
        return x
    pos = dist.get_rank(group)

    def peer(p):
        return p if group is None else dist.get_global_rank(group, p)

    levels = int(math.log2(m))
    flat = x.reshape(-1)
    pad = (-flat.numel()) % m
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    ranks = torch.arange(m, device=x.device)
    y = flat                       # my piece of my group's combined vector
    for k in range(levels):
        bit = 1 << k
        half = y.numel() // 2
        is_lo = (pos & bit) == 0
        # The lower position keeps the first half, its partner the
        # second: retained pieces cover the same index range.
        mine, give = (y[:half], y[half:]) if is_lo else (y[half:], y[:half])
        recv = _exchange(give.contiguous(), peer(pos ^ bit))
        a, b = (mine, recv) if is_lo else (recv, mine)
        a32, b32 = a.float(), b.float()
        partial = torch.stack([a32 @ b32, a32 @ a32, b32 @ b32])
        dots_all = partial.new_empty(m, 3)
        dist.all_gather(list(dots_all.unbind(0)), partial, group=group)
        # The merged group: ranks whose position shares my high bits.
        in_group = (ranks >> (k + 1)) == (pos >> (k + 1))
        dot, anormsq, bnormsq = torch.where(in_group[:, None], dots_all,
                                            0.0).sum(0)
        acoeff, bcoeff = _coefficients(dot, anormsq, bnormsq)
        y = acoeff.to(y.dtype) * a + bcoeff.to(y.dtype) * b
    # Distance-halving allgather, inverting the split order.
    for k in reversed(range(levels)):
        bit = 1 << k
        recv = _exchange(y, peer(pos ^ bit))
        y = torch.cat([y, recv] if (pos & bit) == 0 else [recv, y])
    if pad:
        y = y[:-pad]
    return y.view(x.shape)


def adasum_allreduce_hierarchical(x: torch.Tensor, *args, **kwargs):
    """Not ported: the two-level (intra-node reduce-scatter, cross-node
    Adasum, intra-node allgather) variant."""
    raise NotImplementedError(
        "hierarchical Adasum is not ported (ROADMAP item 1.2)")
