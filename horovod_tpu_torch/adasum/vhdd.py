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

The process-set variant (``members=``, or a set's ``group``) runs the
same schedule among the members, paired by their position in the set;
:func:`adasum_allreduce_hierarchical` is the two-level variant (a mean
reduce-scatter within each node, Adasum across the nodes on each shard,
an allgather within the node).  ``wire_codec="fp8"`` sends the
exchanged pieces as e4m3 with a scale each (the cross-node exchanges
only, in the two-level variant).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..collectives.compression import fp8_dequantize, fp8_quantize
from ..core.state import global_state
from ..core.topology import hier_groups

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


def _exchange(send: torch.Tensor, peer: int, group=None,
              wire_codec=None) -> torch.Tensor:
    """Swap ``send`` with global rank ``peer``'s tensor of the same shape.
    The send and the receive are posted together: a blocking send on
    both partners deadlocks on gloo.

    ``wire_codec="fp8"`` (``horovod_tpu/adasum/xla.py::_codec_permute``)
    quantizes ``send`` to e4m3 with its own max-abs scale, swaps the
    codes (as ``uint8``) and the f32 scale, and dequantizes what arrives
    to ``send``'s dtype; the mixing stays in the working dtype and f32.
    """
    if wire_codec is None:
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, peer, group=group),
               dist.P2POp(dist.irecv, recv, peer, group=group)]
    elif wire_codec == "fp8":
        q, scale = fp8_quantize(send)
        q, scale = q.view(torch.uint8), scale.reshape(1)
        recv, recv_s = torch.empty_like(q), torch.empty_like(scale)
        ops = [dist.P2POp(dist.isend, q, peer, group=group),
               dist.P2POp(dist.isend, scale, peer, group=group),
               dist.P2POp(dist.irecv, recv, peer, group=group),
               dist.P2POp(dist.irecv, recv_s, peer, group=group)]
    else:
        raise ValueError(f"unknown adasum wire codec {wire_codec!r}")
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    if wire_codec is None:
        return recv
    return fp8_dequantize(recv.view(torch.float8_e4m3fn), recv_s[0],
                          send.dtype)


def _members_group(members: Sequence[int]):
    """The group of the registered process set whose members are
    ``members`` (a set is registered collectively, never here)."""
    from ..core.process_sets import process_set_of_ranks
    return process_set_of_ranks(members).group


def adasum_allreduce(x: torch.Tensor, group=None,
                     members: Optional[Sequence[int]] = None,
                     wire_codec=None) -> torch.Tensor:
    """Adasum of ``x`` over every rank of ``group`` (the default group
    when ``None``); a new tensor of x's shape and dtype.

    ``members`` (global ranks, the JAX ``members=``) names a registered
    process set instead: the exchange runs over its group, between
    members paired by their position in the set, and a non-member raises
    ``ValueError``.  The member count must be a power of two.  One
    member returns ``x`` itself with no communication.  The flat vector
    is padded with zeros to a multiple of the member count, so it halves
    evenly at every level; each level moves half of what the last did,
    O(n) bytes a rank in all, plus the 3 f32 partial dot products of
    every member (``all_gather`` of an ``[n, 3]`` tensor) that the merged
    group sums.

    ``wire_codec="fp8"`` sends every exchanged piece -- the halves of the
    reduce levels and the pieces of the rebuild -- as e4m3 with its own
    scale (see :func:`_exchange`); a rank's own piece is never quantized.
    """
    if wire_codec not in (None, "fp8"):
        raise ValueError(f"unknown adasum wire codec {wire_codec!r}")
    if members is not None:
        members = tuple(sorted(int(r) for r in members))
        if len(members) & (len(members) - 1) != 0:
            raise ValueError(f"Adasum requires a power-of-two member "
                             f"count, got {len(members)}")
        if dist.get_rank() not in members:
            raise ValueError(f"rank {dist.get_rank()} is not among the "
                             f"Adasum members {members}")
        if group is None:
            group = _members_group(members)
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
        recv = _exchange(give.contiguous(), peer(pos ^ bit), group,
                         wire_codec)
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
        recv = _exchange(y, peer(pos ^ bit), group, wire_codec)
        y = torch.cat([y, recv] if (pos & bit) == 0 else [recv, y])
    if pad:
        y = y[:-pad]
    return y.view(x.shape)


def adasum_allreduce_hierarchical(x: torch.Tensor,
                                  local_size: Optional[int] = None,
                                  wire_codec=None) -> torch.Tensor:
    """Two-level Adasum (``horovod_tpu/adasum/xla.py::
    adasum_allreduce_hierarchical``; the reference's hybrid
    ``adasum_gpu_operations.cc``).  The world is split into nodes of
    ``local_size`` consecutive ranks (``hvd.local_size()`` when ``None``;
    it must divide the world, and the node count must be a power of
    two): a reduce-scatter within the node takes the MEAN of the node's
    vectors (zero-padded to a multiple of ``local_size``; divided in the
    tensor's dtype), Adasum runs across the nodes on each shard (the
    ranks of one local rank form a cross group; the coefficients are per
    shard, as in the reference), and an allgather within the node
    rebuilds the vector.  With one rank a node this is
    :func:`adasum_allreduce` over the world; with one node, the mean.
    ``wire_codec="fp8"`` quantizes only the cross-node Adasum exchanges;
    the node's reduce-scatter and allgather stay in the working dtype."""
    local = int(local_size or global_state().local_size or 1)
    n = dist.get_world_size()
    if local < 1 or n % local:
        raise ValueError(f"local_size {local} does not divide the world "
                         f"size {n}")
    if local == 1:
        return adasum_allreduce(x, wire_codec=wire_codec)
    node, cross = hier_groups(local)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % local
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.contiguous()
    shard = flat.new_empty(flat.numel() // local)
    dist.reduce_scatter_tensor(shard, flat, group=node)
    if shard.dtype.is_floating_point:
        shard.div_(local)
    else:
        shard.copy_(torch.div(shard, local, rounding_mode="trunc"))
    mixed = adasum_allreduce(shard, group=cross,
                             wire_codec=wire_codec).contiguous()
    out = flat.new_empty(flat.numel())
    dist.all_gather_into_tensor(out, mixed, group=node)
    if pad:
        out = out[:-pad]
    return out.view(x.shape)
