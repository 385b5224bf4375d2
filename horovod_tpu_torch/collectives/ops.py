"""Collective operations over ``torch.distributed``.

Counterpart of ``horovod_tpu/collectives/ops.py``'s eager surface and of
the shim ``horovod_tpu/torch_api/__init__.py``: :func:`allreduce` (Sum,
Average, Min, Max, Product, Adasum) with ``prescale_factor`` /
``postscale_factor`` and ``compression``, :func:`grouped_allreduce`,
:func:`allgather` (ragged first dims), :func:`grouped_allgather`,
:func:`broadcast`, :func:`reducescatter`, :func:`grouped_reducescatter`,
:func:`alltoall` (even, or uneven with ``splits``, or the JAX op's
``split_axis`` / ``concat_axis`` form), :func:`ppermute`,
:func:`sparse_allreduce_async`, :func:`barrier`, :func:`desync_check`
(the in-step replica probe), and the exchanges of
the compressed and sharded paths: :func:`powersgd_allreduce`,
:func:`topk_allreduce`, :func:`fp8_allreduce`,
:func:`hierarchical_allreduce` (two-level, codecs per leg),
:func:`chunked_allreduce` and the ZeRO building blocks
:func:`psum_scatter_bucket` (and its ``_async`` twin) /
:func:`allgather_bucket`.  Each op but the last four has an ``*_async`` twin
that returns a :class:`Handle` around the ``torch.distributed`` work
object; the result is ready after ``handle.wait()``, and
``handle.poll()`` says whether the work is done.  (The package's top
level wraps these handles in Horovod's integer handles:
:mod:`~horovod_tpu_torch.collectives.handles`.)

``process_set=`` (``None`` for the global set, a name or a
:class:`~horovod_tpu_torch.core.process_sets.ProcessSet`) runs an op on
the set's group: members only, ``Average`` divides by the set's size,
ranks and roots are global ranks, and the ``splits`` of ``alltoall`` are
indexed by set position.  A rank that is not a member raises
``ValueError`` (the JAX in-step model gives it an unspecified value; in
the per-rank model it never calls).

Horovod's keywords are accepted: ``average=``, ``name=`` (a label for
error messages; nothing is keyed on it), ``op=``, ``compression=``,
``prescale_factor=``, ``postscale_factor=``, ``process_set=``.  **The
second positional parameter** of ``allreduce`` and its variants is
Horovod's ``average``; a :class:`ReduceOp` given there is taken as
``op`` (the port's earlier order, ``allreduce(x, Sum)``), a bool as
``average`` (``False``: Sum).  Giving an op both ways, or ``average``
beside ``op``, raises ``ValueError``.

Arithmetic follows the JAX ops: ``Average`` is a sum followed by a
division in the tensor's own dtype (truncating for integers), with the
prescale applied before the reduction and the postscale after.
``reducescatter`` of Min, Max and Product reduces the whole tensor and
keeps this rank's shard, as the JAX op does; a scattered dim that does
not divide by the set's size raises ``ValueError`` (upstream Horovod
hands the low ranks one extra row).  ``op=Adasum`` runs its whole
exchange when it is called
(:func:`~horovod_tpu_torch.adasum.vhdd.adasum_allreduce`), so every rank
must issue its Adasum calls in the same order.  The inputs are never
modified, except by the in-place ``*_`` variants.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..adasum.vhdd import adasum_allreduce
from ..core import stall
from ..core.basics import _require_init
from ..core.exceptions import HorovodInternalError
from ..core.process_sets import ProcessSet, get_process_set
from ..ops import fused_update as fu
from ..timeline.metrics import note_collective
from . import eager, joinop
from .compression import (Compression, fp8_quantize, is_error_feedback,
                          is_fp8, is_powersgd, parse_compression,
                          powersgd_effective_rank, powersgd_matrix_shape,
                          topk_count)
from .reduce_op import Adasum, Average, Max, Min, Product, ReduceOp, Sum

_TORCH_OPS = {
    Sum: dist.ReduceOp.SUM,
    Average: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


class Handle:
    """An in-flight collective: ``wait()`` blocks until it is done and
    returns its result; ``poll()`` is True once its work (and every part
    of a grouped handle) has completed.  A failure of the collective
    surfaces from ``wait()`` as :class:`HorovodInternalError`."""

    def __init__(self, work, finish: Callable[[], object],
                 parts: Sequence["Handle"] = (), name: Optional[str] = None):
        self._work = work
        self._finish = finish
        self._parts = tuple(parts)
        self._name = name
        self._done = False
        self._result = None

    @classmethod
    def completed(cls, result) -> "Handle":
        h = cls(None, lambda: result)
        h.wait()
        return h

    def poll(self) -> bool:
        if self._done:
            return True
        return (self._work is None or self._work.is_completed()) and \
            all(p.poll() for p in self._parts)

    def wait(self):
        if not self._done:
            if self._work is not None:
                try:
                    with stall.watched(self._name or "collective"):
                        self._work.wait()
                except Exception as e:
                    label = f" {self._name!r}" if self._name else ""
                    raise HorovodInternalError(
                        f"collective{label} failed: {e}") from e
            self._result = self._finish()
            self._done = True
        return self._result


def _member_set(process_set, op: str,
                tensor: Optional[torch.Tensor] = None,
                nbytes: Optional[int] = None) -> ProcessSet:
    """The registered set, checked to hold this rank; counts the call
    with ``tensor``'s bytes, or ``nbytes`` (an exchange's plan rows)."""
    st = _require_init()
    ps = get_process_set(process_set)
    if not ps.included(st.rank):
        raise ValueError(
            f"{op}: rank {st.rank} is not a member of process set "
            f"{ps.name!r} (ranks {ps.ranks}); non-members do not call "
            f"the set's collectives")
    if nbytes is None:
        nbytes = 0 if tensor is None else \
            tensor.numel() * tensor.element_size()
    note_collective(op, ps.name, nbytes)
    return ps


def _note_rows(legs) -> None:
    """Note an exchange's plan rows in the span registry."""
    from ..timeline.spans import note_leg
    for leg in legs:
        note_leg(leg)


def _divide_in_dtype(y: torch.Tensor, n: int) -> torch.Tensor:
    """Average's division in the tensor's own dtype (integer tensors
    truncate toward zero, as ``lax.div`` does)."""
    if y.dtype.is_floating_point:
        return y.div_(n)
    return y.copy_(torch.div(y, n, rounding_mode="trunc"))


def _resolve_op(average, op) -> ReduceOp:
    """Horovod's ``(average, op)`` pair as one op (module docstring)."""
    if isinstance(average, ReduceOp):
        if op is not None:
            raise ValueError(f"op given twice: {average} and {op}")
        return average
    if average is not None and op is not None:
        raise ValueError("specify either op or average, not both")
    if op is not None:
        return op
    return Sum if average is False else Average


def _check_compression(compression, fp8_ok: bool = False):
    """The codec of an allreduce: a cast codec, or (``fp8_ok``)
    ``Compression.fp8``; the other exchange-level codecs need their own
    op."""
    compression = parse_compression(
        Compression.none if compression is None else compression)
    if getattr(compression, "wire_format", "") and \
            not (fp8_ok and is_fp8(compression)):
        raise ValueError(
            f"{compression.__name__} is an exchange codec: use "
            f"powersgd_allreduce, topk_allreduce, fp8_allreduce or "
            f"hierarchical_allreduce, or the DistributedOptimizer")
    return compression


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------


def _join_postscale(slot, op: ReduceOp, dtype: torch.dtype,
                    postscale_factor: float, n: int) -> float:
    """While ranks are drained, ``Average`` is the mean over the active
    ranks: the postscale gains ``n / n_active``.  An integer ``Average``
    is refused then (a truncating rescale is ill-defined)."""
    if not slot.draining or op is not Average:
        return postscale_factor
    if not (dtype.is_floating_point or dtype.is_complex):
        slot.abort("integer-dtype Average while ranks are joined is "
                   "unsupported (truncating rescale is ill-defined)")
    return postscale_factor * n / slot.k


def allreduce_async_(tensor: torch.Tensor, average=None,
                     name: Optional[str] = None,
                     op: Optional[ReduceOp] = None, *,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set=None, wire_codec=None) -> Handle:
    """Allreduce ``tensor`` IN PLACE; the handle returns ``tensor``.
    ``wire_codec="fp8"`` (Adasum only) sends Adasum's exchanged pieces
    as e4m3.  Takes its slot in ``hvd.join``'s drain protocol (see
    :mod:`.joinop`)."""
    op = _resolve_op(average, op)
    _check_allreduce_op(op, wire_codec)
    ps = _member_set(process_set, "allreduce", tensor)
    with eager.join_op(ps) as slot:
        postscale_factor = _join_postscale(slot, op, tensor.dtype,
                                           postscale_factor, ps.size())
        slot.publish(eager.join_header(
            "allreduce", tensor, op=op.value, pre=prescale_factor,
            post=postscale_factor,
            codec="adasum_fp8" if wire_codec else "none"))
        return _allreduce_start(tensor, op, ps, prescale_factor,
                                postscale_factor, wire_codec, name)


def _check_allreduce_op(op: ReduceOp, wire_codec) -> None:
    if op not in _TORCH_OPS and op is not Adasum:
        raise NotImplementedError(f"reduce op {op} is not ported")
    if wire_codec is not None and op is not Adasum:
        raise ValueError("wire_codec applies to op=Adasum only; use "
                         "fp8_allreduce for Sum/Average")


def exchange_allreduce_async_(tensor: torch.Tensor, op: ReduceOp, *,
                              prescale_factor: float = 1.0,
                              postscale_factor: float = 1.0,
                              process_set=None, wire_codec=None,
                              name: Optional[str] = None) -> Handle:
    """:func:`allreduce_async_` for the exchanges inside a train step
    (the optimizer's planned buckets, the two-level and chunked
    exchanges): no join slot, as the JAX package's in-step collectives
    take none."""
    _check_allreduce_op(op, wire_codec)
    ps = _member_set(process_set, "allreduce", tensor)
    return _allreduce_start(tensor, op, ps, prescale_factor,
                            postscale_factor, wire_codec, name)


def _step_joins() -> bool:
    """Whether a train step's own collectives take a join slot: only
    while the native batcher runs.  Its gradient batches are the one
    exchange that takes part in ``hvd.join``'s drain, so the step's
    other collectives must as well; beside the planned buckets (no slot,
    as the JAX traced step's collectives) a slot would only add a
    host-synced presence round, which a captured graph cannot run."""
    from . import batching
    return batching.current() is not None


def step_allreduce_(tensor: torch.Tensor, op: ReduceOp, *,
                    process_set=None) -> torch.Tensor:
    """A train step's own allreduce of ``tensor``, in place (the loss
    average, the guard screen, the sync-BN sums, the eval metrics): a
    join slot only under :func:`_step_joins`."""
    if _step_joins():
        return allreduce_(tensor, op=op, process_set=process_set)
    return exchange_allreduce_async_(tensor, op,
                                     process_set=process_set).wait()


def step_allreduce(tensor: torch.Tensor, op: ReduceOp, *,
                   process_set=None) -> torch.Tensor:
    """:func:`step_allreduce_` of a copy of ``tensor``."""
    return step_allreduce_(tensor.clone(), op, process_set=process_set)


def step_grouped_allreduce(tensors: Sequence[torch.Tensor],
                           op: ReduceOp, *,
                           process_set=None) -> List[torch.Tensor]:
    """:func:`grouped_allreduce` for a train step's own list (flax BN's
    running statistics): a join slot only under :func:`_step_joins`."""
    from ..controller.fusion import pack, plan_buckets, unpack
    if _step_joins():
        return grouped_allreduce(tensors, op=op, process_set=process_set)
    tensors = list(tensors)
    spec = plan_buckets(tensors)
    handles = [exchange_allreduce_async_(buf, op, process_set=process_set)
               for buf in pack(tensors, spec)]
    return unpack([h.wait() for h in handles], spec)


def _allreduce_start(tensor: torch.Tensor, op: ReduceOp, ps: ProcessSet,
                     prescale_factor: float, postscale_factor: float,
                     wire_codec, name: Optional[str]) -> Handle:
    if prescale_factor != 1.0:
        tensor.mul_(prescale_factor)
    if op is Adasum:
        y = adasum_allreduce(
            tensor, group=ps.group,
            members=None if ps.is_global() else ps.ranks,
            wire_codec=wire_codec)
        if y is not tensor:
            tensor.copy_(y)
        if postscale_factor != 1.0:
            tensor.mul_(postscale_factor)
        return Handle.completed(tensor)
    work = dist.all_reduce(tensor, op=_TORCH_OPS[op], group=ps.group,
                           async_op=True)

    def finish():
        if op is Average:
            _divide_in_dtype(tensor, ps.size())
        if postscale_factor != 1.0:
            tensor.mul_(postscale_factor)
        return tensor

    return Handle(work, finish, name=name)


def allreduce_async(tensor: torch.Tensor, average=None,
                    name: Optional[str] = None,
                    op: Optional[ReduceOp] = None, *,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set=None) -> Handle:
    """Allreduce a copy of ``tensor``; the input is left as it is."""
    return allreduce_async_(tensor.clone(), average, name, op,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor,
                            process_set=process_set)


def allreduce(tensor: torch.Tensor, average=None,
              name: Optional[str] = None, compression=None,
              op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None) -> torch.Tensor:
    """Reduce ``tensor`` over the set's ranks (NCCLAllreduce analogue);
    ``compression`` (a cast codec) narrows the wire and widens the
    result back.  ``Compression.fp8`` runs :func:`fp8_allreduce` for
    Sum/Average and Adasum's e4m3 wire for Adasum."""
    compression = _check_compression(compression, fp8_ok=True)
    if is_fp8(compression):
        op = _resolve_op(average, op)
        if op is Adasum:
            return allreduce_async_(
                tensor.clone(), op=op, name=name,
                prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, process_set=process_set,
                wire_codec="fp8").wait()
        ps = get_process_set(process_set)
        with eager.join_op(ps) as slot:
            postscale_factor = _join_postscale(slot, op, tensor.dtype,
                                               postscale_factor, ps.size())
            slot.publish(eager.join_header(
                "allreduce", tensor, op=op.value, pre=prescale_factor,
                post=postscale_factor, codec="fp8"))
            return fp8_allreduce(tensor, op,
                                 prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor,
                                 process_set=process_set)
    wire, ctx = compression.compress(tensor)
    if wire is tensor:
        wire = tensor.clone()
    out = allreduce_async_(wire, average, name, op,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor,
                           process_set=process_set).wait()
    return compression.decompress(out, ctx)


def allreduce_(tensor: torch.Tensor, average=None,
               name: Optional[str] = None, op: Optional[ReduceOp] = None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None) -> torch.Tensor:
    """Allreduce ``tensor`` in place and return it."""
    return allreduce_async_(tensor, average, name, op,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor,
                            process_set=process_set).wait()


def grouped_allreduce_async_(tensors: Sequence[torch.Tensor], average=None,
                             name: Optional[str] = None,
                             op: Optional[ReduceOp] = None, *,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             process_set=None) -> Handle:
    """Allreduce a list as one fused unit, writing each result back into
    its tensor; the handle returns the list."""
    tensors = list(tensors)
    inner = grouped_allreduce_async(
        tensors, average, name, op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set)

    def finish():
        for t, y in zip(tensors, inner.wait()):
            t.copy_(y)
        return tensors

    return Handle(None, finish, parts=(inner,), name=name)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name: Optional[str] = None,
                            op: Optional[ReduceOp] = None, *,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set=None) -> Handle:
    """Allreduce a list as one fused unit: packed into per-dtype buffers
    by the fusion planner, one collective per buffer, split back out."""
    from ..controller.fusion import pack, plan_buckets, unpack
    tensors = list(tensors)
    spec = plan_buckets(tensors)
    with joinop.flush(process_set, len(spec.buffers)):
        handles = [allreduce_async_(buf, average, name, op,
                                    prescale_factor=prescale_factor,
                                    postscale_factor=postscale_factor,
                                    process_set=process_set)
                   for buf in pack(tensors, spec)]
    return Handle(None, lambda: unpack([h.wait() for h in handles], spec),
                  parts=handles, name=name)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name: Optional[str] = None, compression=None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set=None) -> List[torch.Tensor]:
    compression = _check_compression(compression)
    wires, ctxs = zip(*[compression.compress(t) for t in tensors]) \
        if tensors else ((), ())
    outs = grouped_allreduce_async(
        wires, average, name, op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set).wait()
    return [compression.decompress(y, c) for y, c in zip(outs, ctxs)]


def grouped_allreduce_(tensors: Sequence[torch.Tensor], average=None,
                       name: Optional[str] = None,
                       op: Optional[ReduceOp] = None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       process_set=None) -> List[torch.Tensor]:
    return grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set).wait()


# ---------------------------------------------------------------------------
# allgather and broadcast
# ---------------------------------------------------------------------------


def _allgatherv(x: torch.Tensor, ps: ProcessSet):
    """The one ragged exchange (the body of :func:`allgather`,
    :func:`~horovod_tpu_torch.collectives.eager.allgatherv` and the
    sparse allreduce): start gathering every member's ``x`` (first dims
    may differ): ``(work, padded outputs, first dims)``.  The first dims
    are exchanged first, so this returns after that small exchange.
    Takes ``x``'s slot in the join protocol (a drained rank contributes
    zero rows)."""
    if x.dim() == 0:
        x = x.reshape(1)
    x = x.contiguous()
    with eager.join_op(ps) as slot:
        slot.publish(eager.join_header("allgather", x))
        return _allgatherv_start(x, ps)


def _allgatherv_start(x: torch.Tensor, ps: ProcessSet):
    n = ps.size()
    dims = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    all_dims = [torch.empty_like(dims) for _ in range(n)]
    dist.all_gather(all_dims, dims, group=ps.group)
    lens = [int(d.item()) for d in all_dims]
    width = max(lens)
    padded = x.new_zeros((width,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    out = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(out, padded, group=ps.group, async_op=True)
    return work, out, lens


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    process_set=None) -> Handle:
    """Concatenate every member's tensor along dim 0, in rank order;
    members may differ in dim 0 only (Horovod's allgather)."""
    ps = _member_set(process_set, "allgather", tensor)
    work, out, lens = _allgatherv(tensor, ps)
    return Handle(work, lambda: torch.cat(
        [o[:m] for o, m in zip(out, lens)], dim=0), name=name)


def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    return allgather_async(tensor, name, process_set).wait()


def grouped_allgather_async(tensors: Sequence[torch.Tensor],
                            name: Optional[str] = None,
                            process_set=None) -> Handle:
    """:func:`allgather` of each tensor, behind one join presence round;
    the handle returns the list."""
    tensors = list(tensors)
    with joinop.flush(process_set, len(tensors)):
        handles = [allgather_async(t, name, process_set) for t in tensors]
    return Handle(None, lambda: [h.wait() for h in handles],
                  parts=handles, name=name)


def grouped_allgather(tensors: Sequence[torch.Tensor],
                      name: Optional[str] = None,
                      process_set=None) -> List[torch.Tensor]:
    return grouped_allgather_async(tensors, name, process_set).wait()


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0,
                     name: Optional[str] = None,
                     process_set=None) -> Handle:
    """Every member's ``tensor`` receives root's value, in place;
    ``root_rank`` is a global rank and must be a member."""
    ps = _member_set(process_set, "broadcast", tensor)
    if root_rank not in ps.ranks:
        raise ValueError(f"broadcast root_rank {root_rank} is not a member "
                         f"of process set {ps.name!r} (ranks {ps.ranks})")
    with eager.join_op(ps) as slot:
        if slot.draining and not slot.mask[root_rank]:
            # A joined rank cannot source new data (upstream's error).
            slot.abort(f"broadcast root_rank {root_rank} has joined and "
                       f"cannot source a broadcast")
        slot.publish(eager.join_header("broadcast", tensor,
                                       root=root_rank))
        work = dist.broadcast(tensor, src=root_rank, group=ps.group,
                              async_op=True)
    return Handle(work, lambda: tensor, name=name)


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None,
                    process_set=None) -> Handle:
    return broadcast_async_(tensor.clone(), root_rank, name, process_set)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    """Root's value, on every member (the input is left as it is)."""
    return broadcast_async(tensor, root_rank, name, process_set).wait()


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None,
               process_set=None) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank, name, process_set).wait()


# ---------------------------------------------------------------------------
# reducescatter and alltoall
# ---------------------------------------------------------------------------


def reducescatter_async(tensor: torch.Tensor, op: ReduceOp = Average,
                        name: Optional[str] = None, process_set=None, *,
                        scatter_axis: int = 0) -> Handle:
    """Reduce over the set, then keep this member's shard of
    ``scatter_axis`` (NCCLReducescatter): the shard at its position in
    the set, ``tensor.shape[scatter_axis] / size`` long."""
    if op is Adasum:
        raise NotImplementedError(
            "reducescatter does not support Adasum (the reference's Adasum "
            "is an allreduce-shaped op); use allreduce(op=Adasum)")
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op}")
    ps = _member_set(process_set, "reducescatter", tensor)
    if tensor.dim() == 0:
        raise ValueError("reducescatter needs a tensor of at least one dim")
    m = ps.size()
    axis = scatter_axis % tensor.dim()
    d = tensor.shape[axis]
    if d % m:
        raise ValueError(
            f"reducescatter over a {m}-member process set needs dim "
            f"{axis} divisible by {m}, got {d}")
    shard = d // m
    pos = ps.position()
    with eager.join_op(ps) as slot:
        # While ranks are drained, Average divides by the active ranks.
        divisor = m
        if slot.draining and op is Average:
            if not tensor.dtype.is_floating_point:
                slot.abort("integer-dtype Average while ranks are joined "
                           "is unsupported")
            divisor = slot.k
        slot.publish(eager.join_header("reducescatter", tensor,
                                       op=op.value, axis=axis,
                                       jk=divisor))
        if op in (Sum, Average):
            x = tensor.movedim(axis, 0).contiguous()
            out = x.new_empty((shard,) + tuple(x.shape[1:]))
            work = dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                              group=ps.group, async_op=True)
        else:
            # No min/max/product scatter on every backend: reduce the
            # whole tensor and keep this member's shard, as the JAX op
            # does.
            x = tensor.movedim(axis, 0).clone(
                memory_format=torch.contiguous_format)
            work = dist.all_reduce(x, op=_TORCH_OPS[op], group=ps.group,
                                   async_op=True)
            out = None

    def finish():
        y = x[pos * shard:(pos + 1) * shard] if out is None else out
        if op is Average:
            _divide_in_dtype(y, divisor)
        return y.movedim(0, axis).contiguous()

    return Handle(work, finish, name=name)


def reducescatter(tensor: torch.Tensor, op: ReduceOp = Average,
                  name: Optional[str] = None, process_set=None, *,
                  scatter_axis: int = 0) -> torch.Tensor:
    return reducescatter_async(tensor, op, name, process_set,
                               scatter_axis=scatter_axis).wait()


def grouped_reducescatter_async(tensors: Sequence[torch.Tensor],
                                op: ReduceOp = Average,
                                name: Optional[str] = None,
                                process_set=None) -> Handle:
    """:func:`reducescatter` of each tensor, behind one join presence
    round; the handle returns the list."""
    tensors = list(tensors)
    with joinop.flush(process_set, len(tensors)):
        handles = [reducescatter_async(t, op, name, process_set)
                   for t in tensors]
    return Handle(None, lambda: [h.wait() for h in handles],
                  parts=handles, name=name)


def grouped_reducescatter(tensors: Sequence[torch.Tensor],
                          op: ReduceOp = Average,
                          name: Optional[str] = None,
                          process_set=None) -> List[torch.Tensor]:
    return grouped_reducescatter_async(tensors, op, name,
                                       process_set).wait()


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None,
                   process_set=None) -> Handle:
    """Exchange rows of dim 0 with every member (NCCLAlltoall).

    Without ``splits`` the rows split evenly, block ``i`` to member ``i``
    (dim 0 must divide by the set's size), and the handle returns the
    received blocks concatenated in member order.  With ``splits`` (one
    count per member, in set order, summing to dim 0) ``splits[i]`` rows
    go to member ``i``: the counts are exchanged first (a small
    ``all_to_all`` that this call waits for), then the rows in one
    ``all_to_all_single`` with explicit split lists; the handle returns
    ``(received, received_splits)``, the splits an int64 CPU tensor."""
    ps = _member_set(process_set, "alltoall", tensor)
    m = ps.size()
    x = tensor.contiguous()
    if x.dim() == 0:
        raise ValueError("alltoall needs a tensor of at least one dim")
    if splits is None:
        if x.shape[0] % m:
            raise ValueError(
                f"alltoall over a {m}-member process set needs dim 0 "
                f"divisible by {m}, got {x.shape[0]}")
        with eager.join_op(ps) as slot:
            slot.publish(eager.join_header("alltoall", x))
            out = torch.empty_like(x)
            work = dist.all_to_all_single(out, x, group=ps.group,
                                          async_op=True)
        return Handle(work, lambda: out, name=name)
    send = [int(s) for s in (splits.tolist() if torch.is_tensor(splits)
                             else splits)]
    if len(send) != m or min(send) < 0 or sum(send) != x.shape[0]:
        raise ValueError(
            f"alltoall splits {send} must hold {m} non-negative counts "
            f"summing to dim 0 ({x.shape[0]})")
    with eager.join_op(ps) as slot:
        # A drained rank replays zero rows and zero splits: the others
        # take nothing from it.
        slot.publish(eager.join_header("alltoallv", x))
        return _alltoallv_start(x, send, ps, name)


def _alltoallv_start(x: torch.Tensor, send: List[int], ps: ProcessSet,
                     name: Optional[str]) -> Handle:
    """The ragged alltoall (the body of ``alltoall(splits=)`` and
    :func:`~horovod_tpu_torch.collectives.eager.alltoallv`): the counts
    first (a small ``all_to_all`` this call waits for), then the rows in
    one ``all_to_all_single``."""
    counts = torch.tensor(send, dtype=torch.int64, device=x.device)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=ps.group)
    recv = recv_counts.tolist()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    work = dist.all_to_all_single(out, x, output_split_sizes=recv,
                                  input_split_sizes=send, group=ps.group,
                                  async_op=True)
    received = torch.tensor(recv, dtype=torch.int64)
    return Handle(work, lambda: (out, received), name=name)


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None,
             process_set=None, *, split_axis: Optional[int] = None,
             concat_axis: Optional[int] = None):
    """The received tensor, or ``(received, received_splits)`` when
    ``splits`` is given (see :func:`alltoall_async`).

    ``split_axis`` / ``concat_axis`` take the JAX op's even form (the
    tiled ``lax.all_to_all``): ``tensor`` splits along ``split_axis``
    into one block a member, block ``i`` goes to member ``i``, and the
    blocks received concatenate along ``concat_axis`` in member order.
    That form is differentiable (its backward is the exchange with the
    two axes swapped) and, as the JAX op inside a step, takes no join
    slot; a set of one member returns ``tensor`` itself."""
    if split_axis is None and concat_axis is None:
        return alltoall_async(tensor, splits, name, process_set).wait()
    if splits is not None:
        raise ValueError("alltoall: splits and split_axis / concat_axis "
                         "exclude each other")
    ps = get_process_set(process_set)
    return _AllToAll.apply(tensor, ps, 0 if split_axis is None
                           else split_axis,
                           0 if concat_axis is None else concat_axis)


def _alltoall_axes(x: torch.Tensor, ps: ProcessSet, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
    """The even all_to_all of ``x`` over ``ps`` in the axis form."""
    m = ps.size()
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % m:
        raise ValueError(
            f"alltoall over a {m}-member process set needs dim "
            f"{split_axis} divisible by {m}, got {x.shape[split_axis]}")
    _member_set(ps, "alltoall", x)
    if m == 1:
        return x
    chunk = x.shape[split_axis] // m
    send = x.movedim(split_axis, 0).reshape((m, chunk) + tuple(
        x.movedim(split_axis, 0).shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ps.group)
    pieces = [recv[i].movedim(0, split_axis) for i in range(m)]
    return torch.cat(pieces, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """:func:`alltoall`'s axis form; the backward swaps the axes."""

    @staticmethod
    def forward(ctx, x, ps, split_axis, concat_axis):
        ctx.ps, ctx.axes = ps, (split_axis, concat_axis)
        return _alltoall_axes(x, ps, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_alltoall_axes(g.contiguous(), ctx.ps, concat_axis,
                               split_axis), None, None, None)


def step_allgather(x: torch.Tensor, *, dim: int = 0,
                   process_set=None) -> torch.Tensor:
    """Every member's ``x`` (equal shapes) concatenated along ``dim`` in
    member order: the JAX ``allgather(..., axis=dim, tiled=True)`` inside
    a step (no join slot, not differentiable)."""
    ps = _member_set(process_set, "allgather", x)
    if ps.size() == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((ps.size() * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=ps.group)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# ppermute
# ---------------------------------------------------------------------------


def _ppermute(x: torch.Tensor, perm, ps: ProcessSet) -> torch.Tensor:
    me = ps.position()
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ps.ranks[dst],
                                  group=ps.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ps.ranks[src],
                                  group=ps.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, perm, ps):
        ctx.perm, ctx.ps = perm, ps
        return _ppermute(x, perm, ps)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(g, inverse, ctx.ps), None, None


def ppermute(x: torch.Tensor, perm, *, process_set=None) -> torch.Tensor:
    """Point-to-point permutation over a set (``lax.ppermute``): ``perm``
    holds ``(source, destination)`` pairs of set positions, each position
    at most once as a source and once as a destination; a member that is
    no destination receives zeros.  The sends and receives go out
    together (``batch_isend_irecv``).  Differentiable: the backward sends
    the gradient along the inverse permutation, so a pipeline or a ring
    gets its backward from autograd.  Every member must run the same
    ppermutes, forward and backward, in the same order."""
    ps = _member_set(process_set, "ppermute", x)
    perm = tuple((int(s), int(d)) for s, d in perm)
    n = ps.size()
    for pos in (0, 1):
        col = [p[pos] for p in perm]
        if len(set(col)) != len(col) or any(not 0 <= c < n for c in col):
            raise ValueError(f"ppermute: bad permutation {perm} over a "
                             f"{n}-member set")
    return _PPermute.apply(x, perm, ps)


# ---------------------------------------------------------------------------
# sparse allreduce
# ---------------------------------------------------------------------------


def sparse_allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                           op: ReduceOp = Average,
                           process_set=None) -> Handle:
    """Allreduce a ``torch.sparse_coo`` tensor without densifying it
    (``horovod/torch/mpi_ops.py::sparse_allreduce_async``): one ragged
    allgather of this rank's ``[indices ‖ values]`` rows, float64 on the
    tensor's device (NCCL carries no sparse tensors; float64 holds int32
    indices and float32 values exactly), then a ``coalesce()`` that sums
    duplicate coordinates.  ``Average`` divides that sum by the set's
    size and the cast back to the input's dtype comes last.  The handle
    returns the coalesced sparse result."""
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce_async expects a sparse tensor; "
                         "use allreduce for dense tensors")
    if op not in (Average, Sum):
        raise ValueError("sparse allreduce supports Average/Sum only")
    t = tensor.detach().coalesce()
    sd, tail = t.sparse_dim(), tuple(t.values().shape[1:])
    width = math.prod(tail)
    rows = torch.cat([t.indices().t().to(torch.float64),
                      t.values().reshape(t._nnz(), width).to(torch.float64)],
                     dim=1)
    ps = _member_set(process_set, "sparse_allreduce", rows)
    work, out, lens = _allgatherv(rows, ps)

    def finish():
        g = torch.cat([o[:n] for o, n in zip(out, lens)], dim=0)
        summed = torch.sparse_coo_tensor(
            g[:, :sd].t().long(), g[:, sd:].reshape((len(g),) + tail),
            tensor.shape).coalesce()
        values = summed.values()
        if op is Average:
            values = values / ps.size()
        return torch.sparse_coo_tensor(summed.indices(),
                                       values.to(tensor.dtype),
                                       tensor.shape).coalesce()

    return Handle(work, finish, name=name)


_SEED_MATRICES: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _powersgd_seed_matrix(cols: int, rank: int,
                          device: Union[str, torch.device] = "cpu"
                          ) -> torch.Tensor:
    """The deterministic right-factor init ``Q0`` (``[cols, rank]`` f32)
    that every rank starts its power iteration from:
    ``cos(i * (j + 1) * 0.9182736 + (j + 1) * 0.3717)``.

    The argument is built as the JAX package builds it -- f32, the same
    operation order -- on the CPU; its cosine is taken in float64 and
    rounded once to f32, so each entry is within half an f32 ulp of the
    exact cosine of that argument (an f32 ``cos`` is only within about
    one ulp, and two such within-one-ulp results can differ by two).
    Then moved to ``device`` and cached per ``(cols, rank, device)``.
    Not on the card: at ``cols = 3880`` the argument reaches ~14,000
    rad, where one rounding of a faster ``cos`` moves the result by
    ~1e-3."""
    key = (int(cols), int(rank), str(torch.device(device)))
    q0 = _SEED_MATRICES.get(key)
    if q0 is None:
        i = torch.arange(cols, dtype=torch.float32)[:, None]
        j = torch.arange(rank, dtype=torch.float32)[None, :]
        arg = i * (j + 1.0) * 0.9182736 + (j + 1.0) * 0.3717
        q0 = torch.cos(arg.double()).float()
        q0 = _SEED_MATRICES[key] = q0.to(device)
    return q0


def powersgd_allreduce_async(x: torch.Tensor, op: ReduceOp = Average, *,
                             rank: int,
                             residual: Optional[torch.Tensor] = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             force_reference: bool = False,
                             process_set=None) -> Handle:
    """Start a rank-``rank`` PowerSGD allreduce of ``x`` (Vogels et al.,
    2019): stage 1 (:func:`~horovod_tpu_torch.ops.fused_update.
    matricize_p`) and the async allreduce of the ``[m, r]`` left factor P.
    ``handle.wait()`` runs the rest -- ``/ n``, stage 2, the allreduce of
    the ``[c, r]`` right factor Q, ``/ n``, stage 3 -- and returns ``(out,
    new_residual)``: ``out`` in x's shape and dtype, ``new_residual`` flat
    f32, ``(x * prescale + residual) - P_orth Q_local^T``.

    Counterpart of ``horovod_tpu/collectives/ops.py::powersgd_allreduce``
    with the JAX package's operation order: the factor allreduces are
    ``SUM`` followed by a division by the world size (the set's size,
    over its group, with ``process_set=``).  ``residual`` of
    ``None`` means zeros (stateless use).  Floating inputs, Sum/Average.
    Wire bytes: ``4 * r * (m + c)`` against ``4 * m * c`` uncompressed.
    ``force_reference=True`` runs the three stages' plain versions on any
    device (the check of the kernels on the card).  Notes its
    ``powersgd`` row and the ``fused_update`` kernel's ``kernel`` row;
    the call is counted at the ``powersgd`` row's bytes.
    """
    from ..controller.fusion import plan_exchange
    if op not in (Sum, Average):
        raise ValueError(f"powersgd_allreduce supports Sum/Average, got {op}")
    if not x.dtype.is_floating_point:
        raise ValueError(
            f"powersgd wire needs a floating dtype, got {x.dtype}")
    leg = plan_exchange("powersgd", size=x.numel(), rank=rank).legs[0]
    ps = _member_set(process_set, "powersgd_allreduce", nbytes=leg.nbytes)
    _note_rows((leg, plan_exchange("kernel", kernel="fused_update",
                                   nbytes=4 * x.numel()).legs[0]))
    return _powersgd_start(x, op, rank, residual, prescale_factor,
                           postscale_factor, force_reference, ps)


def _powersgd_start(x, op, rank, residual, prescale_factor,
                    postscale_factor, force_reference, ps) -> Handle:
    """:func:`powersgd_allreduce_async` over ``ps`` (a registered set or
    one of the two-level layout's groups), checks done."""
    n = ps.size()
    size = x.numel()
    m, c = powersgd_matrix_shape(size)
    r = powersgd_effective_rank(size, rank)
    plain = dict(force_reference=force_reference)
    acc, p = fu.matricize_p(x, residual, _powersgd_seed_matrix(c, r,
                                                                x.device),
                            rows=m, prescale=prescale_factor, **plain)
    work = dist.all_reduce(p, op=dist.ReduceOp.SUM, group=ps.group,
                           async_op=True)

    def finish():
        p.div_(n)
        p_orth, q_local = fu.orthonormalize_q(acc, p, **plain)
        q = q_local.clone()
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=ps.group)
        q.div_(n)
        out, new_residual = fu.reconstruct_residual(
            acc, p_orth, q, q_local, size=size,
            n_scale=float(n) if op is Sum else 1.0,
            postscale=postscale_factor, **plain)
        return out.view(x.shape).to(x.dtype), new_residual

    return Handle(work, finish)


def powersgd_allreduce(x: torch.Tensor, op: ReduceOp = Average, *,
                       rank: int, residual: Optional[torch.Tensor] = None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       force_reference: bool = False, process_set=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, new_residual)`` of a rank-``rank`` PowerSGD allreduce (see
    :func:`powersgd_allreduce_async`)."""
    return powersgd_allreduce_async(
        x, op, rank=rank, residual=residual, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
        force_reference=force_reference, process_set=process_set).wait()


# ---------------------------------------------------------------------------
# fp8 and top-k exchanges
# ---------------------------------------------------------------------------


def _global_only(process_set, what: str) -> None:
    if process_set is not None and \
            not get_process_set(process_set).is_global():
        raise NotImplementedError(
            f"{what} does not support process sets; use fp16/bf16 "
            f"compression for subset reductions")


def _fp8_start(x: torch.Tensor, op: ReduceOp, prescale_factor: float,
               postscale_factor: float, ps) -> Handle:
    """:func:`fp8_allreduce_async` over ``ps``, checks done."""
    n, pos = ps.size(), ps.position()
    shape, dtype = x.shape, x.dtype
    x32 = x.float()
    if prescale_factor != 1.0:
        x32 = x32 * prescale_factor
    flat = x32.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scales = fp8_quantize(flat.view(n, -1), axis=0)  # row j -> rank j
    send = q.view(torch.uint8)
    recv = torch.empty_like(send)
    # S[src, dst]: the scale each sender used for the row now in
    # recv[src] is column ``pos``.
    smat = scales.new_empty(n * n)
    dist.all_gather_into_tensor(smat, scales, group=ps.group)
    work = dist.all_to_all_single(recv, send, group=ps.group, async_op=True)

    def finish():
        mine = smat.view(n, n)[:, pos]
        acc = (recv.view(torch.float8_e4m3fn).float()
               * mine[:, None]).sum(0)
        if op is Average:
            acc = acc / n
        if postscale_factor != 1.0:
            acc = acc * postscale_factor
        qr, s2 = fp8_quantize(acc)
        gathered = torch.empty(n * acc.numel(), dtype=torch.uint8,
                               device=acc.device)
        dist.all_gather_into_tensor(gathered, qr.view(torch.uint8),
                                    group=ps.group)
        s2_all = s2.new_empty(n)
        dist.all_gather_into_tensor(s2_all, s2.reshape(1), group=ps.group)
        out = (gathered.view(torch.float8_e4m3fn).float().view(n, -1)
               * s2_all[:, None]).reshape(-1)
        if pad:
            out = out[:-pad]
        return out.view(shape).to(dtype)

    return Handle(work, finish)


def fp8_allreduce_async(x: torch.Tensor, op: ReduceOp = Average, *,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set=None) -> Handle:
    """Start an allreduce of ``x`` with an e4m3 wire and f32
    accumulation (``horovod_tpu/collectives/ops.py::fp8_allreduce``):

    1. pad the flat f32 bucket to a multiple of ``n`` and quantize row
       ``j`` (the shard rank ``j`` reduces) with its own max-abs scale;
    2. ``all_to_all`` the e4m3 rows (as ``uint8``), the ``[n, n]`` scale
       matrix on an ``all_gather``;
    3. dequantize and reduce this rank's shard in f32 (``/ n`` for
       Average, then the postscale);
    4. re-quantize it, ``all_gather`` the e4m3 shards and their scales,
       dequantize every shard -- this rank's own included -- from the
       wire bytes.

    ``handle.wait()`` returns the result in x's shape and dtype.  Two
    e4m3 roundings end to end; the reduction is exact f32.  Floating
    inputs, Sum/Average, the global set only (as the reference).  Notes
    its ``fp8`` row and is counted at its bytes."""
    from ..controller.fusion import plan_exchange
    _global_only(process_set, "fp8_allreduce")
    if op not in (Sum, Average):
        raise ValueError(f"fp8_allreduce supports Sum/Average, got {op}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"fp8 wire needs a floating dtype, got {x.dtype}")
    leg = plan_exchange("fp8", size=x.numel(),
                        world=get_process_set(None).size()).legs[0]
    ps = _member_set(None, "fp8_allreduce", nbytes=leg.nbytes)
    _note_rows((leg,))
    return _fp8_start(x, op, prescale_factor, postscale_factor, ps)


def fp8_allreduce(x: torch.Tensor, op: ReduceOp = Average, *,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  process_set=None) -> torch.Tensor:
    """The result of :func:`fp8_allreduce_async`."""
    return fp8_allreduce_async(
        x, op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set).wait()


def _topk_select(acc: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``|acc|``, largest first and the
    lower index first among equals -- ``lax.top_k``'s choice, which
    ``torch.topk`` does not make on ties: a stable descending sort."""
    return torch.sort(acc.abs(), descending=True, stable=True).indices[:k]


def _topk_start(x: torch.Tensor, op: ReduceOp, fraction: float,
                residual: Optional[torch.Tensor], prescale_factor: float,
                postscale_factor: float, ps) -> Handle:
    """:func:`topk_allreduce_async` over ``ps``, checks done."""
    n = ps.size()
    shape, dtype = x.shape, x.dtype
    acc = x.float().reshape(-1)
    if prescale_factor != 1.0:
        acc = acc * prescale_factor
    if residual is not None:
        acc = acc + residual.float().reshape(-1)
    size = acc.numel()
    k = min(topk_count(size, fraction), size)
    idx = _topk_select(acc, k)
    vals = acc[idx]
    gv = vals.new_empty(n * k)
    gi = torch.empty(n * k, dtype=torch.int32, device=acc.device)
    w_vals = dist.all_gather_into_tensor(gv, vals, group=ps.group,
                                         async_op=True)
    work = dist.all_gather_into_tensor(gi, idx.to(torch.int32),
                                       group=ps.group, async_op=True)

    def finish():
        w_vals.wait()
        dense = acc.new_zeros(size).index_add_(0, gi.long(), gv)
        if op is Average:
            dense = dense / n
        if postscale_factor != 1.0:
            dense = dense * postscale_factor
        own = acc.new_zeros(size).index_put_((idx,), vals)
        return dense.view(shape).to(dtype), acc - own

    return Handle(work, finish)


def topk_allreduce_async(x: torch.Tensor, op: ReduceOp = Average, *,
                         fraction: float,
                         residual: Optional[torch.Tensor] = None,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         process_set=None) -> Handle:
    """Start a top-``fraction`` sparsified allreduce (DGC-style, Lin et
    al., 2018; ``horovod_tpu/collectives/ops.py::topk_allreduce``): each
    rank adds ``residual`` to its f32 ``x * prescale`` (``acc``), keeps
    the ``k = ceil(fraction * size)`` largest magnitudes (ties to the
    lower index, see :func:`_topk_select`) and allgathers its ``(value
    f32, index int32)`` pairs; every rank scatter-adds all ``n * k``
    pairs into a dense f32 bucket (duplicate indices across ranks add
    up).  ``handle.wait()`` returns ``(out, new_residual)``: ``out`` in
    x's shape and dtype, ``new_residual = acc - own`` flat f32, ``own``
    this rank's sent pairs densified -- the elements it did not send.
    Floating inputs, Sum/Average, the global set only.  Notes its
    ``topk`` row and is counted at its bytes."""
    from ..controller.fusion import plan_exchange
    _global_only(process_set, "topk_allreduce")
    if op not in (Sum, Average):
        raise ValueError(f"topk_allreduce supports Sum/Average, got {op}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"topk wire needs a floating dtype, got {x.dtype}")
    leg = plan_exchange("topk", size=x.numel(), fraction=fraction).legs[0]
    ps = _member_set(None, "topk_allreduce", nbytes=leg.nbytes)
    _note_rows((leg,))
    return _topk_start(x, op, fraction, residual, prescale_factor,
                       postscale_factor, ps)


def topk_allreduce(x: torch.Tensor, op: ReduceOp = Average, *,
                   fraction: float, residual: Optional[torch.Tensor] = None,
                   prescale_factor: float = 1.0,
                   postscale_factor: float = 1.0, process_set=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, new_residual)`` of :func:`topk_allreduce_async`."""
    return topk_allreduce_async(
        x, op, fraction=fraction, residual=residual,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set).wait()


# ---------------------------------------------------------------------------
# The two-level and chunked allreduce, and the ZeRO building blocks
# ---------------------------------------------------------------------------


def microbatch_pad_quantum(n: int, base: int = 256) -> int:
    """``lcm(n, base)``: the two-level exchange pads each bucket to a
    multiple of it, so its per-leg payload is the same for every ``n``
    dividing 256 (the JAX package's quantum)."""
    return base * n // math.gcd(base, n)


def hierarchical_allreduce(x: torch.Tensor, op: ReduceOp = Average, *,
                           dcn_codec=None, ici_codec=None,
                           dcn_residual: Optional[torch.Tensor] = None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           topology: Optional[Tuple[int, int]] = None,
                           process_set=None):
    """Two-level allreduce (``HOROVOD_HIERARCHICAL_ALLREDUCE``,
    ``horovod_tpu/collectives/ops.py::hierarchical_allreduce``) over
    ``n_dcn`` nodes of ``n_ici`` ranks: the world laid out by
    ``topology`` (default
    :func:`~horovod_tpu_torch.core.topology.hier_mesh_shape`), or -- with
    ``process_set``, the data set of a mesh whose data axes are the
    ``(dcn, inner)`` pair (``mesh.group(data_axes(mesh))``) -- that set
    over its own ICI and DCN lines (``process_set.hier``), as the JAX op
    runs over its ``(dcn_axis, ici_axis)`` pair:

    1. reduce-scatter (Sum) within the node of the flat bucket,
       zero-padded to a multiple of :func:`microbatch_pad_quantum`;
    2. the cross-node exchange of this rank's ``padded / n_ici`` shard
       only, under ``dcn_codec``: a (cast) allreduce; fp8 (an allgather
       of e4m3 shards and their scales, summed in f32); or an
       error-feedback codec (powersgd/topk over the DCN group, fed
       ``dcn_residual``);
    3. ``/ n`` for Average, then an allgather within the node.

    ``ici_codec`` (none/fp16/bf16) sets the wire dtype of both
    intra-node legs.  With an error-feedback ``dcn_codec`` the return is
    ``(out, new_dcn_residual)``, the residual flat f32 of the shard's
    length.  With one node the op is the flat :func:`allreduce`,
    statically, as in the reference.  Sum/Average; non-floating buckets
    ride uncompressed.  Over more than one node it notes its
    ``hier`` rows and is counted at their bytes."""
    from ..core.topology import HierPair, hier_mesh_shape
    if op not in (Sum, Average):
        raise ValueError(
            f"hierarchical_allreduce supports Sum/Average, got {op}")
    ici_codec = parse_compression(ici_codec)
    dcn_codec = parse_compression(dcn_codec)
    if getattr(ici_codec, "wire_format", ""):
        raise ValueError(
            f"ICI leg codec must be psum-compatible (none|fp16|bf16), "
            f"got {ici_codec.__name__}")
    if process_set is not None:
        pair = getattr(process_set, "hier", None)
        if pair is None:
            raise ValueError(
                f"hierarchical_allreduce over process set "
                f"{process_set.name!r}: only a mesh's two data axes "
                f"(mesh.group(data_axes(mesh))) carry a two-level layout")
        if topology is not None and tuple(topology) != pair.shape:
            raise ValueError(f"topology {tuple(topology)} conflicts with "
                             f"the set's {pair.shape}")
    else:
        if topology is None:
            topology = hier_mesh_shape()
        if topology is None:
            raise ValueError("hierarchical_allreduce needs a two-level "
                             "layout: set HOROVOD_HIERARCHICAL or pass "
                             "topology=")
        pair = HierPair(*(int(t) for t in topology))
    n_dcn, n_ici = pair.shape
    legs = ()
    if n_dcn > 1:
        from ..controller.fusion import plan_hier_legs
        legs = plan_hier_legs(x.numel(), x.dtype, n_dcn=n_dcn, n_ici=n_ici,
                              ici_codec=ici_codec, dcn_codec=dcn_codec)
    # With one node the flat allreduce below counts itself.
    ps = _member_set(process_set, "hierarchical_allreduce",
                     nbytes=sum(leg.nbytes for leg in legs))
    if n_dcn * n_ici != ps.size():
        raise ValueError(f"topology {n_dcn}x{n_ici} does not cover the "
                         f"{ps.size()} ranks of set {ps.name!r}")
    n = ps.size()
    ef = is_error_feedback(dcn_codec)
    floating = x.dtype.is_floating_point
    if not floating:
        ici_codec = dcn_codec = Compression.none
    quantum = microbatch_pad_quantum(n_ici)
    size = x.numel()
    shard_len = (size + (-size) % quantum) // n_ici

    if n_dcn == 1:
        y = exchange_allreduce_async_(
            x.clone(), op, process_set=process_set,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor).wait()
        if ef:
            return y, (dcn_residual if dcn_residual is not None else
                       torch.zeros(shard_len, device=x.device))
        return y

    ici, dcn = pair.sets()
    _note_rows(legs)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    pad = (-size) % quantum
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    ici_wire, ici_ctx = ici_codec.compress(flat.contiguous())
    shard = ici_wire.new_empty(shard_len)
    dist.reduce_scatter_tensor(shard, ici_wire, op=dist.ReduceOp.SUM,
                               group=ici.group)
    shard = ici_codec.decompress(shard, ici_ctx)

    new_residual = None
    if ef and floating:
        if is_powersgd(dcn_codec):
            shard, new_residual = _powersgd_start(
                shard, Sum, dcn_codec.rank, dcn_residual, 1.0, 1.0, False,
                dcn).wait()
        else:
            shard, new_residual = _topk_start(
                shard, Sum, dcn_codec.fraction, dcn_residual, 1.0, 1.0,
                dcn).wait()
    elif is_fp8(dcn_codec):
        q, scale = fp8_quantize(shard)
        gq = torch.empty(n_dcn * shard_len, dtype=torch.uint8,
                         device=shard.device)
        dist.all_gather_into_tensor(gq, q.view(torch.uint8), group=dcn.group)
        gs = scale.new_empty(n_dcn)
        dist.all_gather_into_tensor(gs, scale.reshape(1), group=dcn.group)
        shard = (gq.view(torch.float8_e4m3fn).float().view(n_dcn, -1)
                 * gs[:, None]).sum(0).to(dtype)
    else:
        dcn_wire, dcn_ctx = dcn_codec.compress(shard)
        dist.all_reduce(dcn_wire, op=dist.ReduceOp.SUM, group=dcn.group)
        shard = dcn_codec.decompress(dcn_wire, dcn_ctx)
    if op is Average:
        _divide_in_dtype(shard, n)
    ag_wire, ag_ctx = ici_codec.compress(shard)
    y = ag_wire.new_empty(n_ici * shard_len)
    dist.all_gather_into_tensor(y, ag_wire.contiguous(), group=ici.group)
    y = ici_codec.decompress(y, ag_ctx)
    if pad:
        y = y[:-pad]
    y = y.reshape(shape)
    if postscale_factor != 1.0:
        y = y * postscale_factor
    if ef:
        if new_residual is None:  # a non-floating bucket sent everything
            new_residual = dcn_residual if dcn_residual is not None else \
                torch.zeros(shard_len, device=x.device)
        return y, new_residual
    return y


def chunked_allreduce(x: torch.Tensor, op: ReduceOp = Average, *,
                      chunk_bytes: int, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      process_set=None) -> torch.Tensor:
    """Allreduce as chunk-sized reduce-scatter + allgather pairs
    (``HOROVOD_EXCHANGE_CHUNK_MB``; ``horovod_tpu/collectives/ops.py::
    chunked_allreduce``): the flat bucket is cut into chunks of
    ``chunk_bytes`` rounded up to a multiple of ``n`` elements, each
    zero-padded to a multiple of ``n``, reduce-scattered (Sum; ``/ n``
    in the dtype for Average) and allgathered.  The same link bytes as
    one allreduce, in independent pieces; the summation order differs
    from :func:`allreduce`'s.  Sum/Average over the global set, or over
    ``process_set`` (a mesh's data set: the JAX op over the data axes); at
    one member, or with ``chunk_bytes <= 0``, it is :func:`allreduce`, as
    in the reference.  The chunked sweep notes its ``chunked`` row."""
    from ..controller.fusion import plan_exchange
    if op not in (Sum, Average):
        raise ValueError(f"chunked_allreduce supports Sum/Average, got {op}")
    ps = _member_set(process_set, "chunked_allreduce", x)
    n = ps.size()
    if n == 1 or int(chunk_bytes) <= 0:
        return exchange_allreduce_async_(
            x.clone(), op, process_set=process_set,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor).wait()
    _note_rows(plan_exchange("chunked", size=x.numel(), dtype=x.dtype,
                             chunk_bytes=int(chunk_bytes), world=n).legs)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    shape = x.shape
    flat = x.reshape(-1)
    chunk_elems = max(1, int(chunk_bytes) // x.element_size())
    chunk_elems += (-chunk_elems) % n
    pieces = []
    for off in range(0, flat.numel(), chunk_elems):
        piece = flat[off:off + chunk_elems]
        pad = (-piece.numel()) % n
        piece = torch.cat([piece, piece.new_zeros(pad)]) if pad else \
            piece.contiguous()
        shard = piece.new_empty(piece.numel() // n)
        dist.reduce_scatter_tensor(shard, piece, op=dist.ReduceOp.SUM,
                                   group=ps.group)
        if op is Average:
            _divide_in_dtype(shard, n)
        full = torch.empty_like(piece)
        dist.all_gather_into_tensor(full, shard, group=ps.group)
        pieces.append(full[:-pad] if pad else full)
    y = (pieces[0] if len(pieces) == 1 else torch.cat(pieces)).view(shape)
    if postscale_factor != 1.0:
        y = y * postscale_factor
    return y


def psum_scatter_bucket_async(flat: torch.Tensor, *, quantum: int,
                              process_set=None) -> Handle:
    """Start :func:`psum_scatter_bucket`; ``handle.wait()`` returns the
    shard.  On NCCL the reduce-scatter runs on the process group's own
    stream, so work enqueued before the wait overlaps it."""
    ps = _member_set(process_set, "reducescatter", flat)
    pad = (-flat.numel()) % quantum
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.contiguous()
    shard = flat.new_empty(flat.numel() // ps.size())
    work = dist.reduce_scatter_tensor(shard, flat, op=dist.ReduceOp.SUM,
                                      group=ps.group, async_op=True)
    return Handle(work, lambda: shard)


def psum_scatter_bucket(flat: torch.Tensor, *, quantum: int,
                        process_set=None) -> torch.Tensor:
    """Zero-pad ``flat`` to a multiple of ``quantum`` and reduce-scatter
    it (Sum) over the set; returns this member's ``padded / n`` shard
    (``horovod_tpu/collectives/ops.py::psum_scatter_bucket``)."""
    return psum_scatter_bucket_async(flat, quantum=quantum,
                                     process_set=process_set).wait()


def allgather_bucket(shard: torch.Tensor, size: int, *,
                     process_set=None) -> torch.Tensor:
    """Allgather :func:`psum_scatter_bucket` shards back into the whole
    bucket and strip the padding down to ``size`` elements."""
    ps = _member_set(process_set, "allgather", shard)
    full = shard.new_empty(ps.size() * shard.numel())
    dist.all_gather_into_tensor(full, shard.contiguous(), group=ps.group)
    return full[:size] if full.numel() != size else full


def desync_check(x: torch.Tensor, process_set=None) -> torch.Tensor:
    """In-step desync probe: a 0-dim bool tensor, True when ``x`` is NOT
    bit-identical on every member of the set.  The position-weighted
    uint32 bit sum of ``x`` (``core.desync._traced_bit_checksum``) goes
    through a MAX and a MIN allreduce (the JAX op's pmax / pmin): two
    8-byte collectives, no data moved."""
    from ..core.desync import _traced_bit_checksum
    c = _traced_bit_checksum(x)
    hi = allreduce(c, op=Max, process_set=process_set)
    lo = allreduce(c, op=Min, process_set=process_set)
    return hi != lo


def barrier(process_set=None) -> None:
    """Block until every member of the set has reached this point."""
    ps = _member_set(process_set, "barrier")
    with eager.join_op(ps) as slot:
        slot.publish({"kind": "barrier"})
    with stall.watched("barrier"):
        from ..elastic import chaos
        chaos.raise_if_armed()      # an injected at=sync comm fault
        dist.barrier(group=ps.group)


__all__ = ["Handle", "allreduce", "allreduce_", "allreduce_async",
           "allreduce_async_", "grouped_allreduce", "grouped_allreduce_",
           "grouped_allreduce_async", "grouped_allreduce_async_",
           "allgather", "allgather_async", "grouped_allgather",
           "grouped_allgather_async", "broadcast", "broadcast_",
           "broadcast_async", "broadcast_async_", "reducescatter",
           "reducescatter_async", "grouped_reducescatter",
           "grouped_reducescatter_async", "alltoall", "alltoall_async",
           "sparse_allreduce_async", "barrier", "desync_check",
           "powersgd_allreduce", "powersgd_allreduce_async",
           "fp8_allreduce", "fp8_allreduce_async", "topk_allreduce",
           "topk_allreduce_async", "hierarchical_allreduce",
           "chunked_allreduce", "microbatch_pad_quantum",
           "psum_scatter_bucket", "psum_scatter_bucket_async",
           "allgather_bucket", "ppermute", "step_allgather"]
