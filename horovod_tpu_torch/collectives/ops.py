"""Collective operations over ``torch.distributed``.

Counterpart of ``horovod_tpu/collectives/ops.py``'s eager surface:
:func:`allreduce` with ``prescale_factor`` / ``postscale_factor``,
:func:`grouped_allreduce`, :func:`allgather`, :func:`broadcast` and
:func:`barrier`, and the PowerSGD exchange :func:`powersgd_allreduce`.
Each synchronous op has an ``*_async`` twin that returns a
:class:`Handle` around the ``torch.distributed`` work object; the result
is ready after ``handle.wait()``.

Arithmetic follows the JAX ops: ``Average`` is a sum followed by a
division in the tensor's own dtype (truncating for integers), with the
prescale applied before the reduction and the postscale after.  The
inputs are never modified, except by the in-place ``allreduce_async_``
that the DistributedOptimizer uses on its own fusion buffers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.basics import _require_init
from ..core.exceptions import HorovodInternalError
from ..ops import fused_update as fu
from .compression import powersgd_effective_rank, powersgd_matrix_shape
from .reduce_op import Average, Max, Min, Product, ReduceOp, Sum

_TORCH_OPS = {
    Sum: dist.ReduceOp.SUM,
    Average: dist.ReduceOp.SUM,
    Min: dist.ReduceOp.MIN,
    Max: dist.ReduceOp.MAX,
    Product: dist.ReduceOp.PRODUCT,
}


class Handle:
    """An in-flight collective: ``wait()`` blocks until it is done and
    returns its result.  A failure of the collective surfaces from
    ``wait()`` as :class:`HorovodInternalError`."""

    def __init__(self, work, finish: Callable[[], object]):
        self._work = work
        self._finish = finish
        self._done = False
        self._result = None

    def wait(self):
        if not self._done:
            if self._work is not None:
                try:
                    self._work.wait()
                except Exception as e:
                    raise HorovodInternalError(
                        f"collective failed: {e}") from e
            self._result = self._finish()
            self._done = True
        return self._result


def _divide_in_dtype(y: torch.Tensor, n: int) -> torch.Tensor:
    """Average's division in the tensor's own dtype (integer tensors
    truncate toward zero, as ``lax.div`` does)."""
    if y.dtype.is_floating_point:
        return y.div_(n)
    return y.copy_(torch.div(y, n, rounding_mode="trunc"))


def allreduce_async_(tensor: torch.Tensor, op: ReduceOp = Average, *,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> Handle:
    """Allreduce ``tensor`` IN PLACE; the handle returns ``tensor``."""
    if op not in _TORCH_OPS:
        raise NotImplementedError(f"reduce op {op} is not ported")
    n = _require_init().size
    if prescale_factor != 1.0:
        tensor.mul_(prescale_factor)
    work = dist.all_reduce(tensor, op=_TORCH_OPS[op], async_op=True)

    def finish():
        if op is Average:
            _divide_in_dtype(tensor, n)
        if postscale_factor != 1.0:
            tensor.mul_(postscale_factor)
        return tensor

    return Handle(work, finish)


def allreduce_async(tensor: torch.Tensor, op: ReduceOp = Average, *,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> Handle:
    """Allreduce a copy of ``tensor``; the input is left as it is."""
    return allreduce_async_(tensor.clone(), op,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor)


def allreduce(tensor: torch.Tensor, op: ReduceOp = Average, *,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce ``tensor`` across every rank (NCCLAllreduce analogue)."""
    return allreduce_async(tensor, op, prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor).wait()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            op: ReduceOp = Average, *,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> Handle:
    """Allreduce a list as one fused unit: packed into per-dtype buffers
    by the fusion planner, one collective per buffer, split back out."""
    from ..controller.fusion import pack, plan_buckets, unpack
    tensors = list(tensors)
    spec = plan_buckets(tensors)
    handles = [allreduce_async_(buf, op, prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)
               for buf in pack(tensors, spec)]
    return Handle(None, lambda: unpack([h.wait() for h in handles], spec))


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = Average, *,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    return grouped_allreduce_async(
        tensors, op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor).wait()


def allgather_async(tensor: torch.Tensor) -> Handle:
    """Concatenate every rank's tensor along dim 0; ranks may differ in
    dim 0 only (Horovod's allgather).  The first dims are exchanged
    first, so the handle is returned after that small exchange."""
    n = _require_init().size
    x = tensor.contiguous()
    if x.dim() == 0:
        x = x.reshape(1)
    dims = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    all_dims = [torch.empty_like(dims) for _ in range(n)]
    dist.all_gather(all_dims, dims)
    lens = [int(d.item()) for d in all_dims]
    width = max(lens)
    padded = x.new_zeros((width,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    out = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(out, padded, async_op=True)
    return Handle(work, lambda: torch.cat(
        [o[:m] for o, m in zip(out, lens)], dim=0))


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    return allgather_async(tensor).wait()


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0) -> Handle:
    """Every rank's ``tensor`` receives root's value, in place."""
    n = _require_init().size
    if not 0 <= root_rank < n:
        raise ValueError(f"broadcast root_rank {root_rank} not in "
                         f"[0, {n})")
    work = dist.broadcast(tensor, src=root_rank, async_op=True)
    return Handle(work, lambda: tensor)


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0) -> Handle:
    return broadcast_async_(tensor.clone(), root_rank)


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Root's value, on every rank (the input is left as it is)."""
    return broadcast_async(tensor, root_rank).wait()


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    return broadcast_async_(tensor, root_rank).wait()


_SEED_MATRICES: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _powersgd_seed_matrix(cols: int, rank: int,
                          device: Union[str, torch.device] = "cpu"
                          ) -> torch.Tensor:
    """The deterministic right-factor init ``Q0`` (``[cols, rank]`` f32)
    that every rank starts its power iteration from:
    ``cos(i * (j + 1) * 0.9182736 + (j + 1) * 0.3717)``.

    Computed as the JAX package computes it -- f32, the same operation
    order -- on the CPU, then moved to ``device`` and cached per
    ``(cols, rank, device)``.  Not on the card: at ``cols = 3880`` the
    argument reaches ~14,000 rad, where one rounding of a faster ``cos``
    moves the result by ~1e-3."""
    key = (int(cols), int(rank), str(torch.device(device)))
    q0 = _SEED_MATRICES.get(key)
    if q0 is None:
        i = torch.arange(cols, dtype=torch.float32)[:, None]
        j = torch.arange(rank, dtype=torch.float32)[None, :]
        q0 = torch.cos(i * (j + 1.0) * 0.9182736 + (j + 1.0) * 0.3717)
        q0 = _SEED_MATRICES[key] = q0.to(device)
    return q0


def powersgd_allreduce_async(x: torch.Tensor, op: ReduceOp = Average, *,
                             rank: int,
                             residual: Optional[torch.Tensor] = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             force_reference: bool = False) -> Handle:
    """Start a rank-``rank`` PowerSGD allreduce of ``x`` (Vogels et al.,
    2019): stage 1 (:func:`~horovod_tpu_torch.ops.fused_update.
    matricize_p`) and the async allreduce of the ``[m, r]`` left factor P.
    ``handle.wait()`` runs the rest -- ``/ n``, stage 2, the allreduce of
    the ``[c, r]`` right factor Q, ``/ n``, stage 3 -- and returns ``(out,
    new_residual)``: ``out`` in x's shape and dtype, ``new_residual`` flat
    f32, ``(x * prescale + residual) - P_orth Q_local^T``.

    Counterpart of ``horovod_tpu/collectives/ops.py::powersgd_allreduce``
    with the JAX package's operation order: the factor allreduces are
    ``SUM`` followed by a division by the world size.  ``residual`` of
    ``None`` means zeros (stateless use).  Floating inputs, Sum/Average.
    Wire bytes: ``4 * r * (m + c)`` against ``4 * m * c`` uncompressed.
    ``force_reference=True`` runs the three stages' plain versions on any
    device (the check of the kernels on the card).
    """
    if op not in (Sum, Average):
        raise ValueError(f"powersgd_allreduce supports Sum/Average, got {op}")
    if not x.dtype.is_floating_point:
        raise ValueError(
            f"powersgd wire needs a floating dtype, got {x.dtype}")
    n = _require_init().size
    size = x.numel()
    m, c = powersgd_matrix_shape(size)
    r = powersgd_effective_rank(size, rank)
    plain = dict(force_reference=force_reference)
    acc, p = fu.matricize_p(x, residual, _powersgd_seed_matrix(c, r,
                                                                x.device),
                            rows=m, prescale=prescale_factor, **plain)
    work = dist.all_reduce(p, op=dist.ReduceOp.SUM, async_op=True)

    def finish():
        p.div_(n)
        p_orth, q_local = fu.orthonormalize_q(acc, p, **plain)
        q = q_local.clone()
        dist.all_reduce(q, op=dist.ReduceOp.SUM)
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
                       force_reference: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, new_residual)`` of a rank-``rank`` PowerSGD allreduce (see
    :func:`powersgd_allreduce_async`)."""
    return powersgd_allreduce_async(
        x, op, rank=rank, residual=residual, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
        force_reference=force_reference).wait()


def barrier() -> None:
    """Block until every rank has reached this point."""
    _require_init()
    dist.barrier()


__all__ = ["Handle", "allreduce", "allreduce_async", "allreduce_async_",
           "grouped_allreduce", "grouped_allreduce_async", "allgather",
           "allgather_async", "broadcast", "broadcast_", "broadcast_async",
           "broadcast_async_", "barrier", "powersgd_allreduce",
           "powersgd_allreduce_async"]
