"""Train-mode BatchNorm for the port: hand-written CUDA backward + plain
PyTorch.

Counterpart of ``horovod_tpu/ops/bn.py``.  Every function normalizes over
the LAST axis, as flax does: ``x`` is channels-last (``[..., C]``) and
the statistics run over every other axis, i.e. over the rows of the
``[N, C]`` view that a contiguous NHWC activation already is.

* :func:`batch_stats` -- f32 mean and fast variance ``E[x^2] - E[x]^2``
  clamped at 0 (flax's default).
* :func:`fused_bn_backward` -- ``(dx, dgamma, dbeta)`` of the train-mode
  normalize, in two passes: :func:`bn_backward_reduce` (``dbeta =
  sum(dy)``, ``dgamma = sum(dy * xhat)``) and :func:`bn_backward_dx`
  (``dx = scale * inv * (dy - dbeta / count - xhat * dgamma / count)``,
  ``count`` the rows ``dbeta`` and ``dgamma`` sum over), with ``inv =
  rsqrt(var + eps)`` computed once by the wrapper for both.  ``x``/``dy``
  keep their dtype (bf16 on the ResNet path), ``dx`` comes back in x's
  dtype and ``dgamma``/``dbeta`` in f32.  Synchronized BatchNorm hands it
  an ``allreduce`` that sums pass 1's rows over the ranks, and the global
  ``count``: the one seam between the passes.
* :func:`bn_train` / :func:`bn_train_with_stats` -- the normalize with
  batch statistics under autograd: its forward is plain PyTorch in f32,
  cast back to x's dtype (the JAX package leaves it to XLA), its backward
  :func:`fused_bn_backward`.  Sync BN hands it an ``average`` for the
  local moments too.
* :class:`BatchNorm` -- the flax-compatible module: parameters ``scale``
  and ``bias`` (f32), buffers ``mean`` and ``var`` (flax's
  ``batch_stats``), flax's running-stat update.  ``sync=True`` is flax's
  ``BatchNorm(axis_name=...)`` over every rank: its train-mode normalize
  is :func:`horovod_tpu_torch.sync_batch_norm.sync_bn_train`, which holds
  the rank exchange (this module imports no collective).

Dispatch, as in :mod:`~horovod_tpu_torch.ops.attention`: a CPU tensor
takes the plain PyTorch version; a CUDA tensor launches the kernels of
``csrc/bn_bwd.cu`` (``bn_bwd_reduce``, replacing ``_bn_bwd_kernels``'
``_reduce_kernel``, and ``bn_bwd_dx``, replacing its ``_dx_kernel``), or
the wrapper raises -- there is no fallback.  ``force_reference=True`` is
the one explicit way to the plain version on the GPU.  The kernels need
a contiguous ``[..., C]`` tensor and never copy one: on the ResNet path
every BN site sees the contiguous NHWC output of a convolution.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from . import registry
from ._build import check_launch, entry, stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132                 # H100 SXM streaming multiprocessors
_CTAS_PER_SM = 8           # pass 1/2 CTAs aimed at per SM (two waves)
_TILE_CHANNELS = 256       # channels per CTA tile (bn_bwd.cu)
_MIN_ROWS_PER_CHUNK = 64


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least f32 (f64 stays f64), as flax promotes its BN
    arithmetic."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _moments(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E[x], E[x^2])`` over every axis but the last."""
    dims = tuple(range(xf.dim() - 1))
    return xf.mean(dims), xf.square().mean(dims)


def _fast_var(mean: torch.Tensor, meansq: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(meansq - mean.square(), 0.0)


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``(mean, var)`` over every axis but the last; the variance is
    the fast ``E[x^2] - E[x]^2``, clamped at 0 (flax's default)."""
    mean, meansq = _moments(_wide(x))
    return mean, _fast_var(mean, meansq)


# ---------------------------------------------------------------------------
# The two passes
# ---------------------------------------------------------------------------


def _rows(name: str, x: torch.Tensor, dy: torch.Tensor) -> Tuple[int, int]:
    """``(n, c)`` of the ``[n, c]`` view of ``x``; ``dy`` must match."""
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} != x "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    return x.numel() // c, c


def _xhat(x2, mean, inv):
    return (_wide(x2) - _wide(mean)) * inv


def reduce_chunks(n: int, c: int) -> int:
    """Row chunks of pass 1 and 2 for an ``[n, c]`` view: enough CTAs
    (channel tiles x chunks) to give every SM ``_CTAS_PER_SM``, but at
    least ``_MIN_ROWS_PER_CHUNK`` rows a chunk."""
    tiles = -(-c // _TILE_CHANNELS)
    want = max(1, _SMS * _CTAS_PER_SM // tiles)
    return max(1, min(want, -(-n // _MIN_ROWS_PER_CHUNK)))


def _cuda_args(name: str, x: torch.Tensor, dy: torch.Tensor,
               rows: Tuple[torch.Tensor, ...]):
    """Checks shared by both passes; returns ``(n, c, chunks, vec)``."""
    n, c = _rows(name, x, dy)
    for t in (x, dy):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: x and dy must share device and "
                             f"dtype, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: x and dy must be contiguous "
                             f"[..., C] tensors (the kernel never copies)")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    for t in rows:
        if (t.dtype != torch.float32 or t.device != x.device
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"{name}: per-channel rows must be contiguous "
                             f"f32 ({c},) on {x.device}")
    vec = int(c % 8 == 0 and x.data_ptr() % 16 == 0
              and dy.data_ptr() % 16 == 0)
    return n, c, reduce_chunks(n, c), vec


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def bn_backward_reduce(x: torch.Tensor, dy: torch.Tensor,
                       mean: torch.Tensor, inv: torch.Tensor, *,
                       force_reference: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: f32 ``(dbeta, dgamma)`` = ``(sum(dy), sum(dy * xhat))``
    over the rows of the ``[n, C]`` view, ``xhat = (x - mean) * inv``;
    ``mean`` and ``inv`` are f32 ``(C,)``."""
    n, c = _rows("bn_backward_reduce", x, dy)
    if force_reference or x.device.type == "cpu":
        dyf = _wide(dy.reshape(n, c))
        xhat = _xhat(x.reshape(n, c), mean, inv)
        return dyf.sum(0), (dyf * xhat).sum(0)
    _check_device("bn_backward_reduce", x)
    n, c, chunks, vec = _cuda_args("bn_backward_reduce", x, dy, (mean, inv))
    workspace = torch.empty((chunks, 2, c), dtype=torch.float32,
                            device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    dgamma = torch.empty_like(dbeta)
    err = entry("bn_bwd_reduce")(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        workspace.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(), n, c,
        chunks, vec, _DTYPES[x.dtype], stream(x))
    check_launch("bn_bwd_reduce", err)
    registry.note_launch("bn_bwd_reduce")
    return dbeta, dgamma


def bn_backward_dx(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                   inv: torch.Tensor, scale: torch.Tensor,
                   dbeta: torch.Tensor, dgamma: torch.Tensor, *,
                   count: Optional[float] = None,
                   force_reference: bool = False) -> torch.Tensor:
    """Pass 2: ``dx = scale * inv * (dy - dbeta / count - xhat * dgamma /
    count)`` in x's dtype and shape; every per-channel row is f32
    ``(C,)``.  ``count`` is the number of rows ``dbeta`` and ``dgamma``
    sum over: the ``n`` rows of x's ``[n, C]`` view (the default), or,
    when they are sums over every rank (sync BN), the global row count.
    It is handed to the kernel as an f32 scalar."""
    n, c = _rows("bn_backward_dx", x, dy)
    count = float(n if count is None else count)
    if not count > 0:
        raise ValueError(f"bn_backward_dx: count must be > 0, got {count}")
    if force_reference or x.device.type == "cpu":
        dyf = _wide(dy.reshape(n, c))
        xhat = _xhat(x.reshape(n, c), mean, inv)
        dx = (_wide(scale) * inv
              * (dyf - dbeta / count - xhat * dgamma / count)).to(x.dtype)
        return dx.reshape(x.shape)
    _check_device("bn_backward_dx", x)
    n, c, chunks, vec = _cuda_args("bn_backward_dx", x, dy,
                                   (mean, inv, scale, dbeta, dgamma))
    dx = torch.empty_like(x)
    err = entry("bn_bwd_dx")(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        scale.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(), dx.data_ptr(),
        n, c, chunks, vec, _DTYPES[x.dtype], count, stream(x))
    check_launch("bn_bwd_dx", err)
    registry.note_launch("bn_bwd_dx")
    return dx


Rows = Callable[[torch.Tensor], torch.Tensor]


def fused_bn_backward(x: torch.Tensor, scale: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor,
                      dy: torch.Tensor, *, eps: float,
                      count: Optional[float] = None,
                      allreduce: Optional[Rows] = None,
                      force_reference: bool = False):
    """``(dx, dgamma, dbeta)`` for train-mode BN over the last axis, from
    the forward's f32 batch ``mean`` and ``var``: the two passes, sharing
    ``inv = rsqrt(var + eps)``.  ``dx`` has x's dtype; ``dgamma`` and
    ``dbeta`` are f32.

    Sync BN (``mean`` and ``var`` are then the global statistics) passes
    ``allreduce``, a function that returns the f32 ``[2C]`` rows ``(dbeta,
    dgamma)`` summed over every rank, and ``count``, the global row count
    those sums cover: pass 1's sums go through ``allreduce`` between the
    passes and pass 2 divides them by ``count``.  The returned ``dgamma``
    and ``dbeta`` stay this rank's own sums."""
    inv = torch.rsqrt(_wide(var) + eps)
    mean = _wide(mean)
    kw = dict(force_reference=force_reference)
    dbeta, dgamma = bn_backward_reduce(x, dy, mean, inv, **kw)
    sum_beta, sum_gamma = dbeta, dgamma
    if allreduce is not None:
        c = dbeta.numel()
        sums = allreduce(torch.cat([dbeta, dgamma]))
        sum_beta, sum_gamma = sums[:c], sums[c:]
    dx = bn_backward_dx(x, dy, mean, inv, _wide(scale), sum_beta,
                        sum_gamma, count=count, **kw)
    return dx, dgamma, dbeta


# ---------------------------------------------------------------------------
# Train-mode normalize with the fused backward
# ---------------------------------------------------------------------------


def normalize(x, mean, inv, scale, bias, dtype, out=None):
    """``(x - mean) * inv * scale + bias`` in f32 (in place on the one
    full-size temporary), cast to ``dtype``; written into ``out`` (and
    ``out`` returned) when given -- an f32 ``out`` is the temporary."""
    if out is not None and out.dtype == torch.float32:
        y = torch.sub(_wide(x), mean, out=out)
    else:
        y = _wide(x) - mean
    y = y.mul_(inv).mul_(_wide(scale)).add_(_wide(bias))
    if out is None:
        return y.to(dtype)
    return y if y is out else out.copy_(y)


class _BNTrain(torch.autograd.Function):
    """Forward: batch statistics and the normalize, plain PyTorch in f32;
    also returns the f32 ``(mean, var)`` (non-differentiable) for the
    running-stat update.  Backward: :func:`fused_bn_backward`.  For sync
    BN, ``average`` averages the local ``(mean, mean of squares)`` over
    the ranks, ``allreduce`` sums pass 1's rows over them and the batch
    spans ``ranks`` equal shares (as under flax's ``pmean``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, force_reference, average,
                allreduce, ranks):
        xf = _wide(x)                # one f32 copy for both uses
        mean, meansq = _moments(xf)
        count = None
        if average is not None:
            c = mean.numel()
            moments = average(torch.cat([mean, meansq]))
            mean, meansq = moments[:c], moments[c:]
            count = (x.numel() // c) * ranks
        var = _fast_var(mean, meansq)
        y = normalize(xf, mean, torch.rsqrt(var + eps), scale, bias,
                      x.dtype)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps, ctx.force_reference = eps, force_reference
        ctx.count, ctx.allreduce = count, allreduce
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, var = ctx.saved_tensors
        # No .contiguous(): on the GPU the kernels refuse a strided dy
        # rather than copy it (every ResNet site's dy arrives contiguous).
        dx, dgamma, dbeta = fused_bn_backward(
            x, scale, mean, var, dy, eps=ctx.eps, count=ctx.count,
            allreduce=ctx.allreduce, force_reference=ctx.force_reference)
        return (dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype), None,
                None, None, None, None)


def bn_train_with_stats(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float, *,
                        force_reference: bool = False,
                        average: Optional[Rows] = None,
                        allreduce: Optional[Rows] = None, ranks: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bn_train`, and the f32 batch ``(mean, var)`` it normalized
    with (for the running statistics).  Sync BN passes ``average`` and
    ``allreduce`` (each maps f32 ``[2C]`` rows to their average, or sum,
    over the ``ranks`` ranks that each hold an equal batch)."""
    if (average is None) != (allreduce is None):
        raise ValueError("bn_train_with_stats: average and allreduce go "
                         "together")
    return _BNTrain.apply(x, scale, bias, float(eps), bool(force_reference),
                          average, allreduce, int(ranks))


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, *, force_reference: bool = False) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with the batch
    statistics of ``x`` over every axis but the last, in x's dtype.
    Differentiable in ``x``, ``scale`` and ``bias``: the backward runs
    the two kernels on CUDA tensors (the plain version on CPU tensors or
    with ``force_reference``)."""
    return bn_train_with_stats(x, scale, bias, eps,
                               force_reference=force_reference)[0]


class BatchNorm(nn.Module):
    """The subset of ``flax.linen.BatchNorm`` the models use (feature axis
    -1, scale and bias on), with the fused backward in train mode.

    Parameters ``scale`` (``scale_init``, 1 by default) and ``bias`` (0)
    are f32; buffers ``mean`` (0) and ``var`` (1) are flax's
    ``batch_stats``.  In train mode (``module.training``) it normalizes
    with the batch statistics and updates the running ones flax's way:
    ``ra = momentum * ra + (1 - momentum) * batch``, with the BIASED fast
    variance (``torch.nn.BatchNorm2d`` weights ``momentum`` the other way
    round and keeps the unbiased variance).  In eval mode it normalizes
    with the running statistics.  The output is in ``dtype`` (x's dtype
    when ``None``).  ``sync=True`` takes the batch statistics over every
    rank's batch (:func:`~horovod_tpu_torch.training.sync_batch_norm`),
    or with ``process_set`` over its members only; it needs
    ``hvd.init()``.
    """

    def __init__(self, features: int, *, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 scale_init: float = 1.0, sync: bool = False,
                 process_set=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.sync = bool(sync)
        self.process_set = process_set
        self.scale_init = float(scale_init)
        self.scale = nn.Parameter(torch.full((features,), self.scale_init,
                                             device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor,
                force_reference: bool = False) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        if not self.training:
            inv = torch.rsqrt(self.var + self.epsilon)
            return normalize(x, self.mean, inv, self.scale, self.bias,
                             dtype)
        if self.sync:
            # The rank exchange lives with the collectives, above this
            # module.
            from ..sync_batch_norm import sync_bn_train
            y, mean, var = sync_bn_train(x, self.scale, self.bias,
                                         self.epsilon,
                                         force_reference=force_reference,
                                         process_set=self.process_set)
        else:
            y, mean, var = bn_train_with_stats(
                x, self.scale, self.bias, self.epsilon,
                force_reference=force_reference)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return y.to(dtype)


__all__ = ["batch_stats", "bn_backward_reduce", "bn_backward_dx",
           "fused_bn_backward", "bn_train", "bn_train_with_stats",
           "normalize", "BatchNorm", "reduce_chunks"]
