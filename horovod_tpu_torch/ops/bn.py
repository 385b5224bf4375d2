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
  (``dx = scale * inv * (dy - dbeta / n - xhat * dgamma / n)``), with
  ``inv = rsqrt(var + eps)`` computed once by the wrapper for both.
  ``x``/``dy`` keep their dtype (bf16 on the ResNet path), ``dx`` comes
  back in x's dtype and ``dgamma``/``dbeta`` in f32.
* :func:`bn_train` -- the normalize with batch statistics under autograd:
  its forward is plain PyTorch in f32, cast back to x's dtype (the JAX
  package leaves it to XLA), its backward :func:`fused_bn_backward`.
* :class:`BatchNorm` -- the flax-compatible module: parameters ``scale``
  and ``bias`` (f32), buffers ``mean`` and ``var`` (flax's
  ``batch_stats``), flax's running-stat update.

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

from typing import Optional, Tuple

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


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``(mean, var)`` over every axis but the last; the variance is
    the fast ``E[x^2] - E[x]^2``, clamped at 0 (flax's default)."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = torch.clamp_min(xf.square().mean(dims) - mean.square(), 0.0)
    return mean, var


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
    return (x2.float() - mean.float()) * inv


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
        dyf = dy.reshape(n, c).float()
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
                   force_reference: bool = False) -> torch.Tensor:
    """Pass 2: ``dx = scale * inv * (dy - dbeta / n - xhat * dgamma / n)``
    in x's dtype and shape; every per-channel row is f32 ``(C,)``."""
    n, c = _rows("bn_backward_dx", x, dy)
    if force_reference or x.device.type == "cpu":
        dyf = dy.reshape(n, c).float()
        xhat = _xhat(x.reshape(n, c), mean, inv)
        dx = (scale.float() * inv
              * (dyf - dbeta / n - xhat * dgamma / n)).to(x.dtype)
        return dx.reshape(x.shape)
    _check_device("bn_backward_dx", x)
    n, c, chunks, vec = _cuda_args("bn_backward_dx", x, dy,
                                   (mean, inv, scale, dbeta, dgamma))
    dx = torch.empty_like(x)
    err = entry("bn_bwd_dx")(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        scale.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(), dx.data_ptr(),
        n, c, chunks, vec, _DTYPES[x.dtype], stream(x))
    check_launch("bn_bwd_dx", err)
    registry.note_launch("bn_bwd_dx")
    return dx


def fused_bn_backward(x: torch.Tensor, scale: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor,
                      dy: torch.Tensor, *, eps: float,
                      force_reference: bool = False):
    """``(dx, dgamma, dbeta)`` for train-mode BN over the last axis, from
    the forward's f32 batch ``mean`` and ``var``: the two passes, sharing
    ``inv = rsqrt(var + eps)``.  ``dx`` has x's dtype; ``dgamma`` and
    ``dbeta`` are f32."""
    inv = torch.rsqrt(var.float() + eps)
    mean = mean.float()
    kw = dict(force_reference=force_reference)
    dbeta, dgamma = bn_backward_reduce(x, dy, mean, inv, **kw)
    dx = bn_backward_dx(x, dy, mean, inv, scale.float(), dbeta, dgamma,
                        **kw)
    return dx, dgamma, dbeta


# ---------------------------------------------------------------------------
# Train-mode normalize with the fused backward
# ---------------------------------------------------------------------------


def _normalize(x, mean, inv, scale, bias, dtype):
    """``(x - mean) * inv * scale + bias`` in f32 (in place on the one
    full-size temporary), cast to ``dtype``."""
    y = x.float() - mean
    return y.mul_(inv).mul_(scale.float()).add_(bias.float()).to(dtype)


class _BNTrain(torch.autograd.Function):
    """Forward: batch statistics and the normalize, plain PyTorch in f32;
    also returns the f32 ``(mean, var)`` (non-differentiable) for the
    running-stat update.  Backward: :func:`fused_bn_backward`."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, force_reference):
        xf = x.float()               # one f32 copy for both uses
        mean, var = batch_stats(xf)
        y = _normalize(xf, mean, torch.rsqrt(var + eps), scale, bias,
                       x.dtype)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps, ctx.force_reference = eps, force_reference
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, var = ctx.saved_tensors
        # No .contiguous(): on the GPU the kernels refuse a strided dy
        # rather than copy it (every ResNet site's dy arrives contiguous).
        dx, dgamma, dbeta = fused_bn_backward(
            x, scale, mean, var, dy, eps=ctx.eps,
            force_reference=ctx.force_reference)
        return (dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype), None,
                None)


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, *, force_reference: bool = False) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with the batch
    statistics of ``x`` over every axis but the last, in x's dtype.
    Differentiable in ``x``, ``scale`` and ``bias``: the backward runs
    the two kernels on CUDA tensors (the plain version on CPU tensors or
    with ``force_reference``)."""
    return _BNTrain.apply(x, scale, bias, float(eps),
                          bool(force_reference))[0]


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
    when ``None``).
    """

    def __init__(self, features: int, *, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 scale_init: float = 1.0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
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
            return _normalize(x, self.mean, inv, self.scale, self.bias,
                              dtype)
        y, mean, var = _BNTrain.apply(x, self.scale, self.bias,
                                      float(self.epsilon),
                                      bool(force_reference))
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return y.to(dtype)


__all__ = ["batch_stats", "bn_backward_reduce", "bn_backward_dx",
           "fused_bn_backward", "bn_train", "BatchNorm", "reduce_chunks"]
