"""Synchronized BatchNorm: the statistics of every rank's batch, on the BN
backward kernels.

* :func:`sync_bn_train` -- the train-mode normalize of flax's
  ``BatchNorm(axis_name=...)`` (``ops.bn.BatchNorm(sync=True)``, made by
  :func:`~horovod_tpu_torch.training.sync_batch_norm`): the local f32
  ``(mean, mean of squares)`` go through one ``Average`` allreduce of
  ``2C`` values, then flax's fast variance, the normalize and the
  running-stat update use the global statistics; the backward sums pass
  1's ``(dbeta, dgamma)`` over the ranks (one ``Sum`` allreduce of ``2C``
  values) and runs pass 2 with the sums and the global row count, this
  rank's rows times the world size -- the gradient of the global batch,
  as autodiff through flax's ``pmean`` gives it.
* :class:`SyncBatchNorm` -- ``hvd.SyncBatchNorm``, below, over every rank
  or over the members of a process set (``process_set=``).

Both layers' parameters get the LOCAL sums, which the
DistributedOptimizer averages like every other gradient.  Their
allreduces run at every world size, world 1 included, and feed
:func:`~horovod_tpu_torch.timeline.metrics.sync_bn_counters`: two a site
per training step.

``SyncBatchNorm`` is the counterpart of
``horovod_tpu/torch_api/sync_batch_norm.py`` (Horovod's
``horovod/torch/sync_batch_norm.py``).  It keeps torch's conventions:
channels at dim 1, torch's ``momentum`` (``None`` for a cumulative
average), the UNBIASED running variance (with the global count), and
``weight`` / ``bias``.

In training mode, over the process set's group (every rank by default;
its ``count`` is the set's global row count):

* forward -- one ``Sum`` allreduce of the local f32 ``(sum, sum of
  squares, count)`` (``2C + 1`` values) gives the global mean and biased
  variance, which normalize this rank's batch and update the running
  statistics;
* backward -- the BN backward kernels' two passes with the allreduce
  between them: pass 1 gives the local ``(dbeta, dgamma)``, one ``Sum``
  allreduce of those ``2C`` values follows, and pass 2 runs with the sums
  and the global count.  ``weight`` and ``bias`` get the LOCAL sums, which
  the DistributedOptimizer averages like every other gradient.

The kernels take the ``[rows, C]`` view ``x.permute(0, 2, ..., 1)``,
which is contiguous for a ``channels_last`` input, and the output is that
layout too.  An input or gradient in any other layout is copied once
into it, and the copy is counted (``sync_bn_counters()["layout_copies"]``).
The layer takes this path at every world size, world 1 included (the
reference hands world 1 to ``_BatchNorm``, which on the GPU would run
cuDNN's backward instead of the kernels).  Eval mode is ``_BatchNorm``'s
own forward with the running statistics.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from .collectives.ops import step_allreduce_
from .collectives.reduce_op import Average, Sum
from .core.basics import size
from .core.device import resolve_device
from .core.process_sets import get_process_set
from .ops.bn import bn_train_with_stats, fused_bn_backward, normalize
from .timeline.metrics import note_sync_bn_allreduce, sync_bn_counters


def _allreduce(rows: torch.Tensor, op, process_set=None) -> torch.Tensor:
    """``rows`` (f32, per channel) allreduced in place over the set's
    ranks (every rank by default), counted by the sync-BN exchange
    counters; a step's own collective (``step_allreduce_``)."""
    note_sync_bn_allreduce(rows.numel() * rows.element_size())
    return step_allreduce_(rows, op, process_set=process_set)


def _sum(rows: torch.Tensor, process_set=None) -> torch.Tensor:
    return _allreduce(rows, Sum, process_set)


def sync_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, *, force_reference: bool = False,
                  process_set=None):
    """flax's ``BatchNorm(axis_name=...)`` in train mode over every rank
    (or the members of ``process_set``, a sub-mesh's set), channels
    last: ``(y, mean, var)``, the statistics over the set (see the module
    docstring).  Every member must hold an equal batch, as under flax's
    ``pmean``."""
    ranks = size() if process_set is None else \
        get_process_set(process_set).size()
    return bn_train_with_stats(
        x, scale, bias, eps, force_reference=force_reference,
        average=lambda rows: _allreduce(rows, Average, process_set),
        allreduce=lambda rows: _sum(rows, process_set), ranks=ranks)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The ``[rows, C]`` channels-last view of ``t`` (channels at dim 1);
    a counted copy when ``t`` is not channels-last in memory."""
    v = t.permute(0, *range(2, t.dim()), 1)
    if not v.is_contiguous():
        sync_bn_counters()["layout_copies"].inc()
        v = v.contiguous()
    return v.view(-1, t.shape[1])


def _from_rows(rows: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``[rows, C]`` back to ``shape`` (channels at dim 1), as a view."""
    v = rows.view(shape[0], *shape[2:], shape[1])
    return v.permute(0, v.dim() - 1, *range(1, v.dim() - 1))


def _empty_channels_last(shape: torch.Size, dtype, device) -> torch.Tensor:
    """A new tensor of ``shape`` laid out channels-last (channels at dim
    1, stride 1), which is not a view: the forward's output may be
    modified in place (an ``nn.ReLU(inplace=True)`` after it), which
    autograd forbids on a view made inside a custom Function."""
    strides, acc = [0] * len(shape), shape[1]
    strides[1] = 1
    for d in range(len(shape) - 1, 1, -1):
        strides[d] = acc
        acc *= shape[d]
    strides[0] = acc
    return torch.empty_strided(tuple(shape), tuple(strides), dtype=dtype,
                               device=device)


class _SyncBatchNormFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, process_set):
        c = x.shape[1]
        rows = _rows(x)
        xf = rows.float()
        stats = torch.cat([xf.sum(0), xf.square().sum(0),
                           xf.new_full((1,), float(rows.shape[0]))])
        stats = _sum(stats, process_set)
        count = stats[-1].item()
        mean = stats[:c] / count
        var = torch.clamp_min(stats[c:2 * c] / count - mean.square(), 0.0)
        scale = weight.float() if weight is not None else \
            torch.ones_like(mean)
        shift = bias.float() if bias is not None else torch.zeros_like(mean)
        out = _empty_channels_last(x.shape, x.dtype, x.device)
        normalize(xf, mean, torch.rsqrt(var + eps), scale, shift, x.dtype,
                  out=_rows(out))
        ctx.save_for_backward(rows, scale, mean, var)
        ctx.count, ctx.eps, ctx.shape = count, eps, x.shape
        ctx.process_set = process_set
        ctx.param_dtype = weight.dtype if weight is not None else None
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        rows, scale, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = fused_bn_backward(
            rows, scale, mean, var, _rows(dy), eps=ctx.eps, count=ctx.count,
            allreduce=lambda sums: _sum(sums, ctx.process_set))
        grads = (None, None) if ctx.param_dtype is None else (
            dgamma.to(ctx.param_dtype), dbeta.to(ctx.param_dtype))
        return _from_rows(dx, ctx.shape), *grads, None, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in ``hvd.SyncBatchNorm(num_features, eps=1e-5, momentum=0.1,
    affine=True, track_running_stats=True, process_set=None)`` over every
    rank, or over the members of ``process_set`` (a non-member raises in
    training mode).  Parameters live on ``device`` (``cuda`` unless the
    caller asks for the CPU)."""

    def __init__(self, num_features: int, *args, process_set=None,
                 device=None, **kwargs):
        super().__init__(num_features, *args, device=resolve_device(device),
                         **kwargs)
        self.process_set = None if process_set is None else \
            get_process_set(process_set)

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.dim() < 2:
            raise ValueError(f"expected at least 2D input, got "
                             f"{input.dim()}D")

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(input)
        if not self.training:
            return super().forward(input)
        out, mean, var, count = _SyncBatchNormFn.apply(
            input, self.weight, self.bias, float(self.eps), self.process_set)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                momentum = (1.0 / float(self.num_batches_tracked)
                            if self.momentum is None else self.momentum)
                unbiased = var * (count / max(count - 1.0, 1.0))
                self.running_mean.mul_(1 - momentum).add_(momentum * mean)
                self.running_var.mul_(1 - momentum).add_(
                    momentum * unbiased)
        return out


__all__ = ["SyncBatchNorm", "sync_bn_train"]
