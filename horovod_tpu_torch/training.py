"""Training steps for a torch module.

Counterpart of ``horovod_tpu/training.py::make_train_step``.  The JAX
step is a pure function of ``(params, opt_state, batch)`` traced over the
mesh; here the module and the optimizer hold the state, so
:func:`make_train_step` returns ``step(batch) -> loss``: forward, loss,
backward (whose gradient hooks launch the fused allreduces of a
:func:`~horovod_tpu_torch.optim.DistributedOptimizer`), then the
optimizer step.  With ``backward_passes_per_step = n`` on the optimizer,
the step runs the optimizer only once the optimizer reports ``n``
backward passes since its last exchange (``exchange_ready``), and the
gradients of those passes are averaged first -- the JAX wrap's
accumulate-then-update.  The returned loss is averaged over every rank.

:func:`causal_lm_loss` is the next-token cross-entropy that
``examples/llama_lora.py`` trains: ``logits[:, :-1]`` against
``tokens[:, 1:]``, mean, in f32.  :func:`bert_pretrain_loss` is the
MLM + NSP objective of ``examples/bert_pretrain.py``.

:func:`make_flax_train_step` (the counterpart of the JAX function of that
name) is the step of a model with batch statistics -- ResNet, LeNet --
on ``(x, y)`` batches: :func:`make_train_step` with :func:`softmax_xent`
in train mode, then the BatchNorm running statistics averaged over the
ranks.  :func:`make_eval_step` averages a metric over the ranks.
:func:`sync_batch_norm` is the JAX package's cross-replica BatchNorm.

``zero_stage=1`` on either step builder (default ``HOROVOD_ZERO``) runs
the optimizer as ZeRO-1 (:mod:`~horovod_tpu_torch.optim.zero`): pass the
BARE optimizer; the step reduce-scatters the gradients, updates this
rank's arena shard with an inner optimizer of the same class, and
allgathers the parameters (``zero_compression``: none, fp16, bf16, fp8,
or an error-feedback codec whose residuals stay on the shard owner).  The
step's ``zero_state`` attribute holds the sharded state.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from .collectives.ops import allreduce, grouped_allreduce
from .collectives.reduce_op import Average
from .core.state import global_state
from .ops.bn import BatchNorm
from .optim import zero as _zero


def next_token_loss(logits: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits[:, :-1]`` against ``tokens[:, 1:]``
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``),
    computed in f32."""
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, vocab),
                           tokens[:, 1:].reshape(-1).long())


def causal_lm_loss(model: torch.nn.Module,
                   tokens: torch.Tensor) -> torch.Tensor:
    """``next_token_loss(model(tokens), tokens)``."""
    return next_token_loss(model(tokens), tokens)


def mlm_nsp_loss(mlm_logits: torch.Tensor, nsp_logits: torch.Tensor,
                 tokens: torch.Tensor,
                 nsp_labels: torch.Tensor) -> torch.Tensor:
    """BERT's pretraining loss as ``examples/bert_pretrain.py`` computes
    it: the mean MLM cross-entropy of ``mlm_logits`` ``[b, t, vocab]``
    against the token identity (the synthetic objective: real masking
    needs a corpus) plus the mean NSP cross-entropy of ``nsp_logits``
    ``[b, 2]``, both in f32."""
    vocab = mlm_logits.shape[-1]
    return (softmax_xent(mlm_logits.reshape(-1, vocab), tokens.reshape(-1))
            + softmax_xent(nsp_logits, nsp_labels))


def bert_pretrain_loss(model: torch.nn.Module, batch) -> torch.Tensor:
    """:func:`mlm_nsp_loss` of ``model(tokens)`` on a ``(tokens,
    nsp_labels)`` batch."""
    tokens, nsp_labels = batch
    return mlm_nsp_loss(*model(tokens), tokens, nsp_labels)


def _resolve_zero_stage(zero_stage: Optional[int]) -> int:
    """``None`` defers to the configured default (``HOROVOD_ZERO``)."""
    if zero_stage is None:
        cfg = global_state().config
        zero_stage = cfg.zero_stage if cfg is not None else 0
    if zero_stage not in (0, 1):
        raise ValueError(f"zero_stage must be 0 or 1, got {zero_stage!r}")
    return zero_stage


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    zero_stage: Optional[int] = None,
                    zero_compression=None) -> Callable[[Any], torch.Tensor]:
    """Build ``step(batch) -> loss``.

    ``loss_fn(model, local_batch)`` runs on this rank's batch; the
    optimizer should be a ``DistributedOptimizer`` (a plain one trains
    each rank on its own), or with ``zero_stage=1`` the bare optimizer,
    whose trainable parameters ZeRO-1 shards (module docstring; a
    ``DistributedOptimizer`` is refused with ``ValueError``).  The
    returned 0-dim tensor is the mean of the ranks' losses; reading it
    synchronizes with the device.
    """
    zero_stage = _resolve_zero_stage(zero_stage)
    params = state = None
    if zero_stage:
        _zero._reject_distributed(optimizer)
        params = [p for g in optimizer.param_groups for p in g["params"]
                  if p.requires_grad]
        state = _zero.zero_init(optimizer, params,
                                compression=zero_compression)

    def step(batch) -> torch.Tensor:
        loss = loss_fn(model, batch)
        loss.backward()
        if zero_stage:
            _zero.zero_apply(optimizer, [p.grad for p in params], state,
                             params, compression=zero_compression)
            optimizer.zero_grad(set_to_none=True)
        # The optimizer counts the passes; a plain one steps every call.
        elif getattr(optimizer, "exchange_ready", True):
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return allreduce(loss.detach(), Average)

    step.zero_state = state
    return step


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` ``[N, classes]`` against integer
    ``labels`` ``[N]`` (``optax.softmax_cross_entropy_with_integer_labels
    (...).mean()``), computed in f32 (f64 logits stay f64)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.long())


def make_flax_train_step(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         zero_stage: Optional[int] = None,
                         zero_compression=None
                         ) -> Callable[[Any], torch.Tensor]:
    """Build ``step((x, y)) -> loss`` for a model with batch statistics.

    Each step puts ``model`` in train mode, runs :func:`make_train_step`
    on ``softmax_xent(model(x), y)`` -- the forward updates every
    BatchNorm's running statistics from this rank's batch, the backward
    launches the optimizer's bucketed allreduces, the optimizer steps
    once its accumulation is complete -- then averages the running
    statistics over the ranks (one grouped allreduce of the model's
    floating-point buffers), as the JAX step does.  Returns the loss
    averaged over the ranks.  ``zero_stage`` / ``zero_compression``: see
    :func:`make_train_step` (the order is the JAX step's: gradients, the
    ZeRO-1 update, the running statistics' average, the loss's).
    """
    def model_loss(m: torch.nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return softmax_xent(m(x), y)

    inner = make_train_step(model, model_loss, optimizer,
                            zero_stage=zero_stage,
                            zero_compression=zero_compression)
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def step(batch) -> torch.Tensor:
        model.train()
        loss = inner(batch)
        if stats:
            with torch.no_grad():
                torch._foreach_copy_(stats,
                                     grouped_allreduce(stats, Average))
        return loss

    step.zero_state = inner.zero_state
    return step


def sync_batch_norm(axes=None, **kwargs) -> BatchNorm:
    """A :class:`~horovod_tpu_torch.ops.bn.BatchNorm` whose batch
    statistics span every rank: the counterpart of the JAX package's
    ``sync_batch_norm`` (flax's ``BatchNorm(axis_name=...)``, a ``pmean``
    of the statistics over the mesh).  ``kwargs`` are the module's
    (``features``, ``momentum``, ``epsilon``, ``dtype``, ...), and its
    parameter and ``batch_stats`` names are the plain module's, so
    checkpoints convert alike.  The forward averages the local f32
    ``(mean, mean of squares)`` over the ranks; the backward sums the two
    gradient statistics between the BN kernels' passes; ``scale`` and
    ``bias`` get local sums, which the DistributedOptimizer averages.
    ``axes`` (a sub-mesh of named axes) is not ported: the statistics
    always span every rank."""
    if axes is not None:
        raise NotImplementedError(
            "sync_batch_norm(axes=...) over a sub-mesh is not ported: it "
            "needs the named mesh axes of ROADMAP item 1.12")
    return BatchNorm(sync=True, **kwargs)


def make_eval_step(metric_fn: Callable[[torch.nn.Module, Any], Any]
                   ) -> Callable[[torch.nn.Module, Any], Any]:
    """Build ``eval_step(model, batch)``: ``metric_fn(model, batch)``
    without gradients, every tensor of its result (a tensor, or a dict,
    list or tuple of them) averaged over the ranks."""

    def average(v):
        if isinstance(v, dict):
            return {k: average(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(average(x) for x in v)
        return allreduce(v, Average)

    def eval_step(model: torch.nn.Module, batch):
        with torch.no_grad():
            return average(metric_fn(model, batch))

    return eval_step
