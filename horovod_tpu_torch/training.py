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
``tokens[:, 1:]``, mean, in f32.

:func:`make_flax_train_step` (the counterpart of the JAX function of that
name) is the step of a model with batch statistics -- ResNet, LeNet --
on ``(x, y)`` batches: :func:`make_train_step` with :func:`softmax_xent`
in train mode, then the BatchNorm running statistics averaged over the
ranks.  :func:`make_eval_step` averages a metric over the ranks.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from .collectives.ops import allreduce, grouped_allreduce
from .collectives.reduce_op import Average


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


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer
                    ) -> Callable[[Any], torch.Tensor]:
    """Build ``step(batch) -> loss``.

    ``loss_fn(model, local_batch)`` runs on this rank's batch; the
    optimizer should be a ``DistributedOptimizer`` (a plain one trains
    each rank on its own).  The returned 0-dim tensor is the mean of the
    ranks' losses; reading it synchronizes with the device.
    """

    def step(batch) -> torch.Tensor:
        loss = loss_fn(model, batch)
        loss.backward()
        # The optimizer counts the passes; a plain one steps every call.
        if getattr(optimizer, "exchange_ready", True):
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return allreduce(loss.detach(), Average)

    return step


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` ``[N, classes]`` against integer
    ``labels`` ``[N]`` (``optax.softmax_cross_entropy_with_integer_labels
    (...).mean()``), computed in f32."""
    return F.cross_entropy(logits.float(), labels.long())


def make_flax_train_step(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer
                         ) -> Callable[[Any], torch.Tensor]:
    """Build ``step((x, y)) -> loss`` for a model with batch statistics.

    Each step puts ``model`` in train mode, runs :func:`make_train_step`
    on ``softmax_xent(model(x), y)`` -- the forward updates every
    BatchNorm's running statistics from this rank's batch, the backward
    launches the optimizer's bucketed allreduces, the optimizer steps
    once its accumulation is complete -- then averages the running
    statistics over the ranks (one grouped allreduce of the model's
    floating-point buffers), as the JAX step does.  Returns the loss
    averaged over the ranks.
    """
    def model_loss(m: torch.nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return softmax_xent(m(x), y)

    inner = make_train_step(model, model_loss, optimizer)
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def step(batch) -> torch.Tensor:
        model.train()
        loss = inner(batch)
        if stats:
            with torch.no_grad():
                torch._foreach_copy_(stats,
                                     grouped_allreduce(stats, Average))
        return loss

    return step


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
