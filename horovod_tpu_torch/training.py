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

``microbatches=k > 1`` on either step builder (default
``HOROVOD_MICROBATCHES``) runs the backward-overlap exchange: the batch
splits into k sub-batches; each one's gradients come from
``torch.autograd.grad`` (so the ``DistributedOptimizer``'s hooks never
fire), are packed into buckets in ready order and reduce-scattered
asynchronously, and the wait on microbatch i's shards comes only after
microbatch i+1's backward is enqueued, so on NCCL the scatter overlaps
that backward.  The shards accumulate in f32 and close with one
allgather a bucket; the optimizer then steps on the result with no
second exchange (:func:`_microbatch_unwrap` lists what it refuses).

:func:`make_train_loop` / :func:`make_flax_train_loop` run
``steps_per_execution=k`` steps (default ``HOROVOD_STEPS_PER_EXEC``) a
call on batches stacked ``[k, batch, ...]`` (:func:`stack_steps`,
``data.DevicePrefetcher(stack_steps=k)``) and return the ``[k]`` losses.
On the GPU the window is one CUDA graph (see :class:`TrainLoop`).  The
JAX builders' ``donate`` has no counterpart: torch updates in place.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .collectives.ops import (allgather_bucket, allreduce,
                              grouped_allreduce, microbatch_pad_quantum,
                              psum_scatter_bucket_async)
from .collectives.reduce_op import Average, Sum
from .controller.fusion import (pack_bucket, plan_buckets, plan_exchange,
                                unpack)
from .core.state import global_state
from .data.tree import stack_steps, tree_leaves, tree_map  # noqa: F401
from .ops.bn import BatchNorm
from .optim import distributed as _dist
from .optim import zero as _zero
from .timeline.metrics import exchange_counters
from .timeline.spans import note_leg


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


def steps_per_execution(default: int = 1) -> int:
    """The resolved steps-per-execution k (``HOROVOD_STEPS_PER_EXEC``
    once ``init()`` has run, else ``default``): the window of
    :func:`make_train_loop` built without ``steps_per_execution``."""
    cfg = global_state().config
    return max(1, cfg.steps_per_exec if cfg is not None else default)


def _resolve_steps(k: Optional[int]) -> int:
    """``None`` defers to :func:`steps_per_execution`."""
    k = steps_per_execution() if k is None else int(k)
    if k < 1:
        raise ValueError(f"steps_per_execution must be >= 1, got {k}")
    return k


def microbatches(default: int = 1) -> int:
    """The resolved microbatch count k (``HOROVOD_MICROBATCHES`` once
    ``init()`` has run, else ``default``): the step builders' default."""
    cfg = global_state().config
    return max(1, cfg.microbatches if cfg is not None else default)


def _resolve_microbatches(k: Optional[int]) -> int:
    """``None`` defers to :func:`microbatches`."""
    k = microbatches() if k is None else int(k)
    if k < 1:
        raise ValueError(f"microbatches must be >= 1, got {k}")
    return k


def _split_microbatches(batch, k: int) -> List[Any]:
    """``k`` contiguous sub-batches of ``batch`` along each tensor's
    leading (local batch) dim, as views."""
    def check(leaf):
        b0 = leaf.shape[0] if leaf.dim() else 0
        if b0 % k:
            raise ValueError(
                f"microbatches={k} must divide the per-device batch "
                f"(got leading dim {b0}); pad or resize the batch")
    tree_map(check, batch)
    return [tree_map(lambda x, i=i: x[i * (x.shape[0] // k):
                                      (i + 1) * (x.shape[0] // k)], batch)
            for i in range(k)]


def _microbatch_unwrap(optimizer):
    """``(optimizer, exchange)`` for the microbatched step: the exchange
    a ``DistributedOptimizer`` wrap would have run (``None`` for a bare
    optimizer -- local accumulation, no collective, as the bare
    single-shot step).  The step runs the exchange itself and steps the
    wrap without its own (``skip_synchronize``).  Refused, as in the JAX
    package: ``backward_passes_per_step > 1``, a process set, an op
    other than Sum/Average (Adasum) and fp8.  The error-feedback codecs
    compose: the step accumulates locally and runs one ``ef_exchange``
    a step."""
    from .collectives.compression import is_fp8
    if not isinstance(optimizer, _dist._DistributedOptimizer):
        return optimizer, None
    if optimizer.backward_passes_per_step > 1:
        raise ValueError(
            "microbatches > 1 cannot combine with "
            "backward_passes_per_step > 1 (both are gradient-accumulation "
            "schemes; pick one)")
    ps = optimizer._process_set
    if ps is not None and not ps.is_global():
        raise NotImplementedError(
            "microbatches > 1 does not support process-set reductions "
            "(the scatter-based exchange has no masked identity)")
    if optimizer._op not in (Sum, Average):
        raise ValueError(
            "microbatches > 1 supports Sum/Average reductions only, got "
            f"{optimizer._op!r} (Adasum composes through "
            "DistributedAdasumOptimizer without microbatching)")
    if is_fp8(optimizer._compression):
        raise NotImplementedError(
            "microbatches > 1 does not support Compression.fp8 (the "
            "quantized exchange owns its own collective); use fp16/bf16")
    return optimizer, {
        "compression": optimizer._compression, "op": optimizer._op,
        "fusion_threshold": optimizer._fusion_threshold,
        "prescale_factor": optimizer._prescale,
        "postscale_factor": optimizer._postscale}


def _is_ef_exchange(exchange) -> bool:
    """Whether a microbatch exchange carries an error-feedback codec
    (then the step accumulates locally and runs one ``ef_exchange``)."""
    from .collectives.compression import is_error_feedback
    return exchange is not None and \
        is_error_feedback(exchange["compression"])


class _MicrobatchGradPipe:
    """The backward-overlap exchange of one microbatched step over
    ``params`` (the JAX ``_microbatch_grad_pipe``).

    :meth:`launch` takes one microbatch's gradients: with an
    ``exchange``, it packs them into buckets in ready order
    (``plan_buckets(reverse=True)`` over ``order``, the flax leaf order
    when the wrap has names), casts each with the codec, applies the
    prescale, notes its ``mb_rs`` row and starts its reduce-scatter
    (:func:`psum_scatter_bucket_async`); without one it keeps them in
    f32.  :meth:`collect` waits and adds the shards to the f32 state.
    :meth:`finalize` scales the shards (``1/k``; ``1/n`` for Average;
    the postscale), casts them back, and closes with one
    :func:`allgather_bucket` a bucket (its ``mb_ag`` row), returning the
    gradients in ``params`` order.  The rows and the exchange counters
    come from ``plan_exchange("microbatch")``."""

    def __init__(self, params: Sequence[torch.Tensor], exchange, k: int,
                 order: Optional[Sequence[int]] = None):
        self._params = list(params)
        self._exchange = exchange
        self._k = k
        self._order = list(range(len(self._params))) if order is None \
            else list(order)
        if exchange is None:
            return
        self._world = global_state().size
        self._spec = plan_buckets([self._params[i] for i in self._order],
                                  exchange["fusion_threshold"], reverse=True)
        legs = plan_exchange(
            "microbatch", buffers=tuple(
                (dt, sum(s.size for s in lspecs))
                for dt, lspecs in self._spec.buffers),
            k=k, world=self._world, compression=exchange["compression"]
        ).legs
        nb = len(self._spec.buffers)
        self.rs_legs, self.ag_legs = legs[:nb], legs[nb:]

    def launch(self, grads: Sequence[torch.Tensor]):
        if self._exchange is None:
            return [g.float() for g in grads]
        comp = self._exchange["compression"]
        pre = self._exchange["prescale_factor"]
        leaves = [grads[i] for i in self._order]
        quantum = microbatch_pad_quantum(self._world)
        pending = []
        for leg, (_, lspecs) in zip(self.rs_legs, self._spec.buffers):
            c, ctx = comp.compress(pack_bucket(leaves, lspecs))
            if pre != 1.0:
                c = c * pre
            note_leg(leg)
            pending.append((psum_scatter_bucket_async(c, quantum=quantum),
                            ctx))
        return pending

    def collect(self, pending, state):
        if self._exchange is None:
            shards = pending
        else:
            comp = self._exchange["compression"]
            shards = [comp.decompress(h.wait(), ctx).float()
                      for h, ctx in pending]
        return shards if state is None else \
            [a + s for a, s in zip(state, shards)]

    def finalize(self, state) -> List[torch.Tensor]:
        k = self._k
        if self._exchange is None:
            return [(a / k).to(p.dtype) for a, p in zip(state, self._params)]
        ex = self._exchange
        comp, post = ex["compression"], ex["postscale_factor"]
        scale = 1.0 / k
        if ex["op"] is Average:
            scale = scale / self._world
        out = []
        for shard, leg, (dt, lspecs) in zip(state, self.ag_legs,
                                            self._spec.buffers):
            shard = shard * scale
            if post != 1.0:
                shard = shard * post
            c, ctx = comp.compress(shard.to(dt))
            note_leg(leg)
            out.append(comp.decompress(
                allgather_bucket(c, sum(s.size for s in lspecs)), ctx))
        m = exchange_counters()
        m["buckets"].inc(len(out))
        m["handles"].inc(len(out) * (k + 1))
        m["wire_bytes"].inc(k * sum(leg.nbytes for leg in self.rs_legs)
                            + sum(leg.nbytes for leg in self.ag_legs))
        grads: List[Optional[torch.Tensor]] = [None] * len(self._params)
        for j, g in zip(self._order, unpack(out, self._spec)):
            grads[j] = g
        return grads  # type: ignore[return-value]


def _ef_reduce(optimizer, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """One error-feedback exchange of the microbatched step's merged
    local gradients (``params`` order = the optimizer's trainable
    order) through the wrap's residuals, in its buckets' leaf order and
    layout; the residuals are updated once, in place, as a step of the
    wrap would."""
    from .models.convert import from_flax_layout
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"]
        if p.requires_grad)}
    trainable = optimizer._trainable
    local = [optimizer._flax_view(i, grads[index[id(p)]])
             for i, p in enumerate(trainable)]
    outs, new_res = _dist.ef_exchange(
        local, optimizer._residuals, compression=optimizer._compression,
        op=optimizer._op, fusion_threshold=optimizer._fusion_threshold,
        prescale_factor=optimizer._prescale,
        postscale_factor=optimizer._postscale)
    for res, new in zip(optimizer._residuals, new_res):
        res.copy_(new)                  # in place, as the wrap's step
    reduced: List[Optional[torch.Tensor]] = [None] * len(grads)
    for i, (p, out) in enumerate(zip(trainable, outs)):
        if optimizer._names is not None:
            out = from_flax_layout(optimizer._names[i], out)
        reduced[index[id(p)]] = out
    return reduced  # type: ignore[return-value]


def _make_microbatch_step(model: torch.nn.Module, loss_fn,
                          optimizer: torch.optim.Optimizer, k: int):
    """``step(batch) -> loss`` of ``microbatches=k > 1`` (the JAX
    ``_build_microbatch_local_step``): k forwards and
    ``torch.autograd.grad`` backwards through
    :class:`_MicrobatchGradPipe`, one optimizer step on the merged
    gradients, the loss the mean over the microbatches averaged over the
    ranks.  With a per-example-mean loss the merged gradient is the
    full batch's up to the f32 accumulation order."""
    optimizer, exchange = _microbatch_unwrap(optimizer)
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    order = None
    name_of = getattr(optimizer, "_name_of", None)
    if exchange is not None and name_of is not None:
        from .models.convert import flax_leaf_order
        order = flax_leaf_order([name_of[id(p)] for p in params])
    ef = _is_ef_exchange(exchange)
    pipe = _MicrobatchGradPipe(params, None if ef else exchange, k, order)

    def step(batch) -> torch.Tensor:
        losses, state, pending = [], None, None
        for mb in _split_microbatches(batch, k):
            loss = loss_fn(model, mb)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [g if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads, params)]
            losses.append(loss.detach())
            # Microbatch i's shards are waited for only now, after
            # microbatch i+1's backward was enqueued.
            if pending is not None:
                state = pipe.collect(pending, state)
            pending = pipe.launch(grads)
        reduced = pipe.finalize(pipe.collect(pending, state))
        if ef:
            reduced = _ef_reduce(optimizer, reduced)
        for p, g in zip(params, reduced):
            p.grad = g
        if exchange is not None:
            with optimizer.skip_synchronize():
                optimizer.step()
        else:
            optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return allreduce(torch.stack(losses).mean(), Average)

    step.zero_state = None
    return step


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    zero_stage: Optional[int] = None,
                    zero_compression=None,
                    microbatches: Optional[int] = None
                    ) -> Callable[[Any], torch.Tensor]:
    """Build ``step(batch) -> loss``.

    ``loss_fn(model, local_batch)`` runs on this rank's batch; the
    optimizer should be a ``DistributedOptimizer`` (a plain one trains
    each rank on its own), or with ``zero_stage=1`` the bare optimizer,
    whose trainable parameters ZeRO-1 shards (module docstring; a
    ``DistributedOptimizer`` is refused with ``ValueError``).  The
    returned 0-dim tensor is the mean of the ranks' losses; reading it
    synchronizes with the device.  ``microbatches=k > 1`` (default
    ``HOROVOD_MICROBATCHES``) runs the backward-overlap exchange (module
    docstring; not with ``zero_stage=1``); ``k = 1`` is this step.
    """
    zero_stage = _resolve_zero_stage(zero_stage)
    k_micro = _resolve_microbatches(microbatches)
    if zero_stage and k_micro > 1:
        raise ValueError(
            "microbatches > 1 is incompatible with zero_stage=1 (the "
            "ZeRO-1 arena reduce-scatter is already shard-based; overlap "
            "it via HOROVOD_EXCHANGE_CHUNK_MB instead)")
    if k_micro > 1:
        return _make_microbatch_step(model, loss_fn, optimizer, k_micro)
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
                         zero_compression=None,
                         microbatches: Optional[int] = None
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
    ``microbatches=k > 1``: the backward-overlap exchange; the BatchNorm
    statistics chain through the k sub-batches and the running averages
    advance k times a step, as in the JAX step -- so it is not the
    single-shot step.
    """
    def model_loss(m: torch.nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return softmax_xent(m(x), y)

    inner = make_train_step(model, model_loss, optimizer,
                            zero_stage=zero_stage,
                            zero_compression=zero_compression,
                            microbatches=microbatches)
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


def _refuse_uncapturable(model: torch.nn.Module, optimizers, k: int,
                         capture: bool = False) -> None:
    """``ValueError`` naming what on the step's path a CUDA graph cannot
    capture, found before capture: a torch-style ``SyncBatchNorm`` (its
    forward reads the row count on the host), an optimizer whose step
    is not capturable (``capturable=False``, torch's Adam family), and
    host bookkeeping a replay would not advance -- a
    ``backward_passes_per_step`` that does not divide ``k`` (every
    replay would repeat the captured phase of the accumulation), a
    window that starts partway through an accumulation, and (at
    ``capture``) a ``.grad`` left from before the window (a replay would
    accumulate into that tensor, not into the parameter's ``.grad``)."""
    from .sync_batch_norm import SyncBatchNorm
    why = (f"steps_per_execution={k} on the GPU captures the window as a "
           f"CUDA graph")
    for name, m in model.named_modules():
        if isinstance(m, SyncBatchNorm):
            raise ValueError(
                f"{why}, and {name or 'the model'} is a torch-style "
                f"SyncBatchNorm, whose forward reads its row count on the "
                f"host (.item()); use training.sync_batch_norm")
    for opt in optimizers:
        kind = type(opt).__name__
        if any(g.get("capturable") is False for g in opt.param_groups):
            raise ValueError(f"{why}, and {kind}'s step is not capturable; "
                             f"build it with capturable=True")
        n = getattr(opt, "backward_passes_per_step", 1)
        if k % n:
            raise ValueError(
                f"{why}, and {kind} accumulates backward_passes_per_step="
                f"{n} passes a step, which does not divide the window: "
                f"each replay would start partway through an "
                f"accumulation; make steps_per_execution a multiple of {n}")
        if getattr(opt, "_handles", None) or any(getattr(opt, "_counter",
                                                         ())):
            raise ValueError(
                f"{why}, and {kind} is partway through a "
                f"backward_passes_per_step accumulation; start the loop "
                f"on a step boundary")
        if capture and any(p.grad is not None for g in opt.param_groups
                           for p in g["params"]):
            raise ValueError(
                f"{why}, and a parameter of {kind} holds a .grad from "
                f"before the window; call zero_grad(set_to_none=True) "
                f"first")


def _state_refs(model: torch.nn.Module, optimizers, zero_state) -> list:
    """What a replay reaches through Python references: the identity of
    every parameter, buffer, optimizer state tensor, error-feedback
    residual and ZeRO-1 shard, and which parameters hold a ``.grad``.
    A window that rebinds any of them cannot be replayed: the graph
    keeps the tensors it was captured with."""
    refs = [id(t) for t in list(model.parameters()) + list(model.buffers())]
    for opt in optimizers:
        refs += [(id(p), key, id(v)) for p, st in opt.state.items()
                 for key, v in st.items() if torch.is_tensor(v)]
        refs += [id(r) for r in getattr(opt, "_residuals", None) or ()]
        refs += [p.grad is None for g in opt.param_groups
                 for p in g["params"]]
    if zero_state is not None:
        refs += [id(t) for t in list(zero_state.shards)
                 + list(zero_state.residuals or ())]
    return refs


def _hyperparameters(optimizers) -> list:
    """Every optimizer's param groups' host values (all entries but the
    parameters and tensors): the captured graph holds them as they were
    at capture."""
    return [[{key: v for key, v in g.items()
              if key != "params" and not torch.is_tensor(v)}
             for g in opt.param_groups] for opt in optimizers]


class TrainLoop:
    """``loop(batches) -> losses``: ``steps_per_execution`` calls of a
    train step (``step(batch) -> loss``) on batches stacked ``[k,
    batch, ...]``, returning the ``[k]`` losses.

    On the CPU the window runs the step k times, eagerly.  On the GPU
    it runs on the loop's own stream (made to wait on the caller's, and
    the caller's on it):

    * the first call runs the window eagerly -- real steps, which create
      the optimizer state, the NCCL communicator and the cuDNN plans;
    * the second captures the window as one ``torch.cuda.CUDAGraph``
      (every generator in ``generators`` registered with it, so a
      replay advances each as the eager steps would) and replays it;
    * later calls copy the batches into the graph's static input and
      replay.  The returned losses are the graph's static output: read
      them before the next call.  A call that finds a param group's
      host value changed since the capture (an lr schedule) captures
      the window again, since the graph holds the captured values;
    * a call after an elastic re-init (``global_state().generation``
      moved) never replays the old graph, which holds the old
      communicator: it drops it and starts over -- an eager window, then
      a capture on the new process group.

    What the capture records on the host -- the kernels' launch
    counters, the metrics registry's counters (exchange, collective,
    ZeRO-1, sync BN) and the span leg registry -- it adds again at every
    later replay, so they count the steps the card runs.  Nothing falls
    back to eager steps: a step the graph cannot capture (a host read
    such as ``.item()``, a non-capturable optimizer, a
    ``backward_passes_per_step`` that does not divide k) raises
    ``ValueError`` naming the cause."""

    def __init__(self, step: Callable[[Any], torch.Tensor], k: int,
                 model: torch.nn.Module, optimizers: Sequence,
                 generators: Sequence[torch.Generator] = ()):
        self.step = step
        self.steps_per_execution = k
        self.zero_state = getattr(step, "zero_state", None)
        self._model = model
        self._optimizers = list(optimizers)
        self._generators = list(generators)
        self._calls = 0
        self._graph = None
        self._static_in = None
        self._static_out = None
        self._stream = None
        self._deltas = None
        self._hyper = None
        self._generation = global_state().generation

    def _window(self, batches) -> torch.Tensor:
        return torch.stack([self.step(tree_map(lambda x, i=i: x[i],
                                               batches))
                            for i in range(self.steps_per_execution)])

    def __call__(self, batches) -> torch.Tensor:
        leaves = tree_leaves(batches)
        k = self.steps_per_execution
        for x in leaves:
            if x.dim() == 0 or x.shape[0] != k:
                raise ValueError(
                    f"batches must be stacked [steps_per_execution={k}, "
                    f"batch, ...] (stack_steps); got a leaf of shape "
                    f"{tuple(x.shape)}")
        if not leaves or leaves[0].device.type != "cuda":
            return self._window(batches)
        gen = global_state().generation
        if gen != self._generation:
            self._graph = self._static_out = self._static_in = None
            self._calls, self._generation = 0, gen
        caller = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        side = self._stream
        side.wait_stream(caller)
        for x in leaves:
            x.record_stream(side)
        with torch.cuda.stream(side):
            if self._calls == 0:
                _refuse_uncapturable(self._model, self._optimizers, k)
                out = self._window(batches)
            elif self._graph is None or \
                    self._hyper != _hyperparameters(self._optimizers):
                out = self._capture(batches)
            else:
                tree_map(lambda d, x: d.copy_(x, non_blocking=True),
                         self._static_in, batches)
                self._replay_counters()
                self._graph.replay()
                out = self._static_out
        caller.wait_stream(side)
        out.record_stream(caller)
        self._calls += 1
        return out

    def _capture(self, batches) -> torch.Tensor:
        from .ops import registry
        from .timeline import metrics, spans
        self._graph = self._static_out = None
        _refuse_uncapturable(self._model, self._optimizers,
                             self.steps_per_execution, capture=True)
        self._hyper = _hyperparameters(self._optimizers)
        refs = _state_refs(self._model, self._optimizers, self.zero_state)
        self._static_in = tree_map(lambda x: x.clone(), batches)
        before = (registry.launch_counts(), metrics.counter_values(),
                  spans.recorder().leg_registry())
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self._window(self._static_in)
        except RuntimeError as e:
            raise ValueError(
                f"the {self.steps_per_execution}-step window cannot be "
                f"captured as a CUDA graph (a host read such as .item() "
                f"or .tolist() on the step's path, or a non-capturable "
                f"op): {e}") from e
        if _state_refs(self._model, self._optimizers,
                       self.zero_state) != refs:
            raise ValueError(
                f"the {self.steps_per_execution}-step window rebinds a "
                f"tensor it reads (a parameter, buffer, optimizer state "
                f"entry, residual or shard) or leaves a .grad set, so a "
                f"replay would not see what the window left")
        after = (registry.launch_counts(), metrics.counter_values(),
                 spans.recorder().leg_registry())
        self._deltas = (
            {f: n - before[0].get(f, 0) for f, n in after[0].items()
             if n != before[0].get(f, 0)},
            {key: v - before[1].get(key, 0.0) for key, v in after[1].items()
             if v != before[1].get(key, 0.0)},
            {tag: {f: v[f] - before[2].get(tag, {}).get(f, 0) for f in v}
             for tag, v in after[2].items() if v != before[2].get(tag)})
        self._graph, self._static_out = graph, out
        # The capture's host increments stand for this first replay.
        graph.replay()
        return out

    def _replay_counters(self) -> None:
        from .ops import registry
        from .timeline import metrics, spans
        launches, counters, legs = self._deltas
        for family, n in launches.items():
            registry.note_launch(family, n)
        metrics.add_counter_values(counters)
        spans.recorder().add_leg_totals(legs)


def _loop_optimizers(optimizer, step) -> list:
    zs = getattr(step, "zero_state", None)
    return [optimizer] + ([zs.inner] if zs is not None else [])


def make_train_loop(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    steps_per_execution: Optional[int] = None,
                    zero_stage: Optional[int] = None,
                    zero_compression=None,
                    microbatches: Optional[int] = None,
                    generators: Sequence[torch.Generator] = ()
                    ) -> TrainLoop:
    """Build ``loop(batches) -> losses`` (the JAX ``make_train_loop``):
    ``steps_per_execution`` (default ``HOROVOD_STEPS_PER_EXEC``) steps
    of :func:`make_train_step` a call, on ``[k, batch, ...]`` stacked
    batches, returning the ``[k]`` losses; on the GPU one CUDA graph a
    window (:class:`TrainLoop`).  The other arguments are
    :func:`make_train_step`'s (``microbatches > 1`` microbatches every
    step of the window); ``generators`` are the ``torch.Generator``\\ s
    the step draws from (dropout), registered with the graph.  k steps
    of the loop equal k step calls bitwise."""
    k = _resolve_steps(steps_per_execution)
    step = make_train_step(model, loss_fn, optimizer, zero_stage=zero_stage,
                           zero_compression=zero_compression,
                           microbatches=microbatches)
    return TrainLoop(step, k, model, _loop_optimizers(optimizer, step),
                     generators)


def make_flax_train_loop(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         steps_per_execution: Optional[int] = None,
                         zero_stage: Optional[int] = None,
                         zero_compression=None,
                         microbatches: Optional[int] = None,
                         generators: Sequence[torch.Generator] = ()
                         ) -> TrainLoop:
    """:func:`make_train_loop` of :func:`make_flax_train_step` (the JAX
    ``make_flax_train_loop``): ``loop(batches)`` on ``(x, y)`` pairs
    stacked ``[k, batch, ...]``, returning the ``[k]`` losses."""
    k = _resolve_steps(steps_per_execution)
    step = make_flax_train_step(model, optimizer, zero_stage=zero_stage,
                                zero_compression=zero_compression,
                                microbatches=microbatches)
    return TrainLoop(step, k, model, _loop_optimizers(optimizer, step),
                     generators)
