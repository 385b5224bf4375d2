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
:func:`sync_batch_norm` is the JAX package's cross-replica BatchNorm
(over a sub-mesh with ``axes=``).

The 3-D step (``tp=`` / ``pipeline_stages=`` on the step functions, defaults
``HOROVOD_TP`` / ``HOROVOD_PIPELINE_STAGES``): on a
:mod:`~horovod_tpu_torch.parallel.mesh` mesh (``build_3d_mesh``), the
model holds this rank's tensor-parallel shards or pipeline stage and the
loss computes with the collectives of :mod:`horovod_tpu_torch.parallel`
on the model axes, while everything the step reduces on its own behalf
-- the gradient exchange, the ZeRO-1 arena, the microbatch overlap, the
BatchNorm statistics and the loss average -- runs over the set of the
mesh's data axes (:func:`batch_sharding` gives a rank its rows).  On a
mesh with model axes the ``DistributedOptimizer`` must exchange over that
set and an error-feedback codec is refused
(:func:`_check_model_parallel_exchange`).

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

The SDC guard (``HOROVOD_GUARD``, :mod:`~horovod_tpu_torch.core.guard`),
when a step is built with it armed: the step screens its gradients --
``[nonfinite count, sum of squares]`` in f32, summed over the ranks in
one 8-byte allreduce (the plan IR's ``guard`` row) -- the raw local
gradients of the single-shot step, the merged gradient of the
microbatched one (before its error-feedback exchange).  A step whose
screen shows a nonfinite value (or a norm past
``HOROVOD_GUARD_NORM_LIMIT``) keeps the parameters, the optimizer state,
the error-feedback residuals, the ZeRO-1 shards and (flax step) the
BatchNorm statistics it started from, bit for bit; the host feeds each
step's ``[nonfinite, grad_norm, skipped]`` row (a loop window's ``[k,
3]`` rows) to the guard policy, which raises ``SustainedAnomalyError``
after ``HOROVOD_GUARD_STREAK`` skips in a row.  The step returns the
loss alone, as an unguarded one does.

With metrics on (``HOROVOD_METRICS``, the default) every step and loop
comes back wrapped in a sampler that records a ``StepReport`` and a
span summary per call (:class:`_InstrumentedStep`); other attributes
are the wrapped object's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .collectives.ops import (allgather_bucket, microbatch_pad_quantum,
                              psum_scatter_bucket_async, step_allreduce,
                              step_grouped_allreduce)
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
    """The resolved steps-per-execution k: the autotuner's current sample
    while one is active (its opt-in steps axis), else
    ``HOROVOD_STEPS_PER_EXEC`` once ``init()`` has run, else ``default``
    -- the window of :func:`make_train_loop` built without
    ``steps_per_execution``."""
    st = global_state()
    if st.autotuner is not None:
        return max(1, st.autotuner.steps_per_exec())
    if st.config is not None:
        return max(1, st.config.steps_per_exec)
    return max(1, default)


def _resolve_steps(k: Optional[int]) -> int:
    """``None`` defers to :func:`steps_per_execution`."""
    k = steps_per_execution() if k is None else int(k)
    if k < 1:
        raise ValueError(f"steps_per_execution must be >= 1, got {k}")
    return k


def microbatches(default: int = 1) -> int:
    """The resolved microbatch count k: the autotuner's current sample
    while one is active (its opt-in microbatch axis), else
    ``HOROVOD_MICROBATCHES`` once ``init()`` has run, else ``default``
    -- the step builders' default."""
    st = global_state()
    if st.autotuner is not None:
        return max(1, st.autotuner.microbatches())
    if st.config is not None:
        return max(1, st.config.microbatches)
    return max(1, default)


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


def _microbatch_unwrap(optimizer, data_set=None):
    """``(optimizer, exchange)`` for the microbatched step: the exchange
    a ``DistributedOptimizer`` wrap would have run (``None`` for a bare
    optimizer -- local accumulation, no collective, as the bare
    single-shot step).  The step runs the exchange itself and steps the
    wrap without its own (``skip_synchronize``).  Refused, as in the JAX
    package: ``backward_passes_per_step > 1``, a process set, an op
    other than Sum/Average (Adasum) and fp8.  The error-feedback codecs
    compose: the step accumulates locally and runs one ``ef_exchange``
    a step.  Under the autotuner, so is a compression axis holding a
    codec this exchange cannot run (``Autotuner.check_exchange``)."""
    from .collectives.compression import is_fp8
    if not isinstance(optimizer, _dist._DistributedOptimizer):
        return optimizer, None
    if optimizer._batched:
        raise ValueError(
            "microbatches > 1 runs the exchange inside the step; the "
            "native batcher (HVD_TPU_NATIVE_CORE=1) does not serve it")
    tuner = global_state().autotuner
    if tuner is not None and not optimizer._ef:
        tuner.check_exchange(optimizer._configured, "microbatch")
    if optimizer.backward_passes_per_step > 1:
        raise ValueError(
            "microbatches > 1 cannot combine with "
            "backward_passes_per_step > 1 (both are gradient-accumulation "
            "schemes; pick one)")
    ps = optimizer._process_set
    if ps is not None and not ps.is_global() and (
            data_set is None or ps.ranks != data_set.ranks):
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
                 order: Optional[Sequence[int]] = None, process_set=None):
        self._params = list(params)
        self._ps = process_set
        self._exchange = exchange
        self._k = k
        self._order = list(range(len(self._params))) if order is None \
            else list(order)
        if exchange is not None:
            self._plan()

    def _plan(self) -> None:
        ex = self._exchange
        self._world = global_state().size if self._ps is None \
            else self._ps.size()
        self._spec = plan_buckets([self._params[i] for i in self._order],
                                  ex["fusion_threshold"], reverse=True)
        legs = plan_exchange(
            "microbatch", buffers=tuple(
                (dt, sum(s.size for s in lspecs))
                for dt, lspecs in self._spec.buffers),
            k=self._k, world=self._world, compression=ex["compression"]
        ).legs
        nb = len(self._spec.buffers)
        self.rs_legs, self.ag_legs = legs[:nb], legs[nb:]

    def replan(self, optimizer) -> None:
        """Plan the buckets again under the current fusion threshold with
        the sample's codec (the tuned step, at a step boundary, after the
        wrap's own re-plan)."""
        tuner = global_state().autotuner
        if self._exchange is None or tuner is None:
            return
        comp = tuner.codec_for(optimizer._configured, "microbatch")
        self._exchange = dict(self._exchange, compression=comp)
        self._plan()

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
            pending.append((psum_scatter_bucket_async(
                c, quantum=quantum, process_set=self._ps), ctx))
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
                allgather_bucket(c, sum(s.size for s in lspecs),
                                 process_set=self._ps), ctx))
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


def _microbatch_core(model: torch.nn.Module, loss_fn,
                     optimizer: torch.optim.Optimizer, k: int,
                     screen: bool, data_set=None):
    """``(core, pipe)``: ``core(batch) -> (loss, screen)`` of
    ``microbatches=k > 1`` (the
    JAX ``_build_microbatch_local_step``): k forwards and
    ``torch.autograd.grad`` backwards through
    :class:`_MicrobatchGradPipe`, one optimizer step on the merged
    gradients, the loss the mean over the microbatches averaged over the
    ranks.  With a per-example-mean loss the merged gradient is the
    full batch's up to the f32 accumulation order.  With ``screen`` the
    guard screens the MERGED gradient (already summed over the ranks for
    a wrapped exchange) before the error-feedback exchange.  ``data_set``
    (the 3-D step's data set, ``None`` for every rank) is where the
    exchange and the loss average run."""
    optimizer, exchange = _microbatch_unwrap(optimizer, data_set)
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    order = None
    name_of = getattr(optimizer, "_name_of", None)
    if exchange is not None and name_of is not None:
        from .models.convert import flax_leaf_order
        order = flax_leaf_order([name_of[id(p)] for p in params])
    ef = _is_ef_exchange(exchange)
    pipe = _MicrobatchGradPipe(params, None if ef else exchange, k, order,
                               data_set)

    def core(batch):
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
        gvec = _guard_screen(reduced) if screen else None
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
        return step_allreduce(torch.stack(losses).mean(), Average,
                              process_set=data_set), gvec

    return core, pipe


def _step_core(model: torch.nn.Module, loss_fn,
               optimizer: torch.optim.Optimizer, zero_stage: int,
               zero_compression, screen: bool, data_set=None,
               param_specs=None, mesh=None):
    """``(core(batch) -> (loss, screen), zero_state)`` of the single-shot
    step: forward, backward (the wrap's hooks launch its buckets), the
    optimizer step or the ZeRO-1 update, the loss averaged over the
    ranks.  With ``screen`` the guard screens the raw LOCAL gradients
    (``p.grad`` after the backward, before the exchange writes the
    reduced ones back), as the JAX ``make_train_step`` does.  The ZeRO-1
    arena and the loss average run over ``data_set`` (every rank when
    ``None``); given ``param_specs`` naming every trainable parameter,
    the arena is ``zero_init(param_specs=)``'s, in the JAX package's
    leaf order."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    state = None
    if zero_stage:
        _zero._reject_distributed(optimizer)
        name_of = {id(p): n for n, p in model.named_parameters()}
        named = {name_of.get(id(p)): p for p in params}
        if param_specs is not None and set(named) == set(param_specs):
            state = _zero.zero_init(optimizer, named, mesh=mesh,
                                    compression=zero_compression,
                                    param_specs=param_specs,
                                    process_set=data_set)
        else:
            state = _zero.zero_init(optimizer, params,
                                    compression=zero_compression,
                                    process_set=data_set)

    def core(batch):
        loss = loss_fn(model, batch)
        loss.backward()
        gvec = _guard_screen([p.grad for p in params]) if screen else None
        if zero_stage:
            _zero.zero_apply(optimizer, [p.grad for p in params], state,
                             params, compression=zero_compression)
            optimizer.zero_grad(set_to_none=True)
        # The optimizer counts the passes; a plain one steps every call.
        elif getattr(optimizer, "exchange_ready", True):
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return step_allreduce(loss.detach(), Average,
                              process_set=data_set), gvec

    return core, state


# ---------------------------------------------------------------------------
# The SDC guard (core/guard.py): the in-step screen, verdict and select
# ---------------------------------------------------------------------------


def _guard_screen_vec(grads) -> torch.Tensor:
    """Local half of the SDC screen: ``[nonfinite_count, sum of
    squares]`` in f32 over the floating gradients (the JAX function of
    that name).  The norm half is a magnitude SCREEN: it saturates to
    inf past ~1e19, which the verdict treats as poisoned."""
    flat = [g.detach().reshape(-1).float() for g in grads
            if g is not None and g.is_floating_point()]
    if not flat:
        return torch.zeros(2, dtype=torch.float32)
    x = torch.cat(flat)
    nonfinite = torch.isfinite(x).logical_not().sum().to(torch.float32)
    return torch.stack([nonfinite, torch.dot(x, x)])


def _guard_screen(grads) -> torch.Tensor:
    """The screen summed over the ranks: one 8-byte allreduce, noted as
    the plan IR's ``guard/screen`` row."""
    note_leg(plan_exchange("guard").legs[0])
    return step_allreduce(_guard_screen_vec(grads), Sum)


def _guard_verdict(gvec: torch.Tensor, norm_limit: float):
    """``(nonfinite, norm, bad)`` from the summed screen vector."""
    nonfinite = gvec[0]
    norm = torch.sqrt(gvec[1])
    bad = (nonfinite > 0) | ~torch.isfinite(norm)
    if norm_limit and norm_limit > 0:
        bad = bad | (norm > norm_limit)
    return nonfinite, norm, bad


def _guard_select(bad: torch.Tensor, old: Sequence[torch.Tensor],
                  new: Sequence[torch.Tensor]) -> None:
    """A poisoned step keeps the OLD tensors, written into ``new`` in
    place: ``torch.where`` returns ``old`` exactly where ``bad`` holds,
    a NaN in ``new`` included (an arithmetic mask would carry it)."""
    for o, n in zip(old, new):
        torch.where(bad.to(n.device), o, n, out=n)


class _GuardState:
    """The tensors a poisoned step must leave bit for bit: the trainable
    parameters, the model's buffers (BatchNorm statistics, for the flax
    step), every optimizer state tensor, a wrap's error-feedback
    residuals (updated in place by the exchange, so copied before it)
    and a ZeRO-1 state's shards and residuals.  :meth:`save` copies them
    into buffers kept from step to step; :meth:`select` puts them back
    on a poisoned step with no host branch, so the step is the same
    eagerly and inside a CUDA graph.  State an optimizer creates on its
    first step has no earlier value: on a poisoned step it is dropped
    (a host read of the verdict, on that step only)."""

    def __init__(self, model: torch.nn.Module, optimizers, zero_state,
                 buffers: bool):
        self._fixed = [p for p in model.parameters() if p.requires_grad]
        if buffers:
            self._fixed += list(model.buffers())
        if zero_state is not None:
            self._fixed += list(zero_state.shards) + \
                list(zero_state.residuals or ())
        self._optimizers = list(optimizers)
        self._key = None
        self._live: List[torch.Tensor] = []
        self._old: List[torch.Tensor] = []

    def _collect(self) -> List[torch.Tensor]:
        out = list(self._fixed)
        for opt in self._optimizers:
            for st in opt.state.values():
                out += [v for _, v in sorted(st.items())
                        if torch.is_tensor(v)]
            out += list(getattr(opt, "_residuals", None) or ())
        return out

    @torch.no_grad()
    def save(self) -> None:
        live = self._collect()
        key = tuple(id(t) for t in live)
        if key != self._key:
            self._key, self._live = key, live
            self._old = [torch.empty_like(t) for t in live]
        if live:
            torch._foreach_copy_(self._old, live)

    @torch.no_grad()
    def select(self, bad: torch.Tensor) -> None:
        _guard_select(bad, self._old, self._live)
        saved = set(self._key)
        fresh = [(st, k) for opt in self._optimizers
                 for st in opt.state.values() for k, v in st.items()
                 if torch.is_tensor(v) and id(v) not in saved]
        if fresh and bool(bad):
            for st, k in fresh:
                del st[k]


class _Step:
    """``step(batch) -> loss`` of a step builder: ``body(batch) ->
    (loss, screen)`` with the screen dropped (``zero_state``: the ZeRO-1
    state, or None; ``microbatches``: its k; ``replan()``: plan the
    exchange's buckets again, False while an accumulation is partway
    through)."""

    def __init__(self, body, zero_state, microbatches: int = 1,
                 replan: Callable[[], bool] = lambda: True):
        self._body = body
        self.zero_state = zero_state
        self.microbatches = microbatches
        self.replan = replan

    def __call__(self, batch) -> torch.Tensor:
        return self._body(batch)[0]


class _GuardedStep(_Step):
    """The host side of a guarded step (the JAX ``_GuardedStep``):
    :meth:`guarded` runs the step between :class:`_GuardState`'s save
    and select and returns ``(loss, [nonfinite, grad_norm, skipped])``;
    a call feeds that row to :func:`~horovod_tpu_torch.core.guard.policy`
    -- the guard's one host read a step, which may raise
    :class:`~horovod_tpu_torch.core.exceptions.SustainedAnomalyError` --
    and returns the loss alone, as an unguarded step does.  A
    :class:`TrainLoop` runs :meth:`guarded` and reads a window's ``[k,
    3]`` rows once."""

    def __init__(self, body, zero_state, microbatches: int,
                 replan: Callable[[], bool], state: _GuardState,
                 norm_limit: float):
        super().__init__(body, zero_state, microbatches, replan)
        self._state = state
        self._norm_limit = norm_limit

    def guarded(self, batch):
        self._state.save()
        loss, gvec = self._body(batch)
        nonfinite, norm, bad = _guard_verdict(gvec, self._norm_limit)
        self._state.select(bad)
        return loss, torch.stack([nonfinite, norm, bad.to(torch.float32)])

    def __call__(self, batch) -> torch.Tensor:
        loss, row = self.guarded(batch)
        _observe_guard_rows(row)
        return loss


def _observe_guard_rows(rows: torch.Tensor) -> None:
    from .core import guard
    guard.policy().observe(rows.detach().cpu().numpy())


def _resolve_tp(tp: Optional[int]) -> int:
    """``None`` defers to the configured default (``HOROVOD_TP``)."""
    if tp is None:
        cfg = global_state().config
        tp = cfg.tp if cfg is not None else 1
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return tp


def _resolve_pipeline_stages(pipeline_stages: Optional[int]) -> int:
    """``None`` defers to the configured default
    (``HOROVOD_PIPELINE_STAGES``)."""
    if pipeline_stages is None:
        cfg = global_state().config
        pipeline_stages = cfg.pipeline_stages if cfg is not None else 1
    pipeline_stages = int(pipeline_stages)
    if pipeline_stages < 1:
        raise ValueError(
            f"pipeline_stages must be >= 1, got {pipeline_stages}")
    return pipeline_stages


def _resolve_model_axes(mesh, tp: int, pipeline_stages: int):
    """``(data_axes, model_axes)`` of ``mesh`` (a
    :class:`~horovod_tpu_torch.parallel.mesh.RankMesh`) for a step built
    with ``tp`` / ``pipeline_stages``, the declared extents checked
    against the mesh's (the JAX function).  The data axes are the
    gradient-exchange domain: every collective the step emits on its own
    behalf runs over their set only."""
    from .parallel import mesh as _pmesh
    names = tuple(mesh.axis_names)

    def check(extent: int, axis: str, knob: str) -> None:
        have = int(mesh.shape[axis]) if axis in names else 1
        if extent > 1 and have != extent:
            raise ValueError(
                f"{knob}={extent} needs a mesh {axis!r} axis of extent "
                f"{extent} (build_3d_mesh); mesh axes are "
                f"{dict(mesh.shape)}")
        if extent == 1 and have > 1:
            raise ValueError(
                f"mesh has a {axis!r} axis of extent {have} but the step "
                f"was built with {knob}={extent}; pass {knob}={have}")

    check(tp, _pmesh.MODEL_AXIS, "tp")
    check(pipeline_stages, _pmesh.PIPE_AXIS, "pipeline_stages")
    d_ax = _pmesh.data_axes(mesh)
    m_ax = tuple(a for a in names if a not in d_ax)
    return d_ax, m_ax


def _check_model_parallel_exchange(optimizer, d_ax, m_ax, data_set) -> None:
    """Refuse a wrap whose gradient exchange would reduce over the model
    axes (the JAX function): on a model-parallel mesh a
    ``DistributedOptimizer`` must exchange over the data axes' set
    (``process_set=mesh.group(data_axes(mesh))``) -- over every rank it
    would sum gradients of DIFFERENT parameter shards -- and an
    error-feedback codec is refused (its residuals are planned from the
    whole model's shapes, not a rank's shards)."""
    if not m_ax or not isinstance(optimizer, _dist._DistributedOptimizer):
        return
    if optimizer._ef:
        raise NotImplementedError(
            "error-feedback codecs (powersgd/topk) do not yet compose "
            "with tp/pipeline_stages: the residual carry is planned from "
            "the global parameter shapes, not the TP-local shards.  Use "
            "fp16/bf16 compression on the DP leg instead")
    ps = optimizer._process_set
    ranks = ps.ranks if ps is not None else \
        tuple(range(global_state().size))
    if ranks != data_set.ranks:
        raise ValueError(
            f"DistributedOptimizer on a model-parallel mesh must be built "
            f"with process_set=mesh.group({tuple(d_ax)}) (the data axes' "
            f"set, ranks {data_set.ranks}) so the gradient exchange never "
            f"reduces over the model axes {tuple(m_ax)}; got ranks "
            f"{ranks}")


def _data_set(tp, pipeline_stages, mesh, optimizer):
    """``(tp, pipeline_stages, data set)`` of a step: the data axes' set
    of ``mesh`` (the current mesh when ``None``), checked, or ``None``
    -- every rank -- without a mesh."""
    from .parallel.mesh import current_mesh
    tp = _resolve_tp(tp)
    pipeline_stages = _resolve_pipeline_stages(pipeline_stages)
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        if tp > 1 or pipeline_stages > 1:
            raise ValueError(
                f"tp={tp} / pipeline_stages={pipeline_stages} need a mesh "
                f"with 'model' / 'pipe' axes (build_3d_mesh)")
        return tp, pipeline_stages, None
    d_ax, m_ax = _resolve_model_axes(mesh, tp, pipeline_stages)
    data_set = mesh.group(d_ax)
    _check_model_parallel_exchange(optimizer, d_ax, m_ax, data_set)
    if data_set.hier is not None and \
            isinstance(optimizer, _dist._DistributedOptimizer) and \
            optimizer._process_set is None:
        # Two data axes (dcn, inner): the wrap exchanges over their set,
        # two-level where the JAX step's exchange over the axes is.
        optimizer.bind_data_set(data_set)
    return tp, pipeline_stages, data_set


def _build_step(model: torch.nn.Module, loss_fn,
                optimizer: torch.optim.Optimizer, zero_stage, zero_compression,
                microbatches, flax: bool, tp=None, pipeline_stages=None,
                param_specs=None, mesh=None) -> _Step:
    """The step both builders return (before the sampler wraps it):
    the single-shot or microbatched core, then -- for the flax step --
    the BatchNorm running statistics averaged over the ranks, under the
    guard when ``HOROVOD_GUARD`` arms it.  On a mesh, everything the step
    reduces on its own behalf runs over the data axes' set."""
    tp, stages, data_set = _data_set(tp, pipeline_stages, mesh, optimizer)
    zero_stage = _resolve_zero_stage(zero_stage)
    k_micro = _resolve_microbatches(microbatches)
    if zero_stage and k_micro > 1:
        raise ValueError(
            "microbatches > 1 is incompatible with zero_stage=1 (the "
            "ZeRO-1 arena reduce-scatter is already shard-based; overlap "
            "it via HOROVOD_EXCHANGE_CHUNK_MB instead)")
    from .core import guard
    guard_on, norm_limit = guard.step_guard(global_state().config)
    pipe = None
    if k_micro > 1:
        core, pipe = _microbatch_core(model, loss_fn, optimizer, k_micro,
                                      guard_on, data_set)
        zero_state = None
    else:
        core, zero_state = _step_core(model, loss_fn, optimizer, zero_stage,
                                      zero_compression, guard_on, data_set,
                                      param_specs, mesh)
    wrap = optimizer if isinstance(optimizer, _dist._DistributedOptimizer) \
        else None

    def replan() -> bool:
        # ZeRO-1 and a bare optimizer read the tuner per call: nothing to
        # plan again.  Partway through a backward_passes_per_step
        # accumulation the wrap's buckets stay until its end.
        if wrap is None:
            return True
        if any(wrap._counter):
            return False
        wrap.replan()
        if pipe is not None:
            pipe.replan(wrap)
        return True
    stats = [b for b in model.buffers() if b.is_floating_point()] \
        if flax else []

    def body(batch):
        if flax:
            model.train()
        loss, gvec = core(batch)
        if stats:
            with torch.no_grad():
                torch._foreach_copy_(stats, step_grouped_allreduce(
                    stats, Average, process_set=data_set))
        return loss, gvec

    if not guard_on:
        step = _Step(body, zero_state, k_micro, replan)
    else:
        optimizers = [optimizer] + ([zero_state.inner]
                                    if zero_state is not None else [])
        step = _GuardedStep(body, zero_state, k_micro, replan,
                            _GuardState(model, optimizers, zero_state,
                                        buffers=flax), norm_limit)
    step.tp, step.pipeline_stages = tp, stages
    step.param_specs, step.data_set = param_specs, data_set
    step._meta = _step_meta(model, optimizer, zero_stage, zero_compression,
                            k_micro, guard_on, tp, stages, param_specs,
                            mesh, data_set, zero_state, flax)
    return step


def _step_meta(model, optimizer, zero_stage, zero_compression, k_micro,
               guard_on, tp, stages, param_specs, mesh, data_set,
               zero_state, flax) -> dict:
    """The builder's description of its step (the JAX builders' ``meta``
    keys): what the exchange accounting and the step auditor
    (``analysis.stepmodel``) price the step's collectives from.  The data
    axes are the mesh's (``hvd``, or ``dcn``/``ici`` on a two-level
    world, without one) and ``world`` their set's size."""
    from .core.topology import hier_mesh_shape
    from .parallel.mesh import current_mesh, data_axes
    mesh = mesh if mesh is not None else current_mesh()
    world = data_set.size() if data_set is not None else \
        global_state().size
    if mesh is not None:
        axes = tuple(data_axes(mesh))
        shape = tuple((a, int(n)) for a, n in mesh.shape.items())
    else:
        hier = hier_mesh_shape()
        axes = ("dcn", "ici") if hier is not None else ("hvd",)
        shape = tuple(zip(axes, hier if hier is not None else (world,)))
    extents = dict(shape)
    return {"optimizer": optimizer, "model": model,
            "zero_stage": zero_stage, "zero_compression": zero_compression,
            "microbatches": k_micro, "guard": guard_on, "tp": tp,
            "pipeline_stages": stages,
            "data_mesh": tuple(int(extents[a]) for a in axes),
            "data_axes": axes, "mesh_shape": shape,
            "param_specs": param_specs, "world": int(world),
            "flax": flax, "data_set": data_set, "zero_state": zero_state}


def make_train_step(model: torch.nn.Module,
                    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer,
                    zero_stage: Optional[int] = None,
                    zero_compression=None,
                    microbatches: Optional[int] = None,
                    tp: Optional[int] = None,
                    pipeline_stages: Optional[int] = None,
                    param_specs=None, mesh=None
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
    Under the SDC guard (module docstring) a poisoned step is skipped.

    ``tp`` / ``pipeline_stages`` (defaults ``HOROVOD_TP`` /
    ``HOROVOD_PIPELINE_STAGES``) build the 3-D step over ``mesh`` (the
    current :mod:`~horovod_tpu_torch.parallel.mesh` mesh when ``None``;
    module docstring): ``model`` holds this rank's shards (e.g.
    ``models.BertTP``), ``loss_fn`` computes with the tensor-parallel
    collectives, and the gradient exchange, the ZeRO-1 arena, the
    microbatch overlap and the loss average run over the data axes' set
    only.  A ``DistributedOptimizer`` must then exchange over that set
    (``process_set=mesh.group(data_axes(mesh))``); an error-feedback
    codec is refused.  ``param_specs`` (``parallel.tp_param_specs``)
    says which leaves are split; the step keeps it (``step.param_specs``,
    beside ``step.data_set``) for ``parallel.gather_tp_params``, which
    reassembles the full tree a checkpoint saves.
    """
    step = _build_step(model, loss_fn, optimizer, zero_stage,
                       zero_compression, microbatches, flax=False, tp=tp,
                       pipeline_stages=pipeline_stages,
                       param_specs=param_specs, mesh=mesh)
    return _instrument(_maybe_tuned(step, step.replan, 1, optimizer), 1,
                       step._meta)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` ``[N, classes]`` against integer
    ``labels`` ``[N]`` (``optax.softmax_cross_entropy_with_integer_labels
    (...).mean()``), computed in f32 (f64 logits stay f64)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    return F.cross_entropy(logits, labels.long())


def _flax_loss(loss_fn: Optional[Callable]) -> Callable:
    """The step's ``loss(model, (x, y))`` for the JAX ``loss_fn(logits,
    y)`` argument: ``loss_fn(model(x), y)``, :func:`softmax_xent` when
    ``None``."""
    fn = loss_fn or softmax_xent

    def loss(m: torch.nn.Module, batch) -> torch.Tensor:
        x, y = batch
        return fn(m(x), y)

    return loss


def make_flax_train_step(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         loss_fn: Optional[Callable] = None,
                         zero_stage: Optional[int] = None,
                         zero_compression=None,
                         microbatches: Optional[int] = None,
                         tp: Optional[int] = None,
                         pipeline_stages: Optional[int] = None,
                         param_specs=None, mesh=None
                         ) -> Callable[[Any], torch.Tensor]:
    """Build ``step((x, y)) -> loss`` for a model with batch statistics.

    Each step puts ``model`` in train mode, runs :func:`make_train_step`'s
    step on ``softmax_xent(model(x), y)`` -- the forward updates every
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
    single-shot step.  A step the SDC guard skips keeps the running
    statistics too.  ``tp``, ``pipeline_stages``, ``param_specs`` and
    ``mesh``: see :func:`make_train_step` (the statistics average over
    the data axes' set).  ``loss_fn(logits, y)`` (the JAX argument)
    replaces the default ``softmax_xent(logits, y)``.
    """
    step = _build_step(model, _flax_loss(loss_fn), optimizer, zero_stage,
                       zero_compression, microbatches, flax=True, tp=tp,
                       pipeline_stages=pipeline_stages,
                       param_specs=param_specs, mesh=mesh)
    return _instrument(_maybe_tuned(step, step.replan, 1, optimizer), 1,
                       step._meta)


def sync_batch_norm(axes=None, **kwargs) -> BatchNorm:
    """A :class:`~horovod_tpu_torch.ops.bn.BatchNorm` whose batch
    statistics span the ranks: the counterpart of the JAX package's
    ``sync_batch_norm`` (flax's ``BatchNorm(axis_name=...)``, a ``pmean``
    of the statistics over the mesh).  ``kwargs`` are the module's
    (``features``, ``momentum``, ``epsilon``, ``dtype``, ...), and its
    parameter and ``batch_stats`` names are the plain module's, so
    checkpoints convert alike.  The forward averages the local f32
    ``(mean, mean of squares)`` over the ranks; the backward sums the two
    gradient statistics between the BN kernels' passes; ``scale`` and
    ``bias`` get local sums, which the DistributedOptimizer averages.
    ``axes`` (a name or tuple of named mesh axes,
    :mod:`~horovod_tpu_torch.parallel.mesh`) spans the statistics over
    that sub-mesh's set only -- flax's ``axis_name=axes`` -- resolved here
    against the current mesh, so build the mesh first; ``None`` spans
    every rank (the JAX default: every axis of the mesh)."""
    ps = None
    if axes is not None:
        from .parallel.mesh import axis_set
        ps = axis_set(axes)
    return BatchNorm(sync=True, process_set=ps, **kwargs)


def mirror_opt_state_specs(optimizer: torch.optim.Optimizer,
                           model: torch.nn.Module, param_specs
                           ) -> dict:
    """``{parameter name: {state key: spec}}`` mirroring ``param_specs``
    onto the optimizer's state (the JAX function): each state tensor of
    its parameter's shape (Adam's moments, SGD's momentum) takes the
    parameter's spec, every other entry (a step count) ``()``.  A torch
    optimizer keeps state per parameter, so on a rank the moments are
    already this rank's shards; the specs say how to gather them
    (``parallel.gather_tp_params``).  Reads the state the optimizer has
    (it is created at the first step)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for p, st in optimizer.state.items():
        name = names.get(id(p))
        if name is None:
            continue
        spec = tuple(param_specs.get(name, ()))
        out[name] = {k: spec if torch.is_tensor(v) and v.shape == p.shape
                     else () for k, v in st.items()}
    return out


def batch_sharding(mesh=None) -> tuple:
    """``(index, count)``: this rank's shard of the batch on ``mesh`` (the
    current mesh when ``None``; ``(rank, size)`` without one) -- dim 0
    splits over the data axes only, so every tensor-parallel rank and
    pipeline stage of a data shard sees the same rows (the JAX
    ``batch_sharding``'s ``P(data_axes)``)."""
    from .parallel.mesh import current_mesh, data_axes
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        st = global_state()
        return st.rank, st.size
    axes = data_axes(mesh)
    return mesh.axis_index(axes), mesh.axis_size(axes)


def shard_batch(batch, mesh=None):
    """This rank's rows of a global ``batch`` (every leaf split on dim 0
    by :func:`batch_sharding`)."""
    index, count = batch_sharding(mesh)

    def rows(x):
        if x.shape[0] % count:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {count} data shards")
        n = x.shape[0] // count
        return x[index * n:(index + 1) * n]

    return tree_map(rows, batch)


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
        return step_allreduce(v, Average)

    def eval_step(model: torch.nn.Module, batch):
        with torch.no_grad():
            return average(metric_fn(model, batch))

    return eval_step


def _refuse_batched(optimizer) -> None:
    """The loops refuse a wrap on the native batcher (``ValueError``):
    its background thread cannot dispatch inside a graph capture."""
    if _dist.is_batched(optimizer):
        raise ValueError(
            "make_train_loop / make_flax_train_loop capture the window as "
            "a CUDA graph, where the native batcher's background thread "
            "cannot dispatch; unset HVD_TPU_NATIVE_CORE for the loop")


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
      a capture on the new process group;
    * under the autotuner, a changed ``trace_key()`` re-plans the buckets
      the graph holds: the tuned loop drops the graph the same way
      (:meth:`restart`), so each sample runs an eager window, a capture
      and then replays, and neither of the first two is scored.

    What the capture records on the host -- the kernels' launch
    counters, the metrics registry's counters (exchange, collective,
    ZeRO-1, sync BN) and the span leg registry -- it adds again at every
    later replay, so they count the steps the card runs.  Under the SDC
    guard the window runs each step's screen, verdict and select (inside
    the graph on the GPU) and the host reads the window's ``[k, 3]``
    guard rows once, after it, for the guard policy.  Nothing falls
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
        # What the last call ran: "cpu" (k eager steps on the CPU),
        # "eager", "capture" or "replay" (the GPU's three kinds).
        self.last_kind: Optional[str] = None

    def restart(self) -> None:
        """Drop the captured graph: the next call runs an eager window and
        the one after it captures again (the tuned loop, after the
        autotuner's sample changed the buckets the graph holds)."""
        self._graph = self._static_out = self._static_in = None
        self._calls = 0

    def _window(self, batches):
        """``(losses [k], guard rows [k, 3] or None)`` of k steps."""
        guarded = getattr(self.step, "guarded", None)
        outs = [guarded(b) if guarded is not None else (self.step(b), None)
                for b in (tree_map(lambda x, i=i: x[i], batches)
                          for i in range(self.steps_per_execution))]
        losses = torch.stack([loss for loss, _ in outs])
        if guarded is None:
            return losses, None
        return losses, torch.stack([row for _, row in outs])

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
            self.last_kind = "cpu"
            return self._observed(self._window(batches))
        gen = global_state().generation
        if gen != self._generation:
            self.restart()
            self._generation = gen
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
                self.last_kind = "eager"
                out = self._window(batches)
            elif self._graph is None or \
                    self._hyper != _hyperparameters(self._optimizers):
                self.last_kind = "capture"
                out = self._capture(batches)
            else:
                tree_map(lambda d, x: d.copy_(x, non_blocking=True),
                         self._static_in, batches)
                self._replay_counters()
                self._graph.replay()
                self.last_kind = "replay"
                out = self._static_out
        caller.wait_stream(side)
        for t in out:
            if t is not None:
                t.record_stream(caller)
        self._calls += 1
        return self._observed(out)

    @staticmethod
    def _observed(out) -> torch.Tensor:
        """The window's losses, its guard rows fed to the policy first."""
        losses, rows = out
        if rows is not None:
            _observe_guard_rows(rows)
        return losses

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
                    generators: Sequence[torch.Generator] = (),
                    tp: Optional[int] = None,
                    pipeline_stages: Optional[int] = None,
                    param_specs=None, mesh=None):
    """Build ``loop(batches) -> losses`` (the JAX ``make_train_loop``):
    ``steps_per_execution`` (default ``HOROVOD_STEPS_PER_EXEC``) steps
    of :func:`make_train_step` a call, on ``[k, batch, ...]`` stacked
    batches, returning the ``[k]`` losses; on the GPU one CUDA graph a
    window (:class:`TrainLoop`).  The other arguments are
    :func:`make_train_step`'s (``microbatches > 1`` microbatches every
    step of the window); ``generators`` are the ``torch.Generator``\\ s
    the step draws from (dropout), registered with the graph.  k steps
    of the loop equal k step calls bitwise."""
    _refuse_batched(optimizer)
    k = _resolve_steps(steps_per_execution)
    step = _build_step(model, loss_fn, optimizer, zero_stage,
                       zero_compression, microbatches, flax=False, tp=tp,
                       pipeline_stages=pipeline_stages,
                       param_specs=param_specs, mesh=mesh)
    loop = TrainLoop(step, k, model, _loop_optimizers(optimizer, step),
                     generators)
    loop._meta = step._meta
    return _instrument(_maybe_tuned(loop, step.replan, k, optimizer), k,
                       step._meta)


def make_flax_train_loop(model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         loss_fn: Optional[Callable] = None,
                         steps_per_execution: Optional[int] = None,
                         zero_stage: Optional[int] = None,
                         zero_compression=None,
                         microbatches: Optional[int] = None,
                         generators: Sequence[torch.Generator] = (),
                         tp: Optional[int] = None,
                         pipeline_stages: Optional[int] = None,
                         param_specs=None, mesh=None):
    """:func:`make_train_loop` of :func:`make_flax_train_step` (the JAX
    ``make_flax_train_loop``): ``loop(batches)`` on ``(x, y)`` pairs
    stacked ``[k, batch, ...]``, returning the ``[k]`` losses;
    ``loss_fn`` as :func:`make_flax_train_step`'s."""
    _refuse_batched(optimizer)
    k = _resolve_steps(steps_per_execution)
    step = _build_step(model, _flax_loss(loss_fn), optimizer, zero_stage,
                       zero_compression, microbatches, flax=True, tp=tp,
                       pipeline_stages=pipeline_stages,
                       param_specs=param_specs, mesh=mesh)
    loop = TrainLoop(step, k, model, _loop_optimizers(optimizer, step),
                     generators)
    loop._meta = step._meta
    return _instrument(_maybe_tuned(loop, step.replan, k, optimizer), k,
                       step._meta)


# ---------------------------------------------------------------------------
# The autotuner's score loop (the JAX ``_maybe_tuned``)
# ---------------------------------------------------------------------------


def _maybe_tuned(fn, replan: Callable[[], bool], steps: int, optimizer):
    """``fn`` (a step, or a :class:`TrainLoop` of ``steps`` steps; its
    step's ``replan``) in :class:`_TunedStep` while the autotuner is
    active (``HOROVOD_AUTOTUNE=1``), else ``fn`` itself."""
    tuner = global_state().autotuner
    if tuner is None:
        return fn
    return _TunedStep(fn, tuner, replan, steps, optimizer)


class _TunedStep:
    """The autotuner's score loop around a step or a loop.  While the
    tuner is not ``done``, each call:

    * re-plans the exchange's buckets (``replan``) when the tuner's
      ``trace_key()`` changed since the last call -- at a step boundary,
      with no handle outstanding; partway through a
      ``backward_passes_per_step`` accumulation, at its end -- and makes
      a loop capture its graph again (:meth:`TrainLoop.restart`);
    * times the call, fenced by reading the loss as a float (a loop's
      last), and feeds ``record_step(seconds, trainable bytes x steps)``;
      a loop's eager and capture windows are not scored.

    Once the tuner is ``done`` a call is the wrapped one's, but for the
    one re-plan to the best configuration: no fence, no timing.
    ``trail`` lists ``(trace_key, kind, scored)`` a call while tuning
    (``kind``: ``"step"``, or the loop's ``last_kind``).  Every other
    attribute is the wrapped object's."""

    def __init__(self, fn, tuner, replan, steps: int, optimizer):
        self._fn = fn
        self._tuner = tuner
        self._replan = replan
        self._loop = fn if isinstance(fn, TrainLoop) else None
        # The step was built under the tuner's current sample.
        self._key = tuner.trace_key()
        self._nbytes = steps * sum(
            p.numel() * p.element_size() for g in optimizer.param_groups
            for p in g["params"] if p.requires_grad)
        self.trail: List[tuple] = []

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, batch):
        import time as _time
        tuner = self._tuner
        key = tuner.trace_key()
        if key != self._key and self._replan():
            if self._loop is not None:
                self._loop.restart()
            self._key = key
        if tuner.done:
            return self._fn(batch)
        t0 = _time.perf_counter()
        out = self._fn(batch)
        float(out.reshape(-1)[-1])          # the fence: read the loss
        seconds = _time.perf_counter() - t0
        kind = "step" if self._loop is None else self._loop.last_kind
        scored = tuner.record_step(seconds, self._nbytes,
                                   warmup=kind in ("eager", "capture"))
        self.trail.append((key, kind, scored))
        return out


# ---------------------------------------------------------------------------
# The step sampler: a StepReport and a span summary per call
# ---------------------------------------------------------------------------


def _instrument(fn, steps: int, meta: dict):
    """``fn`` wrapped in :class:`_InstrumentedStep` (``steps`` optimizer
    steps a call), or ``fn`` itself -- which keeps the builder's ``meta``
    as ``_meta`` -- when ``HOROVOD_METRICS=0``."""
    from .timeline import metrics as _metrics
    if not _metrics.registry().enabled:
        return fn
    return _InstrumentedStep(fn, steps, meta)


class _InstrumentedStep:
    """Host-side sampler around a step or a loop (the JAX
    ``_InstrumentedStep``): each call's wall time -- the dispatch, which
    ends when the call returns (the loss is read later) -- becomes a
    :class:`~horovod_tpu_torch.timeline.metrics.StepReport`, and the
    span recorder books the call as ``dispatch`` and the host time since
    the previous call's return as ``dispatch_gap`` (mirrored into an
    open timeline), then closes the step with ``step_boundary``, which
    feeds the straggler monitor and the trace plane.  Every other
    attribute is the wrapped object's.  The exchange accounting is
    computed once, from shapes, and degrades to zeros on failure: it
    must never break training."""

    def __init__(self, fn, steps: int, meta: dict):
        self._fn = fn
        self._steps = max(int(steps), 1)
        self._meta = meta
        self._accounting = None
        self._step_count = 0
        self._last_end: Optional[float] = None

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def _account(self):
        if self._accounting is None:
            try:
                self._accounting = _step_exchange_accounting(
                    self._meta, getattr(self._fn, "zero_state", None))
            except Exception:
                self._accounting = ("unknown", 0, 0)
        return self._accounting

    def __call__(self, *args):
        import time as _time

        from .timeline import metrics as _metrics
        from .timeline import spans as _spans
        reg = _metrics.registry()
        if not reg.enabled:
            return self._fn(*args)
        codec, wire, raw = self._account()
        rec = _spans.recorder()
        step = self._step_count + self._steps
        rec.set_step(step)
        t0 = _time.perf_counter()
        t0_unix_us = _time.time() * 1e6
        gap = (t0 - self._last_end) if self._last_end is not None else 0.0
        if gap > 0:
            rec.add("dispatch_gap", gap, emit=True)
        with rec.span("dispatch", name="step"):
            out = self._fn(*args)
        t1 = _time.perf_counter()
        wall = t1 - t0
        self._last_end = t1
        self._step_count += self._steps
        try:
            _metrics.record_step_report(_metrics.StepReport(
                step=self._step_count, wall_time_s=wall,
                steps_per_exec=self._steps,
                microbatches=self._meta["microbatches"],
                zero_stage=int(getattr(self._fn, "zero_state", None)
                               is not None),
                codec=codec, exchanged_bytes=wire,
                uncompressed_bytes=raw))
            # The step's wall includes the dispatch gap (a late host is
            # a late rank); its wall-clock anchor backs up to the gap's
            # start.
            rec.step_boundary(step, wall + gap,
                              t0_unix_us=t0_unix_us - gap * 1e6)
        except Exception:
            pass
        return out


def _step_exchange_accounting(meta: dict, zero_state):
    """``(codec, wire_bytes, uncompressed_bytes)`` of one optimizer
    step's exchange a rank: ZeRO-1 as ``zero_report`` prices it, a
    ``DistributedOptimizer`` wrap by ``wire_payload_bytes`` over its
    bucket plan, a bare optimizer no wire at all."""
    from .collectives.compression import parse_compression, \
        wire_payload_bytes
    optimizer = meta["optimizer"]
    params = [p for p in meta["model"].parameters() if p.requires_grad]
    raw = sum(p.numel() * p.element_size() for p in params)
    if zero_state is not None:
        comp = meta["zero_compression"]
        rep = _zero.zero_report(optimizer, params,
                                global_state().size, compression=comp)
        codec = getattr(parse_compression(comp), "__name__", "none") \
            if comp else "none"
        return (codec, int(rep["zero1_exchanged_bytes_per_chip"]),
                int(rep["replicated_allreduce_bytes_per_chip"]))
    if not isinstance(optimizer, _dist._DistributedOptimizer):
        return ("none", 0, raw)
    comp = optimizer._compression
    wire = sum(wire_payload_bytes(comp, sum(s.size for s in lspecs),
                                  dt.itemsize)
               for dt, lspecs in optimizer.bucket_plan.buffers)
    return (getattr(comp, "__name__", type(comp).__name__), int(wire), raw)
