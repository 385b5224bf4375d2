"""Gradient exchange and ``DistributedOptimizer``.

Counterpart of ``horovod_tpu/optim/distributed.py`` (the flat branch of
``allreduce_gradients``) and of ``horovod_tpu/torch_api/optimizer.py``
(``_DistributedOptimizer``, the torch hook semantics).

:func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` so that
``step()`` sees gradients averaged over every rank:

* only parameters with ``requires_grad`` are exchanged (a LoRA fine-tune
  with a frozen base sends its adapters and nothing else);
* at wrap time they are planned into fusion buckets once
  (``plan_buckets(..., reverse=True)``: per dtype, at most the fusion
  threshold each, in the order the backward pass produces them);
* a post-accumulate-grad hook on every parameter marks its gradient
  ready; when the last gradient of a bucket arrives, the bucket is packed
  into one flat buffer, compressed (``Compression.none/fp16/bf16``) and
  its allreduce launched asynchronously, so communication overlaps the
  rest of the backward pass;
* ``synchronize()`` launches any bucket still waiting (with ``p.grad``
  as it stands, zeros where a parameter has none), drains every handle,
  decompresses and writes the averaged gradients back into ``p.grad``,
  and re-raises the first error once every handle is drained;
* ``step()`` synchronizes first; ``backward_passes_per_step = n``
  accumulates ``n`` backward passes locally and exchanges their mean;
  ``gradient_predivide_factor = f`` scales by ``1/f`` before the sum and
  ``f/size`` after it.

``compression=None`` (the default) follows ``HOROVOD_COMPRESSION``, as
the JAX wrap does.  The error-feedback codec ``powersgd:<r>`` makes the
optimizer stateful: it plans its buckets as the JAX package's
``ef_bucket_plan`` does (forward, and -- given ``named_parameters`` -- in
the order and layout ``jax.tree.leaves`` sees the flax parameters, since
the matricized bucket is the matrix PowerSGD approximates), holds one
flat f32 residual per bucket (zero at wrap time), launches each bucket's
stage 1 and P allreduce from the hook of its last gradient, and finishes
the exchange in ``synchronize()``; the residual is replaced only once its
whole bucket has been exchanged and written back.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..collectives.compression import (Compression, is_error_feedback,
                                       parse_compression,
                                       wire_payload_bytes)
from ..collectives.ops import (Handle, allreduce_async_,
                               powersgd_allreduce_async)
from ..collectives.reduce_op import Average, ReduceOp, Sum
from ..controller.fusion import (FusionSpec, pack_bucket, plan_buckets,
                                 unpack, unpack_bucket)
from ..core.state import global_state
from ..models.convert import (flax_leaf_order, from_flax_layout,
                              to_flax_layout)
from ..timeline.metrics import exchange_counters, note_compression_ratio


def _resolve_compression(compression):
    """``None`` defers to ``HOROVOD_COMPRESSION`` (a spec string resolved
    through :func:`parse_compression`); an explicit codec or spec string
    is taken as it is.  Passing ``Compression.none`` explicitly disables
    the environment's default."""
    if compression is None:
        cfg = global_state().config
        return parse_compression(cfg.compression if cfg is not None
                                 else None)
    return parse_compression(compression)


def _ef_enabled() -> bool:
    """``HOROVOD_EF_RESIDUAL`` (default on): whether the error-feedback
    codec carries its residual across steps.  Off drops the compression
    error every step -- useful only for ablations."""
    cfg = global_state().config
    return cfg.ef_residual if cfg is not None else True


def _launch_bucket(grads, lspecs, op: ReduceOp, compression,
                   prescale_factor: float, postscale_factor: float,
                   divisor: int = 1) -> Tuple[Any, Any]:
    """Pack one bucket's gradients (``grads[s.index]`` for each leaf spec)
    into a new flat buffer, divide it by ``divisor`` (the accumulated
    passes), compress it and launch its async allreduce.  Returns
    ``(handle, ctx)``; ``compression.decompress(handle.wait(), ctx)`` is
    the reduced bucket.  Feeds the exchange counters."""
    buf = pack_bucket(grads, lspecs)
    if divisor > 1:
        buf.div_(divisor)
    wire, ctx = compression.compress(buf)
    handle = allreduce_async_(wire, op, prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor)
    m = exchange_counters()
    m["buckets"].inc()
    m["handles"].inc()
    m["wire_bytes"].inc(wire.numel() * wire.element_size())
    return handle, ctx


def _launch_ef_bucket(grads, lspecs, op: ReduceOp, compression,
                      residual: Optional[torch.Tensor],
                      prescale_factor: float,
                      postscale_factor: float) -> Handle:
    """Pack one bucket into a new flat buffer and start its PowerSGD
    exchange (stage 1 and the async P allreduce) with ``residual`` fed in
    (``None``: zeros).  ``handle.wait()`` returns ``(reduced bucket,
    new_residual)``; a non-floating bucket takes the plain allreduce and
    hands ``residual`` back unchanged.  Feeds the exchange counters."""
    buf = pack_bucket(grads, lspecs)
    m = exchange_counters()
    m["buckets"].inc()
    if not buf.dtype.is_floating_point:
        inner = allreduce_async_(buf, op, prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor)
        m["handles"].inc()
        m["wire_bytes"].inc(buf.numel() * buf.element_size())
        return Handle(None, lambda: (inner.wait(), residual))
    handle = powersgd_allreduce_async(
        buf, op, rank=compression.rank, residual=residual,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor)
    m["handles"].inc(2)
    m["wire_bytes"].inc(wire_payload_bytes(compression, buf.numel()))
    return handle


def allreduce_gradients(grads: Sequence[torch.Tensor],
                        op: ReduceOp = Average, *,
                        compression=Compression.none,
                        fusion_threshold: Optional[int] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0
                        ) -> List[torch.Tensor]:
    """Fused allreduce of a gradient list (the flat branch): pack per
    bucket, compress, allreduce, decompress, unpack.  Returns new tensors
    in the input order; the inputs are left as they are.

    An error-feedback codec runs its exchange here WITHOUT residual state
    (the stateful path is the ``DistributedOptimizer``'s): each bucket's
    compression error is dropped."""
    grads = list(grads)
    compression = parse_compression(compression)
    spec = plan_buckets(grads, fusion_threshold,
                        extra=(compression.__name__,))
    if is_error_feedback(compression):
        handles = [_launch_ef_bucket(grads, lspecs, op, compression, None,
                                     prescale_factor, postscale_factor)
                   for _, lspecs in spec.buffers]
        return unpack([h.wait()[0] for h in handles], spec)
    pending = [_launch_bucket(grads, lspecs, op, compression,
                              prescale_factor, postscale_factor)
               for _, lspecs in spec.buffers]
    return unpack([compression.decompress(h.wait(), ctx)
                   for h, ctx in pending], spec)


# ---------------------------------------------------------------------------
# Error feedback: the bucket plan, the residual state and the exchange
# ---------------------------------------------------------------------------


def ef_bucket_plan(leaves, fusion_threshold: Optional[int],
                   compression) -> FusionSpec:
    """The EF exchange's buckets: forward over ``leaves``, keyed by the
    codec (the JAX package's ``ef_bucket_plan``).  ``None`` takes the
    configured threshold, never a tuned one: the residuals' shapes follow
    the plan."""
    return plan_buckets(leaves, fusion_threshold,
                        extra=("ef", compression.__name__))


def ef_residual_shape(size: int, compression) -> tuple:
    """Per-bucket residual shape: ``(size,)``, the whole bucket's unsent
    error (the flat codecs; the per-leg codecs are not ported)."""
    if not is_error_feedback(compression):
        raise ValueError(f"{compression.__name__} carries no residual")
    return (int(size),)


def ef_init_residuals(params, fusion_threshold: Optional[int],
                      compression) -> Tuple[torch.Tensor, ...]:
    """Zero residuals matching the EF bucket plan of ``params``-shaped
    gradients: one flat f32 tensor per bucket, on its leaves' device (one
    rank per process, so no leading world axis)."""
    params = list(params)
    spec = ef_bucket_plan(params, fusion_threshold, compression)
    return tuple(
        torch.zeros(ef_residual_shape(sum(s.size for s in lspecs),
                                      compression),
                    dtype=torch.float32, device=params[lspecs[0].index].device)
        for _, lspecs in spec.buffers)


def _note_plan_bytes(spec: FusionSpec, compression) -> None:
    raw = wire = 0
    for dt, lspecs in spec.buffers:
        size = sum(s.size for s in lspecs)
        raw += size * dt.itemsize
        wire += wire_payload_bytes(compression, size, dt.itemsize)
    note_compression_ratio(raw, wire)


def ef_exchange(grads: Sequence[torch.Tensor],
                residuals: Sequence[torch.Tensor], *, compression,
                op: ReduceOp = Average,
                fusion_threshold: Optional[int] = None,
                prescale_factor: float = 1.0,
                postscale_factor: float = 1.0
                ) -> Tuple[List[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Error-feedback fused gradient exchange: ``(reduced grads,
    new_residuals)`` from the gradients and the previous step's residuals
    (one per bucket of :func:`ef_bucket_plan`).  With
    ``HOROVOD_EF_RESIDUAL=0`` the residuals are not fed in and come back
    unchanged."""
    grads = list(grads)
    if not grads:
        return grads, tuple(residuals)
    compression = parse_compression(compression)
    spec = ef_bucket_plan(grads, fusion_threshold, compression)
    if len(residuals) != len(spec.buffers):
        raise ValueError(
            f"EF residual carry has {len(residuals)} buckets but the plan "
            f"has {len(spec.buffers)} -- residuals initialized under a "
            f"different fusion threshold or codec?")
    feed = _ef_enabled()
    handles = [_launch_ef_bucket(grads, lspecs, op, compression,
                                 res if feed else None, prescale_factor,
                                 postscale_factor)
               for (_, lspecs), res in zip(spec.buffers, residuals)]
    outs, new_res = [], []
    for h, res in zip(handles, residuals):
        out, r_out = h.wait()
        outs.append(out)
        new_res.append(r_out if feed else res)
    _note_plan_bytes(spec, compression)
    return unpack(outs, spec), tuple(new_res)


def is_ef_optimizer(optimizer) -> bool:
    """True when ``optimizer`` is a ``DistributedOptimizer`` wrap whose
    codec carries error-feedback residuals."""
    return isinstance(optimizer, _DistributedOptimizer) and \
        is_error_feedback(optimizer._compression)


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin providing the bucketed hooks and ``synchronize``; never
    instantiated directly (see :func:`DistributedOptimizer`)."""

    def _init_distributed(self, named_parameters, compression, op,
                          backward_passes_per_step: int,
                          gradient_predivide_factor: float,
                          fusion_threshold: Optional[int]) -> None:
        f = float(gradient_predivide_factor)
        self._prescale, self._postscale = 1.0 / f, f
        if named_parameters is not None:
            # Horovod's contract: unique names, covering every parameter.
            keys = [k for k, _ in named_parameters]
            if len(set(keys)) != len(keys):
                dups = sorted({k for k in keys if keys.count(k) > 1})
                raise ValueError(
                    f"named_parameters contains duplicate names: {dups}")
            given = {id(p) for _, p in named_parameters}
            unnamed = sum(id(p) not in given for group in self.param_groups
                          for p in group["params"])
            if unnamed:
                raise ValueError(
                    f"named_parameters was given, but {unnamed} "
                    f"optimizer parameter(s) are not named in it")
        self._compression = compression
        self._op = op
        self._ef = is_error_feedback(compression)
        self.backward_passes_per_step = backward_passes_per_step
        self._trainable = [p for group in self.param_groups
                           for p in group["params"] if p.requires_grad]
        # The flax names of the trainable parameters, in _trainable's
        # order: only an EF wrap with names uses them (its buckets follow
        # the JAX package's leaf order and layout).
        self._names: Optional[List[str]] = None
        if self._ef and named_parameters is not None:
            name_of = {id(p): k for k, p in named_parameters}
            names = [name_of[id(p)] for p in self._trainable]
            order = flax_leaf_order(names)
            self._trainable = [self._trainable[i] for i in order]
            self._names = [names[i] for i in order]
        self._index = {p: i for i, p in enumerate(self._trainable)}
        if self._ef:
            # Forward over the (flax-ordered, flax-laid-out) leaves, as
            # the JAX ef_bucket_plan; one zero residual per bucket.
            leaves = [self._flax_view(i, p)
                      for i, p in enumerate(self._trainable)]
            self.bucket_plan = ef_bucket_plan(leaves, fusion_threshold,
                                              compression)
            self._residuals = list(ef_init_residuals(
                leaves, fusion_threshold, compression))
            _note_plan_bytes(self.bucket_plan, compression)
        else:
            # The fusion buckets of the trainable parameters, indexed in
            # optimizer order, first bucket first to be ready.
            self.bucket_plan = plan_buckets(self._trainable,
                                            fusion_threshold, reverse=True)
        self._bucket_of: Dict[int, int] = {}
        for b, (_, lspecs) in enumerate(self.bucket_plan.buffers):
            for s in lspecs:
                self._bucket_of[s.index] = b
        self._counter = [0] * len(self._trainable)
        self._ready: List[set] = [set() for _ in self.bucket_plan.buffers]
        self._handles: Dict[int, tuple] = {}
        for p in self._trainable:
            p.register_post_accumulate_grad_hook(self._hook)

    # -- hooks ------------------------------------------------------------
    def _hook(self, p: torch.Tensor) -> None:
        i = self._index[p]
        b = self._bucket_of[i]
        if b in self._handles or i in self._ready[b]:
            raise AssertionError(
                "gradient produced twice without synchronize(); call "
                "optimizer.synchronize() (or step()) every "
                "backward_passes_per_step backwards")
        self._counter[i] += 1
        if self._counter[i] < self.backward_passes_per_step:
            return  # local accumulation pass: no communication
        self._ready[b].add(i)
        if len(self._ready[b]) == len(self.bucket_plan.buffers[b][1]):
            self._launch(b)

    def _flax_view(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s tensor ``t`` as the EF bucket holds it."""
        return t if self._names is None else \
            to_flax_layout(self._names[i], t)

    def _launch(self, b: int) -> None:
        _, lspecs = self.bucket_plan.buffers[b]
        grads = {}
        for s in lspecs:
            p = self._trainable[s.index]
            grads[s.index] = p.grad if p.grad is not None \
                else torch.zeros_like(p)
        if self._ef:
            feed = _ef_enabled()
            for s in lspecs:
                grads[s.index] = self._flax_view(s.index, grads[s.index])
            self._handles[b] = (_launch_ef_bucket(
                grads, lspecs, self._op, self._compression,
                self._residuals[b] if feed else None, self._prescale,
                self._postscale), feed)
            return
        self._handles[b] = _launch_bucket(
            grads, lspecs, self._op, self._compression, self._prescale,
            self._postscale, divisor=self.backward_passes_per_step)

    @property
    def residuals(self) -> Tuple[torch.Tensor, ...]:
        """The error-feedback residuals, one flat f32 tensor per bucket of
        ``bucket_plan`` (empty for a codec without error feedback)."""
        return tuple(self._residuals) if self._ef else ()

    @property
    def exchange_ready(self) -> bool:
        """True once ``backward_passes_per_step`` backward passes have run
        since the last ``synchronize()``: the pass that completes the
        accumulation, after which ``step()`` applies the exchanged mean."""
        return max(self._counter, default=0) >= self.backward_passes_per_step

    # -- sync -------------------------------------------------------------
    def synchronize(self) -> None:
        """Launch the buckets still waiting, drain every handle, and
        write the averaged gradients into ``p.grad``.

        Drains EVERY handle even when one fails, then re-raises the first
        error: stopping at the first would leave later handles pending and
        the next ``step()`` would trip over them instead.
        """
        for b in range(len(self.bucket_plan.buffers)):
            if b not in self._handles:
                self._launch(b)
        first_error = None
        for b in sorted(self._handles):
            handle, ctx = self._handles[b]
            try:
                if self._ef:
                    out, new_residual = handle.wait()
                else:
                    out = self._compression.decompress(handle.wait(), ctx)
                for i, view in unpack_bucket(
                        out, self.bucket_plan.buffers[b][1]):
                    p = self._trainable[i]
                    if self._names is not None:
                        view = from_flax_layout(self._names[i], view)
                    if p.grad is None:
                        p.grad = view.clone(
                            memory_format=torch.contiguous_format)
                    else:
                        p.grad.copy_(view)
                if self._ef and ctx:     # ctx: the residual was fed in
                    self._residuals[b] = new_residual
            except Exception as e:  # drained below; first one re-raised
                if first_error is None:
                    first_error = e
        self._handles.clear()
        self._ready = [set() for _ in self.bucket_plan.buffers]
        self._counter = [0] * len(self._trainable)
        if first_error is not None:
            raise first_error

    def step(self, closure=None):
        self.synchronize()
        return super().step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "zero_grad() called with pending allreduce handles; call "
                "synchronize() or step() first")
        return super().zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[Iterable] = None,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         gradient_predivide_factor: float = 1.0,
                         fusion_threshold: Optional[int] = None
                         ) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` so ``step()`` sees gradients reduced over every
    rank (``hvd.DistributedOptimizer``).  The wrapped object keeps its own
    class's ``step``/``state_dict`` behaviour (its ``__class__`` is
    rebound to a subclass of both).

    ``compression`` accepts a codec class, a spec string (``"bf16"``,
    ``"powersgd:4"``, ...) or ``None`` to follow ``HOROVOD_COMPRESSION``.
    The error-feedback codec ``Compression.powersgd(r)`` carries one
    residual per bucket (``optimizer.residuals``; ``HOROVOD_EF_RESIDUAL``)
    and supports Sum/Average with one backward pass per step."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    compression = _resolve_compression(compression)
    if is_error_feedback(compression):
        if op not in (Sum, Average):
            raise NotImplementedError(
                "powersgd/topk support Sum/Average reductions only")
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                "error-feedback compression with backward_passes_per_step"
                " > 1 is not supported; use microbatches=k instead "
                "(residual applied once per optimizer step)")
    if gradient_predivide_factor != 1.0 and op is not Average:
        raise ValueError("gradient_predivide_factor requires op=Average")
    if gradient_predivide_factor <= 0.0:
        raise ValueError("gradient_predivide_factor must be positive, got "
                         f"{gradient_predivide_factor}")
    named = list(named_parameters) if named_parameters is not None else None
    optimizer.__class__ = type(
        "Distributed" + optimizer.__class__.__name__,
        (_DistributedOptimizer, optimizer.__class__), {})
    optimizer._init_distributed(named, compression, op,
                                backward_passes_per_step,
                                gradient_predivide_factor, fusion_threshold)
    return optimizer
