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
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..collectives.compression import Compression
from ..collectives.ops import allreduce_async_
from ..collectives.reduce_op import Average, ReduceOp
from ..controller.fusion import (pack_bucket, plan_buckets, unpack,
                                 unpack_bucket)
from ..timeline.metrics import exchange_counters


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


def allreduce_gradients(grads: Sequence[torch.Tensor],
                        op: ReduceOp = Average, *,
                        compression=Compression.none,
                        fusion_threshold: Optional[int] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0
                        ) -> List[torch.Tensor]:
    """Fused allreduce of a gradient list (the flat branch): pack per
    bucket, compress, allreduce, decompress, unpack.  Returns new tensors
    in the input order; the inputs are left as they are."""
    grads = list(grads)
    spec = plan_buckets(grads, fusion_threshold)
    pending = [_launch_bucket(grads, lspecs, op, compression,
                              prescale_factor, postscale_factor)
               for _, lspecs in spec.buffers]
    return unpack([compression.decompress(h.wait(), ctx)
                   for h, ctx in pending], spec)


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
        self.backward_passes_per_step = backward_passes_per_step
        self._trainable = [p for group in self.param_groups
                           for p in group["params"] if p.requires_grad]
        self._index = {p: i for i, p in enumerate(self._trainable)}
        # The fusion buckets of the trainable parameters, indexed in
        # optimizer order, first bucket first to be ready.
        self.bucket_plan = plan_buckets(self._trainable, fusion_threshold,
                                        reverse=True)
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

    def _launch(self, b: int) -> None:
        _, lspecs = self.bucket_plan.buffers[b]
        grads = {}
        for s in lspecs:
            p = self._trainable[s.index]
            grads[s.index] = p.grad if p.grad is not None \
                else torch.zeros_like(p)
        self._handles[b] = _launch_bucket(
            grads, lspecs, self._op, self._compression, self._prescale,
            self._postscale, divisor=self.backward_passes_per_step)

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
                out = self._compression.decompress(handle.wait(), ctx)
                for i, view in unpack_bucket(
                        out, self.bucket_plan.buffers[b][1]):
                    p = self._trainable[i]
                    if p.grad is None:
                        p.grad = view.clone()
                    else:
                        p.grad.copy_(view)
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
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         gradient_predivide_factor: float = 1.0,
                         fusion_threshold: Optional[int] = None
                         ) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` so ``step()`` sees gradients reduced over every
    rank (``hvd.DistributedOptimizer``).  The wrapped object keeps its own
    class's ``step``/``state_dict`` behaviour (its ``__class__`` is
    rebound to a subclass of both)."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
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
