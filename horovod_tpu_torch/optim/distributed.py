"""Gradient exchange and ``DistributedOptimizer``.

Counterpart of ``horovod_tpu/optim/distributed.py`` (the flat branch of
``allreduce_gradients``) and of ``horovod_tpu/torch_api/optimizer.py``
(``_DistributedOptimizer``, the torch hook semantics).

:func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` so that
``step()`` sees gradients averaged over every rank:

* only parameters with ``requires_grad`` are exchanged (a LoRA fine-tune
  with a frozen base sends its adapters and nothing else);
* at wrap time they are planned into fusion buckets
  (``plan_buckets(..., reverse=True)``: per dtype, at most the fusion
  threshold each, in the order the backward pass produces them); under
  the autotuner (``HOROVOD_AUTOTUNE=1``) the tuned train step plans them
  again (:meth:`~_DistributedOptimizer.replan`) whenever the tuner's
  sample changes the threshold or the codec;
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
the JAX wrap does.  The exchange a bucket takes follows the JAX
``allreduce_gradients`` (see :func:`_launch_bucket`): ``fp8`` through
``fp8_allreduce``, a per-leg ``ici:<c>,dcn:<c>`` codec or
``HOROVOD_HIERARCHICAL`` through ``hierarchical_allreduce``,
``HOROVOD_EXCHANGE_CHUNK_MB`` through ``chunked_allreduce``.  The
error-feedback codecs ``powersgd:<r>`` and ``topk:<f>`` (and a per-leg
codec whose DCN leg is one) make the optimizer stateful: it plans its
buckets as the JAX package's ``ef_bucket_plan`` does (forward, and --
given ``named_parameters`` -- in the order and layout ``jax.tree.leaves``
sees the flax parameters, since the matricized bucket is the matrix
PowerSGD approximates), holds one f32 residual per bucket (zero at wrap
time; ``ef_residual_shape``), launches each bucket's exchange
(PowerSGD's stage 1 and P allreduce, top-k's gathers) from the hook of
its last gradient, and finishes it in ``synchronize()``; the residual
is replaced only once its whole bucket has been exchanged and written
back.

``op=Adasum`` (:func:`DistributedAdasumOptimizer`) mixes each fusion
bucket with its own Adasum coefficients, so which leaves share a bucket
changes the result at world > 1: the buckets are planned as the JAX
package's flat exchange plans them -- forward over the leaves in
``jax.tree.leaves`` order (given ``named_parameters``), at the fusion
threshold.  Each bucket is packed, compressed (the fp16 / bf16 cast),
Adasum-reduced and decompressed.  The exchanges run in bucket order from
``synchronize()``, not from the hooks: every rank must issue the
exchange's point-to-point and gather calls in the same order, so Adasum
gives up the overlap with the backward pass.  As in the JAX package,
Adasum is applied to the gradients, not (as upstream Horovod's
``DistributedAdasumOptimizer`` does) to the optimizer's update.

After an elastic re-init (``shutdown()`` then ``init()``) the wrap finds
``global_state().generation`` moved on its next hook, ``synchronize()``
or ``zero_grad()``: it drops the handles still in flight from the old
process group (never waiting on them), rebuilds the two-level groups on
the new world, and refuses (``ValueError``) a process set, whose group
the re-init destroyed.  :func:`ef_resize_residuals` re-buckets the
error-feedback residuals for a new world size.

``HVD_TPU_NATIVE_CORE=1`` (opt-in) puts a wrap on the native cycle
batcher instead (``collectives/batching.py``, the JAX shim's hot path):
each hook hands its accumulated gradient to the C++ scheduler, which
cuts fused batches -- deterministic (at ``synchronize()``, in name
order) at world > 1 and on the GPU -- and runs one ``grouped_allreduce``
a batch on its own thread; ``synchronize()`` waits on the native
handles.  It serves Sum/Average with no codec, fp16 or bf16 and refuses
at construction (``ValueError``) what it cannot run: the error-feedback
codecs, fp8, per-leg codecs, Adasum, ZeRO-1, the two-level layout and
the chunked exchange.  Its collectives take part in ``hvd.join``'s
drain, and while it runs so do a step's own (the loss average, the
guard screen, the BN statistics, ``hvd.SyncBatchNorm``'s sums): an
uneven-data loop joins through it.  The planned buckets, like the JAX
traced step's collectives, take no join slot, nor then do the step's.

``process_set=`` exchanges every bucket over the set's group (members
only; ``Average`` divides by the set's size), and ``sparse_as_dense=True``
densifies a sparse gradient (``nn.Embedding(sparse=True)``) before it is
packed, as ``horovod_tpu/torch_api/optimizer.py`` does; without it a
sparse gradient raises ``ValueError``.  ``num_groups`` is accepted for
Horovod's signature and has no effect: buckets follow the fusion
threshold.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..collectives.compression import (Compression, is_error_feedback,
                                       is_fp8, is_hier_legs, is_powersgd,
                                       is_topk, parse_compression,
                                       wire_payload_bytes)
from ..collectives.ops import (Handle, chunked_allreduce,
                               exchange_allreduce_async_,
                               fp8_allreduce_async, hierarchical_allreduce,
                               microbatch_pad_quantum,
                               powersgd_allreduce_async,
                               topk_allreduce_async)
from ..collectives.reduce_op import Adasum, Average, ReduceOp, Sum
from ..controller.fusion import (DEFAULT_FUSION_THRESHOLD, FusionSpec,
                                 exchange_chunk_bytes,
                                 hier_requested, pack_bucket, plan_buckets,
                                 plan_exchange, plan_hier_legs, unpack,
                                 unpack_bucket)
from ..core import stall
from ..core.process_sets import get_process_set
from ..core.state import global_state
from ..core.topology import hier_groups, hier_mesh_shape
from ..models.convert import (flax_leaf_order, from_flax_layout,
                              to_flax_layout)
from ..timeline.metrics import (exchange_counters, note_compression_ratio,
                                note_hier_legs)
from ..timeline.spans import note_leg


def _configured_compression(compression):
    """``None`` defers to ``HOROVOD_COMPRESSION`` (a spec string resolved
    through :func:`parse_compression`); an explicit codec or spec string
    is taken as it is.  Passing ``Compression.none`` explicitly disables
    the environment's default."""
    if compression is None:
        cfg = global_state().config
        return parse_compression(cfg.compression if cfg is not None
                                 else None)
    return parse_compression(compression)


def _resolve_compression(compression, op: ReduceOp = Average,
                         process_set=None):
    """The codec an exchange runs with: :func:`_configured_compression`,
    then -- while the autotuner is active -- its compression axis as the
    wrap's exchange can run it (``Autotuner.codec_for``)."""
    comp = _configured_compression(compression)
    tuner = global_state().autotuner
    if tuner is None:
        return comp
    subset = process_set is not None and \
        not get_process_set(process_set).is_global()
    return tuner.codec_for(comp, "wrap", op=op, subset=subset)


def _ef_enabled() -> bool:
    """``HOROVOD_EF_RESIDUAL`` (default on): whether the error-feedback
    codec carries its residual across steps.  Off drops the compression
    error every step -- useful only for ablations."""
    cfg = global_state().config
    return cfg.ef_residual if cfg is not None else True


def _hier_legs(compression, size: int, dtype):
    """One bucket's rows of the two-level exchange on the configured
    layout (:func:`plan_hier_legs`)."""
    n_dcn, n_ici = hier_mesh_shape()
    return plan_hier_legs(size, dtype, n_dcn=n_dcn, n_ici=n_ici,
                          compression=compression)


def _launch_bucket(grads, lspecs, op: ReduceOp, compression,
                   prescale_factor: float, postscale_factor: float,
                   divisor: int = 1, process_set=None) -> Handle:
    """Pack one bucket's gradients (``grads[s.index]`` for each leaf spec)
    into a new flat buffer, divide it by ``divisor`` (the accumulated
    passes) and start its exchange; ``handle.wait()`` returns the reduced
    bucket, decompressed.  The exchange follows the JAX package's
    ``allreduce_gradients`` routing:

    * ``Compression.fp8``: :func:`fp8_allreduce_async`, or Adasum's e4m3
      wire for ``op=Adasum``;
    * a per-leg codec, or ``HOROVOD_HIERARCHICAL`` /
      ``HOROVOD_HIERARCHICAL_ALLREDUCE`` with a cast codec:
      :func:`hierarchical_allreduce` (Sum/Average, the global set; a
      per-leg codec without the two-level layout rides its ICI codec on
      the flat allreduce);
    * ``HOROVOD_EXCHANGE_CHUNK_MB``: :func:`chunked_allreduce` of the
      compressed buffer (Sum/Average, the global set);
    * else the cast codec and one async allreduce.

    Feeds the exchange counters: one bucket, the collectives it issues
    (``handles``) and its wire bytes, priced from the exchange's plan
    rows (fp8: ``wire_payload_bytes``, one byte a value; its row prices
    both directions of the padded bucket).  The flat exchange notes its
    ``flat`` row here; the other exchanges note theirs inside their
    ops."""
    buf = pack_bucket(grads, lspecs)
    if divisor > 1:
        buf.div_(divisor)
    m = exchange_counters()
    m["buckets"].inc()
    size, itemsize = buf.numel(), buf.element_size()
    kw = dict(prescale_factor=prescale_factor,
              postscale_factor=postscale_factor)
    if is_fp8(compression):
        if op is Adasum:
            handle = exchange_allreduce_async_(
                buf, op, process_set=process_set, wire_codec="fp8", **kw)
            m["handles"].inc()
        else:
            handle = fp8_allreduce_async(buf, op, process_set=process_set,
                                         **kw)
            m["handles"].inc(2)
        m["wire_bytes"].inc(wire_payload_bytes(compression, size, itemsize))
        return handle
    global_sum = process_set is None and op in (Sum, Average)
    shape = hier_mesh_shape() if global_sum and hier_requested(
        compression) else None
    if is_hier_legs(compression) and shape is None:
        compression = compression.ici     # the flat exchange, ICI codec
    wire, ctx = compression.compress(buf)
    if shape is not None:
        y = hierarchical_allreduce(
            wire, op, dcn_codec=getattr(compression, "dcn", None),
            ici_codec=getattr(compression, "ici", None), topology=shape,
            **kw)
        legs = _hier_legs(compression, size, buf.dtype)
        note_hier_legs(legs)
        m["handles"].inc(3 if shape[0] > 1 else 1)
        m["wire_bytes"].inc(sum(leg.nbytes for leg in legs))
        return Handle.completed(compression.decompress(y, ctx))
    chunk = exchange_chunk_bytes()
    if chunk > 0 and global_sum:
        y = chunked_allreduce(wire, op, chunk_bytes=chunk, **kw)
        n = global_state().size
        leg = plan_exchange("chunked", size=wire.numel(), dtype=wire.dtype,
                            chunk_bytes=chunk, world=n).legs[0]
        m["handles"].inc(1 if n == 1 else len(leg.audit))
        m["wire_bytes"].inc(leg.nbytes)
        return Handle.completed(compression.decompress(y, ctx))
    leg = plan_exchange("flat", size=wire.numel(), dtype=wire.dtype).legs[0]
    note_leg(leg)
    m["wire_bytes"].inc(leg.nbytes)
    inner = exchange_allreduce_async_(wire, op, process_set=process_set,
                                      **kw)
    m["handles"].inc()
    return Handle(None, lambda: compression.decompress(inner.wait(), ctx),
                  parts=(inner,))


def _launch_ef_bucket(grads, lspecs, op: ReduceOp, compression,
                      residual: Optional[torch.Tensor],
                      prescale_factor: float,
                      postscale_factor: float, process_set=None) -> Handle:
    """Pack one bucket into a new flat buffer and start its error-feedback
    exchange with ``residual`` fed in (``None``: zeros): PowerSGD's stage
    1 and async P allreduce, top-k's async gathers, or the two-level
    exchange of a per-leg codec (its residual ``[2, shard]``, the DCN
    leg's in row 1).  ``handle.wait()`` returns ``(reduced bucket,
    new_residual)``; a non-floating bucket takes the plain allreduce and
    hands ``residual`` back unchanged.  Notes the bucket's ``ef`` ledger
    row (the nested PowerSGD / top-k row is noted by its op; the
    two-level exchange notes its own rows) and feeds the exchange
    counters from the rows."""
    buf = pack_bucket(grads, lspecs)
    m = exchange_counters()
    m["buckets"].inc()
    kw = dict(prescale_factor=prescale_factor,
              postscale_factor=postscale_factor)
    if not is_hier_legs(compression):
        ledger = plan_exchange("ef", size=buf.numel(), dtype=buf.dtype,
                               compression=compression).legs[0]
        note_leg(ledger)
    if not buf.dtype.is_floating_point:
        inner = exchange_allreduce_async_(buf, op,
                                          process_set=process_set, **kw)
        m["handles"].inc()
        m["wire_bytes"].inc(buf.numel() * buf.element_size())
        return Handle(None, lambda: (inner.wait(), residual))
    if is_hier_legs(compression):
        shape = hier_mesh_shape()
        if shape is None:
            raise NotImplementedError(
                "per-leg error-feedback compression (ici:...,dcn:powersgd/"
                "topk) needs the two-level layout; set HOROVOD_HIERARCHICAL"
                " or use the flat codec spec instead")
        out, r_out = hierarchical_allreduce(
            buf, op, dcn_codec=compression.dcn, ici_codec=compression.ici,
            dcn_residual=None if residual is None else residual[1],
            topology=shape, **kw)
        legs = _hier_legs(compression, buf.numel(), buf.dtype)
        note_hier_legs(legs)
        m["handles"].inc(3 if shape[0] > 1 else 1)
        m["wire_bytes"].inc(sum(leg.nbytes for leg in legs))
        return Handle.completed(
            (out, torch.stack([torch.zeros_like(r_out), r_out])))
    if is_powersgd(compression):
        handle = powersgd_allreduce_async(
            buf, op, rank=compression.rank, residual=residual,
            process_set=process_set, **kw)
    else:
        handle = topk_allreduce_async(
            buf, op, fraction=compression.fraction, residual=residual,
            process_set=process_set, **kw)
    m["handles"].inc(2)
    m["wire_bytes"].inc(ledger.nbytes)
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
    compression error is dropped.  ``op=Adasum`` mixes each bucket with
    its own coefficients, the buckets exchanged in order."""
    grads = list(grads)
    compression = _resolve_compression(compression, op)
    if is_hier_legs(compression) and is_error_feedback(compression) and \
            hier_mesh_shape() is None:
        # One level: the DCN hop is the whole world.
        compression = compression.dcn
    spec = plan_buckets(grads, fusion_threshold,
                        extra=(compression.__name__,))
    if is_error_feedback(compression):
        handles = [_launch_ef_bucket(grads, lspecs, op, compression, None,
                                     prescale_factor, postscale_factor)
                   for _, lspecs in spec.buffers]
        return unpack([h.wait()[0] for h in handles], spec)
    handles = [_launch_bucket(grads, lspecs, op, compression,
                              prescale_factor, postscale_factor)
               for _, lspecs in spec.buffers]
    return unpack([h.wait() for h in handles], spec)


# ---------------------------------------------------------------------------
# Error feedback: the bucket plan, the residual state and the exchange
# ---------------------------------------------------------------------------


def _ef_threshold(fusion_threshold: Optional[int]) -> int:
    """The EF plans' threshold (the JAX ``_ef_threshold``): ``None``
    takes the configured one, never the autotuner's -- the residuals'
    shapes follow the plan, so it is pinned."""
    if fusion_threshold is not None:
        return int(fusion_threshold)
    cfg = global_state().config
    return cfg.fusion_threshold if cfg is not None else \
        DEFAULT_FUSION_THRESHOLD


def ef_bucket_plan(leaves, fusion_threshold: Optional[int],
                   compression) -> FusionSpec:
    """The EF exchange's buckets: forward over ``leaves``, keyed by the
    codec (the JAX package's ``ef_bucket_plan``), at
    :func:`_ef_threshold`."""
    return plan_buckets(leaves, _ef_threshold(fusion_threshold),
                        extra=("ef", compression.__name__))


def ef_residual_shape(size: int, compression) -> tuple:
    """Per-bucket residual shape: ``(size,)``, the whole bucket's unsent
    error, for the flat codecs; ``(2, padded / n_ici)`` for a per-leg
    codec -- one row a leg of the two-level exchange, the ICI row
    identically zero (its legs are exact), the DCN row the DCN codec's
    unsent shard-domain error (the JAX package's layout)."""
    if not is_error_feedback(compression):
        raise ValueError(f"{compression.__name__} carries no residual")
    if is_hier_legs(compression):
        shape = hier_mesh_shape()
        n_ici = shape[1] if shape is not None else 1
        padded = size + (-size) % microbatch_pad_quantum(n_ici)
        return (2, padded // n_ici)
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
    """The compression gauges of one step over ``spec``'s buckets: the
    per-leg codecs priced by their rows (:func:`plan_hier_legs`) on the
    two-level layout, the others by :func:`wire_payload_bytes`."""
    hier = is_hier_legs(compression) and hier_mesh_shape() is not None
    raw = wire = 0
    for dt, lspecs in spec.buffers:
        size = sum(s.size for s in lspecs)
        raw += size * dt.itemsize
        wire += sum(leg.nbytes for leg in _hier_legs(compression, size,
                                                     dt)) if hier else \
            wire_payload_bytes(compression, size, dt.itemsize)
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
    return isinstance(optimizer, _DistributedOptimizer) and optimizer._ef


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin providing the bucketed hooks and ``synchronize``; never
    instantiated directly (see :func:`DistributedOptimizer`)."""

    def _init_distributed(self, named_parameters, compression, op,
                          backward_passes_per_step: int,
                          gradient_predivide_factor: float,
                          fusion_threshold: Optional[int],
                          process_set=None,
                          sparse_as_dense: bool = False,
                          batched: bool = False) -> None:
        self._process_set = process_set
        self._batched = batched
        self._native: Dict[int, int] = {}
        self._sparse_as_dense = sparse_as_dense
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
        self._configured = self._compression = compression
        self._op = op
        self._ef = is_error_feedback(compression)
        self._adasum = op is Adasum
        self.backward_passes_per_step = backward_passes_per_step
        self._fusion_threshold = fusion_threshold
        self._trainable = [p for group in self.param_groups
                           for p in group["params"] if p.requires_grad]
        # Each parameter's given name (the microbatched step plans its
        # buckets in their flax leaf order).
        self._name_of: Optional[Dict[int, str]] = None
        if named_parameters is not None:
            self._name_of = {id(p): k for k, p in named_parameters}
        # The flax names of the trainable parameters, in _trainable's
        # order: only an EF or Adasum wrap with names uses them (its
        # buckets follow the JAX package's leaf order and layout).
        self._names: Optional[List[str]] = None
        if (self._ef or self._adasum) and named_parameters is not None:
            names = [self._name_of[id(p)] for p in self._trainable]
            order = flax_leaf_order(names)
            self._trainable = [self._trainable[i] for i in order]
            self._names = [names[i] for i in order]
        self._index = {p: i for i, p in enumerate(self._trainable)}
        if batched:
            # The batcher cuts deterministic batches in name order: every
            # rank must give a parameter the same unique name.
            self._batch_names = [
                self._name_of[id(p)] if self._name_of is not None
                else f"allreduce.noname.{i}"
                for i, p in enumerate(self._trainable)]
        if self._ef:
            # Forward over the (flax-ordered, flax-laid-out) leaves, as
            # the JAX ef_bucket_plan; one zero residual per bucket.
            leaves = [self._flax_view(i, p)
                      for i, p in enumerate(self._trainable)]
            self.bucket_plan = ef_bucket_plan(leaves, fusion_threshold,
                                              compression)
            self._residuals = list(ef_init_residuals(
                leaves, fusion_threshold, compression))
        self._handles: Dict[int, tuple] = {}
        self._plan()
        shape = hier_mesh_shape()
        if shape is not None and shape[0] > 1:
            # The two-level groups are made collectively, so here, where
            # every rank wraps, not in a hook.
            hier_groups(shape[1])
        self._generation = global_state().generation
        # The hook holds the optimizer weakly: torch's garbage collector
        # does not follow a parameter's post-accumulate-grad hooks, so a
        # bound method there would keep the optimizer, its state and its
        # parameters alive after their last user dropped them.
        ref = weakref.ref(self)

        def hook(p: torch.Tensor) -> None:
            opt = ref()
            if opt is not None:
                opt._hook(p)

        for p in self._trainable:
            p.register_post_accumulate_grad_hook(hook)

    # -- the plan ---------------------------------------------------------
    def _plan(self) -> None:
        """The buckets and the hooks' bookkeeping: an EF wrap's pinned
        plan (built with its residuals), else the buckets under the
        current fusion threshold and codec (the autotuner's sample while
        one is active) -- Adasum's forward over the leaves, as the JAX
        flat exchange plans them; the others over the trainable
        parameters in optimizer order, first bucket first to be ready."""
        tuner = global_state().autotuner
        if self._ef and tuner is not None:
            tuner.check_exchange(self._configured, "ef")
        if not self._ef:
            self._compression = _resolve_compression(
                self._configured, self._op, self._process_set)
            if self._adasum:
                self.bucket_plan = plan_buckets(
                    [self._flax_view(i, p)
                     for i, p in enumerate(self._trainable)],
                    self._fusion_threshold,
                    extra=(self._compression.__name__,))
            else:
                self.bucket_plan = plan_buckets(
                    self._trainable, self._fusion_threshold, reverse=True)
        _note_plan_bytes(self.bucket_plan, self._compression)
        self._bucket_of: Dict[int, int] = {}
        for b, (_, lspecs) in enumerate(self.bucket_plan.buffers):
            for s in lspecs:
                self._bucket_of[s.index] = b
        self._counter = [0] * len(self._trainable)
        self._ready: List[set] = [set() for _ in self.bucket_plan.buffers]

    def replan(self) -> None:
        """Plan the buckets again under the current fusion threshold and
        codec: the tuned train step calls it at a step boundary whenever
        the autotuner's ``trace_key()`` changed (the JAX step traces
        again).  An error-feedback wrap keeps its plan, pinned to the
        configured threshold with its residuals.  Refused
        (``RuntimeError``) with a handle outstanding or partway through
        a ``backward_passes_per_step`` accumulation."""
        if self._handles or self._native or any(self._counter):
            raise RuntimeError(
                "DistributedOptimizer.replan() needs a step boundary: no "
                "handle outstanding and no accumulation partway through")
        self._plan()

    # -- re-init ----------------------------------------------------------
    def _check_generation(self) -> None:
        """After an elastic re-init: drop the old group's in-flight
        handles and partial accumulation (their collectives died with
        it), refuse a process set (its group was destroyed), and make the
        two-level groups on the new world (collectively: every rank
        reaches its first hook, ``synchronize()`` or ``zero_grad()`` of
        the new world in the same order)."""
        gen = global_state().generation
        if gen == self._generation:
            return
        self._handles.clear()
        self._native.clear()
        self._ready = [set() for _ in self.bucket_plan.buffers]
        self._counter = [0] * len(self._trainable)
        if self._process_set is not None and \
                not self._process_set.is_global():
            raise ValueError(
                f"DistributedOptimizer(process_set={self._process_set.name!r})"
                f" was wrapped before a re-init, which destroyed the set's "
                f"group; wrap the optimizer again after registering the set")
        shape = hier_mesh_shape()
        if shape is not None and shape[0] > 1:
            hier_groups(shape[1])
        self._generation = gen

    # -- hooks ------------------------------------------------------------
    def _hook(self, p: torch.Tensor) -> None:
        self._check_generation()
        if self._batched:
            self._batched_hook(p)
            return
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
        # Adasum buckets wait for synchronize(), which runs them in order.
        if len(self._ready[b]) == len(self.bucket_plan.buffers[b][1]) \
                and not self._adasum:
            self._launch(b)

    def _batched_hook(self, p: torch.Tensor) -> None:
        """The batched path's hook (JAX ``torch_api/optimizer.py``): the
        accumulated gradient goes to the native batcher, reduced in
        place; ``synchronize`` waits on its handle."""
        from ..collectives import batching
        i = self._index[p]
        if i in self._native:
            raise AssertionError(
                "gradient produced twice without synchronize(); call "
                "optimizer.synchronize() (or step()) every "
                "backward_passes_per_step backwards")
        self._counter[i] += 1
        if self._counter[i] < self.backward_passes_per_step:
            return  # local accumulation pass: no communication
        if p.grad.is_sparse:
            if not self._sparse_as_dense:
                raise ValueError(
                    "sparse gradient encountered (e.g. Embedding("
                    "sparse=True)); pass sparse_as_dense=True to "
                    "DistributedOptimizer to densify it before the "
                    "exchange")
            p.grad = p.grad.to_dense()
        if self.backward_passes_per_step > 1:
            p.grad.div_(self.backward_passes_per_step)
        self._native[i] = batching.batcher().enqueue(
            p.grad, self._batch_names[i], self._op, self._compression,
            self._process_set, self._prescale, self._postscale)

    def _flax_view(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s tensor ``t`` as its bucket holds it (flax's
        layout once the wrap has flax names)."""
        return t if self._names is None else \
            to_flax_layout(self._names[i], t)

    def _launch(self, b: int) -> None:
        _, lspecs = self.bucket_plan.buffers[b]
        grads = {}
        for s in lspecs:
            p = self._trainable[s.index]
            if p.grad is not None and p.grad.is_sparse:
                if not self._sparse_as_dense:
                    raise ValueError(
                        "sparse gradient encountered (e.g. Embedding("
                        "sparse=True)); pass sparse_as_dense=True to "
                        "DistributedOptimizer to densify it before the "
                        "exchange")
                p.grad = p.grad.to_dense()
            grads[s.index] = self._flax_view(
                s.index, p.grad if p.grad is not None else torch.zeros_like(p))
        if self._ef:
            feed = _ef_enabled()
            self._handles[b] = (_launch_ef_bucket(
                grads, lspecs, self._op, self._compression,
                self._residuals[b] if feed else None, self._prescale,
                self._postscale, self._process_set), feed)
            return
        if is_error_feedback(self._compression):
            # The autotuner's error-feedback axis on a wrap configured
            # without one: the codec's stateless form (no residual), the
            # accumulated passes averaged through the prescale.
            inner = _launch_ef_bucket(
                grads, lspecs, self._op, self._compression, None,
                self._prescale / self.backward_passes_per_step,
                self._postscale, self._process_set)
            self._handles[b] = (Handle(None, lambda: inner.wait()[0],
                                       parts=(inner,)), None)
            return
        self._handles[b] = (_launch_bucket(
            grads, lspecs, self._op, self._compression, self._prescale,
            self._postscale, divisor=self.backward_passes_per_step,
            process_set=self._process_set), None)

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
        """Launch the buckets still waiting, drain every handle in bucket
        order, and write the reduced gradients into ``p.grad``.

        Drains EVERY handle even when one fails, then re-raises the first
        error: stopping at the first would leave later handles pending and
        the next ``step()`` would trip over them instead.  The wait runs
        under the stall inspector, and an injected ``at=sync`` chaos
        fault is raised here.
        """
        self._check_generation()
        with stall.watched("DistributedOptimizer.synchronize"):
            from ..elastic import chaos
            chaos.raise_if_armed()
            self._synchronize()

    def _synchronize_batched(self) -> None:
        """Wait on every native handle (the batcher flushes at the first),
        then re-raise the first error."""
        from ..collectives import batching
        first_error = None
        b = batching.current()
        for i in sorted(self._native):
            try:
                if b is None:
                    raise RuntimeError(
                        "the native batcher stopped with gradients in it")
                b.wait(self._native[i])
            except Exception as e:  # drained below; first one re-raised
                if first_error is None:
                    first_error = e
        self._native.clear()
        self._counter = [0] * len(self._trainable)
        if first_error is not None:
            raise first_error

    def _synchronize(self) -> None:
        if self._batched:
            self._synchronize_batched()
            return
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
                    out = handle.wait()
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
                    # In place: a captured train loop replays this copy.
                    self._residuals[b].copy_(new_residual)
            except Exception as e:  # drained below; first one re-raised
                if first_error is None:
                    first_error = e
        self._handles.clear()
        self._ready = [set() for _ in self.bucket_plan.buffers]
        self._counter = [0] * len(self._trainable)
        if first_error is not None:
            raise first_error

    def skip_synchronize(self):
        """A context in which ``step()`` does not synchronize: for a
        caller that already called ``synchronize()`` (to clip the
        reduced gradients, say), as upstream Horovod's."""
        return _SkipSynchronize(self)

    def step(self, closure=None):
        if getattr(self, "_should_synchronize", True):
            self.synchronize()
        return super().step(closure)

    def zero_grad(self, *args, **kwargs):
        self._check_generation()
        if self._handles or self._native:
            raise AssertionError(
                "zero_grad() called with pending allreduce handles; call "
                "synchronize() or step() first")
        return super().zero_grad(*args, **kwargs)


class _SkipSynchronize:
    def __init__(self, opt) -> None:
        self._opt = opt

    def __enter__(self):
        self._opt._should_synchronize = False

    def __exit__(self, *exc) -> None:
        self._opt._should_synchronize = True


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[Iterable] = None,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = Average,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0,
                         process_set=None,
                         sparse_as_dense: bool = False,
                         fusion_threshold: Optional[int] = None
                         ) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` so ``step()`` sees gradients reduced over every
    rank (``hvd.DistributedOptimizer``).  The wrapped object keeps its own
    class's ``step``/``state_dict`` behaviour (its ``__class__`` is
    rebound to a subclass of both).

    ``compression`` accepts a codec class, a spec string (``"bf16"``,
    ``"fp8"``, ``"powersgd:4"``, ``"topk:0.25"``, ``"ici:none,dcn:fp8"``,
    ...) or ``None`` to follow ``HOROVOD_COMPRESSION``.  The
    error-feedback codecs carry one residual per bucket
    (``optimizer.residuals``; ``HOROVOD_EF_RESIDUAL``) and support
    Sum/Average with one backward pass per step.  fp8 (but for Adasum),
    top-k and the per-leg codecs refuse a process set smaller than the
    world, as in the JAX package.
    ``op=Adasum`` needs a power-of-two world (see the module docstring).
    ``process_set``, ``sparse_as_dense`` and ``num_groups``: see the
    module docstring.  Every argument is checked before the optimizer's
    class is rebound, so a refused wrap leaves it as it was."""
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    compression = _configured_compression(compression)
    if process_set is not None and \
            not get_process_set(process_set).is_global() and (
                is_topk(compression) or is_hier_legs(compression)
                or (is_fp8(compression) and op is not Adasum)):
        raise NotImplementedError(
            f"{compression.__name__} does not support process-set "
            f"reductions (no masked identity for a quantized, sparse or "
            f"two-level exchange); use fp16/bf16 there")
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
    if process_set is not None:
        process_set = get_process_set(process_set)
        if not process_set.included():
            raise ValueError(
                f"this rank is not a member of process set "
                f"{process_set.name!r} (ranks {process_set.ranks})")
    batched = _batched_requested()
    if batched:
        _check_batched(compression, op)
    named = list(named_parameters) if named_parameters is not None else None
    optimizer.__class__ = type(
        "Distributed" + optimizer.__class__.__name__,
        (_DistributedOptimizer, optimizer.__class__), {})
    optimizer._init_distributed(named, compression, op,
                                backward_passes_per_step,
                                gradient_predivide_factor, fusion_threshold,
                                process_set, sparse_as_dense,
                                batched=batched)
    return optimizer


def _batched_requested() -> bool:
    """The batched path is opt-in: ``HVD_TPU_NATIVE_CORE=1``."""
    cfg = global_state().config
    if cfg is not None:
        return cfg.native_core
    from ..core.config import _env_bool
    return _env_bool("NATIVE_CORE")


def _check_batched(compression, op: ReduceOp) -> None:
    """``ValueError`` for a wrap the native batcher cannot serve: it runs
    plain ``Average`` / ``Sum`` with no codec, fp16 or bf16 through one
    ``grouped_allreduce`` a batch.  Refused: the error-feedback codecs
    (PowerSGD, top-k), fp8, Adasum, ZeRO-1, a two-level layout and the
    chunked exchange; the native core must build (its failure raises,
    never a quiet fallback to the planned buckets)."""
    why = "HVD_TPU_NATIVE_CORE=1 (the native batcher) serves "
    if op not in (Sum, Average):
        raise ValueError(f"{why}Sum/Average only, not {op}; unset it for "
                         f"Adasum")
    if getattr(compression, "wire_format", ""):
        raise ValueError(
            f"{why}the fp16/bf16 casts only, not {compression.__name__} "
            f"(error feedback, fp8 and per-leg codecs run on the planned "
            f"buckets); unset HVD_TPU_NATIVE_CORE")
    cfg = global_state().config
    if cfg is not None and cfg.zero_stage == 1:
        raise ValueError(f"{why}no ZeRO-1 (HOROVOD_ZERO=1 shards the "
                         f"optimizer over a reduce-scatter arena)")
    if hier_requested(compression):
        raise ValueError(f"{why}the flat exchange only, not the two-level "
                         f"layout (HOROVOD_HIERARCHICAL)")
    if exchange_chunk_bytes() > 0:
        raise ValueError(f"{why}the flat exchange only, not the chunked "
                         f"one (HOROVOD_EXCHANGE_CHUNK_MB)")
    from .. import _core
    _core.require_lib()


def is_batched(optimizer) -> bool:
    """True for a ``DistributedOptimizer`` wrap on the native batcher."""
    return isinstance(optimizer, _DistributedOptimizer) and \
        optimizer._batched


def DistributedAdasumOptimizer(optimizer: torch.optim.Optimizer,
                               named_parameters: Optional[Iterable] = None,
                               **kwargs) -> torch.optim.Optimizer:
    """:func:`DistributedOptimizer` with ``op=Adasum``
    (``hvd.DistributedAdasumOptimizer``): each fusion bucket of gradients
    is combined by Adasum, and the wrapped optimizer steps on the
    result."""
    kwargs["op"] = Adasum
    return DistributedOptimizer(optimizer, named_parameters, **kwargs)


# --- elastic resize -------------------------------------------------------

def ef_resize_residuals(residuals, params, old_world: int, new_world: int,
                        *, fusion_threshold: Optional[int] = None,
                        compression=None):
    """Re-bucket stacked error-feedback residuals for a new world size
    (the JAX package's ``ef_resize_residuals``, on the same numbers).

    ``residuals`` holds one ``[old_world, *row]`` tensor a bucket -- every
    rank's residual, row ``r`` rank ``r``'s (``elastic.TorchState``
    gathers them at commit); ``params`` the leaves the buckets were
    planned over (``None``: keep each bucket's row shape).  The bucket
    shapes depend only on the fusion threshold, so a rank change only
    changes the leading axis, and the dropped ranks' unsent mass is
    carried: with the exchange averaging over the world, the carried
    quantity is ``sum(residuals) / world``, so the kept rows are scaled
    by ``new/old`` and each dropped row's mass is spread uniformly::

        res'_i = (new/old) * res_i + sum(dropped) / old

    which preserves ``sum(res') / new == sum(res) / old`` (the same
    algebra when growing: new rows start at zero).  A bucket is zeroed,
    and counted in ``horovod_ef_residual_zeroed_total``, only when the
    plan itself is irreconcilable (a different bucket count or row
    shape).  The arithmetic is the JAX function's, in numpy float32, so
    both packages agree bitwise.

    Returns ``(new_residuals, report)`` with ``report = {"carried_bytes",
    "zeroed_buckets"}``; the new residuals are f32 CPU tensors."""
    import logging

    import numpy as np
    logger = logging.getLogger("horovod_tpu_torch.optim")
    old_world, new_world = int(old_world), int(new_world)
    report = {"carried_bytes": 0, "zeroed_buckets": 0}
    expected = None
    if params is not None:
        comp = parse_compression(compression) if compression is not None \
            else _configured_compression(None)
        spec = ef_bucket_plan(list(params), fusion_threshold, comp)
        expected = [ef_residual_shape(sum(s.size for s in lspecs), comp)
                    for _dt, lspecs in spec.buffers]

    def _zeroed(shape):
        from .zero import _count_zeroed_residual
        _count_zeroed_residual()
        report["zeroed_buckets"] += 1
        return torch.zeros((new_world,) + tuple(shape), dtype=torch.float32)

    res_list = list(residuals)
    if expected is not None and len(res_list) != len(expected):
        logger.warning(
            "ef_resize_residuals: carry has %d bucket(s) but the plan "
            "for the new world has %d -- zeroing all residuals",
            len(res_list), len(expected))
        return tuple(_zeroed(s) for s in expected), report

    out = []
    for i, r in enumerate(res_list):
        arr = (r.detach().cpu().float().numpy() if torch.is_tensor(r)
               else np.asarray(r, dtype=np.float32))
        shape = tuple(expected[i]) if expected is not None else (
            arr.shape[1:] if arr.ndim >= 2 else None)
        if arr.ndim < 2 or shape is None or arr.shape[1:] != shape:
            logger.warning(
                "ef_resize_residuals: bucket %d shape %s irreconcilable "
                "with planned row shape %s -- zeroing it", i,
                getattr(arr, "shape", None), shape)
            out.append(_zeroed(shape if shape is not None else (0,)))
            continue
        rows = arr.shape[0]
        keep = min(rows, new_world)
        newr = np.zeros((new_world,) + shape, np.float32)
        newr[:keep] = arr[:keep] * (new_world / rows)
        if rows > new_world:
            newr += arr[new_world:].sum(axis=0) / rows
        out.append(torch.from_numpy(newr))
        report["carried_bytes"] += int(arr.nbytes)
    return tuple(out), report
