"""``horovod_tpu_torch.tensorflow``: drop-in ``horovod.tensorflow`` API.

The port's counterpart of ``horovod_tpu/tensorflow`` (reference
``horovod/tensorflow/__init__.py`` + ``mpi_ops.py``):
``init/rank/size/...``, eager tensor collectives (``allreduce``,
``allgather``, ``broadcast``, ``alltoall``, ``reducescatter``, the
grouped ops), **``DistributedGradientTape``** (wraps ``tf.GradientTape``;
``gradient()`` returns globally-reduced gradients),
``broadcast_variables``, and ``DistributedOptimizer`` for Keras.

TF stays the user-facing autograd engine on the host; each collective
bridges a TF tensor to numpy, then to a torch tensor on this rank's
device (a copy), runs the port's op layer
(:mod:`horovod_tpu_torch.collectives.ops`: NCCL on the GPU, gloo on the
CPU) and comes back through numpy as a TF tensor.  The reference's TF1
session surface (``broadcast_global_variables`` +
``BroadcastGlobalVariablesHook``) is provided through ``tf.compat.v1``:
the broadcast is a re-runnable graph op (a ``tf.py_function`` hop into
the collective feeding grouped assigns), so
``MonitoredTrainingSession``/estimator-style TF1 scripts port unchanged.

Only importing this module imports TensorFlow.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import tensorflow as tf
import torch

from ..core.basics import (  # noqa: F401
    init, shutdown, is_initialized, size, rank, local_size, local_rank,
    cross_size, cross_rank, is_homogeneous, nccl_built, mpi_built,
    cuda_built, rocm_built, start_timeline, stop_timeline,
    gloo_built, tpu_built, mpi_threads_supported, join, _require_init,
)
from ..core.exceptions import (  # noqa: F401
    HorovodInternalError, HostsUpdatedInterrupt,
)
from ..core.process_sets import (  # noqa: F401
    ProcessSet, add_process_set, remove_process_set, get_process_set,
)
from . import elastic  # noqa: F401  (hvd.elastic.TensorFlowKerasState)
from .sync_batch_norm import (  # noqa: F401
    SyncBatchNorm, SyncBatchNormalization,
)
from ..collectives.reduce_op import (  # noqa: F401
    ReduceOp, Average, Sum, Min, Max, Product, Adasum,
)
from ..collectives.compression import Compression  # noqa: F401
from ..collectives import ops as _ops
from ..optim.functions import broadcast_parameters as _broadcast_tensors


def _to_torch(t) -> torch.Tensor:
    """A TF tensor, variable or array as a torch tensor on this rank's
    device -- always a copy, so no op writes into TF's buffer."""
    return torch.tensor(np.asarray(t), device=_require_init().device)


def _to_tf(out: torch.Tensor, like=None) -> tf.Tensor:
    return tf.convert_to_tensor(out.detach().cpu().numpy(),
                                dtype=getattr(like, "dtype", None))


def _broadcast_arrays(values, root_rank: int, process_set) -> list:
    """Root's values of ``values`` (TF tensors or arrays) as torch
    tensors, fused per dtype (one collective a bucket,
    ``broadcast_parameters``)."""
    tensors = {str(i): _to_torch(v) for i, v in enumerate(values)}
    _broadcast_tensors(tensors, root_rank, process_set=process_set)
    return list(tensors.values())


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, compression=Compression.none,
              op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, process_set=None) -> tf.Tensor:
    if op is None:
        op = Sum if average is False else Average
    out = _ops.allreduce(_to_torch(tensor), name=name,
                         compression=compression, op=op,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor,
                         process_set=process_set)
    return _to_tf(out, tensor)


def grouped_allreduce(tensors: Sequence, average=None, name=None, op=None,
                      process_set=None, compression=Compression.none,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[tf.Tensor]:
    if op is None:
        op = Sum if average is False else Average
    tensors = list(tensors)

    def _dispatch(ts):
        outs = _ops.grouped_allreduce(
            [_to_torch(t) for t in ts], name=name, compression=compression,
            op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
        return [_to_tf(o, t) for o, t in zip(outs, ts)]

    if not tf.executing_eagerly():
        # Inside a tf.function graph (keras fit): hop out via py_function
        # so the port's collective runs eagerly (the reference registers
        # custom TF kernels for this; the bridge cost is equivalent).
        reduced = tf.py_function(lambda *ts: _dispatch(ts), tensors,
                                 [t.dtype for t in tensors])
        for r, t in zip(reduced, tensors):
            r.set_shape(t.shape)
        return reduced
    return _dispatch(tensors)


def grouped_allgather(tensors: Sequence, name=None,
                      process_set=None) -> List[tf.Tensor]:
    """Reference ``hvd.grouped_allgather``: one join round for the set."""
    outs = _ops.grouped_allgather([_to_torch(t) for t in tensors],
                                  name=name, process_set=process_set)
    return [_to_tf(o, t) for o, t in zip(outs, tensors)]


def grouped_reducescatter(tensors: Sequence, op: ReduceOp = Average,
                          name=None, process_set=None) -> List[tf.Tensor]:
    """Reference ``hvd.grouped_reducescatter``: one fused scatter."""
    outs = _ops.grouped_reducescatter([_to_torch(t) for t in tensors], op,
                                      name=name, process_set=process_set)
    return [_to_tf(o, t) for o, t in zip(outs, tensors)]


def allgather(tensor, name: Optional[str] = None,
              process_set=None) -> tf.Tensor:
    """Reference parity: first dims MAY differ across ranks (sizes are
    exchanged first, like the reference's negotiation)."""
    return _to_tf(_ops.allgather(_to_torch(tensor), name=name,
                                 process_set=process_set))


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              process_set=None) -> tf.Tensor:
    out = _ops.broadcast(_to_torch(tensor), root_rank, name=name,
                         process_set=process_set)
    return _to_tf(out, tensor)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set=None):
    """Reference parity (``horovod.tensorflow.alltoall``): with ``splits``
    the exchange is uneven and the result is ``(received,
    received_splits)``; without, ``tensor`` splits evenly."""
    if splits is None:
        out = _ops.alltoall(_to_torch(tensor), name=name,
                            process_set=process_set)
        return _to_tf(out, tensor)
    data, rsplits = _ops.alltoall(_to_torch(tensor),
                                  splits=np.asarray(splits).tolist(),
                                  name=name, process_set=process_set)
    return _to_tf(data), _to_tf(rsplits.to(torch.int32))


def reducescatter(tensor, op: ReduceOp = Average, name=None,
                  process_set=None):
    out = _ops.reducescatter(_to_torch(tensor), op, name=name,
                             process_set=process_set)
    return _to_tf(out, tensor)


def barrier(process_set=None) -> None:
    _ops.barrier(process_set=process_set)


def broadcast_variables(variables, root_rank: int = 0,
                        process_set=None) -> None:
    """Assign every variable its root-rank value (``hvd.broadcast_variables``).

    Variables are FUSED per dtype into flat buckets, one collective a
    bucket (``broadcast_parameters``), instead of one round trip a
    variable.
    """
    variables = list(variables)
    rows = _broadcast_arrays(variables, root_rank, process_set)
    for v, row in zip(variables, rows):
        v.assign(_to_tf(row, v))


def broadcast_global_variables(root_rank: int = 0, process_set=None):
    """Broadcast all TF1 global variables from ``root_rank``.

    Reference parity: ``horovod.tensorflow.broadcast_global_variables``
    (the TF1 half of the API).  Graph mode (``tf.compat.v1`` sessions):
    returns a re-runnable op -- a ``tf.py_function`` that runs the fused
    broadcast and feeds one assign per variable (the reference registers
    a native ``HorovodBroadcast`` kernel; the py_function hop is this
    shim's standard graph bridge, same as ``grouped_allreduce``).
    Limitation: ``py_function`` captures process-local Python state, so
    the returned op is NOT serializable into a GraphDef -- graphs that
    are frozen, exported, or executed by a session in a different process
    will fail to resolve it (the reference's native kernel survives those
    flows).  Run the op in the process that built it, as
    ``BroadcastGlobalVariablesHook`` does.  Eager mode raises like the
    reference: eager variables never reach the ``global_variables()``
    collection, so a silent no-op would leave every rank on its own init
    -- use ``broadcast_variables``.
    """
    v1 = tf.compat.v1
    if tf.executing_eagerly():
        raise RuntimeError(
            "hvd.broadcast_global_variables() does not support eager "
            "execution. Please use `hvd.broadcast_variables(<model/"
            "optimizer variables>)` instead.")
    variables = v1.global_variables()
    if not variables:
        return tf.no_op(name="horovod_broadcast_global_variables")

    def _dispatch(*ts):
        return [_to_tf(r, t) for r, t in
                zip(_broadcast_arrays(ts, root_rank, process_set), ts)]

    outs = tf.py_function(_dispatch, [v.read_value() for v in variables],
                          [v.dtype.base_dtype for v in variables])
    assigns = []
    for v, o in zip(variables, outs):
        o.set_shape(v.shape)
        assigns.append(v1.assign(v, o))
    return tf.group(*assigns, name="horovod_broadcast_global_variables")


class BroadcastGlobalVariablesHook(tf.compat.v1.train.SessionRunHook):
    """TF1 ``SessionRunHook`` broadcasting initial state from ``root_rank``.

    Reference parity: ``horovod.tensorflow.BroadcastGlobalVariablesHook``
    (the last TF1 surface).  Use with
    ``tf.compat.v1.train.MonitoredTrainingSession`` or estimators: the
    broadcast op is (re)built in ``begin()`` against the current graph and
    run once in ``after_create_session``, i.e. after variable
    initialization, exactly the reference's hook protocol.  The op is a
    ``py_function`` bridge (see :func:`broadcast_global_variables`): it
    must run in the process that built it and cannot ride a frozen or
    exported GraphDef -- in-process MonitoredSession/estimator use is the
    supported shape.  ``device`` is
    accepted for signature parity (the collective runs on the port's
    device).
    """

    def __init__(self, root_rank: int = 0, device: str = "",
                 process_set=None):
        super().__init__()
        self.root_rank = root_rank
        self.device = device
        self.process_set = process_set
        self.bcast_op = None

    def begin(self):
        if (self.bcast_op is None
                or self.bcast_op.graph is not
                tf.compat.v1.get_default_graph()):
            with tf.device(self.device):
                self.bcast_op = broadcast_global_variables(
                    self.root_rank, process_set=self.process_set)

    def after_create_session(self, session, coord):
        session.run(self.bcast_op)


def broadcast_object(obj, root_rank: int = 0, name=None, process_set=None):
    from ..optim.functions import broadcast_object as _bo
    return _bo(obj, root_rank, process_set=process_set)


def allgather_object(obj, name=None, process_set=None) -> list:
    from ..optim.functions import allgather_object as _ago
    return _ago(obj, name=name, process_set=process_set)


class DistributedGradientTape(tf.GradientTape):
    """``tf.GradientTape`` whose ``gradient()`` allreduces the result.

    Reference: ``horovod/tensorflow/__init__.py::DistributedGradientTape``
    (the TF2 hot path).  Gradients are fused through
    ``grouped_allreduce`` -- one collective per dtype bucket rather than
    one per tensor.
    """

    def __init__(self, tape: tf.GradientTape,
                 compression=Compression.none, op: ReduceOp = Average,
                 process_set=None, sparse_as_dense: bool = False,
                 gradient_predivide_factor: float = 1.0):
        # Adopt the wrapped tape's recording state.  sparse_as_dense
        # defaults OFF like the reference: densifying an embedding grad
        # can be a huge silent memory cost, so it is explicit opt-in.
        if gradient_predivide_factor != 1.0 and op is not Average:
            raise ValueError("gradient_predivide_factor requires "
                             "op=Average (reference behavior)")
        if gradient_predivide_factor <= 0.0:
            raise ValueError("gradient_predivide_factor must be positive")
        self.__dict__.update(tape.__dict__)
        self._hvd_compression = compression
        self._hvd_op = op
        self._hvd_process_set = process_set
        self._hvd_sparse_as_dense = sparse_as_dense
        self._hvd_prescale = 1.0 / gradient_predivide_factor
        self._hvd_postscale = gradient_predivide_factor

    def gradient(self, target, sources, output_gradients=None,
                 unconnected_gradients=tf.UnconnectedGradients.NONE):
        grads = super().gradient(target, sources, output_gradients,
                                 unconnected_gradients)
        flat = tf.nest.flatten(grads)
        idx = [i for i, g in enumerate(flat) if g is not None]
        for i in idx:
            if isinstance(flat[i], tf.IndexedSlices):
                # Embedding-style sparse grads: densify before the dense
                # allreduce (reference sparse_as_dense), or refuse loudly.
                if not self._hvd_sparse_as_dense:
                    raise ValueError(
                        "IndexedSlices gradient with sparse_as_dense="
                        "False; dense allreduce needs sparse_as_dense="
                        "True")
                flat[i] = tf.convert_to_tensor(flat[i])
        if idx:
            reduced = grouped_allreduce(
                [tf.convert_to_tensor(flat[i]) for i in idx],
                op=self._hvd_op, name="gradtape",
                process_set=self._hvd_process_set,
                compression=self._hvd_compression,
                prescale_factor=self._hvd_prescale,
                postscale_factor=self._hvd_postscale)
            for i, g in zip(idx, reduced):
                flat[i] = g
        return tf.nest.pack_sequence_as(grads, flat)


def DistributedOptimizer(optimizer, compression=Compression.none,
                         op: ReduceOp = Average, process_set=None,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = True,
                         sparse_as_dense: bool = False):
    """Keras-3 optimizer wrapper: allreduce grads in ``apply_gradients``.

    Reference: ``horovod/tensorflow/__init__.py::DistributedOptimizer``
    (wrap ``compute_gradients``); Keras 3 funnels everything through
    ``apply_gradients``, so the reduction hooks there.

    ``backward_passes_per_step > 1`` reproduces the reference's local
    gradient aggregation (``gradient_aggregation_eager.py``): gradients
    accumulate into local buffers for N-1 calls with NO communication and
    NO variable update; the Nth call allreduces the aggregate (averaged
    over N when ``average_aggregated_gradients``) and applies it.
    """
    base = optimizer.__class__
    bpps = int(backward_passes_per_step)
    if bpps < 1:
        raise ValueError("backward_passes_per_step must be >= 1")

    class _Distributed(base):
        _hvd_wrapped = True

        def _hvd_reduce_and_apply(self, grads, tvars, args, kwargs):
            idx = [i for i, g in enumerate(grads) if g is not None]
            for i in idx:
                if isinstance(grads[i], tf.IndexedSlices):
                    # Same policy as DistributedGradientTape: densify
                    # for the dense allreduce only with explicit opt-in.
                    if not sparse_as_dense:
                        raise ValueError(
                            "IndexedSlices gradient with sparse_as_dense"
                            "=False; dense allreduce needs "
                            "sparse_as_dense=True")
                    grads[i] = tf.convert_to_tensor(grads[i])
            if idx:
                reduced = grouped_allreduce(
                    [tf.convert_to_tensor(grads[i]) for i in idx],
                    op=op, name="opt", process_set=process_set)
                for i, g in zip(idx, reduced):
                    grads[i] = g
            return super().apply_gradients(zip(grads, tvars), *args,
                                           **kwargs)

        def apply_gradients(self, grads_and_vars, *args, **kwargs):
            grads_and_vars = list(grads_and_vars)
            grads = [g for g, _ in grads_and_vars]
            tvars = [v for _, v in grads_and_vars]
            if bpps == 1:
                return self._hvd_reduce_and_apply(grads, tvars, args,
                                                  kwargs)

            if not hasattr(self, "_hvd_agg_counter"):
                self._hvd_agg_counter = tf.Variable(
                    0, dtype=tf.int64, trainable=False,
                    name="hvd_agg_counter")
                self._hvd_agg_bufs = [
                    None if g is None else tf.Variable(
                        tf.zeros(g.shape, g.dtype), trainable=False,
                        name=f"hvd_agg_{i}")
                    for i, g in enumerate(grads)]
            # Validate BEFORE any buffer mutation: a mid-loop raise after
            # partial assign_adds would double-count on the next pass.
            if not sparse_as_dense and any(
                    isinstance(g, tf.IndexedSlices) for g in grads):
                raise ValueError(
                    "IndexedSlices gradient with sparse_as_dense=False; "
                    "dense aggregation needs sparse_as_dense=True")
            for buf, g in zip(self._hvd_agg_bufs, grads):
                if buf is not None and g is not None:
                    buf.assign_add(tf.convert_to_tensor(g))
            self._hvd_agg_counter.assign_add(1)

            def _boundary():
                scale = 1.0 / bpps if average_aggregated_gradients else 1.0
                agg = [None if b is None
                       else tf.cast(scale, b.dtype) * b.read_value()
                       for b in self._hvd_agg_bufs]
                with tf.control_dependencies(
                        [a for a in agg if a is not None]):
                    for b in self._hvd_agg_bufs:
                        if b is not None:
                            b.assign(tf.zeros_like(b))
                    self._hvd_agg_counter.assign(0)
                self._hvd_reduce_and_apply(agg, tvars, args, kwargs)
                return tf.convert_to_tensor(self.iterations)

            def _skip():
                return tf.convert_to_tensor(self.iterations)

            if tf.executing_eagerly():
                # Both paths return iterations, like the bpps==1 path and
                # the Keras base apply_gradients contract.
                return (_boundary()
                        if int(self._hvd_agg_counter) >= bpps
                        else _skip())
            # Slot variables must exist BEFORE tf.cond traces the
            # apply branch (variable creation is illegal inside cond).
            if hasattr(self, "build") and not getattr(self, "built",
                                                      True):
                self.build(tvars)
            return tf.cond(self._hvd_agg_counter >= bpps,
                           _boundary, _skip)

    optimizer.__class__ = _Distributed
    return optimizer
