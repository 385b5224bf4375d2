"""Horovod's integer handles: the ``*_async`` functions of the package's
top level, ``synchronize`` and ``poll``.

Counterpart of the handle table of ``horovod_tpu/torch_api/__init__.py``
(upstream ``horovod/torch/handle_manager.cc``), kept in
:mod:`~horovod_tpu_torch.collectives.eager` with the JAX package's
sentinels.  Each ``*_async`` function here starts the op of
:mod:`~horovod_tpu_torch.collectives.ops` of the same name, keeps its
:class:`~horovod_tpu_torch.collectives.ops.Handle` under a new integer
and returns the integer -- but ``allreduce_async`` /
``allreduce_async_``, while ``hvd.join``'s protocol applies (world > 1,
the global set), queue the op for the fused deferred flush instead.
:func:`synchronize` flushes, waits and returns the result (a grouped
handle's is the list of results) and forgets the handle; :func:`poll`
flushes a queued op and reads whether its work has completed.  An
unknown or already synchronized handle raises
:class:`~horovod_tpu_torch.collectives.eager.UnknownHandleError`, a
``ValueError`` as upstream's and a ``KeyError`` as the JAX package's.
The op layer's ``Handle`` objects stay for the DistributedOptimizer's
internal use.
"""

from __future__ import annotations

import functools
import inspect

from ..core.process_sets import get_process_set
from ..timeline.metrics import collective_counters
from . import eager, ops
from .compression import Compression

synchronize = eager.synchronize
poll = eager.poll


def _int_handle(fn, kind: str):
    """``fn`` (an op-layer ``*_async`` function) returning an integer
    handle, counted under ``kind`` and the call's process set."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs) -> int:
        handle = fn(*args, **kwargs)
        ps = sig.bind(*args, **kwargs).arguments.get("process_set")
        collective_counters(kind, get_process_set(ps).name)[
            "handles"].inc()
        return eager._alloc_handle(handle)

    wrapper.__doc__ = (f"Horovod's ``{fn.__name__}``: an integer handle "
                       f"for :func:`synchronize` / :func:`poll`.\n\n"
                       + (fn.__doc__ or ""))
    return wrapper


def _deferring(fn, inplace: bool):
    """:func:`_int_handle` of an allreduce that queues for the fused
    deferred flush while the join protocol applies (JAX
    ``allreduce_async``): the copying op snapshots its input, the
    in-place op writes its result back into it at the flush."""
    start = _int_handle(fn, "allreduce")
    sig = inspect.signature(fn)

    @functools.wraps(start)
    def wrapper(*args, **kwargs) -> int:
        a = sig.bind(*args, **kwargs).arguments
        ps = get_process_set(a.get("process_set"))
        if a.get("wire_codec") is not None or eager._in_flush() or \
                not eager._defer_applies(ps):
            return start(*args, **kwargs)
        op = ops._resolve_op(a.get("average"), a.get("op"))
        ops._check_allreduce_op(op, None)
        tensor = a["tensor"]
        collective_counters("allreduce", ps.name)["handles"].inc()
        return eager.defer(eager._DeferredAllreduce(
            x=tensor if inplace else tensor.clone(), op=op,
            name=a.get("name"), process_set=ps,
            prescale=float(a.get("prescale_factor", 1.0)),
            postscale=float(a.get("postscale_factor", 1.0)),
            compression=Compression.none,
            target=tensor if inplace else None))

    return wrapper


allreduce_async = _deferring(ops.allreduce_async, inplace=False)
allreduce_async_ = _deferring(ops.allreduce_async_, inplace=True)
grouped_allreduce_async = _int_handle(ops.grouped_allreduce_async,
                                      "allreduce")
grouped_allreduce_async_ = _int_handle(ops.grouped_allreduce_async_,
                                       "allreduce")
allgather_async = _int_handle(ops.allgather_async, "allgather")
grouped_allgather_async = _int_handle(ops.grouped_allgather_async,
                                      "allgather")
broadcast_async = _int_handle(ops.broadcast_async, "broadcast")
broadcast_async_ = _int_handle(ops.broadcast_async_, "broadcast")
reducescatter_async = _int_handle(ops.reducescatter_async, "reducescatter")
grouped_reducescatter_async = _int_handle(ops.grouped_reducescatter_async,
                                          "reducescatter")
alltoall_async = _int_handle(ops.alltoall_async, "alltoall")
sparse_allreduce_async = _int_handle(ops.sparse_allreduce_async,
                                     "sparse_allreduce")

__all__ = ["allreduce_async", "allreduce_async_", "grouped_allreduce_async",
           "grouped_allreduce_async_", "allgather_async",
           "grouped_allgather_async", "broadcast_async", "broadcast_async_",
           "reducescatter_async", "grouped_reducescatter_async",
           "alltoall_async", "sparse_allreduce_async", "synchronize",
           "poll"]
