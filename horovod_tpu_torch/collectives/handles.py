"""Horovod's integer handles: the ``*_async`` functions of the package's
top level, ``synchronize`` and ``poll``.

Counterpart of the handle table of ``horovod_tpu/torch_api/__init__.py``
(upstream ``horovod/torch/handle_manager.cc``).  Each ``*_async``
function here starts the op of :mod:`~horovod_tpu_torch.collectives.ops`
of the same name, keeps its :class:`~horovod_tpu_torch.collectives.ops.
Handle` under a new integer and returns the integer.
:func:`synchronize` waits and returns the result (a grouped handle's is
the list of results) and forgets the handle; :func:`poll` reads whether
its work has completed (``work.is_completed()``).  An unknown or
already synchronized handle raises ``ValueError``, as upstream's does.
The op layer's ``Handle`` objects stay for the DistributedOptimizer's
internal use.
"""

from __future__ import annotations

import functools
import inspect
import itertools
import threading
from typing import Dict

from ..core.process_sets import get_process_set
from ..timeline.metrics import collective_counters
from . import ops


class _HandleTable:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = itertools.count(1)
        self._handles: Dict[int, ops.Handle] = {}

    def add(self, handle: ops.Handle) -> int:
        with self._lock:
            h = next(self._next)
            self._handles[h] = handle
            return h

    def get(self, h: int, pop: bool = False) -> ops.Handle:
        with self._lock:
            handle = (self._handles.pop if pop else self._handles.get)(h,
                                                                       None)
        if handle is None:
            raise ValueError(f"handle {h} was not created or has been "
                             f"synchronized")
        return handle


_table = _HandleTable()


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its result."""
    return _table.get(handle, pop=True).wait()


def poll(handle: int) -> bool:
    """True once the op behind ``handle`` has completed."""
    return _table.get(handle).poll()


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
        return _table.add(handle)

    wrapper.__doc__ = (f"Horovod's ``{fn.__name__}``: an integer handle "
                       f"for :func:`synchronize` / :func:`poll`.\n\n"
                       + (fn.__doc__ or ""))
    return wrapper


allreduce_async = _int_handle(ops.allreduce_async, "allreduce")
allreduce_async_ = _int_handle(ops.allreduce_async_, "allreduce")
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
