"""``horovod_tpu_torch.mxnet``: MXNet API shim (reference ``horovod/mxnet/``).

The port's counterpart of ``horovod_tpu/mxnet``.  MXNet reached
end-of-life upstream (retired by Apache in 2023) and is installed
nowhere here, but the reference ships the binding
(``horovod/mxnet/__init__.py``, ``mpi_ops.py``: tensor collectives,
``DistributedOptimizer`` wrapping ``mx.optimizer.Optimizer.update``,
``DistributedTrainer`` wrapping ``gluon.Trainer._allreduce_grads``,
``broadcast_parameters``), so the full surface exists here.  NDArrays
bridge through numpy to a torch tensor on this rank's device and the
port's op layer, as the TF shim's tensors do; the identity functions work
without ``mxnet``, and every tensor API raises with guidance unless the
``mxnet`` package imports.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.basics import (  # noqa: F401
    init, shutdown, is_initialized, size, rank, local_size, local_rank,
    cross_size, cross_rank, nccl_built, mpi_built, gloo_built, tpu_built,
    cuda_built, rocm_built, start_timeline, stop_timeline,
    mpi_threads_supported, _require_init,
)
from ..collectives.reduce_op import (  # noqa: F401
    ReduceOp, Average, Sum, Min, Max, Product, Adasum,
)
from ..collectives.compression import Compression  # noqa: F401
from ..collectives import ops as _ops


def _require_mxnet():
    try:
        import mxnet  # noqa: F401
        return mxnet
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.mxnet tensor APIs require the `mxnet` "
            "package, which is not installed (MXNet is EOL). Use "
            "horovod_tpu_torch (the horovod.torch API) or "
            "horovod_tpu_torch.tensorflow instead.") from e


def _to_torch(nd) -> torch.Tensor:
    """An NDArray as a torch tensor on this rank's device (a copy)."""
    return torch.tensor(nd.asnumpy(), device=_require_init().device)


def _to_nd(mx, out: torch.Tensor, ctx, dtype=None):
    return mx.nd.array(out.detach().cpu().numpy(), ctx=ctx, dtype=dtype)


def allreduce(tensor, average: Optional[bool] = None, name=None,
              op: Optional[ReduceOp] = None, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, process_set=None):
    """``hvd.allreduce`` for NDArrays (reference ``mxnet/mpi_ops.py``)."""
    mx = _require_mxnet()
    if op is None:
        op = Sum if average is False else Average
    out = _ops.allreduce(_to_torch(tensor), name=name, op=op,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor,
                         process_set=process_set)
    return _to_nd(mx, out, tensor.context)


def allreduce_(tensor, average: Optional[bool] = None, name=None,
               op: Optional[ReduceOp] = None, process_set=None):
    """In-place variant: writes the reduced value back into ``tensor``."""
    result = allreduce(tensor, average=average, name=name, op=op,
                       process_set=process_set)
    tensor[:] = result
    return tensor


def grouped_allreduce(tensors, average: Optional[bool] = None, name=None,
                      op: Optional[ReduceOp] = None, process_set=None):
    mx = _require_mxnet()
    if op is None:
        op = Sum if average is False else Average
    outs = _ops.grouped_allreduce([_to_torch(t) for t in tensors],
                                  name=name, op=op, process_set=process_set)
    return [_to_nd(mx, o, t.context) for o, t in zip(outs, tensors)]


def grouped_allgather(tensors, name=None, process_set=None):
    """Reference ``hvd.grouped_allgather``: one join round for the set."""
    mx = _require_mxnet()
    outs = _ops.grouped_allgather([_to_torch(t) for t in tensors],
                                  name=name, process_set=process_set)
    return [_to_nd(mx, o, t.context) for o, t in zip(outs, tensors)]


def grouped_reducescatter(tensors, op: ReduceOp = Average, name=None,
                          process_set=None):
    """Reference ``hvd.grouped_reducescatter``: one fused scatter."""
    mx = _require_mxnet()
    outs = _ops.grouped_reducescatter([_to_torch(t) for t in tensors],
                                      op, name=name,
                                      process_set=process_set)
    return [_to_nd(mx, o, t.context) for o, t in zip(outs, tensors)]


def allgather(tensor, name=None, process_set=None):
    """Ragged-capable allgather (first dims may differ across ranks)."""
    mx = _require_mxnet()
    out = _ops.allgather(_to_torch(tensor), name=name,
                         process_set=process_set)
    return _to_nd(mx, out, tensor.context)


def broadcast(tensor, root_rank: int = 0, name=None, process_set=None):
    mx = _require_mxnet()
    out = _ops.broadcast(_to_torch(tensor), root_rank, name=name,
                         process_set=process_set)
    return _to_nd(mx, out, tensor.context)


def broadcast_(tensor, root_rank: int = 0, name=None, process_set=None):
    tensor[:] = broadcast(tensor, root_rank, name=name,
                          process_set=process_set)
    return tensor


def alltoall(tensor, splits=None, name=None, process_set=None):
    """With ``splits``: uneven exchange, returns (received, recv_splits)
    (reference ``horovod.mxnet.alltoall`` semantics)."""
    mx = _require_mxnet()
    if splits is None:
        out = _ops.alltoall(_to_torch(tensor), name=name,
                            process_set=process_set)
        return _to_nd(mx, out, tensor.context)
    sp = getattr(splits, "asnumpy", lambda: splits)()
    out, rsplits = _ops.alltoall(_to_torch(tensor),
                                 splits=np.asarray(sp).tolist(), name=name,
                                 process_set=process_set)
    host = out.cpu().numpy()
    return (mx.nd.array(host, ctx=tensor.context, dtype=host.dtype),
            _to_nd(mx, rsplits, tensor.context, dtype="int32"))


def reducescatter(tensor, op: ReduceOp = Average, name=None,
                  process_set=None):
    mx = _require_mxnet()
    out = _ops.reducescatter(_to_torch(tensor), op, name=name,
                             process_set=process_set)
    return _to_nd(mx, out, tensor.context)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a gluon param dict from root (reference
    ``horovod/mxnet/__init__.py::broadcast_parameters``)."""
    _require_mxnet()
    if not hasattr(params, "items"):
        raise ValueError("broadcast_parameters expects a dict-like of "
                         "name -> Parameter/NDArray")
    for name, p in sorted(params.items()):
        nd = p.data() if hasattr(p, "data") else p
        broadcast_(nd, root_rank, name=f"broadcast.{name}")


def broadcast_object(obj, root_rank: int = 0, name=None, process_set=None):
    from ..optim.functions import broadcast_object as _bo
    return _bo(obj, root_rank, process_set=process_set)


def allgather_object(obj, name=None, process_set=None) -> list:
    from ..optim.functions import allgather_object as _ago
    return _ago(obj, name=name, process_set=process_set)


def DistributedOptimizer(optimizer, op: ReduceOp = Average,
                         process_set=None):
    """Wrap ``mx.optimizer.Optimizer`` so ``update()`` sees reduced grads
    (reference ``horovod/mxnet/__init__.py::DistributedOptimizer``)."""
    _require_mxnet()

    class _Distributed(optimizer.__class__):
        def __init__(self):
            self.__dict__.update(optimizer.__dict__)

        def _do_allreduce(self, index, grad):
            if isinstance(index, (tuple, list)):
                grouped = grouped_allreduce(
                    list(grad), op=op, name=f"grad.{index[0]}",
                    process_set=process_set)
                for g, r in zip(grad, grouped):
                    g[:] = r
            else:
                allreduce_(grad, name=f"grad.{index}", op=op,
                           process_set=process_set)

        def update(self, index, weight, grad, state):
            self._do_allreduce(index, grad)
            super().update(index, weight, grad, state)

        def update_multi_precision(self, index, weight, grad, state):
            self._do_allreduce(index, grad)
            super().update_multi_precision(index, weight, grad, state)

    return _Distributed()


def DistributedTrainer(params, optimizer, optimizer_params=None,
                       process_set=None):
    """Gluon trainer whose ``_allreduce_grads`` runs the port's collective
    (reference ``horovod/mxnet/__init__.py::DistributedTrainer``)."""
    mx = _require_mxnet()

    class _Trainer(mx.gluon.Trainer):
        def __init__(self):
            super().__init__(params, optimizer,
                             optimizer_params or {}, kvstore=None)
            # Reference behavior: the optimizer's rescale_grad divides by
            # world size, so the collective must SUM (not average) or the
            # update would be scaled by 1/size^2.
            self._scale /= size()

        def _allreduce_grads(self):
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    for g in param.list_grad():
                        allreduce_(g, name=f"grad.{i}", op=Sum,
                                   process_set=process_set)

    return _Trainer()
