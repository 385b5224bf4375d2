"""State synchronization: ``broadcast_parameters``,
``broadcast_optimizer_state``, ``broadcast_object``, ``allgather_object``.

Counterpart of ``horovod_tpu/optim/functions.py`` (the rank-0-saves /
everyone-restores idiom of ``horovod/torch/functions.py``).  Tensors are
broadcast in place; small ones are fused per dtype through the bucket
planner (one collective per bucket), and a tensor larger than the
threshold goes on its own without a copy.  Each takes ``process_set=``:
the root (a global rank) reaches the set's members only.
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, List, Mapping, Tuple, Union

import torch

from ..collectives.ops import allgather, broadcast_
from ..controller.fusion import pack_bucket, plan_buckets, unpack_bucket
from ..core.basics import _require_init


@torch.no_grad()
def _broadcast_tensors_(tensors: List[torch.Tensor], root_rank: int,
                        process_set=None) -> None:
    spec = plan_buckets(tensors)
    for _, lspecs in spec.buffers:
        if len(lspecs) == 1 and tensors[lspecs[0].index].is_contiguous():
            broadcast_(tensors[lspecs[0].index], root_rank,
                       process_set=process_set)
            continue
        buf = broadcast_(pack_bucket(tensors, lspecs), root_rank,
                         process_set=process_set)
        for i, view in unpack_bucket(buf, lspecs):
            tensors[i].copy_(view)


def broadcast_parameters(
        params: Union[Mapping[str, torch.Tensor],
                      Iterable[Tuple[str, torch.Tensor]]],
        root_rank: int = 0, process_set=None) -> None:
    """Overwrite every member's tensors with root's, in place.
    ``params`` is a ``state_dict()`` or ``named_parameters()``."""
    _require_init()
    items = params.values() if isinstance(params, Mapping) else \
        (t for _, t in params)
    _broadcast_tensors_([t.detach() for t in items], root_rank, process_set)


def _pickled(obj: Any, device: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)),
                            dtype=torch.uint8).to(device)


def _unpickled(data: torch.Tensor) -> Any:
    return pickle.loads(data.cpu().numpy().tobytes())


def broadcast_object(obj: Any, root_rank: int = 0, name=None,
                     process_set=None) -> Any:
    """Root's picklable object, on every member (``name`` is accepted
    for Horovod's signature).  The pickled bytes travel as a ``uint8``
    tensor on this rank's device, after a broadcast of their length."""
    st = _require_init()
    root = st.rank == root_rank
    data = _pickled(obj, st.device) if root else None
    n = torch.tensor([data.numel() if root else 0], dtype=torch.int64,
                     device=st.device)
    broadcast_(n, root_rank, name, process_set)
    if not root:
        data = torch.empty(int(n.item()), dtype=torch.uint8,
                           device=st.device)
    broadcast_(data, root_rank, name, process_set)
    return obj if root else _unpickled(data)


def allgather_object(obj: Any, name=None, process_set=None) -> List[Any]:
    """Every member's picklable object, in rank order
    (``horovod/torch/functions.py::allgather_object``).  The pickled
    bytes travel as a ``uint8`` tensor on this rank's device (NCCL needs
    device tensors) through the ragged allgather, after an allgather of
    their lengths."""
    st = _require_init()
    data = _pickled(obj, st.device)
    lens = allgather(torch.tensor([data.numel()], dtype=torch.int64,
                                  device=st.device), name, process_set)
    flat = allgather(data, name, process_set)
    return [_unpickled(part) for part in torch.split(flat, lens.tolist())]


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0,
                              process_set=None) -> None:
    """Overwrite every rank's optimizer state and hyper-parameters with
    root's: state tensors on this rank's device are broadcast in place,
    everything else (step counters held on the host, param-group
    hyper-parameters) is pickled from root."""
    st = _require_init()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    on_device, others = [], {}
    for i, p in enumerate(params):
        for key, val in sorted(optimizer.state.get(p, {}).items()):
            if torch.is_tensor(val) and val.device == st.device:
                on_device.append(val)
            else:
                others[(i, key)] = val
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in optimizer.param_groups]
    _broadcast_tensors_(on_device, root_rank, process_set)
    others, groups = broadcast_object((others, groups), root_rank,
                                      process_set=process_set)
    for (i, key), val in others.items():
        optimizer.state[params[i]][key] = val
    for g, hp in zip(optimizer.param_groups, groups):
        g.update(hp)
