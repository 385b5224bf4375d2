"""State synchronization: ``broadcast_parameters``,
``broadcast_optimizer_state``, ``broadcast_object``.

Counterpart of ``horovod_tpu/optim/functions.py`` (the rank-0-saves /
everyone-restores idiom of ``horovod/torch/functions.py``).  Tensors are
broadcast in place; small ones are fused per dtype through the bucket
planner (one collective per bucket), and a tensor larger than the
threshold goes on its own without a copy.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Mapping, Tuple, Union

import torch
import torch.distributed as dist

from ..collectives.ops import broadcast_
from ..controller.fusion import pack_bucket, plan_buckets, unpack_bucket
from ..core.basics import _require_init


@torch.no_grad()
def _broadcast_tensors_(tensors: List[torch.Tensor], root_rank: int) -> None:
    spec = plan_buckets(tensors)
    for _, lspecs in spec.buffers:
        if len(lspecs) == 1 and tensors[lspecs[0].index].is_contiguous():
            broadcast_(tensors[lspecs[0].index], root_rank)
            continue
        buf = broadcast_(pack_bucket(tensors, lspecs), root_rank)
        for i, view in unpack_bucket(buf, lspecs):
            tensors[i].copy_(view)


def broadcast_parameters(
        params: Union[Mapping[str, torch.Tensor],
                      Iterable[Tuple[str, torch.Tensor]]],
        root_rank: int = 0) -> None:
    """Overwrite every rank's tensors with root's, in place.  ``params``
    is a ``state_dict()`` or ``named_parameters()``."""
    _require_init()
    items = params.values() if isinstance(params, Mapping) else \
        (t for _, t in params)
    _broadcast_tensors_([t.detach() for t in items], root_rank)


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Root's picklable object, on every rank."""
    _require_init()
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
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
    _broadcast_tensors_(on_device, root_rank)
    others, groups = broadcast_object((others, groups), root_rank)
    for (i, key), val in others.items():
        optimizer.state[params[i]][key] = val
    for g, hp in zip(optimizer.param_groups, groups):
        g.update(hp)
