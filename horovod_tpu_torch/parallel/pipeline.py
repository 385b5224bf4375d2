"""Pipeline parallelism: the GPipe schedule over a mesh axis.

Counterpart of ``horovod_tpu/parallel/pipeline.py``.  Every rank of the
pipeline set (a mesh axis, ``"pp"`` or ``"pipe"``) runs the same loop of
``M + S - 1`` ticks for ``M`` microbatches and ``S`` stages (GPipe: fill,
steady state, drain; bubble ``(S - 1) / (M + S - 1)``): stage 0 takes
microbatch ``t`` at tick ``t``, the others what their left neighbour
sent at the tick before, and each tick ends in a
:func:`~horovod_tpu_torch.collectives.ops.ppermute` one stage to the
right.  The last stage banks microbatch ``t - S + 1``; its bank reaches
every rank by a masked sum (one allreduce whose backward is the
identity, Megatron's "g"), so every rank computes the same loss.

The backward is autograd's: each ppermute's backward sends its gradient
one stage to the left.  Every choice that depends on the stage is a
``torch.where`` on a flag, never a Python branch, so every rank builds
the same graph and runs the same ppermutes, forward and backward, in the
same order -- which the point-to-point pairs need.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch

from ..collectives.ops import ppermute
from .mesh import PP_AXIS
from .tp import reduce_from_tp, resolve_set


def stack_stage_params(per_stage: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack per-stage flat dicts along a new leading stage dim (stage
    ``s``'s own tree is ``{n: t[s] for n, t in stacked.items()}``)."""
    names = list(per_stage[0])
    return {n: torch.stack([p[n] for p in per_stage]) for n in names}


def split_microbatches(batch: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, ...) -> (n, B / n, ...)``."""
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} not divisible by {n}")
    return batch.reshape(n, batch.shape[0] // n, *batch.shape[1:])


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, *,
                   axis=PP_AXIS, mesh=None) -> torch.Tensor:
    """Run ``microbatches`` ``(M, mb, ...)`` (the same on every rank of
    the set) through the stages; returns the last stage's ``(M, mb,
    ...)`` outputs on every rank.  ``stage_fn(params, x) -> y`` with
    ``y.shape == x.shape``; ``stage_params`` is THIS rank's stage (the
    JAX function's ``P("pp")`` shard, its leading dim of 1 dropped)."""
    ps = resolve_set(axis, mesh)
    size, my = ps.size(), ps.position()
    m = microbatches.shape[0]
    ticks = m + size - 1
    perm = [(i, (i + 1) % size) for i in range(size)]
    dev = microbatches.device
    first = torch.tensor(my == 0, device=dev)
    last = torch.tensor(my == size - 1, device=dev)
    zero_mb = torch.zeros_like(microbatches[0])
    incoming = zero_mb
    banks = []
    for t in range(ticks):
        mb_in = microbatches[t] if t < m else zero_mb
        y = stage_fn(stage_params, torch.where(first, mb_in, incoming))
        if t >= size - 1:
            banks.append(y)
        if t < ticks - 1:
            incoming = ppermute(y, perm, process_set=ps)
    outputs = torch.where(last, torch.stack(banks), 0.0)
    return reduce_from_tp(outputs, axis=ps)


__all__ = ["pipeline_apply", "split_microbatches", "stack_stage_params"]
