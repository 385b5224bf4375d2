"""Tensor parallelism: Megatron's column- and row-parallel projections.

Counterpart of ``horovod_tpu/parallel/tp.py``.  Each rank of the
tensor-parallel set (a mesh axis, ``"tp"`` or ``"model"``; see
:mod:`~horovod_tpu_torch.parallel.mesh`) holds a shard of every split
kernel and computes on it (Shoeybi et al., arXiv:1909.08053):

* :func:`column_parallel` -- the kernel split on its output dim; no
  communication forward.  Its input's gradient is a per-rank PARTIAL
  sum, which :func:`copy_to_tp` (Megatron's "f": identity forward, one
  allreduce backward) closes before it reaches anything replicated;
* :func:`row_parallel` -- the kernel split on its input dim; the forward
  ends in one allreduce whose backward is the identity
  (:func:`reduce_from_tp`, Megatron's "g").  The bias adds after the sum.

Without the pair every kernel gradient comes out multiplied by the tp
extent, and norm and embedding gradients come out as per-rank partials.
A column -> row pair costs one allreduce forward and one backward.  On a
set of one rank both are the identity and no collective runs.

Parameters travel as flat ``{dotted name: tensor}`` dicts, the port's
names of the flax tree (``layer_0.wq.kernel``).
:func:`tp_param_specs` gives each leaf its split as a tuple, the JAX
``PartitionSpec`` as a tuple (``(None, axis)`` a column kernel,
``(axis,)`` a column bias, ``(axis, None)`` a row kernel, ``()``
replicated); :func:`shard_params` cuts this rank's shard by those specs
and :func:`gather_tp_params` reassembles the full tree from every rank's
shard (each shard into a zero tensor of the full shape at its offset,
then one ``Sum`` allreduce a leaf: exact, and an op every backend runs
on every device).  :func:`shard_tp_params` is the JAX function of that
name (kernels only).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..collectives.ops import exchange_allreduce_async_
from ..collectives.reduce_op import Sum
from ..core.process_sets import ProcessSet
from .mesh import TP_AXIS, axis_set

COLUMN_KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_in")
ROW_KEYS = ("wo", "w_down", "w_out")

Spec = tuple


def resolve_set(axis, mesh=None) -> ProcessSet:
    """``axis`` (a mesh axis name or tuple of names, or a
    :class:`ProcessSet`) as this rank's set."""
    if isinstance(axis, ProcessSet):
        return axis
    return axis_set(axis, mesh)


def _sum(x: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    return exchange_allreduce_async_(x.contiguous().clone(), Sum,
                                     process_set=ps).wait()


class _CopyToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ps):
        ctx.ps = ps
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.ps), None


class _ReduceFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ps):
        return _sum(x, ps)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, *, axis=TP_AXIS, mesh=None) -> torch.Tensor:
    """Megatron "f": identity forward, ``Sum`` allreduce over ``axis``
    backward.  Place it on an activation that feeds column-parallel
    layers; one covers every column layer reading the same tensor."""
    ps = resolve_set(axis, mesh)
    if ps.size() == 1:
        return x
    return _CopyToTP.apply(x, ps)


def reduce_from_tp(x: torch.Tensor, *, axis=TP_AXIS,
                   mesh=None) -> torch.Tensor:
    """Megatron "g": ``Sum`` allreduce over ``axis`` forward, identity
    backward (the output's gradient is already the same on every rank;
    an allreduce there would multiply every upstream gradient by the tp
    extent)."""
    ps = resolve_set(axis, mesh)
    if ps.size() == 1:
        return x
    return _ReduceFromTP.apply(x, ps)


def column_parallel(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    axis=TP_AXIS) -> torch.Tensor:
    """``x @ kernel_local (+ bias_local)``: ``kernel`` is this rank's
    ``(d_in, d_out / tp)`` shard; the output is sharded on its feature
    dim.  No communication (``axis`` documents the pairing)."""
    del axis
    y = x @ kernel
    if bias is not None:
        y = y + bias
    return y


def row_parallel(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, axis=TP_AXIS,
                 mesh=None) -> torch.Tensor:
    """``sum_tp(x_local @ kernel_local) (+ bias)``: ``x`` sharded on its
    feature dim (a :func:`column_parallel` output), ``kernel`` this rank's
    ``(d_in / tp, d_out)`` shard.  The bias adds after the sum (added
    per rank it would count tp times)."""
    y = reduce_from_tp(x @ kernel, axis=axis, mesh=mesh)
    if bias is not None:
        y = y + bias
    return y


def tp_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
           axis=TP_AXIS, activation=F.silu,
           w_gate: Optional[torch.Tensor] = None,
           mesh=None) -> torch.Tensor:
    """Column -> row MLP: SwiGLU (``activation(x @ w_gate) * (x @ w_up)``)
    with ``w_gate``, else ``activation(x @ w_up)``, then ``@ w_down``.
    One :func:`copy_to_tp` on the input, so the block costs one allreduce
    forward and one backward."""
    x = copy_to_tp(x, axis=axis, mesh=mesh)
    up = column_parallel(x, w_up)
    if w_gate is not None:
        up = activation(column_parallel(x, w_gate)) * up
    else:
        up = activation(up)
    return row_parallel(up, w_down, axis=axis, mesh=mesh)


def _owner(name: str):
    names = name.split(".")
    return names, (names[-2] if len(names) >= 2 else "")


def shard_tp_params(params: Dict[str, torch.Tensor], tp_rank: int,
                    tp_size: int, *, column_keys=COLUMN_KEYS,
                    row_keys=ROW_KEYS) -> Dict[str, torch.Tensor]:
    """This rank's TP shard of a replicated flat dict, the JAX function:
    column kernels split on the output (last) dim, row kernels on the
    input (first) dim; everything else -- column biases too -- stays
    whole.  The shards are views of ``params``."""
    out = {}
    for name, leaf in params.items():
        names, owner = _owner(name)
        if names[-1] != "kernel" or leaf.dim() < 2:
            out[name] = leaf
        elif owner in column_keys:
            if leaf.shape[-1] % tp_size:
                raise ValueError(
                    f"{owner}.kernel output dim {leaf.shape[-1]} not "
                    f"divisible by tp={tp_size}")
            width = leaf.shape[-1] // tp_size
            out[name] = leaf[..., tp_rank * width:(tp_rank + 1) * width]
        elif owner in row_keys:
            if leaf.shape[0] % tp_size:
                raise ValueError(
                    f"{owner}.kernel input dim {leaf.shape[0]} not "
                    f"divisible by tp={tp_size}")
            width = leaf.shape[0] // tp_size
            out[name] = leaf[tp_rank * width:(tp_rank + 1) * width]
        else:
            out[name] = leaf
    return out


def tp_param_specs(params, *, axis: str = TP_AXIS,
                   column_keys=COLUMN_KEYS,
                   row_keys=ROW_KEYS) -> Dict[str, Spec]:
    """``{name: spec}`` for a TP train step over natural-dim shards
    (``params``: a flat dict of tensors, or of anything with ``.dim()``
    or ``.ndim``): column kernels ``(None, axis)``, column BIASES
    ``(axis,)`` -- a bias added before the row sum lives on the sharded
    feature dim, so its gradient is per shard -- row kernels ``(axis,
    None)``, everything else ``()`` (row biases add after the sum on
    replicated activations)."""
    out = {}
    for name, leaf in params.items():
        ndim = leaf.dim() if hasattr(leaf, "dim") else len(leaf.shape)
        names, owner = _owner(name)
        spec: Spec = ()
        if len(names) >= 2 and names[-1] in ("kernel", "bias"):
            if owner in column_keys:
                if names[-1] == "kernel" and ndim == 2:
                    spec = (None, axis)
                elif names[-1] == "bias" and ndim == 1:
                    spec = (axis,)
            elif owner in row_keys and names[-1] == "kernel" \
                    and ndim == 2:
                spec = (axis, None)
        out[name] = spec
    return out


def split_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits (``None``: replicated)."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim")
    return dims[0] if dims else None


def shard_params(params: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                 tp_rank: int, tp_size: int) -> Dict[str, torch.Tensor]:
    """This rank's shard of every leaf by ``specs``
    (:func:`tp_param_specs`): the split dim cut in ``tp_size`` blocks,
    block ``tp_rank`` kept (a contiguous copy); replicated leaves as they
    are."""
    out = {}
    for name, leaf in params.items():
        d = split_dim(specs.get(name, ()))
        if d is None:
            out[name] = leaf
            continue
        if leaf.shape[d] % tp_size:
            raise ValueError(f"{name}: dim {d} ({leaf.shape[d]}) not "
                             f"divisible by tp={tp_size}")
        w = leaf.shape[d] // tp_size
        out[name] = leaf.narrow(d, tp_rank * w, w).contiguous()
    return out


def gather_tp_params(local: Dict[str, torch.Tensor],
                     specs: Dict[str, Spec], *, axis=TP_AXIS,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params` over the set of ``axis``: every
    split leaf whole, from every member's shard (see the module
    docstring); replicated leaves as they are.  Collective over the set,
    leaf by leaf in ``local``'s order.  The JAX 3-D step's ``out_specs``
    reassemble the same tree, which checkpoints save."""
    ps = resolve_set(axis, mesh)
    n, pos = ps.size(), ps.position()
    out = {}
    with torch.no_grad():
        for name, leaf in local.items():
            d = split_dim(specs.get(name, ()))
            if d is None or n == 1:
                out[name] = leaf
                continue
            shape = list(leaf.shape)
            w = shape[d]
            shape[d] = w * n
            full = leaf.new_zeros(shape)
            full.narrow(d, pos * w, w).copy_(leaf)
            out[name] = exchange_allreduce_async_(
                full, Sum, process_set=ps).wait()
    return out


def split_bytes(params: Dict[str, torch.Tensor],
                specs: Dict[str, Spec]) -> int:
    """Bytes of the leaves ``specs`` splits."""
    return sum(t.numel() * t.element_size() for n, t in params.items()
               if split_dim(specs.get(n, ())) is not None)


__all__ = ["COLUMN_KEYS", "ROW_KEYS", "column_parallel", "copy_to_tp",
           "gather_tp_params", "reduce_from_tp", "resolve_set",
           "row_parallel", "shard_params", "shard_tp_params",
           "split_bytes", "split_dim", "tp_mlp", "tp_param_specs"]
