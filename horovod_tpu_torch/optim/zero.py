"""ZeRO-1 sharded optimizer state (Rajbhandari et al., 2020).

Counterpart of ``horovod_tpu/optim/zero.py``.  The replicated step
allreduces every gradient and runs the whole optimizer on every rank;
ZeRO stage 1 splits that work over the world:

* the gradients are packed into flat per-dtype **arenas** (leaf order,
  each zero-padded to a multiple of the world) and exchanged with one
  ``reduce_scatter`` an arena: each rank receives the mean of its own
  1/n slice only (the autotuner's zero axis, ``HOROVOD_AUTOTUNE_ZERO=1``,
  also samples an allreduce of the whole arena, of which each rank keeps
  its slice: :func:`_use_reducescatter`);
* each rank runs the optimizer on its slice of the parameter arena, so
  the optimizer's work and state shrink by the world size;
* the updated shards come back with one ``all_gather`` an arena,
  optionally compressed -- fp16/bf16 cast the wire; fp8 quantizes each
  shard with one scale and every rank dequantizes every shard from the
  wire bytes, its own included, so the replicas stay bitwise equal; an
  error-feedback codec (powersgd/topk) sends each owner's compressed
  parameter DELTA (:func:`ef_delta_allgather`) with the residual kept on
  the owner.

In torch's idiom the sharded state is a :class:`ZeroState`: a shard-local
inner ``torch.optim.Optimizer`` of the bare optimizer's class and
hyperparameters over the rank's flat arena shards (plus the EF residuals).
Every optimizer on the port's paths (SGD with momentum, AdamW) is
elementwise, so an update of a flat shard is the per-leaf update.  Pass
the BARE optimizer: :func:`zero_apply`'s reduce-scatter replaces the
``DistributedOptimizer``'s allreduce, and a wrapped one is refused.

With a per-leg codec on a two-level layout -- the world's
(:func:`~horovod_tpu_torch.core.topology.hier_mesh_shape`) or that of a
mesh's two data axes (``build_3d_mesh(dcn_size=...)``: the arenas are
sharded over the data set, ``(dcn, inner)``) -- the reduce-scatter runs
within the node first and then across nodes, and the allgather in the
inverse order, so only the 1/n_ici slice crosses nodes; shard ``j = ici
* n_dcn + dcn`` belongs to the rank at those positions, the JAX
package's ``(ici, dcn)``-major order, in :func:`zero_init` and
:func:`zero_apply` alike.

Elastic resizes (:func:`zero_resize`) work on the state of every rank at
once, as the JAX package's arenas hold it: :func:`zero_stack` gathers each
rank's inner optimizer state and residuals into ``[world, ...]`` host
tensors (a :class:`StackedZeroState`), :func:`zero_resize` re-lays them
for another world size, and :func:`zero_load` copies this rank's row back
into a live :class:`ZeroState` in place.  Not here: ``zero_sharding`` /
``shard_zero_state``, which place state on a JAX mesh: each rank's state
lives on its own device here, so they have no counterpart.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..collectives.compression import (Compression, fp8_quantize, is_fp8,
                                       is_error_feedback, is_hier_legs,
                                       is_powersgd, parse_compression,
                                       powersgd_factor_widths,
                                       powersgd_matrix_shape, topk_count)
from ..collectives.ops import (_divide_in_dtype, _group_allgather,
                               _group_reduce_scatter, _powersgd_seed_matrix,
                               _topk_select, psum_scatter_bucket,
                               step_allreduce_)
from ..collectives.reduce_op import Sum
from ..controller.fusion import _LeafSpec, dtype_name, plan_exchange
from ..core.basics import _require_init
from ..core.state import global_state
from ..core.topology import set_pair
from ..timeline.metrics import note_collective, note_zero_step
from ..timeline.spans import note_leg


@dataclasses.dataclass(frozen=True)
class _ArenaBuffer:
    """One flat per-dtype buffer of the ZeRO arena."""
    dtype: torch.dtype
    leaves: Tuple[_LeafSpec, ...]
    size: int      # unpadded element count
    padded: int    # padded so ``world`` divides it
    shard: int     # padded // world


@dataclasses.dataclass(frozen=True)
class ZeroSpec:
    """How a leaf list maps onto the arenas: a pure function of the
    leaves' shapes and dtypes and the world size."""
    buffers: Tuple[_ArenaBuffer, ...]
    num_leaves: int
    world: int


def plan_arena(leaves: Sequence, world: int) -> ZeroSpec:
    """One arena per dtype (first appearance order, leaf order within),
    padded to a multiple of ``world``."""
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(
            _LeafSpec(i, tuple(x.shape), int(math.prod(x.shape))))
    buffers = []
    for dt, specs in by_dtype.items():
        size = sum(s.size for s in specs)
        padded = int(math.ceil(size / world)) * world if size else 0
        buffers.append(_ArenaBuffer(dtype=dt, leaves=tuple(specs),
                                    size=size, padded=padded,
                                    shard=padded // world))
    return ZeroSpec(buffers=tuple(buffers), num_leaves=len(leaves),
                    world=world)


def arena_pack(leaves: Sequence[torch.Tensor],
               spec: ZeroSpec) -> List[torch.Tensor]:
    """Ravel and concatenate the leaves into new padded flat arenas."""
    out = []
    for buf in spec.buffers:
        parts = [leaves[s.index].reshape(-1) for s in buf.leaves]
        pad = buf.padded - buf.size
        if pad:
            parts.append(parts[0].new_zeros(pad))
        out.append(torch.cat(parts))
    return out


def arena_unpack(arenas: Sequence[torch.Tensor],
                 spec: ZeroSpec) -> List[torch.Tensor]:
    """Slice the arenas (padding dropped) back into the leaf list
    (views)."""
    leaves: List[Optional[torch.Tensor]] = [None] * spec.num_leaves
    for arena, buf in zip(arenas, spec.buffers):
        off = 0
        for s in buf.leaves:
            leaves[s.index] = arena[off:off + s.size].view(s.shape)
            off += s.size
    assert all(x is not None for x in leaves)
    return leaves  # type: ignore[return-value]


def _reject_distributed(optimizer) -> None:
    from .distributed import _DistributedOptimizer
    if isinstance(optimizer, _DistributedOptimizer):
        raise ValueError(
            "zero_stage=1 replaces the gradient allreduce with a "
            "reduce-scatter; pass the bare optimizer, not "
            "DistributedOptimizer (which would re-reduce disjoint shard "
            "gradients)")


def _comm(ps) -> Tuple[object, int]:
    """``(group, size)`` of a set view, or of the world for ``None``."""
    if ps is None:
        return None, dist.get_world_size()
    return ps.group, ps.size()


def _allgather(x: torch.Tensor, ps=None) -> torch.Tensor:
    return _group_allgather(x, *_comm(ps))


def compressed_allgather(x: torch.Tensor, *, compression=None,
                         process_set=None) -> torch.Tensor:
    """Allgather every member's flat ``x`` (its shard), with an optional
    wire codec.  fp16/bf16 cast the shard down for the wire and back up;
    fp8 sends the e4m3 codes and one f32 scale a shard and dequantizes
    every shard from the wire bytes -- the sender's own included, so
    every rank gets the same values.  Non-floating or already one-byte
    shards gather as they are.  ``process_set`` is a set view (``None``:
    the world)."""
    comp = parse_compression(compression)
    if is_fp8(comp):
        if not x.dtype.is_floating_point or x.element_size() <= 1:
            return _allgather(x, process_set)
        q, scale = fp8_quantize(x)
        full_q = _allgather(q.view(torch.uint8), process_set)
        scales = _allgather(scale.reshape(1), process_set)
        n = scales.numel()
        full = full_q.view(torch.float8_e4m3fn).float().view(n, -1) \
            * scales[:, None]
        return full.reshape(-1).to(x.dtype)
    wire, ctx = comp.compress(x)
    return comp.decompress(_allgather(wire, process_set), ctx)


def _orthonormalize_columns(p: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the few columns of ``p`` (the JAX
    package's ``ops._orthonormalize_columns``, in plain PyTorch)."""
    cols = []
    for k in range(p.shape[1]):
        v = p[:, k]
        for u in cols:
            v = v - torch.dot(u, v) * u
        norm = torch.sqrt(torch.sum(v * v))
        cols.append(v / torch.clamp_min(norm, 1e-12))
    return torch.stack(cols, dim=1)


def ef_delta_allgather(delta: torch.Tensor, *, compression,
                       order: Optional[Sequence[int]] = None,
                       process_set=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed allgather of each shard owner's parameter DELTA (flat
    f32, the fed-back residual included).

    Each rank compresses its own delta locally -- PowerSGD as a local
    low-rank factorization (``P = orth(M Q0)``, ``Q = M^T P``; the plain
    orthonormalization, no collective inside), top-k as its largest
    magnitudes -- then one allgather moves the compressed payloads and
    every rank rebuilds every shard's delta from the same bytes.

    Returns ``(full, own)``: the ``[n, shard]`` f32 rebuild, row ``j``
    shard ``j`` (``order[j]`` is the world rank that owns shard ``j``;
    default rank ``j``), and this rank's own row (what the world applied
    for it -- the EF residual is ``delta - own``).  Over the members of
    ``process_set`` (a set view; every rank when ``None``), ``order``
    and the rows then indexed by set position."""
    _, n = _comm(process_set)
    me = dist.get_rank() if process_set is None else process_set.position()
    perm = list(order) if order is not None else list(range(n))
    shard = delta.numel()
    if is_powersgd(compression):
        m, c = powersgd_matrix_shape(shard)
        pad = m * c - shard
        flat = torch.cat([delta, delta.new_zeros(pad)]) if pad else delta
        mat = flat.view(m, c)
        r = max(1, min(int(compression.rank), m, c))
        p = _orthonormalize_columns(
            mat @ _powersgd_seed_matrix(c, r, delta.device))
        q = mat.T @ p                                     # [c, r]
        wire = torch.cat([p.reshape(-1), q.reshape(-1)])  # [r * (m + c)]
        gw = _allgather(wire, process_set).view(n, -1)[perm]
        ps = gw[:, :r * m].reshape(n, m, r)
        qs = gw[:, r * m:].reshape(n, c, r)
        full = torch.einsum("nmr,ncr->nmc", ps, qs).reshape(n, -1)[:, :shard]
    else:
        k = min(topk_count(shard, compression.fraction), shard)
        idx = _topk_select(delta, k)
        gv = _allgather(delta[idx], process_set).view(n, k)[perm]
        gi = _allgather(idx.to(torch.int32), process_set).view(n, k)[perm]
        pos = gi.long() + (torch.arange(n, device=delta.device)
                           * shard)[:, None]
        full = delta.new_zeros(n * shard).index_put_(
            (pos.reshape(-1),), gv.reshape(-1)).view(n, shard)
    return full, full[perm.index(me)]


@dataclasses.dataclass
class ZeroState:
    """The sharded optimizer state of ``zero_stage=1``: the arena plan,
    this rank's parameter shards (flat, one an arena), the inner
    optimizer over them (the bare optimizer's class and
    hyperparameters), and -- for an error-feedback codec -- one f32
    residual a shard, on its owner."""
    spec: ZeroSpec
    shards: List[torch.Tensor]
    inner: torch.optim.Optimizer
    residuals: Optional[List[torch.Tensor]] = None
    # The set the arenas are sharded over (the 3-D step's data set);
    # None: every rank.
    process_set: Any = None
    # The arena's leaf order as indices into the leaves zero_apply gets
    # (zero_init's param_specs: the JAX package's leaf order); None: as
    # given.
    order: Optional[List[int]] = None

    def state_bytes(self) -> int:
        """Bytes of the inner optimizer's state tensors on this rank."""
        return _state_bytes(self.inner)


def _inner_optimizer(optimizer: torch.optim.Optimizer,
                     tensors: Sequence[torch.Tensor]
                     ) -> torch.optim.Optimizer:
    """A new optimizer of ``optimizer``'s class over ``tensors`` with its
    (single) parameter group's hyperparameters."""
    if len(optimizer.param_groups) != 1:
        raise ValueError(
            f"zero_stage=1 needs an optimizer with one parameter group "
            f"(the arenas mix every leaf), got "
            f"{len(optimizer.param_groups)}")
    cls = type(optimizer)
    hyper = {k: v for k, v in optimizer.param_groups[0].items()
             if k != "params"}
    accepted = inspect.signature(cls.__init__).parameters
    inner = cls(list(tensors), **{k: v for k, v in hyper.items()
                                  if k in accepted})
    inner.param_groups[0].update(hyper)
    return inner


def _state_bytes(opt: torch.optim.Optimizer) -> int:
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if torch.is_tensor(v))


def _check_legs(comp, ps) -> None:
    """A per-leg codec needs a two-level layout: every rank's, or a mesh
    data set's; a user's process set is one level."""
    if is_hier_legs(comp) and ps is not None and \
            getattr(ps, "hier", None) is None:
        raise ValueError("zero_compression per leg (ici:...,dcn:...) runs "
                         "over every rank or a mesh's two data axes, not a "
                         "process set")


def _shard_index(comp, ps=None) -> Tuple[int, Optional[Any]]:
    """This rank's shard index among the arena's set ``ps`` (every rank
    when ``None``), and the two-level layout (a ``HierPair``) when a
    per-leg codec runs on one: shard ``ici * n_dcn + dcn``."""
    st = _require_init()
    pair = set_pair(ps) if is_hier_legs(comp) else None
    if pair is None or pair.n_dcn == 1:
        return (st.rank if ps is None else ps.position()), None
    dcn, ici = pair.index()
    return ici * pair.n_dcn + dcn, pair


def _owner_order(pair, n: int) -> List[int]:
    """The position in the arena's set owning each shard index (shard
    ``ici * n_dcn + dcn`` is position ``dcn * n_ici + ici``)."""
    if pair is None:
        return list(range(n))
    n_dcn, n_ici = pair.shape
    return [(j % n_dcn) * n_ici + j // n_dcn for j in range(n)]


def _zero_set(process_set):
    """A set view for the arenas (``None``: every rank, the bare global
    set included; a mesh's data set keeps its two-level pair)."""
    if process_set is None:
        return None
    from ..core.process_sets import get_process_set
    ps = get_process_set(process_set)
    return None if ps.is_global() and ps.hier is None else ps


def zero_init(optimizer: torch.optim.Optimizer, params, mesh=None,
              compression=None, param_specs=None,
              process_set=None) -> ZeroState:
    """The sharded state for ``zero_stage=1`` (the JAX ``zero_init(
    optimizer, params, mesh=, compression=, param_specs=)``): this rank's
    arena shards, an inner optimizer over them, and -- when
    ``compression`` is an error-feedback codec -- zero f32 residuals, one
    a shard.  Collective-free.

    ``params`` are the tensors this rank trains, as :func:`zero_apply`
    gets them: a sequence, or a ``{name: tensor}`` dict (then in its
    order).  On a model-parallel mesh they are this rank's TP / stage
    shards (a rank holds no other), and the arenas are sharded over the
    mesh's data set only: every ``(tp, pipe)`` group owns the arenas of
    its own shards.  ``mesh`` (the current mesh when ``param_specs`` is
    given without one) selects that data set
    (``mesh.group(data_axes(mesh))``); with two data axes, ``(dcn,
    inner)``, a per-leg codec runs the two-level exchange over them.
    ``param_specs`` -- the ``{name: spec}`` dict the step was built with
    -- takes the leaves in the JAX package's leaf order
    (``models.convert.flax_leaf_order`` of the names), so the arenas and
    every shard are the JAX ``zero_init``'s on the same mesh; ``params``
    must then be a dict with the same names.  ``process_set`` shards the
    arenas over a set of one's own (one level); given beside a mesh it
    must be the mesh's data set, else ``ValueError``."""
    from ..core.process_sets import get_process_set
    _reject_distributed(optimizer)
    comp = parse_compression(compression) if compression else \
        Compression.none
    order = None
    if isinstance(params, dict):
        names, tensors = list(params), list(params.values())
        if param_specs is not None:
            if set(param_specs) != set(names):
                raise ValueError(
                    f"param_specs names {sorted(set(param_specs) ^ set(names))}"
                    f" differ from the params'")
            from ..models.convert import flax_leaf_order
            order = list(flax_leaf_order(names))
    else:
        if param_specs is not None:
            raise ValueError("param_specs= needs params as a {name: tensor} "
                             "dict (the names the specs key)")
        tensors = list(params)
    st = _require_init()
    ps = _zero_set(process_set)
    if mesh is not None or param_specs is not None:
        from ..parallel.mesh import current_mesh, data_axes
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError("zero_init(param_specs=) needs a mesh "
                             "(build_3d_mesh) or mesh=")
        data = mesh.group(data_axes(mesh))
        if process_set is not None and \
                get_process_set(process_set).ranks != data.ranks:
            raise ValueError(
                f"zero_init: process_set {get_process_set(process_set).ranks}"
                f" conflicts with the mesh's data set {data.ranks}")
        ps = _zero_set(data)
    _check_legs(comp, ps)
    leaves = [tensors[i].detach() for i in order] if order is not None \
        else [p.detach() for p in tensors]
    spec = plan_arena(leaves, st.size if ps is None else ps.size())
    idx = _shard_index(comp, ps)[0]
    shards = [a[idx * b.shard:(idx + 1) * b.shard].clone()
              for a, b in zip(arena_pack(leaves, spec), spec.buffers)]
    residuals = None
    if is_error_feedback(comp):
        residuals = [torch.zeros(b.shard, device=a.device)
                     for a, b in zip(shards, spec.buffers)]
    return ZeroState(spec, shards, _inner_optimizer(optimizer, shards),
                     residuals, ps, order)


def zero_plan(spec: ZeroSpec, compression=None, shape=None,
              use_rs: bool = True):
    """The ``zero`` plan of one step over ``spec``'s arenas:
    ``(gradient rows, allgather rows)``, one of each an arena
    (``plan_exchange("zero")``; ``shape`` is the two-level layout a
    per-leg codec runs on, else ``None``; ``use_rs`` False prices the
    allreduce exchange's rows)."""
    legs = plan_exchange(
        "zero", buffers=tuple((dtype_name(b.dtype), b.size, b.padded,
                               b.shard) for b in spec.buffers),
        world=spec.world, compression=compression, axes_shape=shape,
        axes=("dcn", "ici") if shape is not None else (),
        use_rs=use_rs).legs
    k = len(spec.buffers)
    return legs[:k], legs[k:]


def _use_reducescatter() -> bool:
    """The gradient exchange over the arena (the JAX function): the
    reduce-scatter, unless the autotuner's zero axis is being searched
    (``HOROVOD_AUTOTUNE_ZERO=1`` on a zero run), whose sample picks the
    reduce-scatter (1) or the allreduce exchange (0)."""
    tuner = global_state().autotuner
    if tuner is not None and tuner.tunes_zero:
        return bool(tuner.zero_stage())
    return True


def _resolve_compression(compression):
    """The allgather's codec: ``compression`` (none when not given), or
    the autotuner's compression axis while one is active, as ZeRO-1's
    exchange can run it (``Autotuner.codec_for``)."""
    comp = parse_compression(compression) if compression else \
        Compression.none
    tuner = global_state().autotuner
    return comp if tuner is None else tuner.codec_for(comp, "zero")


def _reduce_scatter_mean(g: torch.Tensor, buf: _ArenaBuffer, n: int,
                         pair, leg, use_rs: bool = True,
                         idx: int = 0, ps=None) -> torch.Tensor:
    """This rank's shard (index ``idx``) of the mean of ``g`` over the
    world: one reduce-scatter, or within the node and then across nodes
    (counted at its row's bytes); with ``use_rs`` False, an allreduce of
    the whole arena, of which this rank keeps its shard."""
    if not use_rs:
        full = step_allreduce_(g, Sum, process_set=ps)
        out = full[idx * buf.shard:(idx + 1) * buf.shard].clone()
    elif pair is None:
        out = psum_scatter_bucket(g, quantum=n, process_set=ps)
    else:
        note_collective("reducescatter", "global" if ps is None else
                        ps.name, leg.nbytes)
        ici, dcn = pair.sets()
        piece = _group_reduce_scatter(g, ici.group, pair.n_ici)
        out = _group_reduce_scatter(piece, dcn.group, pair.n_dcn)
    return _divide_in_dtype(out, n)


def zero_apply(optimizer: torch.optim.Optimizer,
               grads: Sequence[Optional[torch.Tensor]], zero_state: ZeroState,
               params: Sequence[torch.Tensor], *,
               compression=None) -> Tuple[List[torch.Tensor], ZeroState]:
    """One ZeRO-1 step: reduce-scatter the mean of ``grads`` arena by
    arena, run the inner optimizer on this rank's shard of ``params``,
    allgather the updated shards (compressed by ``compression``) and
    write them into ``params`` in place.  ``None`` gradients count as
    zeros.  Returns ``(params, zero_state)``.

    With an error-feedback ``compression`` the allgather moves each
    owner's compressed delta (:func:`ef_delta_allgather`) and the
    residuals of ``zero_state`` (from ``zero_init(...,
    compression=...)``) carry what was not sent.  Notes the step's
    ``zero`` rows (:func:`zero_plan`) and feeds the ZeRO-1 counters
    (``timeline.metrics.zero_totals``) with the link bytes
    :func:`zero_report` prices, from the rows."""
    from .distributed import _ef_enabled
    _reject_distributed(optimizer)
    params = list(params)
    if not params:
        return params, zero_state
    comp = _resolve_compression(compression)
    ef = is_error_feedback(comp)
    if ef and zero_state.residuals is None:
        raise ValueError(
            "zero_compression=powersgd/topk needs the residual-carrying "
            "state from zero_init(..., compression=...)")
    ps = zero_state.process_set
    _, n = _comm(ps)
    spec = zero_state.spec
    grads = list(grads)
    given = params
    if zero_state.order is not None:
        if len(params) != len(zero_state.order) or \
                len(grads) != len(params):
            raise ValueError("zero_state was planned for other parameters")
        params = [params[i] for i in zero_state.order]
        grads = [grads[i] for i in zero_state.order]
    if spec != plan_arena(params, n):
        raise ValueError("zero_state was planned for other parameters or "
                         "another world size")
    _check_legs(comp, ps)
    idx, pair = _shard_index(comp, ps)
    shape = pair.shape if pair is not None else None
    set_name = "global" if ps is None else ps.name
    use_rs = _use_reducescatter()
    rs_legs, ag_legs = zero_plan(spec, comp, shape, use_rs)
    grads = [g if g is not None else torch.zeros_like(p)
             for g, p in zip(grads, params)]
    with torch.no_grad():
        g_arenas = arena_pack(grads, spec)
        p_arenas = arena_pack([p.detach() for p in params], spec)
        for g, p, buf, shard, leg in zip(g_arenas, p_arenas, spec.buffers,
                                         zero_state.shards, rs_legs):
            note_leg(leg)
            shard.grad = _reduce_scatter_mean(g, buf, n, pair, leg,
                                              use_rs, idx, ps)
            shard.copy_(p[idx * buf.shard:(idx + 1) * buf.shard])
        old = [s.clone() for s in zero_state.shards] if ef else None
        zero_state.inner.step()
        for s in zero_state.shards:
            s.grad = None
        full, ag_payload, ag_extra = [], 0, 0
        if ef:
            feed = _ef_enabled()
            dcomp = comp.dcn if is_hier_legs(comp) else comp
            order = _owner_order(pair, n)
            for i, (o, new, arena, buf) in enumerate(zip(
                    old, zero_state.shards, p_arenas, spec.buffers)):
                note_leg(ag_legs[i])
                note_collective("allgather", set_name, ag_legs[i].nbytes)
                if not buf.dtype.is_floating_point or buf.shard < 1:
                    g = _allgather(new, ps).view(n, -1)[order].reshape(-1)
                    full.append(g)
                    ag_extra += g.numel() * g.element_size() * (n - 1) // n
                    continue
                res = zero_state.residuals[i]
                delta = new.float() - o.float()
                if feed:
                    delta = delta + res
                recon, own = ef_delta_allgather(delta, compression=dcomp,
                                                order=order, process_set=ps)
                full.append((arena.float() + recon.reshape(-1))
                            .to(buf.dtype))
                ag_extra += _ef_wire(dcomp, buf) * n * (n - 1) // n
                if feed:
                    res.copy_(delta - own)      # in place, replayable
        else:
            for s, buf, leg in zip(zero_state.shards, spec.buffers, ag_legs):
                note_leg(leg)
                note_collective("allgather", set_name, leg.nbytes)
                if pair is not None:
                    ici, dcn = pair.sets()
                    block = compressed_allgather(s, compression=comp.dcn,
                                                 process_set=dcn)
                    g = compressed_allgather(block, compression=comp.ici,
                                             process_set=ici)
                else:
                    g = compressed_allgather(s, compression=comp,
                                             process_set=ps)
                full.append(g)
                ag_payload += n * leg.elements * _wire_itemsize(comp,
                                                                buf.dtype)
                if is_fp8(comp):
                    ag_extra += 4 * n         # one f32 scale a shard
        for p, v in zip(params, arena_unpack(full, spec)):
            p.copy_(v)
    rs = sum(leg.nbytes for leg in rs_legs)
    note_zero_step(rs * (n - 1) // n, ag_payload * (n - 1) // n + ag_extra,
                   zero_state.state_bytes())
    return given, zero_state


def _wire_itemsize(comp, dt: torch.dtype) -> int:
    if not dt.is_floating_point:
        return dt.itemsize
    if is_fp8(comp):
        return 1 if dt.itemsize > 1 else dt.itemsize
    wd = getattr(comp, "wire_dtype", None)
    if wd is not None and dt.itemsize > wd.itemsize:
        return wd.itemsize
    return dt.itemsize


def _ef_wire(comp, buf: _ArenaBuffer) -> int:
    """One owner's compressed-delta payload bytes for one arena."""
    if not buf.dtype.is_floating_point or buf.shard < 1:
        return buf.shard * buf.dtype.itemsize
    if is_powersgd(comp):
        pw, qw = powersgd_factor_widths(buf.shard, comp.rank)
        return 4 * (pw + qw)
    return 8 * topk_count(buf.shard, comp.fraction)


def _meta_state_bytes(optimizer, shapes_dtypes) -> int:
    """The optimizer's state bytes over tensors of these shapes and
    dtypes, from one step on the meta device (nothing materialized)."""
    ts = [torch.empty(shape, dtype=dt, device="meta")
          for shape, dt in shapes_dtypes]
    for t in ts:
        t.grad = torch.empty_like(t)
    inner = _inner_optimizer(optimizer, ts)
    inner.step()
    return _state_bytes(inner)


def zero_report(optimizer: torch.optim.Optimizer, params, world: int,
                compression=None) -> dict:
    """Static wire and memory accounting of ``zero_stage=1`` (the JAX
    package's dict, same keys): per-rank link bytes a step of the
    gradient reduce-scatter and the (compressed) parameter allgather,
    their sum, the replicated allreduce's, and the optimizer-state bytes
    a rank holds under ZeRO-1 and replicated.  ``params`` needs only
    shapes and dtypes (meta tensors do); the state bytes come from one
    step of ``optimizer``'s class on the meta device -- for SGD with
    momentum those of ``optax.sgd``; torch's Adam family keeps one step
    counter a tensor where optax keeps one."""
    params = list(params)
    spec = plan_arena(params, world)
    comp = parse_compression(compression) if compression else \
        Compression.none
    rs = sum(b.padded * b.dtype.itemsize
             for b in spec.buffers) * (world - 1) // max(world, 1)
    if is_error_feedback(comp):
        ag = sum(_ef_wire(comp, b) * world * (world - 1) // max(world, 1)
                 for b in spec.buffers)
    else:
        ag = sum(b.padded * _wire_itemsize(comp, b.dtype)
                 for b in spec.buffers) * (world - 1) // max(world, 1)
        if is_fp8(comp):
            ag += 4 * world * len(spec.buffers)
    full_bytes = sum(b.padded * b.dtype.itemsize for b in spec.buffers)
    allreduce_eq = 2 * full_bytes * (world - 1) // max(world, 1)
    shard_state = _meta_state_bytes(
        optimizer, [((b.shard,), b.dtype) for b in spec.buffers])
    full_state = _meta_state_bytes(
        optimizer, [(tuple(p.shape), p.dtype) for p in params])
    return {
        "world": world,
        "reducescatter_bytes_per_chip": int(rs),
        "allgather_bytes_per_chip": int(ag),
        "zero1_exchanged_bytes_per_chip": int(rs + ag),
        "replicated_allreduce_bytes_per_chip": int(allreduce_eq),
        "opt_state_bytes_per_chip_zero1": int(shard_state),
        "opt_state_bytes_per_chip_replicated": int(full_state),
    }


# --- elastic resize -------------------------------------------------------

class StackedZeroState(NamedTuple):
    """Every rank's ZeRO-1 state at once (the JAX package's layout):
    ``inner`` one dict an arena, each optimizer state entry a
    ``[world, ...]`` tensor (row ``r`` rank ``r``'s shard; a 0-dim entry
    such as Adam's ``step`` becomes ``[world]``, a host value stays as it
    is), and ``residuals`` one ``[world, shard]`` f32 tensor an arena for
    an error-feedback codec (the JAX ``_ZeroEFState``), else ``None``."""
    residuals: Optional[Tuple[torch.Tensor, ...]]
    inner: Any


def zero_stack(zero_state: ZeroState) -> StackedZeroState:
    """Gather every rank's shard-local state into a
    :class:`StackedZeroState` of CPU tensors (collective: every rank
    calls it at the same point).  Device tensors travel by allgather,
    host tensors (Adam's ``step`` without ``capturable``) as objects."""
    from .functions import allgather_object
    st = _require_init()
    n = st.size

    def gather(v: torch.Tensor) -> torch.Tensor:
        if v.device == st.device:
            flat = _allgather(v.detach().reshape(-1).contiguous())
            return flat.view((n,) + tuple(v.shape)).cpu()
        return torch.stack([t.reshape(v.shape) for t in
                            allgather_object(v.detach().cpu())])

    inner = []
    for shard in zero_state.shards:
        entry = zero_state.inner.state.get(shard, {})
        inner.append({k: gather(v) if torch.is_tensor(v) else v
                      for k, v in sorted(entry.items())})
    residuals = None
    if zero_state.residuals is not None:
        residuals = tuple(gather(r) for r in zero_state.residuals)
    return StackedZeroState(residuals, inner)


def zero_load(zero_state: ZeroState, stacked: StackedZeroState,
              row: Optional[int] = None) -> ZeroState:
    """Copy row ``row`` (this rank's shard index when ``None``) of
    ``stacked`` into ``zero_state`` in place: the inner optimizer's state
    tensors and the residuals keep their identities (a captured train
    loop replays them), entries the live state lacks are created, and
    entries ``stacked`` lacks are dropped."""
    if row is None:
        row, _ = _shard_index(Compression.none, zero_state.process_set)
    if len(stacked.inner) != len(zero_state.shards):
        raise ValueError(
            f"stacked ZeRO state has {len(stacked.inner)} arena(s), the "
            f"live state {len(zero_state.shards)}")
    with torch.no_grad():
        for shard, entry in zip(zero_state.shards, stacked.inner):
            live = zero_state.inner.state[shard]
            for k in [k for k in live if k not in entry]:
                del live[k]
            for k, v in entry.items():
                if not torch.is_tensor(v):
                    live[k] = v
                    continue
                src = v[row]
                cur = live.get(k)
                if torch.is_tensor(cur) and cur.shape == src.shape and \
                        cur.dtype == src.dtype:
                    cur.copy_(src)
                else:
                    dev = cur.device if torch.is_tensor(cur) else \
                        (shard.device if src.dim() else src.device)
                    live[k] = src.to(dev).clone()
        if stacked.residuals is not None and zero_state.residuals is not None:
            for r, s in zip(zero_state.residuals, stacked.residuals):
                r.copy_(s[row])
    return zero_state


def zero_resize(state, params, old_world: int, new_world: int):
    """Re-lay ZeRO-1 state out for a new world size (the JAX package's
    ``zero_resize``, on the same numbers).

    ``state`` is a :class:`StackedZeroState`, or any tree (dicts, lists,
    tuples) of ``[old_world, ...]`` tensors.  The flat arenas are planned
    again for ``new_world`` over ``params`` and every sharded leaf
    (leading ``[old_world, shard]``) is re-sliced so each new rank owns
    the right 1/``new_world`` of the SAME flat content -- nothing is
    derived again, the bytes move.  The residuals index flat arena
    positions, so re-slicing carries the unsent compression mass exactly
    (only the arena padding changes).  ``[old_world]`` leaves (Adam's
    step count) are broadcast from row 0.

    Returns ``(new_state, report)`` with ``report = {"carried_bytes",
    "zeroed_buckets", "resharded", "replicated"}``.  Raises
    ``ValueError`` when ``params`` is ``None`` or a sharded leaf matches
    no arena."""
    import logging
    logger = logging.getLogger("horovod_tpu_torch.optim")
    if params is None:
        raise ValueError("zero_resize needs the params tree to re-plan "
                         "the flat arenas")
    from ..data.tree import tree_map
    old_world, new_world = int(old_world), int(new_world)
    leaves = list(params)
    old_spec = plan_arena(leaves, old_world)
    new_spec = plan_arena(leaves, new_world)
    report = {"carried_bytes": 0, "zeroed_buckets": 0, "resharded": 0,
              "replicated": 0}

    def relayout(arr: torch.Tensor, ob: _ArenaBuffer, nb: _ArenaBuffer
                 ) -> torch.Tensor:
        flat = arr.reshape(-1)[:ob.size]
        pad = nb.padded - ob.size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.reshape(new_world, nb.shard).clone()

    def match_buffer(arr: torch.Tensor) -> Optional[int]:
        cands = [i for i, b in enumerate(old_spec.buffers)
                 if b.shard == arr.shape[1]]
        if len(cands) > 1:
            same_dt = [i for i in cands
                       if old_spec.buffers[i].dtype == arr.dtype]
            cands = same_dt or cands
        return cands[0] if len(cands) == 1 else None

    residuals = None
    inner = state
    if isinstance(state, StackedZeroState):
        inner = state.inner
        if state.residuals is not None:
            res_out = []
            for r, ob, nb in zip(state.residuals, old_spec.buffers,
                                 new_spec.buffers):
                arr = torch.as_tensor(r).detach().cpu().float()
                if arr.dim() == 2 and tuple(arr.shape) == (old_world,
                                                           ob.shard):
                    res_out.append(relayout(arr, ob, nb))
                    report["carried_bytes"] += int(ob.size * 4)
                else:
                    logger.warning(
                        "zero_resize: residual carry of shape %s is "
                        "irreconcilable with arena %s/%s -- zeroing it",
                        tuple(arr.shape), ob, nb)
                    _count_zeroed_residual()
                    res_out.append(torch.zeros(new_world, nb.shard))
                    report["zeroed_buckets"] += 1
            for nb in new_spec.buffers[len(res_out):]:
                _count_zeroed_residual()
                res_out.append(torch.zeros(new_world, nb.shard))
                report["zeroed_buckets"] += 1
            residuals = tuple(res_out)

    def fix_leaf(x):
        if not torch.is_tensor(x):
            return x
        arr = x.detach().cpu()
        if arr.dim() >= 1 and arr.shape[0] == old_world:
            if arr.dim() >= 2:
                i = match_buffer(arr)
                if i is not None:
                    report["resharded"] += 1
                    report["carried_bytes"] += int(
                        old_spec.buffers[i].size * arr.element_size())
                    return relayout(arr, old_spec.buffers[i],
                                    new_spec.buffers[i])
                raise ValueError(
                    f"zero_resize: sharded leaf of shape "
                    f"{tuple(arr.shape)} dtype {arr.dtype} matches no "
                    f"arena of the old plan")
            if not bool((arr == arr[0]).all()):
                logger.warning(
                    "zero_resize: per-shard scalar rows disagree (%s); "
                    "adopting shard 0's value", arr)
            report["replicated"] += 1
            return arr[:1].repeat_interleave(new_world, dim=0)
        return x

    new_inner = tree_map(fix_leaf, inner)
    if isinstance(state, StackedZeroState):
        return StackedZeroState(residuals, new_inner), report
    return new_inner, report


def _count_zeroed_residual() -> None:
    from ..timeline import metrics as _metrics
    _metrics.registry().counter(
        "horovod_ef_residual_zeroed_total",
        "EF residual buckets dropped (zeroed) during an elastic "
        "resize because shapes were irreconcilable").inc()
