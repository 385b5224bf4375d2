"""The rank mesh: the world's ranks laid out on named axes.

Counterpart of ``horovod_tpu/parallel/mesh.py``.  A JAX mesh is the
devices of one program reshaped onto named axes; here it is the world's
ranks (one process, one device each), reshaped row-major exactly as the
JAX package reshapes ``jax.devices()``, so rank ``r`` sits where JAX's
device ``r`` sits.  A :class:`RankMesh` has ``.axis_names``, ``.shape``
(``{axis: extent}`` in axis order) and ``.ranks`` (the reshaped grid),
and ``.group(axes)`` -- this rank's
:class:`~horovod_tpu_torch.core.process_sets.ProcessSet` over those axes:
the ranks that share every other coordinate with it.  A named axis
(``"model"``, ``"tp"``, ``"sp"``, ``"pp"``, ``"ep"``, ``"data"``, or the
``("dcn", "data")`` pair) thus resolves to a set, and the collectives of
:mod:`horovod_tpu_torch.parallel` run on it.

**Every rank builds every group, in the same order.**
``torch.distributed.new_group`` is collective over the world (see
:mod:`~horovod_tpu_torch.core.process_sets`), so building a mesh is too:
every rank calls the build function with the same arguments, and it
registers, for every non-empty combination of the axes of extent above
1 (the single axes, the data axes' group among them), one set per line,
and one set per rank for the axes of extent 1 -- in one fixed order.  A
set whose ranks are the whole world is the global set; a set whose ranks
an earlier set already holds is that set.  ``.group`` then only looks
sets up.

Each build function records the mesh in ``global_state().mesh``, where
a named axis of the parallel layers resolves when no mesh is passed; an
axis the mesh dropped (``build_3d_mesh`` keeps only ``data`` and the
axes of extent above 1) has extent 1 and resolves to this rank alone.

:func:`parse_topology_spec` is
:func:`horovod_tpu_torch.core.topology.parse_topology_spec`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.process_sets import ProcessSet, add_process_set
from ..core.state import global_state
from ..core.topology import HierPair
from ..core.topology import parse_topology_spec  # noqa: F401

# Canonical axis names (the JAX package's).
HVD_AXIS = "hvd"      # flat data-parallel axis
DCN_AXIS = "dcn"      # cross-node axis
ICI_AXIS = "ici"      # in-node axis
FLAT_AXES: Tuple[str, ...] = (HVD_AXIS,)
HIER_AXES: Tuple[str, ...] = (DCN_AXIS, ICI_AXIS)

# The 5-axis parallelism mesh, outermost first.
DP_AXIS = "dp"
PP_AXIS = "pp"
EP_AXIS = "ep"
SP_AXIS = "sp"
TP_AXIS = "tp"
PARALLEL_AXES: Tuple[str, ...] = (DP_AXIS, PP_AXIS, EP_AXIS, SP_AXIS,
                                  TP_AXIS)

# The 3-D training mesh, outermost first: "data" is the gradient-exchange
# axis (with "dcn" outside it when nodes split it), "model" the tensor-
# parallel axis innermost, "pipe" between them.
DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
THREED_AXES: Tuple[str, ...] = (DCN_AXIS, DATA_AXIS, PIPE_AXIS, MODEL_AXIS)

# Axes that shard the MODEL, never the batch.
MODEL_PARALLEL_AXES: Tuple[str, ...] = (PIPE_AXIS, MODEL_AXIS)

_KNOWN_AXES = frozenset(FLAT_AXES + HIER_AXES + PARALLEL_AXES + THREED_AXES)

Axes = Union[str, Sequence[str]]


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _world_set(ranks: Tuple[int, ...]) -> ProcessSet:
    """The registered set of ``ranks``: the global set for the whole
    world, a set already registered with these ranks, else a new one
    (collective: every rank registers it)."""
    st = global_state()
    for ps in st.process_sets.values():
        if ps.ranks == ranks:
            return ps
    return add_process_set(ranks)


class RankMesh:
    """The world's ranks on named axes (see the module docstring).

    ``ranks`` is the row-major grid (``numpy`` int array of the mesh's
    shape), ``axis_names`` the axes outermost first, ``shape`` the
    ``{axis: extent}`` mapping in that order."""

    def __init__(self, ranks: Sequence[int], axis_names: Sequence[str],
                 extents: Sequence[int]):
        st = global_state()
        if not st.initialized:
            raise ValueError("build a mesh after horovod_tpu_torch.init()")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.ranks = np.asarray(list(ranks), dtype=np.int64).reshape(
            tuple(int(e) for e in extents))
        self.shape: Dict[str, int] = {a: int(e) for a, e in
                                      zip(self.axis_names, extents)}
        self._sets: Dict[Tuple[int, ...], ProcessSet] = {}
        self._groups: Dict[Tuple[str, ...], ProcessSet] = {}
        self._build_sets()

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _lines(self, axes: Tuple[str, ...]):
        """Every group of ranks varying along ``axes`` only, in
        row-major order of the other coordinates."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        grid = np.transpose(self.ranks, rest + idx).reshape(
            -1, int(np.prod([self.ranks.shape[i] for i in idx], dtype=int)))
        return [tuple(sorted(int(r) for r in row)) for row in grid]

    def _build_sets(self) -> None:
        live = [a for a in self.axis_names if self.shape[a] > 1]
        combos = [c for n in range(1, len(live) + 1)
                  for c in itertools.combinations(live, n)]
        lines = [line for c in combos for line in self._lines(c)]
        lines += [(int(r),) for r in self.ranks.flat]
        for line in lines:
            if line not in self._sets:
                self._sets[line] = _world_set(line)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (this process's when ``None``)."""
        rank = global_state().rank if rank is None else rank
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def _live(self, axes: Axes) -> Tuple[str, ...]:
        out = []
        for a in _as_axes(axes):
            if a not in self.axis_names:
                if a not in _KNOWN_AXES:
                    raise ValueError(
                        f"unknown mesh axis {a!r}; the mesh has "
                        f"{self.axis_names}")
                continue             # a dropped axis: extent 1
            if self.shape[a] > 1:
                out.append(a)
        return tuple(sorted(out, key=self.axis_names.index))

    def members(self, axes: Axes, rank: Optional[int] = None
                ) -> Tuple[int, ...]:
        """The ranks of ``rank``'s line over ``axes``, sorted."""
        rank = global_state().rank if rank is None else rank
        live = self._live(axes)
        if not live:
            self.coords(rank)
            return (int(rank),)
        for line in self._lines(live):
            if rank in line:
                return line
        raise ValueError(f"rank {rank} is not in the mesh")

    def group(self, axes: Axes) -> ProcessSet:
        """This rank's set over ``axes`` (a name or a tuple of names);
        looked up once per axes (the layers resolve it every call).  The
        set of the mesh's data axes, when they are the ``(dcn, inner)``
        pair, is a view carrying their two-level factorisation
        (``.hier``, :meth:`hier_pair`): the gradient exchange over it may
        run the ICI x DCN decomposition, as the JAX package's does over
        the two axes."""
        key = _as_axes(axes)
        ps = self._groups.get(key)
        if ps is None:
            ps = self._sets[self.members(key)]
            d_ax = data_axes(self)
            if len(d_ax) == 2 and set(key) == set(d_ax):
                ps = dataclasses.replace(ps, hier=self.hier_pair())
            self._groups[key] = ps
        return ps

    def hier_pair(self) -> Optional[HierPair]:
        """The two-level layout of the data axes when they are the
        ``(dcn, inner)`` pair (``n_dcn = shape["dcn"]``, ``n_ici`` the
        inner axis's extent, this rank's lines along each), else
        ``None``."""
        d_ax = data_axes(self)
        if len(d_ax) != 2 or d_ax[0] != DCN_AXIS:
            return None
        return HierPair(self.shape[DCN_AXIS], self.shape[d_ax[1]],
                        ici=self.group(d_ax[1]), dcn=self.group(DCN_AXIS))

    def axis_size(self, axes: Axes) -> int:
        """The product of the extents of ``axes`` (1 for a dropped
        axis)."""
        return int(np.prod([self.shape.get(a, 1) for a in _as_axes(axes)],
                           dtype=int))

    def axis_index(self, axes: Axes, rank: Optional[int] = None) -> int:
        """``rank``'s row-major index along ``axes`` (its position in
        :meth:`group`)."""
        c = self.coords(rank)
        idx = 0
        for a in _as_axes(axes):
            idx = idx * self.shape.get(a, 1) + c.get(a, 0)
        return idx

    def __repr__(self) -> str:
        return f"RankMesh({self.shape})"


def _ranks(ranks: Optional[Sequence[int]]) -> list:
    """The mesh's ranks, increasing (a set's positions are its sorted
    ranks, so a line's order is its axis order)."""
    if ranks is None:
        return list(range(global_state().size))
    ranks = [int(r) for r in ranks]
    if ranks != sorted(set(ranks)):
        raise ValueError(f"mesh ranks must be distinct and increasing, "
                         f"got {ranks}")
    return ranks


def _install(mesh: RankMesh) -> RankMesh:
    global_state().mesh = mesh
    return mesh


def current_mesh() -> Optional[RankMesh]:
    """The mesh built last (``None`` before one)."""
    return global_state().mesh


def axis_set(axes: Axes, mesh: Optional[RankMesh] = None) -> ProcessSet:
    """This rank's set over the named ``axes`` of ``mesh`` (the current
    mesh when ``None``)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(
            f"axis {axes!r} names a mesh axis, but no mesh was built: call "
            f"build_3d_mesh / build_parallel_mesh first")
    return mesh.group(axes)


def build_mesh(ranks: Optional[Sequence[int]] = None,
               hierarchical: bool = False,
               dcn_size: Optional[int] = None) -> RankMesh:
    """The flat ``("hvd",)`` mesh over ``ranks`` (every rank by default),
    or with ``hierarchical`` the two-level ``("dcn", "ici")`` one:
    ``dcn_size`` nodes, by default one a ``local_size()`` block of
    consecutive ranks."""
    ranks = _ranks(ranks)
    n = len(ranks)
    if not hierarchical:
        return _install(RankMesh(ranks, FLAT_AXES, (n,)))
    if dcn_size is None:
        local = max(int(global_state().local_size or 1), 1)
        if n % local:
            raise ValueError(
                f"hierarchical mesh needs equal ranks per node, got "
                f"local_size {local} for {n} ranks")
        dcn_size = n // local
    if n % dcn_size:
        raise ValueError(f"{n} devices do not factor into dcn={dcn_size}")
    return _install(RankMesh(ranks, HIER_AXES, (dcn_size, n // dcn_size)))


def build_parallel_mesh(ranks: Optional[Sequence[int]] = None, dp: int = 1,
                        pp: int = 1, ep: int = 1, sp: int = 1,
                        tp: int = 1) -> RankMesh:
    """The 5-axis ``(dp, pp, ep, sp, tp)`` mesh; any axis may be 1, and
    the product must be the number of ranks."""
    ranks = _ranks(ranks)
    n = len(ranks)
    extents = {DP_AXIS: dp, PP_AXIS: pp, EP_AXIS: ep, SP_AXIS: sp,
               TP_AXIS: tp}
    prod = int(np.prod(list(extents.values())))
    if prod != n:
        raise ValueError(
            f"dp*pp*ep*sp*tp = {prod} != {n} devices ({extents})")
    return _install(RankMesh(ranks, PARALLEL_AXES,
                             [extents[a] for a in PARALLEL_AXES]))


def build_3d_mesh(ranks: Optional[Sequence[int]] = None, data: int = 1,
                  pipe: int = 1, model: int = 1,
                  dcn_size: int = 1) -> RankMesh:
    """The DP x pipeline x TP mesh: axes from ``(dcn, data, pipe,
    model)``, outermost first, each of extent 1 dropped but ``data``.
    With ``dcn_size > 1`` the data axes are the ``("dcn", "data")``
    pair."""
    ranks = _ranks(ranks)
    n = len(ranks)
    extents = {DCN_AXIS: int(dcn_size), DATA_AXIS: int(data),
               PIPE_AXIS: int(pipe), MODEL_AXIS: int(model)}
    for name, e in extents.items():
        if e < 1:
            raise ValueError(
                f"bad 3-D mesh extent {name}={e}: extents must be >= 1")
    prod = int(np.prod(list(extents.values())))
    if prod != n:
        raise ValueError(
            f"dcn*data*pipe*model = {prod} != {n} devices ({extents})")
    axes = tuple(a for a in THREED_AXES if extents[a] > 1 or a == DATA_AXIS)
    return _install(RankMesh(ranks, axes, [extents[a] for a in axes]))


def data_axes(mesh: RankMesh) -> Tuple[str, ...]:
    """The gradient-exchange axes of ``mesh``: every axis that shards the
    batch, not the model (all axes of a pure-DP mesh)."""
    return tuple(a for a in mesh.axis_names
                 if a not in MODEL_PARALLEL_AXES
                 and a not in (EP_AXIS, SP_AXIS, TP_AXIS, PP_AXIS))


def model_axes(mesh: RankMesh) -> Tuple[str, ...]:
    """The model-parallel axes of ``mesh`` (the complement of
    :func:`data_axes`)."""
    da = set(data_axes(mesh))
    return tuple(a for a in mesh.axis_names if a not in da)


def mesh_axes(mesh: RankMesh) -> Tuple[str, ...]:
    """Every axis of ``mesh``."""
    return tuple(mesh.axis_names)


def mesh_size(mesh: RankMesh) -> int:
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
