"""The two-level (DCN x ICI) layout of the world over ``torch.distributed``.

Counterpart of ``horovod_tpu/parallel/mesh.py``'s two-level mesh: there a
``(dcn, ici)`` device mesh, here ``n_dcn`` nodes of ``n_ici``
consecutive ranks.  The ICI groups are the nodes (ranks ``[c * n_ici,
(c + 1) * n_ici)``); the DCN groups join the ranks at the same position
in each node (ranks ``lr, lr + n_ici, ...``).  A rank's position in its
ICI group is its ``ici`` index and in its DCN group its ``dcn`` index,
so rank ``r = dcn * n_ici + ici`` -- the JAX mesh's row-major order.

:func:`parse_topology_spec` is the port's copy of the JAX parser of
``HOROVOD_HIERARCHICAL``: ``auto`` (or ``HOROVOD_HIERARCHICAL_ALLREDUCE``
alone) takes ``n_ici = local_size()``, the rule hierarchical Adasum
uses; ``rows,cols`` pins ``rows`` nodes of ``cols`` ranks.

``torch.distributed.new_group`` is collective over the whole world, so
:func:`hier_groups` makes every node group and every cross group on
every rank, in the same order, once per ``n_ici``, and caches them in
the global state (``shutdown()`` destroys them).

A :class:`HierPair` is one exchange's two-level layout: ``n_dcn`` x
``n_ici`` and this rank's ICI and DCN sets.  The world form
(:func:`world_pair`) lays the world out as above; a rank mesh with two
data axes (``build_3d_mesh(dcn_size=...)``, ``build_mesh(hierarchical=
True)``) gives its data set one over its own axes
(``RankMesh.hier_pair``): the ICI set is this rank's line
along the inner data axis, the DCN set its line along ``dcn``, so a
position in the data set is ``dcn * n_ici + ici``, as in the world.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

from .process_sets import ProcessSet
from .state import global_state


def parse_topology_spec(spec: Optional[str],
                        n: Optional[int] = None
                        ) -> Tuple[bool, Optional[int]]:
    """``HOROVOD_HIERARCHICAL`` spec -> ``(hierarchical, dcn_size)``.

    - unset / ``""`` / ``off``/``0``/``false``/``no``: not hierarchical;
    - ``auto``/``on``/``1``/``true``/``yes``: two-level, the node size
      from ``local_size()`` (``dcn_size`` is ``None``);
    - ``rows,cols``: ``rows`` nodes of ``cols`` ranks; ``rows * cols``
      must equal ``n`` when ``n`` is given.
    """
    if spec is None:
        return False, None
    s = str(spec).strip().lower()
    if s in ("", "0", "off", "false", "no"):
        return False, None
    if s in ("auto", "1", "on", "true", "yes"):
        return True, None
    parts = [p.strip() for p in s.split(",")]
    if len(parts) == 2 and all(p.isdigit() for p in parts):
        rows, cols = int(parts[0]), int(parts[1])
        if rows < 1 or cols < 1:
            raise ValueError(
                f"bad HOROVOD_HIERARCHICAL spec {spec!r}: extents must "
                f"be >= 1")
        if n is not None and rows * cols != n:
            raise ValueError(
                f"HOROVOD_HIERARCHICAL={spec!r} names a {rows}x{cols} "
                f"topology but the mesh has {n} devices")
        return True, rows
    raise ValueError(
        f"bad HOROVOD_HIERARCHICAL spec {spec!r}: expected "
        f"auto|off|<rows>,<cols>")


def hier_mesh_shape() -> Optional[Tuple[int, int]]:
    """``(n_dcn, n_ici)`` when the world is laid out in two levels
    (``HOROVOD_HIERARCHICAL`` or ``HOROVOD_HIERARCHICAL_ALLREDUCE``), else
    ``None`` -- the JAX package's ``controller/fusion.py::
    hier_mesh_shape`` on its ``(dcn, ici)`` mesh."""
    st = global_state()
    cfg = st.config
    if not st.initialized or cfg is None:
        return None
    hier, dcn = parse_topology_spec(cfg.hierarchical, st.size)
    if not (hier or cfg.hierarchical_allreduce):
        return None
    if dcn is None:
        local = max(int(st.local_size or 1), 1)
        if st.size % local:
            raise ValueError(f"local_size {local} does not divide the "
                             f"world size {st.size}")
        dcn = st.size // local
    return dcn, st.size // dcn


def hier_groups(n_ici: int):
    """This rank's ``(ICI group, DCN group)`` for nodes of ``n_ici``
    consecutive ranks (``torch.distributed`` groups), made collectively
    on the first call for ``n_ici`` and cached."""
    st = global_state()
    with st.lock:
        got = st.hierarchy.get(n_ici)
        if got is None:
            n, me = dist.get_world_size(), dist.get_rank()
            if n_ici < 1 or n % n_ici:
                raise ValueError(f"node size {n_ici} does not divide the "
                                 f"world size {n}")
            node = cross = None
            for c in range(n // n_ici):
                g = dist.new_group(list(range(c * n_ici, (c + 1) * n_ici)))
                if me // n_ici == c:
                    node = g
            for lr in range(n_ici):
                g = dist.new_group(list(range(lr, n, n_ici)))
                if me % n_ici == lr:
                    cross = g
            got = st.hierarchy[n_ici] = (node, cross)
        return got


def hier_sets(n_ici: int) -> Tuple[ProcessSet, ProcessSet]:
    """:func:`hier_groups` as unregistered :class:`ProcessSet` views
    (``ici``, ``dcn``): members in global ranks, ``position()`` this
    rank's index in each.  A mesh's data set has its own
    (:meth:`~horovod_tpu_torch.parallel.mesh.RankMesh.hier_pair`)."""
    node, cross = hier_groups(n_ici)
    n, me = dist.get_world_size(), dist.get_rank()
    c, lr = divmod(me, n_ici)
    ici = ProcessSet(f"ici{c}", tuple(range(c * n_ici, (c + 1) * n_ici)),
                     node)
    dcn = ProcessSet(f"dcn{lr}", tuple(range(lr, n, n_ici)), cross)
    return ici, dcn


@dataclasses.dataclass(frozen=True)
class HierPair:
    """The two-level layout one exchange runs on: ``n_dcn`` nodes of
    ``n_ici`` ranks, and this rank's ICI and DCN sets (``None`` for the
    world form, whose sets :func:`hier_sets` makes on first use)."""

    n_dcn: int
    n_ici: int
    ici: Optional[ProcessSet] = None
    dcn: Optional[ProcessSet] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_dcn, self.n_ici

    def sets(self) -> Tuple[ProcessSet, ProcessSet]:
        """``(ici, dcn)``."""
        if self.ici is not None:
            return self.ici, self.dcn
        return hier_sets(self.n_ici)

    def index(self) -> Tuple[int, int]:
        """This rank's ``(dcn, ici)`` positions."""
        ici, dcn = self.sets()
        return dcn.position(), ici.position()


def world_pair(shape: Optional[Tuple[int, int]] = None
               ) -> Optional[HierPair]:
    """The world's :class:`HierPair` for ``shape`` (default
    :func:`hier_mesh_shape`; ``None`` when the world is one level)."""
    shape = hier_mesh_shape() if shape is None else shape
    return None if shape is None else HierPair(int(shape[0]),
                                               int(shape[1]))


def set_pair(process_set) -> Optional[HierPair]:
    """The two-level layout of an exchange over ``process_set``: the
    pair a mesh's two data axes put on their set, the world form
    (:func:`world_pair`) for ``None`` (every rank), and ``None`` -- one
    level -- for any other set (a user's ``add_process_set`` set, the
    global set passed by name, stays flat, as a ``process_set=`` does in
    the JAX package)."""
    pair = getattr(process_set, "hier", None)
    if pair is not None:
        return pair
    return world_pair() if process_set is None else None
