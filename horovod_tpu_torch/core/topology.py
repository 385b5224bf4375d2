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
"""

from __future__ import annotations

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
    rank's index in each."""
    node, cross = hier_groups(n_ici)
    n, me = dist.get_world_size(), dist.get_rank()
    c, lr = divmod(me, n_ici)
    ici = ProcessSet(f"ici{c}", tuple(range(c * n_ici, (c + 1) * n_ici)),
                     node)
    dcn = ProcessSet(f"dcn{lr}", tuple(range(lr, n, n_ici)), cross)
    return ici, dcn
