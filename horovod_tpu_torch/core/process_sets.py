"""Process sets: named subsets of ranks with their own communicator.

Counterpart of ``horovod_tpu/core/process_sets.py`` (upstream Horovod's
``hvd.add_process_set``).  A rank is a ``torch.distributed`` rank, one
process driving one device, and a set's communicator is a
``torch.distributed`` group over its members (``None``, the default
group, for the global set).  Every collective takes ``process_set=``: its
members reduce, gather or exchange among themselves, and a rank that is
not a member must not call it (it raises ``ValueError``).

**Registration is collective over the whole world.**
``torch.distributed.new_group`` must be called by every rank of the
default group, members or not, with the same ranks and in the same
order; so every rank calls :func:`add_process_set` and
:func:`remove_process_set` for every set, in the same order, as upstream
Horovod requires.  A rank that skips one deadlocks the others (gloo) or
pairs the wrong groups (NCCL, which builds a set's communicator lazily,
at its first collective).  Looking a set up (:func:`get_process_set`,
:func:`process_set_names`) is local.

The rules are the JAX module's: ranks sorted, no duplicates, each in
``[0, size)``; a name registered again with the same ranks returns the
existing set (no new group), with other ranks it raises; the global set
cannot be removed.  Errors are :class:`ProcessSetError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch.distributed as dist

from .exceptions import ProcessSetError
from .state import global_state

GLOBAL_PROCESS_SET_NAME = "global"


@dataclasses.dataclass(frozen=True)
class ProcessSet:
    """A named subset of ranks and its ``torch.distributed`` group
    (``None`` for the global set; torch's non-member marker on a rank
    outside the set)."""

    name: str
    ranks: Tuple[int, ...]  # global ranks, sorted
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    # The two-level (dcn, ici) factorisation of a mesh's two data axes
    # (a ``core.topology.HierPair``), set on the view
    # ``RankMesh.group(data_axes(mesh))`` returns; ``None`` on a
    # registered set, so a user's set stays flat.
    hier: Any = dataclasses.field(default=None, compare=False, repr=False)

    def size(self) -> int:
        return len(self.ranks)

    def included(self, rank: Optional[int] = None) -> bool:
        """Whether ``rank`` (this process's rank when ``None``) is a
        member."""
        if rank is None:
            rank = global_state().rank
        return rank in self.ranks

    def is_global(self) -> bool:
        return self.name == GLOBAL_PROCESS_SET_NAME

    def position(self, rank: Optional[int] = None) -> int:
        """``rank``'s index among the members (this process's when
        ``None``); ``ValueError`` for a non-member."""
        if rank is None:
            rank = global_state().rank
        if rank not in self.ranks:
            raise ValueError(
                f"rank {rank} is not a member of process set "
                f"{self.name!r} (ranks {self.ranks})")
        return self.ranks.index(rank)


def _require_init():
    st = global_state()
    if not st.initialized:
        raise ProcessSetError(
            "call horovod_tpu_torch.init() before using process sets")
    return st


def add_process_set(ranks: Sequence[int],
                    name: Optional[str] = None) -> ProcessSet:
    """Register a new process set (``hvd.add_process_set``).  Collective:
    every rank calls it, with the same arguments and in the same order
    (see the module docstring)."""
    st = _require_init()
    ranks = tuple(sorted(int(r) for r in ranks))
    if len(set(ranks)) != len(ranks):
        raise ProcessSetError(f"duplicate ranks in {ranks}")
    if not ranks or ranks[0] < 0 or ranks[-1] >= st.size:
        raise ProcessSetError(
            f"ranks {ranks} out of range for world size {st.size}")
    if name is None:
        name = "ps_" + "_".join(map(str, ranks))
    with st.lock:
        existing = st.process_sets.get(name)
        if existing is not None:
            if existing.ranks != ranks:
                raise ProcessSetError(
                    f"process set {name!r} already exists with ranks "
                    f"{existing.ranks}")
            return existing
        ps = ProcessSet(name, ranks, dist.new_group(ranks=list(ranks)))
        st.process_sets[name] = ps
        return ps


def _destroy(ps: ProcessSet) -> None:
    if ps.group is not None and ps.included():
        dist.destroy_process_group(ps.group)


def remove_process_set(name_or_set) -> None:
    """Deregister a set by name or object and destroy its group.
    Collective, like :func:`add_process_set`."""
    st = _require_init()
    name = name_or_set.name if isinstance(name_or_set, ProcessSet) \
        else name_or_set
    if name == GLOBAL_PROCESS_SET_NAME:
        raise ProcessSetError("cannot remove the global process set")
    with st.lock:
        ps = st.process_sets.pop(name, None)
    if ps is not None:
        _destroy(ps)


def get_process_set(name_or_set=None) -> ProcessSet:
    """``None`` (the global set), a name or a :class:`ProcessSet`, as a
    registered set."""
    st = _require_init()
    if name_or_set is None:
        return st.process_sets[GLOBAL_PROCESS_SET_NAME]
    if isinstance(name_or_set, ProcessSet):
        known = st.process_sets.get(name_or_set.name)
        if known is None or known.ranks != name_or_set.ranks:
            raise ProcessSetError(
                f"process set {name_or_set.name!r} is not registered")
        # A mesh's data-set view keeps its two-level pair.
        return known if name_or_set.hier is None else name_or_set
    try:
        return st.process_sets[name_or_set]
    except KeyError:
        raise ProcessSetError(
            f"unknown process set {name_or_set!r}") from None


def process_set_of_ranks(ranks: Sequence[int]) -> ProcessSet:
    """The registered set whose members are ``ranks`` (the global set
    for every rank)."""
    st = _require_init()
    ranks = tuple(sorted(int(r) for r in ranks))
    with st.lock:
        for ps in st.process_sets.values():
            if ps.ranks == ranks:
                return ps
    raise ProcessSetError(
        f"no process set has ranks {ranks}; register one with "
        f"add_process_set first")


def process_set_names() -> List[str]:
    return sorted(_require_init().process_sets)


def _install_global_set() -> ProcessSet:
    """Called by ``init()``: register the world set."""
    st = global_state()
    ps = ProcessSet(GLOBAL_PROCESS_SET_NAME, tuple(range(st.size)))
    st.process_sets = {GLOBAL_PROCESS_SET_NAME: ps}
    return ps


def _drop_all(destroy: bool) -> None:
    """Called by ``shutdown()``: forget every set, destroying the groups
    of the others when the default group outlives ``shutdown()``."""
    st = global_state()
    sets = list(st.process_sets.values())
    st.process_sets = {}
    if destroy:
        for ps in sets:
            _destroy(ps)
