"""Lifecycle and identity: ``init/shutdown/rank/size/...``.

Counterpart of ``horovod_tpu/core/basics.py``, over ``torch.distributed``
instead of a JAX mesh: one process is one rank and drives one device.
NCCL carries the collectives when the device is CUDA (the default), gloo
when the caller asks for the CPU.

``init()`` takes its world from, in order: a process group the caller
already initialized; an explicit ``store`` (e.g. a ``FileStore``) with
``rank`` and ``size``; the launcher's environment (``HOROVOD_RANK`` /
``HOROVOD_SIZE``, else torchrun's ``RANK`` / ``WORLD_SIZE``, meeting at
``MASTER_ADDR``/``MASTER_PORT``).  With none of these it is a world of
size 1, as Horovod's is, rendezvousing through an in-process
``HashStore`` (no port is opened).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .config import load_config
from .device import resolve_device
from .exceptions import NotInitializedError
from .process_sets import _drop_all, _install_global_set
from .state import global_state


def _first(*vals: int) -> int:
    """The first value that is set (>= 0), else -1."""
    for v in vals:
        if v is not None and v >= 0:
            return int(v)
    return -1


def _os_int(name: str) -> int:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else -1


def init(*, device: Optional[Union[str, torch.device]] = None,
         store=None, rank: Optional[int] = None,
         size: Optional[int] = None) -> None:
    """Initialize the framework (``hvd.init()`` parity).

    ``device`` is where this rank's tensors live: ``cuda`` unless the
    caller asks for ``"cpu"`` (with no GPU and no explicit CPU, it
    raises).  On CUDA the device is ``cuda:<local_rank>`` and the
    backend NCCL; on the CPU, gloo.  ``store`` with ``rank`` and
    ``size`` names a world explicitly.
    """
    st = global_state()
    with st.lock:
        if st.initialized:
            return
        cfg = load_config()
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        local_rank = _first(cfg.env_local_rank, _os_int("LOCAL_RANK"), 0)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        owns = False
        if dist.is_initialized():
            r, n = dist.get_rank(), dist.get_world_size()
        else:
            r = _first(rank, cfg.env_rank, _os_int("RANK"))
            n = _first(size, cfg.env_size, _os_int("WORLD_SIZE"))
            if store is None and n in (-1, 1):
                r, n, store = 0, 1, dist.HashStore()
            if r < 0 or n < 1:
                raise ValueError(f"init: rank {r} / size {n} not given")
            kw = {"store": store} if store is not None else \
                {"init_method": "env://"}
            dist.init_process_group(backend, rank=r, world_size=n, **kw)
            owns = True
        st.config = cfg
        st.device = dev
        st.rank, st.size = r, n
        st.local_rank = local_rank
        st.local_size = _first(cfg.env_local_size,
                               _os_int("LOCAL_WORLD_SIZE"), n)
        st.cross_rank = _first(cfg.env_cross_rank, r // max(st.local_size,
                                                            1))
        st.cross_size = _first(cfg.env_cross_size,
                               -(-n // max(st.local_size, 1)))
        st.owns_group = owns
        st.initialized = True
        _install_global_set()


def shutdown() -> None:
    """Tear down framework state (``hvd.shutdown()`` parity): forgets
    every process set and destroys the process group if ``init()``
    created it (which destroys the sets' groups with it); otherwise it
    destroys the groups of the sets it registered."""
    st = global_state()
    with st.lock:
        if not st.initialized:
            return
        owns = st.owns_group
        _drop_all(destroy=not owns and dist.is_initialized())
        if not owns and dist.is_initialized():
            for node, cross in st.hierarchy.values():
                for g in (node, cross):
                    if g not in (None, dist.GroupMember.NON_GROUP_MEMBER):
                        dist.destroy_process_group(g)
        st.reset()
    if owns and dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return global_state().initialized


def _require_init():
    st = global_state()
    if not st.initialized:
        raise NotInitializedError()
    return st


def size() -> int:
    """Number of ranks (one device each)."""
    return _require_init().size


def rank() -> int:
    return _require_init().rank


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    return _require_init().cross_rank


def cross_size() -> int:
    return _require_init().cross_size


def nccl_built() -> bool:
    return bool(dist.is_available() and dist.is_nccl_available())


def cuda_built() -> bool:
    return torch.version.cuda is not None


def is_homogeneous() -> bool:
    """True when every node runs the same number of ranks:
    ``local_size`` divides the world."""
    st = _require_init()
    return st.size % max(st.local_size, 1) == 0


def gloo_built() -> bool:
    return bool(dist.is_available() and dist.is_gloo_available())


def mpi_built() -> bool:
    """The port has no MPI controller: always False."""
    return False


def rocm_built() -> bool:
    return torch.version.hip is not None


def tpu_built() -> bool:
    """The port runs on GPUs and CPUs: always False."""
    return False


def mpi_threads_supported() -> bool:
    """No MPI, so no multithreaded MPI: always False."""
    return False


def join(device=None) -> int:
    """Not ported: Horovod's join (ROADMAP item 1.8)."""
    raise NotImplementedError("hvd.join is not ported (ROADMAP item 1.8)")


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Not ported: the timeline writer (ROADMAP item 1.11)."""
    raise NotImplementedError(
        "hvd.start_timeline is not ported (ROADMAP item 1.11)")


def stop_timeline() -> None:
    """Not ported: the timeline writer (ROADMAP item 1.11)."""
    raise NotImplementedError(
        "hvd.stop_timeline is not ported (ROADMAP item 1.11)")


def steps_per_execution(default: int = 1) -> int:
    """The resolved steps-per-execution k (``HOROVOD_STEPS_PER_EXEC``,
    else ``default``): the length of
    :func:`~horovod_tpu_torch.training.make_train_loop`'s window."""
    from ..training import steps_per_execution as resolved
    return resolved(default)
