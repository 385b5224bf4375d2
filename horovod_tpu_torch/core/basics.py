"""Lifecycle and identity: ``init/shutdown/rank/size/...``.

Counterpart of ``horovod_tpu/core/basics.py``, over ``torch.distributed``
instead of a JAX mesh: one process is one rank and drives one device.
NCCL carries the collectives when the device is CUDA (the default), gloo
when the caller asks for the CPU.

``init()`` takes its world from, in order: a process group the caller
already initialized; an explicit ``store`` (e.g. a ``FileStore``) with
``rank`` and ``size``; the launcher's environment (``HOROVOD_RANK`` /
``HOROVOD_SIZE``, else torchrun's ``RANK`` / ``WORLD_SIZE``, meeting in
the ``FileStore`` at ``HVD_TPU_RENDEZVOUS_FILE`` when the launcher names
one, else at ``MASTER_ADDR``/``MASTER_PORT``).  With none of these it is
a world of size 1, as Horovod's is, rendezvousing through an in-process
``HashStore`` (no port is opened).  The process group's timeout is
``HOROVOD_ELASTIC_TIMEOUT`` (default 600 s), so a lost NCCL peer
surfaces as an error the elastic loop can recover from.

``shutdown()`` then ``init()`` rebuilds the world in the same process
(the elastic loop's re-init): the process group and every process set's
group are destroyed, the exchange-plan cache is cleared, and
``global_state().generation`` advances, which the optimizer wrap and the
train loop check before they touch what the old group left behind.

``init()`` also arms the observability plane, as the JAX ``init()``
does: the Chrome-trace timeline (``HOROVOD_TIMELINE``, cycle marks with
``HOROVOD_TIMELINE_MARK_CYCLES``; :func:`start_timeline` /
:func:`stop_timeline` at run time), the default metric families and,
under ``HOROVOD_METRICS_PORT``, the ``/metrics`` server, the straggler
monitor on the span recorder's step boundary (metrics on), and the
cross-rank trace plane (``HOROVOD_TRACE_SYNC=1``, over the launcher's
HTTP KV store; without one it only warns).  ``shutdown()`` stops each.
Under ``HOROVOD_AUTOTUNE=1`` it builds the online tuner
(``global_state().autotuner``), whose current sample the exchange knobs
read.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .config import Config, _env, load_config
from .device import resolve_device
from .exceptions import NotInitializedError
from .process_sets import _drop_all, _install_global_set
from .state import global_state

logger = logging.getLogger("horovod_tpu_torch")


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
            path = _env("RENDEZVOUS_FILE")
            if store is None and path:
                store = dist.FileStore(path, n)
            kw = {"store": store} if store is not None else \
                {"init_method": "env://"}
            dist.init_process_group(
                backend, rank=r, world_size=n,
                timeout=datetime.timedelta(seconds=cfg.elastic_timeout),
                **kw)
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
        st.generation += 1
        st.initialized = True
        _install_global_set()
        _install_observability(st, cfg)
        if cfg.autotune:
            from ..autotune import Autotuner
            st.autotuner = Autotuner(cfg)
        from . import stall
        stall.configure(cfg)
        # Deterministic fault injection (HOROVOD_CHAOS): installed once a
        # process, keyed to the rank; no-op without the variable.
        from ..elastic import chaos
        chaos.maybe_install(rank=r, size=n)
        # A new world starts a new guard streak (HOROVOD_GUARD_STREAK is
        # read again).
        from . import guard
        guard.reset()


def _install_observability(st, cfg: Config) -> None:
    """The timeline, the default metric families and the ``/metrics``
    server, the span recorder's rank and timeline, the straggler monitor
    on its step boundary and the trace plane (the JAX ``init()``'s
    wiring, ``horovod_tpu/core/basics.py:139-171``)."""
    if cfg.timeline:
        from ..timeline import Timeline
        st.timeline = Timeline(cfg.timeline,
                               mark_cycles=cfg.timeline_mark_cycles,
                               rank=st.rank)
    if cfg.metrics_enabled:
        from ..timeline import metrics as _metrics
        _metrics.install_default_metrics()
        if cfg.metrics_port >= 0:
            from ..run.metrics_server import MetricsServer
            st.metrics_server = MetricsServer(port=cfg.metrics_port)
            logger.info("Prometheus /metrics on port %d",
                        st.metrics_server.port)
    elif cfg.metrics_port >= 0:
        logger.warning("HOROVOD_METRICS_PORT set but HOROVOD_METRICS=0; "
                       "not starting the metrics endpoint")
    from ..timeline import spans as _spans
    rec = _spans.recorder().configure(rank=st.rank, timeline=st.timeline)
    if cfg.metrics_enabled:
        from ..timeline.straggler import StragglerMonitor
        st.straggler = StragglerMonitor(
            world=st.size, stall_check_time=cfg.stall_check_time)
        rec.add_listener(st.straggler.observe)
    if cfg.trace_sync:
        _install_trace_plane(st, cfg, rec)


def _install_trace_plane(st, cfg: Config, rec) -> None:
    """Arm the cross-rank trace plane (``HOROVOD_TRACE_SYNC=1``): the
    clock offset to the rendezvous KV server and the step summaries'
    publication.  The KV endpoint is the elastic assignment URL
    (``HVD_TPU_ELASTIC_ASSIGNMENT=http://...``) with the job's secret;
    without one this is a warning, never an init failure."""
    from ..elastic.notify import ASSIGNMENT_ENV
    from ..run.secret import SECRET_ENV
    url = os.environ.get(ASSIGNMENT_ENV, "")
    secret = os.environ.get(SECRET_ENV)
    if not url.startswith("http://") or not secret:
        logger.warning(
            "HOROVOD_TRACE_SYNC=1 but no HTTP KV rendezvous is "
            "configured (%s/%s); skipping clock alignment",
            ASSIGNMENT_ENV, SECRET_ENV)
        return
    try:
        from ..run.http_kv import KVClient
        from ..timeline.sync import TracePlane
        kv = KVClient.from_url(url, secret, timeout_s=5.0)
        st.trace_plane = TracePlane(
            kv, rank=st.rank, size=st.size,
            publish_steps=cfg.trace_publish_steps, monitor=st.straggler)
        rec.add_listener(st.trace_plane.on_summary)
    except Exception as e:  # ConnectionError, auth, ... -- telemetry only
        logger.warning("trace plane disabled: %s", e)


def shutdown() -> None:
    """Tear down framework state (``hvd.shutdown()`` parity): forgets
    every process set and destroys the process group if ``init()``
    created it (which destroys the sets' groups with it); otherwise it
    destroys the groups of the sets it registered.  Stops the stall
    inspector, the native gradient batcher and the join state, drops
    queued async ops and clears the exchange-plan cache, so a later
    ``init()`` (an elastic re-init, at another world size perhaps) starts
    clean."""
    st = global_state()
    with st.lock:
        if not st.initialized:
            return
        # The eager control plane first: queued async ops are dropped
        # (flushing could hang on peers that already left), the join
        # state forgotten and the native batcher's thread stopped.
        from ..collectives import batching, eager, joinop
        batching.shutdown_batcher()
        eager.reset_deferred()
        joinop.reset()
        owns = st.owns_group
        _drop_all(destroy=not owns and dist.is_initialized())
        if not owns and dist.is_initialized():
            for node, cross in st.hierarchy.values():
                for g in (node, cross):
                    if g not in (None, dist.GroupMember.NON_GROUP_MEMBER):
                        dist.destroy_process_group(g)
        st.reset()
        from . import stall
        stall.teardown()
    from ..controller.fusion import clear_plan_cache
    clear_plan_cache()
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
    """``hvd.join()``: drain until every rank has joined, then return the
    last rank to join (-1 at world 1); see
    :func:`horovod_tpu_torch.collectives.eager.join`."""
    from ..collectives import eager
    return eager.join(device)


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start (or restart) timeline capture into ``file_path``
    (``hvd.start_timeline``; ``HOROVOD_TIMELINE`` is the environment's
    way at ``init()``).  Requires ``init()`` first, as the reference
    does: ``init()`` would otherwise replace a timeline opened before
    it.  An open timeline is closed first."""
    from ..timeline import Timeline
    from ..timeline import spans as _spans
    st = _require_init()
    with st.lock:
        if st.timeline is not None:
            st.timeline.close()
        st.timeline = Timeline(file_path, mark_cycles=mark_cycles,
                               rank=st.rank)
        _spans.recorder().configure(timeline=st.timeline)


def stop_timeline() -> None:
    """Stop timeline capture and finalize the trace file
    (``hvd.stop_timeline``); a no-op without an open timeline."""
    from ..timeline import spans as _spans
    st = global_state()
    with st.lock:
        if st.timeline is not None:
            st.timeline.close()
            st.timeline = None
            _spans.recorder().timeline = None


def steps_per_execution(default: int = 1) -> int:
    """The resolved steps-per-execution k (``HOROVOD_STEPS_PER_EXEC``,
    else ``default``): the length of
    :func:`~horovod_tpu_torch.training.make_train_loop`'s window."""
    from ..training import steps_per_execution as resolved
    return resolved(default)
