"""The eager control plane: integer handles, the deferred fused flush,
the ragged ops and ``hvd.join``.

Counterpart of ``horovod_tpu/collectives/eager.py`` for what
:mod:`~horovod_tpu_torch.collectives.ops` lacks, in the JAX package's
multi-process mode with one device a process: a rank's "local rank
stack" is one row.

* The handle table (upstream ``horovod/torch/handle_manager.cc``):
  integer handles whose value is an op-layer ``Handle``, a result, an
  error, or ``_PENDING`` while a deferred op waits for its flush.
  :func:`synchronize` and :func:`poll` flush first.  An unknown or spent
  handle raises :class:`UnknownHandleError` (a ``KeyError``, as the JAX
  package's, and a ``ValueError``, as upstream's) -- also after a failed
  flush.
* The deferred queue: while the join protocol applies (world > 1, the
  global set, ``HOROVOD_JOIN_DISABLE`` unset) ``allreduce_async`` does
  not dispatch; it queues, and a flush point (``synchronize``, ``poll``,
  any public collective, ``hvd.join``, 512 queued ops) runs everything
  queued behind ONE presence round.  Compatible ops (same
  :meth:`_DeferredAllreduce.fuse_key`) fuse into per-rank buckets of at
  most ``HOROVOD_DEFERRED_FUSE_THRESHOLD`` bytes
  (``controller.fusion.plan_eager_flush``), one collective a bucket;
  the units issue in ``HOROVOD_EXCHANGE_SCHEDULE`` order.  A failed unit
  stamps a fresh ``RuntimeError`` (chained to the cause) into each of its
  handles and an "aborted" one into each handle of the units after it.
* :func:`allgatherv`, :func:`alltoallv` and :func:`alltoallv_row`, the
  JAX package's ragged entry points, over the op layer's one ragged
  exchange; :func:`local_result`, :func:`one_row`,
  :func:`local_rank_count` and :func:`replicated_stack` for code written
  against the JAX package's rank-stacked results.
* :func:`join`: the drain protocol of :mod:`.joinop` at world > 1; at
  world 1 a barrier that returns -1.

The native gradient batcher (:mod:`.batching`) runs its collectives on
its own thread: at world > 1 every public collective here and in the op
layer first flushes it (but on that thread), so the ranks issue their
collectives in one order and no two threads issue them on one group at
once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.process_sets import get_process_set
from ..core.state import global_state
from . import joinop as _join


class UnknownHandleError(KeyError, ValueError):
    """An unknown or already synchronized integer handle."""

    def __str__(self) -> str:
        return str(self.args[0]) if self.args else "unknown handle"


def _unknown(handle) -> UnknownHandleError:
    return UnknownHandleError(f"handle {handle} was not created or has "
                              f"been synchronized")


# ---------------------------------------------------------------------------
# Rank-stacked helpers (one rank a process)
# ---------------------------------------------------------------------------


def local_rank_count(ps=None) -> int:
    """This process's rows in a rank-stacked input: 1 for a member of
    the set, 0 for a non-member."""
    ps = get_process_set(ps)
    return 1 if ps.included() else 0


def replicated_stack(leaf, ps=None):
    """One value as this process's rank stack: ``[1, ...]`` for a
    member, ``[0, ...]`` for a non-member (numpy in, numpy out; a tensor
    stays a tensor)."""
    k = local_rank_count(ps)
    if torch.is_tensor(leaf):
        return leaf.unsqueeze(0).expand((k,) + tuple(leaf.shape))
    x = np.asarray(leaf)
    return np.broadcast_to(x[None], (k,) + x.shape)


def local_result(out):
    """This process's portion of a result as a rank stack: ``out`` as a
    ``[1, ...]`` row (the JAX package's multi-process
    ``local_result``)."""
    if torch.is_tensor(out):
        return out.unsqueeze(0)
    return np.asarray(out)[None]


def one_row(out):
    """One rank's row of a result: this rank's, ``out`` itself."""
    return out


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    dev = global_state().device or torch.device("cpu")
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)), device=dev)


# ---------------------------------------------------------------------------
# Join plumbing shared by every public collective
# ---------------------------------------------------------------------------

_eager_stats_lock = threading.Lock()
_eager_stats = {"ops": 0}


def eager_op_stats() -> dict:
    """Cumulative eager-plane accounting since ``init()``: ``ops`` public
    collectives dispatched, ``fences`` join presence rounds run (the
    eager plane's only cross-rank fence).  Feeds the ``horovod_eager_*``
    metric families."""
    with _eager_stats_lock:
        ops = _eager_stats["ops"]
    return {"ops": ops, "fences": _join.stats()["presence_rounds"]}


def _flush_batcher() -> None:
    """Dispatch the native batcher's pending batches before a collective
    (at world > 1, where issue order must match across ranks; not on the
    batcher's own thread)."""
    from . import batching
    b = batching.current()
    if b is not None and global_state().size > 1 and \
            not batching.on_batcher_thread():
        b.flush()


def _join_sync(ps) -> "_join.Slot":
    """The flush points and the presence round at the top of a public
    collective: the native batcher's pending batches and the deferred
    async ops dispatch first (program order, the same point on every
    rank), then :func:`joinop.sync`."""
    if not _join._replaying:
        _flush_batcher()
        if not _in_flush():
            flush_deferred()
    with _eager_stats_lock:
        _eager_stats["ops"] += 1
    return _join.sync(ps)


@contextlib.contextmanager
def join_op(ps):
    """A public op's join slot: yields the :class:`joinop.Slot`; an
    exception before the op published its header publishes an abort
    record at its slot, so drained ranks raise instead of waiting."""
    slot = _join_sync(ps)
    try:
        yield slot
    except BaseException as e:
        if slot.draining and not slot.published:
            slot.published = True
            _join._publish_abort(slot.mask, f"{type(e).__name__}: {e}")
        raise


def join_header(kind: str, x: torch.Tensor, **fields) -> dict:
    """An op's replay header: ``kind``, ``x``'s dtype and shape, the
    fused layout when a deferred-flush bucket is in flight on this
    thread, and ``fields``."""
    meta = {"kind": kind, "dtype": x.dtype, "shape": tuple(x.shape)}
    extra = getattr(_fused_meta_tls, "extra", None)
    if extra and kind == "allreduce":
        meta.update(extra)
    meta.update(fields)
    return meta


# ---------------------------------------------------------------------------
# The handle table (HandleManager analogue)
# ---------------------------------------------------------------------------

_handle_lock = threading.Lock()
_handle_counter = itertools.count(1)
_handles: Dict[int, Any] = {}

_PENDING = object()  # handle value: enqueued in _deferred, not dispatched
_ABSENT = object()   # pop default: "no such handle", not "pending"


def _alloc_handle(value) -> int:
    with _handle_lock:
        h = next(_handle_counter)
        _handles[h] = value
        return h


def synchronize(handle: int):
    """Wait for the op behind ``handle`` and return its result; the
    handle is spent either way.  Deferred ops flush first; a deferred op
    whose flush failed raises its own error here, once.  An injected
    ``at=sync`` chaos comm fault is raised here."""
    from . import ops
    flush_error = None
    try:
        flush_deferred()
    except Exception as e:  # KeyboardInterrupt/SystemExit propagate
        # The error was stamped into every affected handle; deliver THIS
        # handle's outcome (its op may have run before a later op failed).
        flush_error = e
    with _handle_lock:
        value = _handles.pop(handle, _ABSENT)
    if value is _ABSENT:
        # A spent or unknown handle stays a KeyError after a failed flush
        # too: the flush error belongs to the ops it aborted.
        raise _unknown(handle)
    if value is _PENDING:
        raise flush_error if flush_error is not None else RuntimeError(
            f"deferred async op (handle {handle}) was never dispatched")
    if isinstance(value, BaseException):
        raise value
    from ..elastic import chaos
    chaos.raise_if_armed()
    if isinstance(value, ops.Handle):
        return value.wait()
    return value


def poll(handle: int) -> bool:
    """True once the op behind ``handle`` has finished.  A still-deferred
    op dispatches its batch first (a caller spinning on ``poll`` must not
    wait on an op that was never issued); a failed flush reads True (the
    error raises at :func:`synchronize`)."""
    from . import ops
    with _handle_lock:
        value = _handles.get(handle, _ABSENT)
    if value is _ABSENT:
        raise _unknown(handle)
    if value is _PENDING:
        try:
            flush_deferred()
        except Exception:  # delivered by synchronize; interrupts raise
            return True
        with _handle_lock:
            value = _handles.get(handle, _ABSENT)
    if isinstance(value, ops.Handle):
        return value.poll()
    return True


# ---------------------------------------------------------------------------
# Deferred async dispatch and the fused flush
# ---------------------------------------------------------------------------

_deferred_lock = threading.Lock()
_deferred: List[tuple] = []          # (handle, entry) in issue order
_MAX_DEFERRED = 512                  # capacity flush (deterministic: count)
_flush_lock = threading.RLock()      # serializes flushes across threads
_flush_tls = threading.local()       # .active: THIS thread is mid-flush
_fused_meta_tls = threading.local()  # .extra: in-flight fused bucket

_fuse_stats_lock = threading.Lock()
_fuse_stats = {"flushes": 0, "fused_buckets": 0, "fused_ops": 0,
               "singleton_ops": 0}

#: Reductions that act element by element: a fused bucket gives each
#: member exactly its own result.  Adasum does not (its coefficients are
#: per vector), so an Adasum op always runs alone.
_FUSABLE_OPS = ("sum", "average", "min", "max", "product")


def deferred_fuse_stats() -> dict:
    """Cumulative fused-flush accounting since the last reset: flushes
    run, fused buckets dispatched, ops that rode a fused bucket, ops
    dispatched alone.  Mirrors the ``deferred_fused_*`` timeline
    counters."""
    with _fuse_stats_lock:
        return dict(_fuse_stats)


@dataclasses.dataclass
class _DeferredAllreduce:
    """A deferred allreduce's request fields, so the flush can group
    compatible ops; ``target`` is the tensor an in-place op writes its
    result into (None: a new tensor)."""
    x: torch.Tensor
    op: Any
    name: Optional[str]
    process_set: Any          # resolved ProcessSet
    prescale: float
    postscale: float
    compression: Any
    target: Optional[torch.Tensor] = None

    def fuse_key(self) -> tuple:
        """Ops fuse only when every parameter of the collective matches
        (kind, dtype, reduce op, scale factors, codec, process set)."""
        from ..controller.fusion import dtype_name
        return ("allreduce", dtype_name(self.x.dtype), str(self.op),
                float(self.prescale), float(self.postscale),
                self.compression.__name__, self.process_set.name)

    def fusable(self) -> bool:
        return str(self.op) in _FUSABLE_OPS and \
            not getattr(self.compression, "wire_format", "")

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        if self.target is None:
            return y
        self.target.copy_(y)
        return self.target

    def dispatch(self):
        from . import ops
        return self.finish(ops.allreduce(
            self.x, op=self.op, name=self.name,
            process_set=self.process_set, prescale_factor=self.prescale,
            postscale_factor=self.postscale, compression=self.compression))


def _deferred_fuse_enabled() -> bool:
    cfg = global_state().config
    if cfg is not None:
        return cfg.deferred_fuse
    from ..core.config import _env_bool
    return _env_bool("DEFERRED_FUSE", True)


def _deferred_fuse_threshold() -> int:
    """Per-rank bucket byte cap of the fused flush
    (``HOROVOD_DEFERRED_FUSE_THRESHOLD``; 0 follows the fusion threshold,
    the autotuner's included)."""
    cfg = global_state().config
    if cfg is not None and cfg.deferred_fuse_threshold > 0:
        return cfg.deferred_fuse_threshold
    from ..controller.fusion import fusion_threshold
    return fusion_threshold()


def _defer_applies(ps) -> bool:
    """Should an ``allreduce_async`` on ``ps`` defer to the flush?
    Exactly when the presence protocol applies; everywhere else the op
    starts at once.  A separate seam, so tests can force deferral at
    world 1."""
    return _join._applies(ps)


def _in_flush() -> bool:
    """True on the thread running flush_deferred's dispatch loop (a
    CONCURRENT thread's collective must wait on the flush lock)."""
    return getattr(_flush_tls, "active", False)


def defer(entry) -> int:
    """Queue a deferred op -- a :class:`_DeferredAllreduce` (fusable at
    the flush) or a bare thunk (always alone) -- and return its integer
    handle."""
    h = _alloc_handle(_PENDING)
    with _deferred_lock:
        _deferred.append((h, entry))
        full = len(_deferred) >= _MAX_DEFERRED
    if full:
        flush_deferred()
    return h


def deferred_count() -> int:
    with _deferred_lock:
        return len(_deferred)


def reset_deferred() -> None:
    """Drop undispatched async ops (``hvd.shutdown()``): an async op is
    only guaranteed dispatched after synchronize/poll, and flushing here
    could hang against peers that already shut down."""
    with _deferred_lock:
        dropped = list(_deferred)
        _deferred.clear()
    with _handle_lock:
        for h, _ in dropped:
            _handles.pop(h, None)
    with _fuse_stats_lock:
        for key in _fuse_stats:
            _fuse_stats[key] = 0
    with _eager_stats_lock:
        _eager_stats["ops"] = 0


def _deferred_error(handle: int, cause: BaseException,
                    reason: str) -> RuntimeError:
    """A fresh error for one handle of a failed flush, chained to the
    shared cause (one shared instance raised from several
    ``synchronize()`` calls would pile up tracebacks)."""
    err = RuntimeError(
        f"deferred async op (handle {handle}) {reason}: {cause!r}")
    err.__cause__ = cause
    return err


@dataclasses.dataclass
class _FlushUnit:
    """One collective of a flush: a fused bucket of compatible ops, or
    one op alone.  ``leg`` is a fused bucket's plan row; the bandwidth
    order reads its wire bytes."""
    pos: int                       # issue position of the first member
    handles: List[int]
    dispatch: Callable[[], Dict[int, Any]]
    fused: bool = False
    leg: Any = None


def _single_unit(pos: int, h: int, entry) -> _FlushUnit:
    d = entry.dispatch if isinstance(entry, _DeferredAllreduce) else entry
    return _FlushUnit(pos, [h], lambda h=h, d=d: {h: d()})


def _fused_unit(bucket, widths) -> _FlushUnit:
    """ONE collective for a planner bucket of compatible deferred ops:
    the members' rows concatenate into one ``[sum(widths)]`` payload, a
    single :func:`~horovod_tpu_torch.collectives.ops.allreduce` carries
    it (one slot in the join protocol, whose header carries the fused
    layout), and the results slice back per handle.  The packing and
    unpacking closures are memoized by the bucket's plan fingerprint
    (``controller.fusion.plan_executable``)."""
    from ..controller import fusion
    from . import ops
    pos = min(p for p, _, _ in bucket)
    handles = [h for _, h, _ in bucket]
    recs = [r for _, _, r in bucket]
    r0 = recs[0]
    dtype = fusion.dtype_name(r0.x.dtype)
    name = f"deferred_fused.{dtype}.{pos}"
    widths = tuple(int(w) for w in widths)
    tails = tuple(tuple(int(d) for d in r.x.shape) for r in recs)
    leg = fusion.plan_exchange("flat", size=sum(widths), dtype=dtype,
                               compression=r0.compression).legs[0]
    plan = fusion.ExchangePlan(family="flat", legs=(leg,))

    def build():
        def pack(xs):
            return torch.cat([x.reshape(-1) for x in xs])

        def unpack(buf):
            out, off = [], 0
            for w, tail in zip(widths, tails):
                out.append(buf[off:off + w].view(tail))
                off += w
            return out
        return pack, unpack

    def dispatch():
        pack, unpack = fusion.plan_executable(
            plan, build, extra=("deferred_unfuse", widths, tails))
        fused = pack([r.x for r in recs])
        _fused_meta_tls.extra = {"fused_ops": len(recs),
                                 "fused_width": sum(widths)}
        try:
            red = ops.allreduce(fused, op=r0.op, name=name,
                                process_set=r0.process_set,
                                prescale_factor=r0.prescale,
                                postscale_factor=r0.postscale,
                                compression=r0.compression)
        finally:
            _fused_meta_tls.extra = None
        return {h: r.finish(v)
                for h, r, v in zip(handles, recs, unpack(red))}

    return _FlushUnit(pos, handles, dispatch, fused=True, leg=leg)


def _plan_flush_units(pending, fuse: bool) -> List[_FlushUnit]:
    """Group pending deferred entries into dispatch units.

    Compatible fusable ops route through
    ``controller.fusion.plan_eager_flush`` and pack into per-rank buckets
    of at most the deferred-fuse threshold; everything else (mismatched
    keys, Adasum, an exchange codec) and any bucket of one member keeps
    the per-op path.  The grouping is pure in issue order and the ops'
    fields, so every rank cuts identical units -- required, since the
    unit count is the flush size the drained ranks replay.  Under
    ``bandwidth`` the fused units issue first, by wire bytes descending,
    then the rest; under ``program`` in the issue order of each unit's
    first member (JAX ``_plan_flush_units``: every fused unit is one flat
    leg of one bandwidth class and a lone op costs 0, so its cost order
    is this order, whatever the link rate)."""
    from ..controller import fusion
    units: List[_FlushUnit] = []
    groups: Dict[tuple, List[tuple]] = {}
    for pos, (h, entry) in enumerate(pending):
        if not (fuse and isinstance(entry, _DeferredAllreduce)
                and entry.fusable()):
            units.append(_single_unit(pos, h, entry))
            continue
        groups.setdefault(entry.fuse_key(), []).append((pos, h, entry))
    threshold = _deferred_fuse_threshold()
    for members in groups.values():
        if len(members) == 1:
            units.append(_single_unit(*members[0]))
            continue
        recs = [entry for _, _, entry in members]
        spec = fusion.plan_eager_flush(
            [r.x for r in recs], local_rank_count(recs[0].process_set),
            threshold, extra=(recs[0].process_set.name,))
        for _dt, lspecs in spec.buffers:
            if len(lspecs) == 1:
                units.append(_single_unit(*members[lspecs[0].index]))
                continue
            units.append(_fused_unit([members[s.index] for s in lspecs],
                                     [s.size for s in lspecs]))
    if fusion.exchange_schedule_mode() == "bandwidth":
        units.sort(key=lambda u: (
            -u.leg.nbytes if u.leg is not None else 0, u.pos))
    else:
        units.sort(key=lambda u: u.pos)
    return units


def _note_flush(units: List[_FlushUnit]) -> None:
    fused = [u for u in units if u.fused]
    n_fused_ops = sum(len(u.handles) for u in fused)
    n_single = len(units) - len(fused)
    with _fuse_stats_lock:
        _fuse_stats["flushes"] += 1
        _fuse_stats["fused_buckets"] += len(fused)
        _fuse_stats["fused_ops"] += n_fused_ops
        _fuse_stats["singleton_ops"] += n_single
    tl = global_state().timeline
    if tl:
        tl.counters({"deferred_fused_buckets": len(fused),
                     "deferred_fused_ops": n_fused_ops,
                     "deferred_singleton_ops": n_single})


def flush_deferred() -> None:
    """Dispatch every deferred async op behind ONE presence round.

    Serialized under an RLock: a reentrant call (a unit's own dispatch
    reaching a flush point on the flushing thread) sees the thread-local
    flag and returns; a concurrent thread's synchronize/poll/collective
    waits here until the flush has stored its results.  The flush size
    the drained ranks replay is the number of dispatch units.  Results
    land per handle; a failed unit stamps a fresh error into each of its
    handles and an "aborted" one into each handle of the later units,
    then the first error is raised."""
    _flush_batcher()
    with _flush_lock:
        if _in_flush():
            return
        with _deferred_lock:
            pending = list(_deferred)
            _deferred.clear()
        if not pending:
            return
        _flush_tls.active = True
        try:
            ps = get_process_set(None)
            units = _plan_flush_units(pending, _deferred_fuse_enabled())
            _note_flush(units)
            from ..timeline import spans
            rec = spans.recorder()
            with _join.flush(ps, len(units)):
                err = None
                for i, unit in enumerate(units):
                    if err is None:
                        try:
                            key = (f"fused@{unit.pos}" if unit.fused
                                   else f"single@{unit.pos}")
                            with rec.span("bucket", name="deferred_flush",
                                          leg="deferred_flush",
                                          bucket_id=i, fuse_key=key):
                                values = unit.dispatch()
                        except BaseException as e:  # noqa: BLE001
                            err = e
                            values = {
                                h: _deferred_error(h, e,
                                                   "failed during flush")
                                for h in unit.handles}
                    else:
                        # Units after a failure never dispatch (the join
                        # flush publishes an abort for their slots).
                        values = {
                            h: _deferred_error(
                                h, err, "aborted: an earlier op in the "
                                "flushed batch failed")
                            for h in unit.handles}
                    with _handle_lock:
                        for h, value in values.items():
                            if h in _handles:
                                _handles[h] = value
                if err is not None:
                    raise err
        except BaseException as e:
            # A failure before the loop ran (a presence-round timeout):
            # no synchronize() may return the sentinel as a result.
            with _handle_lock:
                for h, _ in pending:
                    if _handles.get(h) is _PENDING:
                        _handles[h] = _deferred_error(
                            h, e, "aborted: flush failed before dispatch")
            raise
        finally:
            _flush_tls.active = False


# ---------------------------------------------------------------------------
# The ragged entry points of the JAX package
# ---------------------------------------------------------------------------


def _local_list(arrs, what: str, k: int) -> list:
    if torch.is_tensor(arrs) or hasattr(arrs, "shape"):
        arrs = [arrs]
    arrs = list(arrs)
    if len(arrs) != k:
        raise ValueError(
            f"{what} takes one array per local rank: expected {k}, got "
            f"{len(arrs)}")
    return arrs


def allgatherv(arrs, *, name: Optional[str] = None, process_set=None):
    """Ragged allgather (the JAX ``allgatherv``): each rank's array may
    differ in dim 0; every member receives the dim-0 concatenation in
    rank order.  ``arrs`` is this process's local list (one array, which
    may be passed bare; numpy arrays go to the rank's device).  The
    exchange is the op layer's one ragged allgather (first dims, then
    the rows padded to the longest)."""
    from . import ops
    ps = get_process_set(process_set)
    (a,) = _local_list(arrs, "allgatherv", local_rank_count(ps))
    return ops.allgather(_as_tensor(a), name=name, process_set=ps)


def alltoallv(arrs, splits, *, name: Optional[str] = None,
              process_set=None):
    """Uneven alltoall (the JAX ``alltoallv``): ``splits[i]`` rows of this
    rank's array go to set position ``i``.  Returns ``(datas,
    recv_splits)``, one entry per local rank: the rows received in
    sender order and the count from each sender.  A non-member passes
    empty lists and gets ``([], [])``."""
    from . import ops
    ps = get_process_set(process_set)
    k = local_rank_count(ps)
    if k == 0:
        if (arrs is not None and len(arrs)) or \
                (splits is not None and len(splits)):
            raise ValueError("this rank is not a member of the process "
                             "set; pass empty arrs/splits")
        return [], []
    (a,) = _local_list(arrs, "alltoallv", k)
    sp = np.asarray(splits.cpu() if torch.is_tensor(splits) else splits)
    if sp.ndim == 2:
        if sp.shape[0] != k:
            raise ValueError(f"alltoallv takes one splits vector per "
                             f"local rank: expected {k}, got {sp.shape[0]}")
        sp = sp[0]
    if sp.shape != (ps.size(),):
        raise ValueError(f"splits must have shape ({ps.size()},), got "
                         f"{sp.shape}")
    out, recv = ops.alltoall(_as_tensor(a), splits=sp.tolist(), name=name,
                             process_set=ps)
    return [out], [recv]


def alltoallv_row(data, splits, *, name: Optional[str] = None,
                  process_set=None):
    """:func:`alltoallv` of this rank's one value: ``(received,
    received_splits)``.  A non-member raises (in the per-rank model a
    non-member never calls the op)."""
    if local_rank_count(process_set) == 0:
        raise RuntimeError(
            "alltoall(splits=...) called on a rank that is not a member "
            "of the process set")
    datas, rsplits = alltoallv([data], [np.asarray(
        splits.cpu() if torch.is_tensor(splits) else splits)],
        name=name, process_set=process_set)
    return datas[0], rsplits[0]


# ---------------------------------------------------------------------------
# hvd.join
# ---------------------------------------------------------------------------


def join(device=None) -> int:
    """``hvd.join()``: this rank stops contributing and drains -- it keeps
    taking part in the other ranks' collectives with identity payloads
    until every rank has joined, then returns the last rank to join.  At
    world 1 there is nobody to wait for: a barrier, then -1, as the JAX
    package's one-process path.  ``device`` is upstream's and unused."""
    from ..core.basics import _require_init
    from . import ops
    st = _require_init()
    _flush_batcher()
    flush_deferred()
    if st.size == 1:
        ops.barrier()
        return -1
    return _join.join_drain()


__all__ = ["UnknownHandleError", "allgatherv", "alltoallv",
           "alltoallv_row", "deferred_count", "deferred_fuse_stats",
           "eager_op_stats", "flush_deferred", "join", "local_rank_count",
           "local_result", "one_row", "poll", "replicated_stack",
           "reset_deferred", "synchronize"]
