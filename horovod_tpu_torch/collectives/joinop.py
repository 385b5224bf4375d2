"""JoinOp: straggler draining for the eager collectives (``hvd.join``).

Counterpart of ``horovod_tpu/collectives/joinop.py`` over
``torch.distributed``, one rank a process.  Upstream semantics
(``horovod/common/ops/operations.cc`` JoinOp, SURVEY.md section 3.2): a
rank that runs out of batches calls ``hvd.join()`` and stops
contributing, while the others keep issuing collectives; the joined rank
keeps PARTICIPATING with identity payloads so nobody deadlocks, and
``join`` returns once every rank has joined, giving the last rank to
join.

The protocol, on the global process set at world >= 2:

* every public eager collective first runs a **presence round**
  (:func:`presence_round`): one ``all_reduce`` of an int32 one-hot
  ``[n]`` (on the device for NCCL, on the CPU for gloo), read on the
  host, which tells every rank who is still active;
* when a rank has drained, the active ranks describe each op in a
  fixed-size int64 **header** broadcast from the lowest active rank
  (:func:`publish`) -- kind, dtype, shape, reduce op, codec, root, the
  fused layout, and the number of ops this presence round covers.  The
  JAX package publishes the same record to its coordination KV store;
  the port keeps no store, and a header on the same group is ordered
  with the ops, needs no store and fails like any collective;
* each drained rank sits in :func:`join_drain`: it runs the same
  presence rounds, receives the headers and re-issues each collective
  through the public API with an identity payload
  (:func:`identity_value`: zeros for sums and gathers, +-inf for min /
  max, ones for products) -- :func:`_replay`;
* ``Average`` is rescaled by ``n_ranks / n_active``, so the mean is over
  the ranks that contributed; an integer ``Average`` during a join is
  refused (a truncating rescale is ill-defined);
* a ragged ``allgather`` from a drained rank contributes zero rows.

A batch of ops known up front (the grouped ops, the deferred flush) runs
behind ONE presence round (:func:`flush`).  An error on the active side
after a presence round publishes an ``abort`` header at the op's slot,
so drained ranks raise at once; a drained rank that waits longer than
``HOROVOD_JOIN_TIMEOUT`` seconds (default 60) for the next presence
round or header raises.  ``HOROVOD_JOIN_DISABLE=1`` skips the presence
rounds (``join()`` then raises at world > 1).  The planned buckets of the
``DistributedOptimizer`` (the port's counterpart of the JAX traced
step) are not drained; the batched path (``HVD_TPU_NATIVE_CORE=1``)
runs through the eager ops and is.
"""

from __future__ import annotations

import contextlib
import datetime
import struct
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.process_sets import get_process_set
from ..core.state import global_state

_lock = threading.Lock()
_gen = 0              # completed join cycles
_joined = False       # this rank is inside join_drain
_replaying = False    # this rank is re-issuing a received op
_presence_idx = 0     # presence rounds completed this generation
_flush_state = None   # active batched flush: {"mask", "remaining", ...}
_last_mask = None     # the newest presence round's mask (subset checks)
_stats = {"presence_rounds": 0, "headers": 0}

# -- the header -------------------------------------------------------------

HEADER_LEN = 64
_MAX_DIMS = 8
_MSG_SLOT = 24
(F_KIND, F_FLUSH, F_OP, F_DTYPE, F_NDIM) = range(5)
F_SHAPE = 5                                  # .. 5 + _MAX_DIMS
(F_PRE, F_POST, F_CODEC, F_ROOT, F_JK, F_FUSED_OPS, F_FUSED_WIDTH,
 F_AXIS, F_MSG_LEN) = range(13, 22)

KINDS = ("abort", "allreduce", "broadcast", "allgather", "reducescatter",
         "alltoall", "alltoallv", "barrier")
#: codec field of an allreduce header: how the active rank ran it
CODECS = ("none", "fp8", "adasum_fp8")
OPS = ("sum", "average", "min", "max", "product", "adasum")
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int32, torch.int64, torch.int16, torch.int8, torch.uint8,
          torch.bool)


def _f2i(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _i2f(v: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(v)))[0]


def encode(meta: dict) -> list:
    """A header's int64 values from ``meta`` (``kind`` and the fields
    its replay needs)."""
    h = [0] * HEADER_LEN
    h[F_KIND] = KINDS.index(meta["kind"])
    h[F_FLUSH] = int(meta.get("flush", 1))
    if meta["kind"] == "abort":
        raw = str(meta.get("message", "")).encode()[:8 * (HEADER_LEN -
                                                           _MSG_SLOT)]
        h[F_MSG_LEN] = len(raw)
        raw = raw + b"\0" * (-len(raw) % 8)
        for i in range(len(raw) // 8):
            h[_MSG_SLOT + i] = struct.unpack("<q", raw[8 * i:8 * i + 8])[0]
        return h
    if "op" in meta:
        h[F_OP] = OPS.index(meta["op"])
    if "dtype" in meta:
        h[F_DTYPE] = DTYPES.index(meta["dtype"])
    shape = tuple(meta.get("shape", ()))
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"join replay supports up to {_MAX_DIMS} dims, "
                         f"got shape {shape}")
    h[F_NDIM] = len(shape)
    for i, d in enumerate(shape):
        h[F_SHAPE + i] = int(d)
    h[F_PRE] = _f2i(meta.get("pre", 1.0))
    h[F_POST] = _f2i(meta.get("post", 1.0))
    h[F_CODEC] = CODECS.index(meta.get("codec", "none"))
    h[F_ROOT] = int(meta.get("root", 0))
    h[F_JK] = int(meta.get("jk", 0))
    h[F_FUSED_OPS] = int(meta.get("fused_ops", 0))
    h[F_FUSED_WIDTH] = int(meta.get("fused_width", 0))
    h[F_AXIS] = int(meta.get("axis", 0))
    return h


def decode(h) -> dict:
    """The ``meta`` dict of an int64 header (the inverse of
    :func:`encode`)."""
    h = [int(v) for v in h]
    kind = KINDS[h[F_KIND]]
    meta = {"kind": kind, "flush": h[F_FLUSH]}
    if kind == "abort":
        raw = b"".join(struct.pack("<q", v)
                       for v in h[_MSG_SLOT:HEADER_LEN])
        meta["message"] = raw[:h[F_MSG_LEN]].decode(errors="replace")
        return meta
    meta.update(
        op=OPS[h[F_OP]], dtype=DTYPES[h[F_DTYPE]],
        shape=tuple(h[F_SHAPE:F_SHAPE + h[F_NDIM]]),
        pre=_i2f(h[F_PRE]), post=_i2f(h[F_POST]), codec=CODECS[h[F_CODEC]],
        root=h[F_ROOT], jk=h[F_JK], fused_ops=h[F_FUSED_OPS],
        fused_width=h[F_FUSED_WIDTH], axis=h[F_AXIS])
    return meta


# -- state ------------------------------------------------------------------

def reset() -> None:
    """Forget join state (``hvd.shutdown()``): a re-initialized world
    starts at generation 0 with nobody joined."""
    global _gen, _joined, _replaying, _presence_idx, _flush_state
    global _last_mask
    with _lock:
        _gen = 0
        _joined = False
        _replaying = False
        _presence_idx = 0
        _flush_state = None
        _last_mask = None
        for key in _stats:
            _stats[key] = 0


def generation() -> int:
    """Join cycles completed since ``init()``."""
    return _gen


def stats() -> dict:
    """Presence rounds and headers this rank has run since ``init()``."""
    return dict(_stats)


def _config():
    return global_state().config


def _disabled() -> bool:
    cfg = _config()
    if cfg is not None:
        return cfg.join_disable
    from ..core.config import _env_bool
    return _env_bool("JOIN_DISABLE")


def _timeout() -> datetime.timedelta:
    cfg = _config()
    if cfg is not None:
        secs = cfg.join_timeout
    else:
        from ..core.config import _env_float
        secs = _env_float("JOIN_TIMEOUT", 60.0)
    return datetime.timedelta(seconds=float(secs))


def _world() -> int:
    st = global_state()
    return st.size if st.initialized else 1


def _device() -> torch.device:
    return global_state().device or torch.device("cpu")


def _wait(work, what: str, timeout: Optional[datetime.timedelta]) -> None:
    if timeout is None:
        work.wait()
        return
    try:
        work.wait(timeout)
    except RuntimeError as e:
        raise RuntimeError(
            f"hvd.join: no {what} from the active ranks within "
            f"HOROVOD_JOIN_TIMEOUT={timeout.total_seconds():g}s ({e})"
        ) from e


def presence_round(active: bool,
                   timeout: Optional[datetime.timedelta] = None
                   ) -> np.ndarray:
    """One presence collective: the ``[n]`` 0/1 mask of active ranks.

    Every rank of the world runs it the same number of times (the active
    ranks once a public op or flush, a drained rank once a drain-loop
    iteration): it is itself a collective."""
    global _presence_idx, _last_mask
    st = global_state()
    t = torch.zeros(st.size, dtype=torch.int32, device=_device())
    if active:
        t[st.rank] = 1
    work = dist.all_reduce(t, op=dist.ReduceOp.SUM, async_op=True)
    _wait(work, "presence round", timeout)
    mask = t.cpu().numpy()
    _presence_idx += 1
    _stats["presence_rounds"] += 1
    _last_mask = mask
    return mask


def _root(mask: np.ndarray) -> int:
    return int(np.flatnonzero(mask)[0])


def _header_exchange(values: Optional[list], root: int,
                     timeout: Optional[datetime.timedelta] = None) -> list:
    t = torch.tensor(values if values is not None else [0] * HEADER_LEN,
                     dtype=torch.int64, device=_device())
    work = dist.broadcast(t, src=root, async_op=True)
    _wait(work, "op header", timeout)
    _stats["headers"] += 1
    return t.cpu().tolist()


def _applies(ps) -> bool:
    """Join handling applies: an active rank's global-set collective at
    world > 1, the protocol not disabled."""
    if _replaying or _joined or _disabled():
        return False
    if ps is None or not ps.is_global():
        return False
    return _world() > 1


class Slot:
    """One public op's place in the protocol.  ``mask`` is None when no
    join handling applies; ``draining`` says some rank has joined, and
    then the op must :meth:`publish` its header before its collective
    (or :meth:`abort`)."""

    def __init__(self, mask: Optional[np.ndarray], n_ops: int = 1):
        self.mask = mask
        self.n_ops = n_ops
        self.published = False

    @property
    def k(self) -> Optional[int]:
        return None if self.mask is None else int(self.mask.sum())

    @property
    def draining(self) -> bool:
        return self.mask is not None and int(self.mask.sum()) < \
            len(self.mask)

    def publish(self, meta: dict) -> None:
        if not self.draining or self.published:
            return
        self.published = True
        publish(self.mask, dict(meta, flush=self.n_ops))

    def abort(self, message: str):
        """Publish an abort record at this op's slot and raise."""
        if self.draining and not self.published:
            self.published = True
            _publish_abort(self.mask, message)
        raise RuntimeError(message)


def publish(mask: np.ndarray, meta: dict) -> None:
    """Broadcast one op's header from the lowest active rank.  Every
    active rank calls it (the root sends, the others receive and ignore
    it); drained ranks receive it in :func:`join_drain`."""
    _header_exchange(encode(meta), _root(mask))


def _publish_abort(mask: np.ndarray, message: str) -> None:
    st = _flush_state
    if st is not None:
        if st.get("aborted"):
            return
        st["aborted"] = True
    publish(mask, {"kind": "abort", "message": message})


@contextlib.contextmanager
def flush(ps, n_ops: int):
    """Run ``n_ops`` consecutive global-set eager collectives behind ONE
    presence round.  Inside, :func:`sync` hands out the cached mask;
    drained ranks read ``n_ops`` from the first header and replay exactly
    that many ops before their next round.  The caller must issue
    exactly ``n_ops`` global-set collectives inside: more raises, and an
    exception (or an under-issue) with ops still owed publishes an abort
    header, so drained ranks fail at once instead of waiting out
    ``HOROVOD_JOIN_TIMEOUT``."""
    global _flush_state
    from . import eager
    eager.flush_deferred()  # pending async ops dispatch before this batch
    ps_ = get_process_set(ps)
    if _flush_state is not None or n_ops <= 1 or not _applies(ps_):
        yield
        return
    mask = presence_round(active=True)
    state = {"mask": mask, "remaining": n_ops, "n_ops": n_ops,
             "aborted": False}
    _flush_state = state
    draining = int(mask.sum()) < len(mask)
    try:
        yield
    except BaseException as e:
        if draining and state["remaining"] > 0:
            _publish_abort(mask, f"{type(e).__name__}: {e}")
        raise
    finally:
        _flush_state = None
    remaining = state["remaining"]
    if remaining > 0 and draining:
        _flush_state = state
        try:
            _publish_abort(mask, f"flush under-issued: "
                                 f"{n_ops - remaining}/{n_ops}")
        finally:
            _flush_state = None
        raise RuntimeError(
            f"join flush announced {n_ops} ops but only "
            f"{n_ops - remaining} were issued; drained ranks would wait "
            f"for the missing replays")


def sync(ps) -> Slot:
    """Called at the top of every public eager collective (through
    ``eager._join_sync``): a presence round -- or the enclosing
    :func:`flush`'s cached mask -- when join handling applies, else an
    inert slot.  A collective on a smaller process set while a member
    is drained raises (draining covers the global set only)."""
    st = _flush_state
    if st is not None and _applies(ps):
        if st["remaining"] <= 0:
            raise RuntimeError(
                "more global-set collectives issued inside a join flush "
                "than its declared op count")
        slot = Slot(st["mask"].copy(), n_ops=st["n_ops"])
        # Only the flush's first op carries the count to the drained
        # ranks; the header field is read once a presence round.
        st["remaining"] -= 1
        return slot
    if _replaying or _joined or _disabled() or _world() <= 1:
        return Slot(None)
    if ps is None or not ps.is_global():
        mask = _last_mask
        if mask is not None:
            drained = sorted(r for r in ps.ranks if r < len(mask)
                             and not mask[r])
            if drained:
                raise RuntimeError(
                    f"eager collective on process set {ps.name!r} while "
                    f"member rank(s) {drained} are drained in hvd.join(): "
                    f"join draining only covers the global process set; "
                    f"finish the join before issuing subset collectives")
        return Slot(None)
    return Slot(presence_round(active=True))


def identity_value(op_value: str, dtype):
    """The reduction identity a joined rank contributes (``op_value`` a
    ``ReduceOp`` value string, ``dtype`` a numpy or torch dtype)."""
    np_dtype = _np_dtype(dtype)
    if op_value == "min":
        return float(np.inf) if np.issubdtype(np_dtype, np.floating) \
            else np.iinfo(np_dtype).max
    if op_value == "max":
        return float(-np.inf) if np.issubdtype(np_dtype, np.floating) \
            else np.iinfo(np_dtype).min
    if op_value == "product":
        return 1
    return 0  # sum / average / adasum / gathers / scatters


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.float32)      # a float: inf is its identity
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _replay(meta: dict) -> None:
    """Re-issue the published collective with an identity payload."""
    global _replaying
    from . import ops
    from .reduce_op import ReduceOp
    kind = meta["kind"]
    if kind == "abort":
        # An active rank failed after its presence round (a broadcast
        # from a joined root, say) and published this instead of an op.
        raise RuntimeError(
            f"collective aborted during join phase: {meta['message']}")
    dev = _device()
    _replaying = True
    try:
        if kind == "barrier":
            ops.barrier()
            return
        dtype, shape = meta["dtype"], tuple(meta["shape"])
        if kind == "allreduce":
            width = meta.get("fused_width", 0)
            if meta.get("fused_ops", 0) and shape != (width,):
                raise RuntimeError(
                    f"fused replay header is inconsistent: bucket shape "
                    f"{shape} does not match the fused width {width}")
            op = ReduceOp(meta["op"])
            x = torch.full(shape, identity_value(meta["op"], dtype),
                           dtype=dtype, device=dev)
            if meta["codec"] == "fp8":
                ops.fp8_allreduce(x, op, prescale_factor=meta["pre"],
                                  postscale_factor=meta["post"])
            else:
                ops.allreduce_async_(
                    x, op=op, prescale_factor=meta["pre"],
                    postscale_factor=meta["post"],
                    wire_codec="fp8" if meta["codec"] == "adasum_fp8"
                    else None).wait()
        elif kind == "broadcast":
            ops.broadcast_async_(torch.zeros(shape, dtype=dtype, device=dev),
                                 meta["root"]).wait()
        elif kind == "allgather":
            ops.allgather(torch.zeros((0,) + shape[1:], dtype=dtype,
                                      device=dev))
        elif kind == "reducescatter":
            x = torch.full(shape, identity_value(meta["op"], dtype),
                           dtype=dtype, device=dev)
            ops.reducescatter_async(x, ReduceOp(meta["op"]),
                                    scatter_axis=meta["axis"]).wait()
        elif kind == "alltoall":
            ops.alltoall(torch.zeros(shape, dtype=dtype, device=dev))
        elif kind == "alltoallv":
            ops.alltoall(torch.zeros((0,) + shape[1:], dtype=dtype,
                                     device=dev),
                         splits=[0] * _world())
        else:  # pragma: no cover - forward compat
            raise RuntimeError(f"unknown join replay kind {kind!r}")
    finally:
        _replaying = False


def join_drain() -> int:
    """The joined rank's loop: mirror every active dispatch with an
    identity replay until every rank has joined; returns the last rank
    to join (the highest join sequence, then the highest rank)."""
    global _gen, _joined, _presence_idx, _last_mask
    if _disabled():
        raise RuntimeError(
            "hvd.join() requires the presence protocol, but "
            "HOROVOD_JOIN_DISABLE=1 turned it off")
    st = global_state()
    # When this rank joined, on the presence-round clock every rank
    # shares (rounds pair 1:1 across ranks).
    join_seq = _presence_idx
    timeout = _timeout()
    _joined = True
    try:
        while True:
            mask = presence_round(active=False, timeout=timeout)
            if int(mask.sum()) == 0:
                break
            root = _root(mask)
            meta = decode(_header_exchange(None, root, timeout))
            n_ops = max(int(meta["flush"]), 1)
            _replay(meta)
            for _ in range(n_ops - 1):
                _replay(decode(_header_exchange(None, root, timeout)))
    finally:
        _joined = False
    last = _read_last(join_seq, st.rank, st.size)
    with _lock:
        _gen += 1
        _presence_idx = 0
        _last_mask = None
    return last


def _read_last(join_seq: int, rank: int, size: int) -> int:
    """The max ``(join_seq, rank)`` over every rank, by one MAX
    ``all_reduce`` of ``join_seq * size + rank``."""
    t = torch.tensor([join_seq * size + rank], dtype=torch.int64,
                     device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item()) % size
