"""Lock-step serving over a world of ranks: one header a loop turn.

The reference's engine and control plane are one controller over a mesh
of devices.  Here each rank of a tensor-parallel mesh is a process with
its own clock, so two ranks reading their own clocks would admit
different requests at different steps, and the next row-parallel
allreduce would hang or mix slots.  So only the world's rank 0 (the
*leader*) reads the clock -- and, in the control plane, the policy, the
chaos faults and the straggler monitor -- and every loop turn ends in
one fixed-size int64 header the leader sends over the world, as
:mod:`~horovod_tpu_torch.collectives.joinop` broadcasts its op headers.
The header is summed over the world (an allreduce in which every rank
but the leader contributes zeros), so besides the leader's fields it
carries one count every rank adds to (``ack``): a caller learns that
every rank reached a point of its turn -- the fleet deletes a streamed
KV object only once every decode rank has imported it.
Every other host decision follows from the header and from the step's
logits, which the row-parallel sums leave the same on every rank of the
mesh.

Within a turn every rank reads the same frozen clock (:meth:`LockStep.
now`, the leader's reading at the last header).  The times a report
keeps are the leader's: the first-token time of each request that
joined the decode batch in the turn (:meth:`LockStep.stamp_first`), the
step's wall (``step_s``) and the serve's wall time.  The leader handles
a step's tokens (appends, releases, token latencies) before the header,
where the control plane's tick reads them; the other ranks queue that
work (:meth:`LockStep.defer`) and run it when the header brings the
leader's times.  A rank outside the mesh (the control plane keeps the
ranks it resized away in step) runs no decode step and takes the step's
tokens from the header.  Should the leader be outside the mesh (a
virtual ``kill@`` of rank 0), the mesh's lowest rank broadcasts the
tokens first (:meth:`LockStep.tokens_from`).

The header (``HEADER`` fields, then one section a lane, then a blob):
the clock, the wall time, flags (a tick), the control plane's tick
(action, target size, evicted rank, the SLO-violation seconds, the
windowed TTFT p99 and the prefix hit rate, the reason as bytes), the
indices of the chaos faults the leader fired, the ack count; per lane
-- one engine of the turn: a fleet steps several decode engines under
one clock, each on a lane (:meth:`LockStep.lane`) -- whether it stepped,
its ``step_s`` and per slot the first-token time, the sampled tokens
(``width`` a slot) and whether the slot's logits were finite; then
``blob_words`` words of bytes the leader attaches (:meth:`LockStep.attach`:
the fleet's handoff tickets and scaler decision).
"""

from __future__ import annotations

import math
import struct
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import global_state

ACTIONS = ("hold", "grow", "shrink", "evict")
MAX_FAULTS = 8
_REASON_WORDS = 8                  # 64 bytes of the decision's reason
(F_CLOCK, F_WALL, F_FLAGS, F_ACTION, F_TARGET, F_EVICT, F_VIOL, F_P99,
 F_HIT, F_NFAULT, F_REASON_LEN, F_ACK, F_BLOB_LEN) = range(13)
F_FAULTS = 13
F_REASON = F_FAULTS + MAX_FAULTS
HEADER = F_REASON + _REASON_WORDS
FLAG_TICK, FLAG_VIOLATED = 1, 4
_L_STEP, _L_STEP_S, _L_SLOTS = range(3)   # a lane's section
_NONE = -1


def _f2i(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _i2f(v: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(v)))[0]


def _opt(x: Optional[float]) -> float:
    return math.nan if x is None else float(x)


def _pack_bytes(raw: bytes) -> np.ndarray:
    raw += b"\0" * (-len(raw) % 8)
    return np.frombuffer(raw, dtype="<i8").astype(np.int64)


def _unpack_bytes(words: np.ndarray, n: int) -> bytes:
    return words.astype("<i8").tobytes()[:n]


class LockStep:
    """The header exchange of one engine -- or of ``lanes`` engines
    under one clock -- over the world (see the module docstring).
    ``slots`` and ``width`` (tokens a slot a step at most: the verify
    width when speculating, else 1) size a lane; its ``tokens`` come
    flat, the caller reshapes them.  ``blob_words`` sizes the bytes the
    leader may attach to a header."""

    def __init__(self, slots: int, width: int = 1, lanes: int = 1,
                 blob_words: int = 0):
        st = global_state()
        self.rank = int(st.rank)
        self.leader = self.rank == 0
        self.slots = int(slots)
        self.width = int(width)
        self.lanes = int(lanes)
        self.blob_words = int(blob_words)
        self.lane_size = _L_SLOTS + self.slots * (self.width + 2)
        self.size = HEADER + self.lanes * self.lane_size + self.blob_words
        self._device = st.device or torch.device("cpu")
        self.headers = 0
        self.reset()

    def reset(self) -> None:
        """Start a serve: the clocks at 0, nothing queued."""
        self._start = time.monotonic()
        self.skip = 0.0              # the leader's fast-forwarded idle time
        self.clock = 0.0
        self.wall = 0.0
        self._first = np.full((self.lanes, self.slots), math.nan)
        self._faults: List[int] = []
        self._steps: dict = {}
        self._blob = b""
        self._deferred: List[Callable[[dict], None]] = []

    def lane(self, i: int) -> "Lane":
        """Lane ``i``'s view, with the engine-facing calls of a one-lane
        :class:`LockStep` (an engine stepped by a fleet holds one)."""
        if not 0 <= i < self.lanes:
            raise ValueError(f"lane {i} of a {self.lanes}-lane header")
        return Lane(self, i)

    # -- the leader's clock --------------------------------------------------
    def fresh(self) -> float:
        """The leader's virtual clock now (wall time plus skipped idle
        gaps); only the leader reads it."""
        if not self.leader:
            raise RuntimeError("only the world's rank 0 reads the clock")
        return time.monotonic() - self._start + self.skip

    def now(self) -> float:
        """The clock every rank reads within a turn."""
        return self.clock

    def stamp_first(self, slot: int, lane: int = 0) -> Optional[float]:
        """The first-token time of the request joining the decode batch
        in ``slot``: the leader's reading, sent with the next header;
        ``None`` elsewhere (the caller sets it from the header)."""
        if not self.leader:
            return None
        t = self.fresh()
        self._first[lane, slot] = t
        return t

    def note_faults(self, indices) -> None:
        """The chaos faults (indices in the spec) the leader fired."""
        self._faults.extend(int(i) for i in indices)

    def note_step(self, step_s: float, sampled, finite,
                  lane: int = 0) -> None:
        """The leader's step: its wall and tokens, for the header."""
        self._steps[lane] = (float(step_s), sampled, finite)

    def attach(self, blob: bytes) -> None:
        """Bytes the leader sends with the next header (``hdr["blob"]``
        on every rank; at most ``8 * blob_words``)."""
        if len(blob) > 8 * self.blob_words:
            raise ValueError(f"a {len(blob)}-byte header blob, room for "
                             f"{8 * self.blob_words}")
        self._blob = bytes(blob)

    def defer(self, fn: Callable[[dict], None]) -> None:
        """Queue ``fn(header)`` on a rank other than the leader; it runs
        when the turn's header arrives."""
        self._deferred.append(fn)

    # -- the collectives -----------------------------------------------------
    def tokens_from(self, root: int, sampled, finite, shape) -> tuple:
        """The step's tokens (of ``shape``) and finite flags from
        ``root`` (the mesh's lowest rank), on every rank: the leader is
        outside the mesh."""
        n = int(np.prod(shape))
        t = torch.zeros(n + self.slots, dtype=torch.int64,
                        device=self._device)
        if self.rank == root:
            t[:n] = torch.as_tensor(np.asarray(sampled).reshape(-1))
            t[n:] = torch.as_tensor(np.asarray(finite).astype(np.int64))
        dist.broadcast(t, src=root)
        v = t.cpu().numpy()
        return v[:n].reshape(shape), v[n:].astype(bool)

    def exchange(self, tick: Optional[dict] = None, ack: int = 0) -> dict:
        """End the turn: the leader sends the header (with ``tick``, the
        control plane's decision record, when it ticked), every rank adds
        ``ack`` to its ``ack`` field, every rank returns it decoded, sets
        its clock and runs its deferred work."""
        h = np.zeros((self.size,), np.int64)
        h[F_ACK] = int(ack)
        if self.leader:
            now = tick["now_s"] if tick is not None else self.fresh()
            h[F_CLOCK] = _f2i(now)
            h[F_WALL] = _f2i(time.monotonic() - self._start)
            flags = 0
            n = self.slots * self.width
            for lane, (step_s, sampled, finite) in self._steps.items():
                base = HEADER + lane * self.lane_size
                h[base + _L_STEP] = 1
                h[base + _L_STEP_S] = _f2i(step_s)
                base += _L_SLOTS + self.slots
                flat = np.asarray(sampled).reshape(-1)
                h[base:base + flat.size] = flat
                h[base + n:base + n + self.slots] = np.asarray(finite)
            for lane in range(self.lanes):
                base = HEADER + lane * self.lane_size + _L_SLOTS
                h[base:base + self.slots] = [_f2i(x)
                                             for x in self._first[lane]]
            if self._blob:
                words = _pack_bytes(self._blob)
                h[F_BLOB_LEN] = len(self._blob)
                base = HEADER + self.lanes * self.lane_size
                h[base:base + words.size] = words
            if tick is not None:
                flags |= FLAG_TICK
                if tick["violated"]:
                    flags |= FLAG_VIOLATED
                d = tick["decision"]
                h[F_ACTION] = ACTIONS.index(d.action)
                h[F_TARGET] = _NONE if d.target_size is None \
                    else d.target_size
                h[F_EVICT] = _NONE if d.evict_rank is None else d.evict_rank
                h[F_VIOL] = _f2i(tick["viol_s"])
                h[F_P99] = _f2i(_opt(tick["p99"]))
                h[F_HIT] = _f2i(_opt(tick["hit"]))
                raw = d.reason.encode()[:8 * _REASON_WORDS]
                h[F_REASON_LEN] = len(raw)
                raw += b"\0" * (-len(raw) % 8)
                for i in range(len(raw) // 8):
                    h[F_REASON + i] = struct.unpack(
                        "<q", raw[8 * i:8 * i + 8])[0]
            h[F_FLAGS] = flags
            if len(self._faults) > MAX_FAULTS:
                raise ValueError(f"more than {MAX_FAULTS} chaos faults in "
                                 f"one loop turn")
            h[F_NFAULT] = len(self._faults)
            h[F_FAULTS:F_FAULTS + len(self._faults)] = self._faults
        t = torch.as_tensor(h).to(self._device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        hdr = self._decode(t.cpu().numpy())
        self.headers += 1
        self.clock, self.wall = hdr["clock"], hdr["wall"]
        self._first[:] = math.nan
        self._faults, self._steps, self._blob = [], {}, b""
        deferred, self._deferred = self._deferred, []
        for fn in deferred:
            fn(hdr)
        return hdr

    def _decode(self, h: np.ndarray) -> dict:
        flags = int(h[F_FLAGS])
        n = self.slots * self.width
        lanes = []
        for lane in range(self.lanes):
            base = HEADER + lane * self.lane_size
            first = base + _L_SLOTS
            toks = first + self.slots
            lanes.append({
                "step": bool(h[base + _L_STEP]),
                "step_s": _i2f(h[base + _L_STEP_S]),
                "first": [_i2f(v) for v in h[first:toks]],
                "tokens": h[toks:toks + n],
                "finite": h[toks + n:toks + n + self.slots].astype(bool)})
        blob = HEADER + self.lanes * self.lane_size
        hdr = {"clock": _i2f(h[F_CLOCK]), "wall": _i2f(h[F_WALL]),
               **lanes[0], "lanes": lanes, "ack": int(h[F_ACK]),
               "blob": _unpack_bytes(h[blob:blob + self.blob_words],
                                     int(h[F_BLOB_LEN])),
               "faults": [int(v) for v in
                          h[F_FAULTS:F_FAULTS + int(h[F_NFAULT])]],
               "tick": None}
        if flags & FLAG_TICK:
            raw = b"".join(struct.pack("<q", int(v)) for v in
                           h[F_REASON:F_REASON + _REASON_WORDS])
            p99, hit = _i2f(h[F_P99]), _i2f(h[F_HIT])
            hdr["tick"] = {
                "now_s": hdr["clock"], "viol_s": _i2f(h[F_VIOL]),
                "violated": bool(flags & FLAG_VIOLATED),
                "p99": None if math.isnan(p99) else p99,
                "hit": None if math.isnan(hit) else hit,
                "action": ACTIONS[int(h[F_ACTION])],
                "reason": raw[:int(h[F_REASON_LEN])].decode(),
                "target_size": None if h[F_TARGET] == _NONE
                else int(h[F_TARGET]),
                "evict_rank": None if h[F_EVICT] == _NONE
                else int(h[F_EVICT])}
        return hdr


class Lane:
    """One lane of a :class:`LockStep`: the calls an engine makes on its
    own header within a turn (``stamp_first``, ``note_step``,
    ``defer``), routed to the lane's section; a deferred call sees the
    header with the lane's fields at the top level.  The lane's owner
    keeps the clock and exchanges the header (:meth:`LockStep.exchange`).
    """

    def __init__(self, ls: LockStep, index: int):
        self.ls = ls
        self.index = index
        self.leader = ls.leader

    def stamp_first(self, slot: int) -> Optional[float]:
        return self.ls.stamp_first(slot, self.index)

    def note_step(self, step_s: float, sampled, finite) -> None:
        self.ls.note_step(step_s, sampled, finite, self.index)

    def defer(self, fn: Callable[[dict], None]) -> None:
        i = self.index
        self.ls.defer(lambda hdr: fn({**hdr, **hdr["lanes"][i]}))


__all__ = ["Lane", "LockStep"]
