"""Lock-step serving over a world of ranks: one header a loop turn.

The reference's engine and control plane are one controller over a mesh
of devices.  Here each rank of a tensor-parallel mesh is a process with
its own clock, so two ranks reading their own clocks would admit
different requests at different steps, and the next row-parallel
allreduce would hang or mix slots.  So only the world's rank 0 (the
*leader*) reads the clock -- and, in the control plane, the policy, the
chaos faults and the straggler monitor -- and every loop turn ends in
one fixed-size int64 header the leader broadcasts over the world, as
:mod:`~horovod_tpu_torch.collectives.joinop` broadcasts its op headers.
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

The header (``HEADER`` fields, then per-slot arrays): the clock, the
wall time, ``step_s``, flags (a tick, a step), the control plane's tick
(action, target size, evicted rank, the SLO-violation seconds, the
windowed TTFT p99 and the prefix hit rate, the reason as bytes), the
indices of the chaos faults the leader fired, and per slot the
first-token time, the sampled tokens (``width`` a slot) and whether the
slot's logits were finite.
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
(F_CLOCK, F_WALL, F_STEP_S, F_FLAGS, F_ACTION, F_TARGET, F_EVICT, F_VIOL,
 F_P99, F_HIT, F_NFAULT, F_REASON_LEN) = range(12)
F_FAULTS = 12
F_REASON = F_FAULTS + MAX_FAULTS
HEADER = F_REASON + _REASON_WORDS
FLAG_TICK, FLAG_STEP, FLAG_VIOLATED = 1, 2, 4
_NONE = -1


def _f2i(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _i2f(v: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(v)))[0]


def _opt(x: Optional[float]) -> float:
    return math.nan if x is None else float(x)


class LockStep:
    """The header exchange of one engine over the world (see the module
    docstring).  ``slots`` and ``width`` (tokens a slot a step at most:
    the verify width when speculating, else 1) size the header; its
    ``tokens`` come flat, the caller reshapes them."""

    def __init__(self, slots: int, width: int = 1):
        st = global_state()
        self.rank = int(st.rank)
        self.leader = self.rank == 0
        self.slots = int(slots)
        self.width = int(width)
        self.size = HEADER + self.slots * (self.width + 2)
        self._device = st.device or torch.device("cpu")
        self.headers = 0
        self.reset()

    def reset(self) -> None:
        """Start a serve: the clocks at 0, nothing queued."""
        self._start = time.monotonic()
        self.skip = 0.0              # the leader's fast-forwarded idle time
        self.clock = 0.0
        self.wall = 0.0
        self._first = np.full((self.slots,), math.nan)
        self._faults: List[int] = []
        self._step: Optional[tuple] = None
        self._deferred: List[Callable[[dict], None]] = []

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

    def stamp_first(self, slot: int) -> Optional[float]:
        """The first-token time of the request joining the decode batch
        in ``slot``: the leader's reading, sent with the next header;
        ``None`` elsewhere (the caller sets it from the header)."""
        if not self.leader:
            return None
        t = self.fresh()
        self._first[slot] = t
        return t

    def note_faults(self, indices) -> None:
        """The chaos faults (indices in the spec) the leader fired."""
        self._faults.extend(int(i) for i in indices)

    def note_step(self, step_s: float, sampled, finite) -> None:
        """The leader's step: its wall and tokens, for the header."""
        self._step = (float(step_s), sampled, finite)

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

    def exchange(self, tick: Optional[dict] = None) -> dict:
        """End the turn: the leader sends the header (with ``tick``, the
        control plane's decision record, when it ticked), every rank
        returns it decoded, sets its clock and runs its deferred
        work."""
        h = np.zeros((self.size,), np.int64)
        if self.leader:
            now = tick["now_s"] if tick is not None else self.fresh()
            h[F_CLOCK] = _f2i(now)
            h[F_WALL] = _f2i(time.monotonic() - self._start)
            flags = 0
            if self._step is not None:
                step_s, sampled, finite = self._step
                flags |= FLAG_STEP
                h[F_STEP_S] = _f2i(step_s)
                base = HEADER + self.slots
                flat = np.asarray(sampled).reshape(-1)
                h[base:base + flat.size] = flat
                n = self.slots * self.width
                h[base + n:base + n + self.slots] = np.asarray(finite)
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
            h[HEADER:HEADER + self.slots] = [_f2i(x) for x in self._first]
        t = torch.as_tensor(h).to(self._device)
        dist.broadcast(t, src=0)
        hdr = self._decode(t.cpu().numpy())
        self.headers += 1
        self.clock, self.wall = hdr["clock"], hdr["wall"]
        self._first[:] = math.nan
        self._faults, self._step = [], None
        deferred, self._deferred = self._deferred, []
        for fn in deferred:
            fn(hdr)
        return hdr

    def _decode(self, h: np.ndarray) -> dict:
        flags = int(h[F_FLAGS])
        base = HEADER + self.slots
        n = self.slots * self.width
        toks = h[base:base + n]
        hdr = {"clock": _i2f(h[F_CLOCK]), "wall": _i2f(h[F_WALL]),
               "step_s": _i2f(h[F_STEP_S]),
               "step": bool(flags & FLAG_STEP),
               "first": [_i2f(v) for v in h[HEADER:base]],
               "tokens": toks,
               "finite": h[base + n:base + n + self.slots].astype(bool),
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


__all__ = ["LockStep"]
