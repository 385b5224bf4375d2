"""Clock alignment + cross-rank trace aggregation over the KV plane.

The port's copy of ``horovod_tpu/timeline/sync.py``, over the port's
``run/http_kv.py``.

Per-rank Chrome traces are anchored to local clocks; merging them
requires knowing each rank's offset.  At ``init()`` (when
``HOROVOD_TRACE_SYNC=1`` and a rendezvous KV server is reachable) every
rank runs an NTP-style ping against the KV server's ``/time`` endpoint
(:func:`estimate_clock_offset`, transported by the existing
:class:`~horovod_tpu_torch.run.http_kv.KVClient` and its
:class:`~horovod_tpu_torch.run.retry.RetryPolicy`): for each sample,

    offset = server_time - (t_send + t_recv) / 2

keeping the minimum-round-trip sample (its midpoint uncertainty is
rtt/2, the NTP bound).  Rank r's offset *to rank 0* is then
``offset_r - offset_0`` -- both measured against the same server clock,
so the server's own absolute error cancels.

Every ``HOROVOD_TRACE_PUBLISH_STEPS`` steps each rank PUTs its compact
per-step span summary under ``trace/summary/<rank>/<step>``; rank 0
collects the fleet's summaries, feeds the
:class:`~horovod_tpu_torch.timeline.straggler.StragglerMonitor`, and can
write one merged Perfetto trace (one pid per rank, offsets applied) via
:meth:`TracePlane.write_merged`.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("horovod_tpu_torch.timeline")

SCOPE = "trace"

#: NTP-style ping samples per offset estimate.
OFFSET_SAMPLES = 8


def estimate_clock_offset(kv, samples: int = OFFSET_SAMPLES
                          ) -> Tuple[float, float]:
    """``(offset_s, rtt_s)`` of this host's clock relative to the KV
    server's, from ``samples`` round trips, keeping the minimum-RTT
    sample.  ``offset_s`` is what to ADD to a local wall-clock reading
    to land on the server's clock."""
    best: Optional[Tuple[float, float]] = None  # (rtt, offset)
    for _ in range(max(1, int(samples))):
        t0 = time.time()
        server_t = kv.server_time()
        t1 = time.time()
        rtt = max(0.0, t1 - t0)
        offset = server_t - (t0 + t1) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    return best[1], best[0]


class TracePlane:
    """Per-rank publisher + (on rank 0) fleet collector."""

    def __init__(self, kv, rank: int, size: int,
                 publish_steps: int = 10, monitor=None):
        self.kv = kv
        self.rank = int(rank)
        self.size = max(1, int(size))
        self.publish_steps = max(1, int(publish_steps))
        self.monitor = monitor
        self.offset_s, self.rtt_s = estimate_clock_offset(kv)
        kv.put(SCOPE, f"offset/{self.rank}",
               json.dumps({"offset_s": self.offset_s,
                           "rtt_s": self.rtt_s}).encode())
        logger.info("trace plane: rank %d clock offset %+.3f ms to KV "
                    "server (rtt %.3f ms)", self.rank,
                    self.offset_s * 1e3, self.rtt_s * 1e3)
        self._offsets: Dict[int, float] = {self.rank: self.offset_s}
        self._collected: Dict[int, List[dict]] = {}

    # -- publish ----------------------------------------------------------
    def on_summary(self, summary: dict) -> None:
        """SpanRecorder listener: publish every N steps; never raises
        (a down driver must not take training with it)."""
        step = int(summary.get("step", 0))
        if step % self.publish_steps:
            return
        try:
            self.kv.put(SCOPE, f"summary/{summary['rank']}/{step}",
                        json.dumps(summary).encode())
            if self.rank == 0:
                self.collect(step)
        except Exception as e:
            logger.debug("trace plane publish failed at step %d: %s",
                         step, e)

    # -- collect (rank 0) -------------------------------------------------
    def rank_offset(self, rank: int) -> float:
        """Rank ``rank``'s clock offset relative to rank 0 (seconds)."""
        off = self._offsets.get(rank)
        if off is None:
            raw = self.kv.get(SCOPE, f"offset/{rank}")
            if raw is None:
                return 0.0
            off = float(json.loads(raw)["offset_s"])
            self._offsets[rank] = off
        return off - self._offsets.get(0, 0.0)

    def collect(self, step: int) -> List[dict]:
        """Fetch every rank's summary for ``step`` (missing ranks are
        skipped -- they may simply not have reached the publish point),
        feed the straggler monitor, and compute the step's skew."""
        out: List[dict] = []
        for r in range(self.size):
            raw = self.kv.get(SCOPE, f"summary/{r}/{step}")
            if raw is None:
                continue
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
        self._collected[step] = out
        if self.monitor is not None:
            for s in out:
                if int(s.get("rank", -1)) != self.rank:
                    # Our own summary already fed the monitor locally.
                    self.monitor.observe(s)
        return out

    # -- merged trace (rank 0) --------------------------------------------
    def write_merged(self, path: str) -> int:
        """Write collected summaries as ONE Perfetto/Chrome trace: one
        pid per rank, per-span-kind complete ("X") events placed on rank
        0's clock (offsets applied).  Returns the event count."""
        events: List[dict] = []
        for r in range(self.size):
            events.append({"name": "process_name", "ph": "M",
                           "pid": r + 1,
                           "args": {"name": f"rank {r}"}})
        n = 0
        for step in sorted(self._collected):
            for s in self._collected[step]:
                r = int(s["rank"])
                t0 = float(s["t0_us"]) - self.rank_offset(r) * 1e6
                events.append({
                    "name": f"step {step}", "ph": "X", "pid": r + 1,
                    "tid": 0, "ts": t0,
                    "dur": float(s["wall_s"]) * 1e6,
                    "args": {"rank": r, "step": step}})
                cursor = t0
                for kind, secs in sorted((s.get("spans") or {}).items()):
                    events.append({
                        "name": kind, "ph": "X", "pid": r + 1, "tid": 1,
                        "ts": cursor, "dur": float(secs) * 1e6,
                        "args": {"rank": r, "step": step, "kind": kind}})
                    cursor += float(secs) * 1e6
                n += 1
        with open(path, "w") as f:
            json.dump(events, f)
        return n

    def step_skew(self, step: int) -> Optional[float]:
        """Slowest-minus-fastest wall among collected summaries for
        ``step`` (None with fewer than two ranks reporting)."""
        walls = [float(s["wall_s"]) for s in self._collected.get(step, [])]
        if len(walls) < 2:
            return None
        return max(walls) - min(walls)
