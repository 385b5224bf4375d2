"""Host-side timing spans.

Counterpart of ``horovod_tpu/timeline/spans.py``, cut to what the
serving path calls: :meth:`SpanRecorder.span` times a host region and
books it under its ``kind`` and ``leg``.  The serving engine wraps each
prefill and decode dispatch in one; :meth:`SpanRecorder.legs` reads the
totals back.  The reference's per-step ring, timeline mirroring and
trace-time leg registry serve the training exchange and are not ported.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional


class SpanRecorder:
    """Process-wide span sink: seconds per span kind and per leg."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, float] = {}
        self._legs: Dict[str, dict] = {}

    def add(self, kind: str, dur_s: float,
            leg: Optional[str] = None) -> None:
        """Book a completed span of ``dur_s`` seconds."""
        with self._lock:
            self._spans[kind] = self._spans.get(kind, 0.0) + float(dur_s)
            if leg:
                lg = self._legs.setdefault(leg, {"secs": 0.0, "count": 0})
                lg["secs"] += float(dur_s)
                lg["count"] += 1

    @contextlib.contextmanager
    def span(self, kind: str, name: str = "", leg: Optional[str] = None):
        """Time a host region and book it under ``kind`` and ``leg``.
        ``name`` labels the region for readers of the code; the booking
        is keyed by kind and leg."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(kind, time.perf_counter() - t0, leg=leg)

    def legs(self) -> dict:
        """``{leg: {"secs", "count"}}`` booked since the last reset."""
        with self._lock:
            return {k: dict(v) for k, v in self._legs.items()}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._legs.clear()


_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    """The process-wide :class:`SpanRecorder` singleton."""
    return _recorder
