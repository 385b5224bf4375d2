"""Host-side timing spans.

Counterpart of ``horovod_tpu/timeline/spans.py``, cut to what the
port calls: :meth:`SpanRecorder.span` times a host region and books it
under its ``kind`` and ``leg``.  The serving engine wraps each prefill
and decode dispatch in one; :meth:`SpanRecorder.legs` reads the totals
back.

The leg registry: every exchange notes the plan-IR rows
(``controller.fusion.ExchangeLeg``) it runs with :func:`note_leg`, which
books ``{tag: {"nbytes", "buckets"}}`` (:meth:`SpanRecorder.
leg_registry`).  The JAX package notes once per trace; the port, which
runs eagerly, notes once per executed exchange (and a captured CUDA
graph's rows once per replay).  The per-step ring and the timeline
mirroring are not ported.
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
        self._leg_bytes: Dict[str, dict] = {}

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

    def note_leg(self, leg, nbytes: Optional[int] = None) -> None:
        """Book one executed exchange leg: an ``ExchangeLeg`` row (its
        tag and planned wire bytes) or a bare tag with ``nbytes``."""
        tag, nbytes = _normalize_leg(leg, nbytes)
        self.add_leg_totals({tag: {"nbytes": nbytes, "buckets": 1}})

    def add_leg_totals(self, totals: dict) -> None:
        """Add ``{tag: {"nbytes", "buckets"}}`` to the registry (a
        replayed CUDA graph's rows)."""
        with self._lock:
            for tag, v in totals.items():
                lg = self._leg_bytes.setdefault(tag,
                                                {"nbytes": 0, "buckets": 0})
                lg["nbytes"] += int(v["nbytes"])
                lg["buckets"] += int(v["buckets"])

    def leg_registry(self) -> dict:
        """``{tag: {"nbytes", "buckets"}}`` noted since the last reset."""
        with self._lock:
            return {k: dict(v) for k, v in self._leg_bytes.items()}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._legs.clear()
            self._leg_bytes.clear()


_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    """The process-wide :class:`SpanRecorder` singleton."""
    return _recorder


def _normalize_leg(leg, nbytes: Optional[int] = None):
    """``(tag, nbytes)`` of a plan-IR row (anything with ``.tag`` and
    ``.nbytes``; the row's bytes unless ``nbytes`` overrides them) or of
    a bare tag: the one place both entry points derive them."""
    tag = getattr(leg, "tag", None)
    if tag is not None:
        return str(tag), int(getattr(leg, "nbytes", 0)
                             if nbytes is None else nbytes)
    return str(leg), int(nbytes if nbytes is not None else 0)


def note_leg(leg, nbytes: Optional[int] = None) -> None:
    """Book one executed leg in the process-wide recorder
    (:meth:`SpanRecorder.note_leg`)."""
    _recorder.note_leg(leg, nbytes=nbytes)
