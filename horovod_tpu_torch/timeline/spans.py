"""Cross-rank span layer: tagged timing spans and per-step summaries.

Counterpart of ``horovod_tpu/timeline/spans.py``.  Every host-side
timing region funnels through the process-wide :class:`SpanRecorder`:
the serving engine's prefill and decode dispatches, and the train-step
sampler's dispatch and dispatch gap (``training._InstrumentedStep``).
Each span is tagged ``(rank, step, bucket_id, fuse_key, leg)`` and, when
a :class:`~horovod_tpu_torch.timeline.Timeline` is attached, mirrored
into the Chrome-trace file, so one rank's file carries the attribution
the cross-rank merge (``python -m horovod_tpu_torch.timeline``) needs.

Per step, the recorder folds its spans into a summary dict::

    {"rank": r, "step": s, "t0_us": <unix epoch us at dispatch start>,
     "wall_s": ..., "spans": {"dispatch": ..., "dispatch_gap": ...},
     "legs": {...}}

(``dispatch`` is the step call, ``dispatch_gap`` the host time between
consecutive calls: input pipeline, Python glue, injected host delays),
which :meth:`SpanRecorder.step_boundary` hands to its listeners: the
straggler monitor on every rank and, under ``HOROVOD_TRACE_SYNC=1``,
the KV trace plane (``timeline/sync.py``).  :meth:`SpanRecorder.legs`
reads the seconds booked per leg since the last reset.

The leg registry: every exchange notes the plan-IR rows
(``controller.fusion.ExchangeLeg``) it runs with :func:`note_leg`, which
books ``{tag: {"nbytes", "buckets"}}`` (:meth:`SpanRecorder.
leg_registry`).  The JAX package notes once per trace; the port, which
runs eagerly, notes once per executed exchange (and a captured CUDA
graph's rows once per replay).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

#: Per-step summaries kept in the ring buffer.
SUMMARY_RING = 64


class SpanRecorder:
    """Process-wide span sink; cheap enough to call per collective."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rank = 0
        self.timeline = None  # Optional[Timeline]
        self._step = 0
        # step -> {"spans": {kind: secs}, "legs": {leg: {secs, count}}}
        self._acc: "OrderedDict[int, dict]" = OrderedDict()
        self.summaries: "OrderedDict[int, dict]" = OrderedDict()
        self._legs: Dict[str, dict] = {}
        self._leg_bytes: Dict[str, dict] = {}
        self._listeners = []

    # -- wiring -----------------------------------------------------------
    def configure(self, rank: Optional[int] = None,
                  timeline=None) -> "SpanRecorder":
        with self._lock:
            if rank is not None:
                self.rank = int(rank)
            if timeline is not None:
                self.timeline = timeline
        return self

    def add_listener(self, fn) -> None:
        """``fn(summary_dict)`` called after every step boundary.
        Idempotent by identity (a re-init must not double-feed)."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- step clock -------------------------------------------------------
    def set_step(self, step: int) -> None:
        self._step = int(step)

    @property
    def step(self) -> int:
        return self._step

    def _bucket(self, step: int) -> dict:
        acc = self._acc.get(step)
        if acc is None:
            acc = self._acc[step] = {"spans": {}, "legs": {}}
            while len(self._acc) > SUMMARY_RING:
                self._acc.popitem(last=False)
        return acc

    # -- span emission ----------------------------------------------------
    def _tags(self, leg, bucket_id, fuse_key) -> dict:
        args = {"rank": self.rank, "step": self._step}
        if leg is not None:
            args["leg"] = leg
        if bucket_id is not None:
            args["bucket_id"] = int(bucket_id)
        if fuse_key is not None:
            args["fuse_key"] = str(fuse_key)
        return args

    def add(self, kind: str, dur_s: float, leg: Optional[str] = None,
            bucket_id: Optional[int] = None,
            fuse_key: Optional[str] = None, emit: bool = False) -> None:
        """Book a completed span of ``dur_s`` seconds at the current
        step.  ``emit=True`` mirrors it into the attached timeline as a
        retroactive "X" event ending now -- for a region with no
        begin/end pair of its own (the dispatch gap); a region that
        already has a timeline range leaves it False."""
        with self._lock:
            acc = self._bucket(self._step)
            acc["spans"][kind] = acc["spans"].get(kind, 0.0) + float(dur_s)
            if leg:
                for book in (acc["legs"], self._legs):
                    lg = book.setdefault(leg, {"secs": 0.0, "count": 0})
                    lg["secs"] += float(dur_s)
                    lg["count"] += 1
        tl = self.timeline
        if emit and tl is not None:
            try:
                tl.complete("spans", kind, dur_s,
                            args=self._tags(leg, bucket_id, fuse_key))
            except Exception:
                pass

    @contextlib.contextmanager
    def span(self, kind: str, name: str = "", leg: Optional[str] = None,
             bucket_id: Optional[int] = None,
             fuse_key: Optional[str] = None):
        """Time a host region and book it under ``kind`` and ``leg``;
        mirrored into the timeline (track ``name``, else ``spans``, its
        args the tags) when one is attached."""
        tl = self.timeline
        if tl is not None:
            tl.begin(name or "spans", kind,
                     args=self._tags(leg, bucket_id, fuse_key))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            if tl is not None:
                tl.end(name or "spans", kind)
            self.add(kind, dur, leg=leg, bucket_id=bucket_id,
                     fuse_key=fuse_key)

    def legs(self) -> dict:
        """``{leg: {"secs", "count"}}`` booked since the last reset."""
        with self._lock:
            return {k: dict(v) for k, v in self._legs.items()}

    # -- leg registry -----------------------------------------------------
    def note_leg(self, leg, nbytes: Optional[int] = None) -> None:
        """Book one executed exchange leg: an ``ExchangeLeg`` row (its
        tag and planned wire bytes) or a bare tag with ``nbytes``; a
        ``leg_bytes/<tag>`` counter sample in the timeline."""
        tag, nbytes = _normalize_leg(leg, nbytes)
        self.add_leg_totals({tag: {"nbytes": nbytes, "buckets": 1}})
        tl = self.timeline
        if tl is not None:
            try:
                tl.counter(f"leg_bytes/{tag}", float(nbytes))
            except Exception:
                pass

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

    # -- step boundary ----------------------------------------------------
    def step_boundary(self, step: int, wall_s: float,
                      t0_unix_us: Optional[float] = None) -> dict:
        """Close step ``step``: fold its spans into a summary, push it
        through the listeners and return it.  ``wall_s`` is the step's
        wall including the dispatch gap; ``t0_unix_us`` anchors it on
        the wall clock for the cross-rank merge."""
        with self._lock:
            acc = self._acc.pop(step, {"spans": {}, "legs": {}})
            summary = {
                "rank": self.rank,
                "step": int(step),
                "t0_us": float(t0_unix_us if t0_unix_us is not None
                               else time.time() * 1e6),
                "wall_s": float(wall_s),
                "spans": {k: round(v, 9)
                          for k, v in sorted(acc["spans"].items())},
                "legs": {k: {"secs": round(v["secs"], 9),
                             "count": v["count"]}
                         for k, v in sorted(acc["legs"].items())},
            }
            self.summaries[step] = summary
            while len(self.summaries) > SUMMARY_RING:
                self.summaries.popitem(last=False)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(summary)
            except Exception:  # observers must never break training
                pass
        return summary

    def reset(self) -> None:
        """Forget everything: spans, summaries, legs, listeners, the
        timeline and the rank (tests; ``shutdown()``)."""
        with self._lock:
            self._step = 0
            self._acc.clear()
            self.summaries.clear()
            self._legs.clear()
            self._leg_bytes.clear()
            self._listeners = []
            self.timeline = None
            self.rank = 0


def dominant_span(summary: dict) -> str:
    """The span kind that took the most host time in a step summary
    (``"compute"`` when none is booked: a captured window hides the
    device work behind one dispatch)."""
    spans = summary.get("spans") or {}
    if not spans:
        return "compute"
    return max(spans.items(), key=lambda kv: kv[1])[0]


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
