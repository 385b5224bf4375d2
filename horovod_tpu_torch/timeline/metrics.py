"""Process-wide metrics registry.

Counterpart of ``horovod_tpu/timeline/metrics.py``, cut to what the
serving scheduler and the gradient exchange use: labelled counter, gauge
and fixed-bucket histogram families in one thread-safe registry.  ``HOROVOD_METRICS=0``
turns every family into a shared no-op object, as in the reference.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

from ..core.config import _env_bool

DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram; ``snapshot()`` gives cumulative per-``le``
    counts with an implicit ``+Inf`` bucket (Prometheus semantics)."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(
                f"bucket bounds must be strictly increasing: {bounds}")
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)  # le semantics: v <= bound
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            raw, total, s = list(self._counts), self._count, self._sum
        cum, acc = {}, 0
        for bound, c in zip(self.bounds, raw):
            acc += c
            cum[repr(bound)] = acc
        cum["+Inf"] = total
        return {"buckets": cum, "sum": s, "count": total}


class _NullMetric:
    """No-op stand-in for every family and child when metrics are off."""

    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def labels(self, **kv) -> "_NullMetric":
        return self

    @property
    def value(self) -> float:
        return 0.0


NULL_METRIC = _NullMetric()


class _Family:
    """One named metric family, optionally labelled; an unlabelled
    family proxies the metric API to its single child."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Sequence[str], buckets: Sequence[float]):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self.buckets)
        return Counter() if self.kind == "counter" else Gauge()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
            return child

    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labelled {self.labelnames}; use .labels()")
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._solo().inc(v)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    @property
    def value(self) -> float:
        return self._solo().value

    def samples(self):
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Thread-safe family store."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    @property
    def enabled(self) -> bool:
        return _env_bool("METRICS", True)

    def _family(self, kind: str, name: str, help: str,
                labelnames: Sequence[str],
                buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind, name, help, labelnames, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()):
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()):
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  labelnames: Sequence[str] = ()):
        return self._family("histogram", name, help, labelnames, buckets)

    def snapshot(self) -> dict:
        """``{family: {"type", "samples": [{"labels", value|histogram}]}}``."""
        with self._lock:
            families = dict(self._families)
        out = {}
        for name in sorted(families):
            fam = families[name]
            out[name] = {"type": fam.kind, "samples": [
                {"labels": dict(zip(fam.labelnames, key)),
                 **(m.snapshot() if fam.kind == "histogram"
                    else {"value": m.value})}
                for key, m in fam.samples()]}
        return out


_registry_lock = threading.Lock()
_registry: Optional[MetricsRegistry] = None


def registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def reset_metrics() -> None:
    """Drop every family (tests)."""
    global _registry
    with _registry_lock:
        _registry = None


_EXCHANGE = {
    "buckets": ("horovod_exchange_buckets_total",
                "fused gradient buckets allreduced"),
    "wire_bytes": ("horovod_exchange_wire_bytes_total",
                   "bytes one rank put on the wire for gradient buckets"),
    "handles": ("horovod_exchange_handles_total",
                "async allreduce handles issued for gradient buckets"),
}


def exchange_counters() -> Dict[str, object]:
    """The gradient-exchange counters the DistributedOptimizer feeds:
    fused buckets sent, bytes on the wire (after compression, one rank's
    payload) and async allreduce handles issued.  A PowerSGD bucket counts
    one bucket, two handles (its P and Q factor allreduces) and ``4 * r *
    (m + c)`` wire bytes."""
    reg = registry()
    return {k: reg.counter(name, help) for k, (name, help)
            in _EXCHANGE.items()}


def exchange_totals() -> Dict[str, float]:
    """The exchange counters' values (0 when ``HOROVOD_METRICS=0``); a
    caller takes differences around the steps it wants to read."""
    return {k: c.value for k, c in exchange_counters().items()}


def note_compression_ratio(uncompressed: int, wire: int) -> None:
    """Set the compression gauges of one optimizer step's exchange (the
    JAX package's ``_note_compression_ratio``): wire and uncompressed
    bytes per step and their ratio.  Set, not incremented: they describe
    the plan, which a wrap fixes once."""
    if wire <= 0:
        return
    reg = registry()
    reg.gauge("horovod_compression_ratio",
              "uncompressed / wire bytes of the gradient exchange"
              ).set(uncompressed / wire)
    reg.gauge("horovod_wire_bytes_per_step",
              "Per-rank exchange wire bytes per optimizer step").set(wire)
    reg.gauge("horovod_uncompressed_bytes_per_step",
              "Equivalent uncompressed exchange bytes per optimizer step"
              ).set(uncompressed)
