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
        """``{family: {"type", "samples": [{"labels", value|histogram}]}}``
        (the plan-cache gauges refreshed first)."""
        if self.enabled:
            _collect_plan_cache(self)
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


def _collect_plan_cache(reg: "MetricsRegistry") -> None:
    """The ``horovod_plan_cache_*`` gauges: the exchange-plan cache's
    hits, misses, evictions and entries (``controller.fusion.
    plan_cache_stats``)."""
    from ..controller.fusion import plan_cache_stats
    for key, value in plan_cache_stats().items():
        reg.gauge(f"horovod_plan_cache_{key}",
                  f"exchange-plan cache {key}").set(value)


def counter_values() -> Dict[Tuple, float]:
    """Every counter's value, keyed by ``(family, label names, label
    values)``."""
    reg = registry()
    with reg._lock:
        fams = [f for f in reg._families.values() if f.kind == "counter"]
    return {(f.name, f.labelnames, key): m.value
            for f in fams for key, m in f.samples()}


def add_counter_values(deltas: Dict[Tuple, float]) -> None:
    """Add ``deltas`` (keyed as :func:`counter_values` keys them) to the
    counters of the current registry: a replayed CUDA graph's
    increments."""
    reg = registry()
    for (name, labelnames, key), v in deltas.items():
        if v > 0:
            reg.counter(name, labelnames=labelnames).labels(
                **dict(zip(labelnames, key))).inc(v)


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


_HIER_LEGS = ("hier/ici_rs", "hier/dcn_ar", "hier/ici_ag")


def exchange_counters() -> Dict[str, object]:
    """The gradient-exchange counters the DistributedOptimizer and the
    microbatch pipe feed: fused buckets sent, bytes on the wire (after
    compression, one rank's payload, priced from the exchange's plan
    rows -- ``controller.fusion.plan_exchange``: the ``flat``,
    ``chunked`` and ``hier`` rows, the ``ef`` ledger row, the
    microbatch pipe's ``mb_rs`` and ``mb_ag`` rows; fp8 by
    ``wire_payload_bytes``) and the collectives issued for the buckets'
    payloads (``handles``): one for a plain or Adasum bucket, two for
    PowerSGD (its P and Q factor allreduces), fp8 (the all-to-all and the
    allgather) and top-k (the value and index gathers), three for a
    two-level bucket, two a chunk for a chunked one (its row's audit
    rows), ``k + 1`` for a microbatched one.  A PowerSGD bucket puts
    ``4 * r * (m + c)`` bytes on the wire, fp8 one a value, top-k
    ``8k / 2``."""
    reg = registry()
    return {k: reg.counter(name, help) for k, (name, help)
            in _EXCHANGE.items()}


def hier_leg_counters() -> Dict[str, object]:
    """Wire bytes of the two-level exchange by leg (``hier/ici_rs``,
    ``hier/dcn_ar``, ``hier/ici_ag``, each priced as ``plan_hier_legs``
    prices it)."""
    reg = registry()
    fam = reg.counter("horovod_exchange_hier_leg_bytes_total",
                      "two-level exchange wire bytes by leg", ("leg",))
    return {leg: fam.labels(leg=leg) for leg in _HIER_LEGS}


def note_hier_legs(legs) -> None:
    """Count one bucket's :class:`~horovod_tpu_torch.controller.fusion.
    ExchangeLeg` rows of the ``hier`` family (a one-node ``flat_ar`` row
    counts nowhere)."""
    m = hier_leg_counters()
    for leg in legs:
        if leg.tag in m:
            m[leg.tag].inc(leg.nbytes)


def exchange_totals(legs: bool = False) -> Dict[str, float]:
    """The exchange counters' values (0 when ``HOROVOD_METRICS=0``); a
    caller takes differences around the steps it wants to read.
    ``legs=True`` adds the two-level exchange's bytes by leg
    (:func:`hier_leg_counters`)."""
    out = {k: c.value for k, c in exchange_counters().items()}
    if legs:
        out.update((k, c.value) for k, c in hier_leg_counters().items())
    return out


_ZERO = {
    "steps": ("horovod_zero1_steps_total", "ZeRO-1 optimizer steps"),
    "reducescatter_bytes": ("horovod_zero1_reducescatter_bytes_total",
                            "per-rank link bytes of ZeRO-1's gradient "
                            "reduce-scatters"),
    "allgather_bytes": ("horovod_zero1_allgather_bytes_total",
                        "per-rank link bytes of ZeRO-1's (compressed) "
                        "parameter allgathers"),
}


def zero_counters() -> Dict[str, object]:
    """The ZeRO-1 counters ``optim.zero.zero_apply`` feeds, each step:
    the steps, and the link bytes of its reduce-scatters and allgathers
    priced as ``zero_report`` prices them (so a step's sum is its
    ``zero1_exchanged_bytes_per_chip``)."""
    reg = registry()
    return {k: reg.counter(name, help) for k, (name, help)
            in _ZERO.items()}


def zero_totals() -> Dict[str, float]:
    """The ZeRO-1 counters' values and the optimizer-state bytes a rank
    holds (``opt_state_bytes``, a gauge)."""
    out = {k: c.value for k, c in zero_counters().items()}
    out["opt_state_bytes"] = registry().gauge(
        "horovod_zero1_opt_state_bytes",
        "optimizer-state bytes this rank holds under ZeRO-1").value
    return out


def note_zero_step(reducescatter_bytes: int, allgather_bytes: int,
                   opt_state_bytes: int) -> None:
    m = zero_counters()
    m["steps"].inc()
    m["reducescatter_bytes"].inc(reducescatter_bytes)
    m["allgather_bytes"].inc(allgather_bytes)
    registry().gauge("horovod_zero1_opt_state_bytes",
                     "optimizer-state bytes this rank holds under ZeRO-1"
                     ).set(opt_state_bytes)


_SYNC_BN = {
    "allreduces": ("horovod_exchange_sync_bn_allreduces_total",
                   "allreduces of synchronized BatchNorm's per-channel "
                   "statistics and gradient sums"),
    "wire_bytes": ("horovod_exchange_sync_bn_wire_bytes_total",
                   "bytes one rank put on the wire for synchronized "
                   "BatchNorm"),
    "layout_copies": ("horovod_sync_bn_layout_copies_total",
                      "channels-last copies SyncBatchNorm made of an input "
                      "or gradient that was not channels-last"),
}


def sync_bn_counters() -> Dict[str, object]:
    """The synchronized-BatchNorm exchange counters: allreduces issued
    (two a site per training step -- the forward's statistics and the
    backward's gradient sums -- at every world size), their bytes, and
    the explicit channels-last copies ``SyncBatchNorm`` made."""
    reg = registry()
    return {k: reg.counter(name, help) for k, (name, help)
            in _SYNC_BN.items()}


def sync_bn_totals() -> Dict[str, float]:
    """The sync-BN counters' values (0 when ``HOROVOD_METRICS=0``)."""
    return {k: c.value for k, c in sync_bn_counters().items()}


def note_sync_bn_allreduce(nbytes: int) -> None:
    m = sync_bn_counters()
    m["allreduces"].inc()
    m["wire_bytes"].inc(nbytes)


_COLLECTIVE = {
    "calls": ("horovod_collective_calls_total",
              "collective ops called, by op kind and process set"),
    "bytes": ("horovod_collective_bytes_total",
              "bytes of the tensors one rank handed to collective ops"),
    "handles": ("horovod_collective_handles_total",
                "integer handles issued by the *_async surface"),
}
_COLLECTIVE_LABELS = ("op", "process_set")


# The labelled children of the registry they were made in: every
# collective call counts itself, so the family and label lookups are made
# once per (op, process set), not once per call.
_collective_children: Dict[Tuple[str, str], Dict[str, object]] = {}
_collective_children_of: Optional[MetricsRegistry] = None


def collective_counters(op: str, process_set: str) -> Dict[str, object]:
    """The counters of one op kind (``allreduce``, ``reducescatter``,
    ...) on one process set (by name): calls, input bytes and integer
    handles.  They sit beside :func:`exchange_counters`, which count the
    DistributedOptimizer's buckets whatever op carries them."""
    global _collective_children_of
    reg = registry()
    if not reg.enabled:
        return dict.fromkeys(_COLLECTIVE, NULL_METRIC)
    if reg is not _collective_children_of:
        _collective_children.clear()
        _collective_children_of = reg
    m = _collective_children.get((op, process_set))
    if m is None:
        m = _collective_children[(op, process_set)] = {
            k: reg.counter(name, help, _COLLECTIVE_LABELS).labels(
                op=op, process_set=process_set)
            for k, (name, help) in _COLLECTIVE.items()}
    return m


def collective_totals() -> Dict[Tuple[str, str], Dict[str, float]]:
    """``{(op, process set): {"calls", "bytes", "handles"}}`` so far (empty
    when ``HOROVOD_METRICS=0``)."""
    out: Dict[Tuple[str, str], Dict[str, float]] = {}
    snap = registry().snapshot()
    for key, (name, _) in _COLLECTIVE.items():
        for sample in snap.get(name, {}).get("samples", ()):
            lab = sample["labels"]
            row = out.setdefault((lab["op"], lab["process_set"]),
                                 dict.fromkeys(_COLLECTIVE, 0.0))
            row[key] = sample["value"]
    return out


def note_collective(op: str, process_set: str, nbytes: int) -> None:
    m = collective_counters(op, process_set)
    m["calls"].inc()
    m["bytes"].inc(nbytes)


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
