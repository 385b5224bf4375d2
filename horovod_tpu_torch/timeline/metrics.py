"""Process-wide metrics registry.

Counterpart of ``horovod_tpu/timeline/metrics.py``: labelled counter,
gauge and fixed-bucket histogram families in one thread-safe registry
that every telemetry source of the port feeds -- the serving scheduler,
the gradient exchange, ZeRO-1, sync BN, the collectives, the elastic
plane, the SDC guard (``core/guard.py``), the tripwire
(``core/desync.py``), the straggler monitor and the per-step
:class:`StepReport` the train-step sampler records (``training.py``).
Rendered as Prometheus text (:func:`render_prometheus`, served by
``run/metrics_server.py`` on ``HOROVOD_METRICS_PORT``) and as a plain
dict (:func:`metrics_snapshot`).  ``HOROVOD_METRICS=0`` turns every
family into a shared no-op object, and the step sampler unwraps.

The port's snapshot keeps a ``samples`` list for every family (labelled
or not) beside the JAX package's ``value`` / histogram fields of an
unlabelled one.  The pull collectors are the ones the port has (the
exchange-plan cache); the JAX package's eager and deferred-fuse
collectors belong to its eager control plane, which is not ported.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.config import _env_bool

DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without the dot."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotonic counter.  ``set_cumulative`` is for a collector whose
    source keeps its own running total (the plan cache)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        with self._lock:
            self._value += v

    def set_cumulative(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

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

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

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
            cum[_fmt(bound)] = acc
        cum["+Inf"] = total
        return {"buckets": cum, "sum": s, "count": total}


class _NullMetric:
    """No-op stand-in for every family and child when metrics are off."""

    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def dec(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def set_cumulative(self, v: float) -> None:
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

    def dec(self, v: float = 1.0) -> None:
        self._solo().dec(v)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def set_cumulative(self, v: float) -> None:
        self._solo().set_cumulative(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def snapshot(self) -> dict:
        return self._solo().snapshot()

    @property
    def value(self) -> float:
        return self._solo().value

    def samples(self):
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Thread-safe family store, pull collectors, the last step report
    and the renderers.  Enabled-ness is ``HOROVOD_METRICS``, read at
    family-access time."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self._last_report: Optional["StepReport"] = None

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

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a pull callback run before every render and snapshot
        (idempotent by identity)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # a broken collector must not kill a scrape
                pass

    def record_step_report(self, report: "StepReport") -> None:
        with self._lock:
            self._last_report = report

    @property
    def last_step_report(self) -> Optional["StepReport"]:
        with self._lock:
            return self._last_report

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self.collect()
        with self._lock:
            families = [self._families[n] for n in sorted(self._families)]
        out: List[str] = []
        for fam in families:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, metric in fam.samples():
                base = "".join(
                    f'{n}="{_escape_label_value(v)}",'
                    for n, v in zip(fam.labelnames, key))[:-1]
                suffix = f"{{{base}}}" if base else ""
                if fam.kind == "histogram":
                    snap = metric.snapshot()
                    for le, c in snap["buckets"].items():
                        lbl = (base + "," if base else "") + \
                            f'le="{_escape_label_value(le)}"'
                        out.append(f"{fam.name}_bucket{{{lbl}}} {c}")
                    out.append(f"{fam.name}_sum{suffix} "
                               f"{_fmt(snap['sum'])}")
                    out.append(f"{fam.name}_count{suffix} {snap['count']}")
                else:
                    out.append(f"{fam.name}{suffix} {_fmt(metric.value)}")
        return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> dict:
        """``{family: {"type", "samples": [{"labels", value|histogram}]}}``,
        and for an unlabelled family also the JAX package's ``value``
        (0.0 before any sample) or ``count`` / ``sum`` / ``buckets``."""
        self.collect()
        with self._lock:
            families = dict(self._families)
        out = {}
        for name in sorted(families):
            fam = families[name]
            kids = fam.samples()
            entry = {"type": fam.kind, "samples": [
                {"labels": dict(zip(fam.labelnames, key)),
                 **(m.snapshot() if fam.kind == "histogram"
                    else {"value": m.value})}
                for key, m in kids]}
            if not fam.labelnames:
                if not kids:
                    entry["value"] = 0.0
                elif fam.kind == "histogram":
                    entry.update(kids[0][1].snapshot())
                else:
                    entry["value"] = kids[0][1].value
            out[name] = entry
        return out


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
    """Drop every family, collector and step report (tests)."""
    global _registry
    with _registry_lock:
        _registry = None


def metrics_snapshot() -> dict:
    """The registry as a plain dict (:meth:`MetricsRegistry.snapshot`)."""
    return registry().snapshot()


def render_prometheus() -> str:
    """The registry as Prometheus text."""
    return registry().render()


@dataclasses.dataclass(frozen=True)
class StepReport:
    """Host-side sample of ONE step-builder call (``training.py``'s
    sampler): its wall time (a steps-per-execution loop's call covers
    ``steps_per_exec`` optimizer steps), and the exchange a step puts on
    the wire per rank (``exchanged_bytes``) against the same gradients
    uncompressed -- a ZeRO-1 step priced by ``zero_report``, a wrap by
    ``wire_payload_bytes`` over its bucket plan."""

    step: int
    wall_time_s: float
    steps_per_exec: int = 1
    microbatches: int = 1
    zero_stage: int = 0
    codec: str = "none"
    exchanged_bytes: int = 0
    uncompressed_bytes: int = 0


def last_step_report() -> Optional[StepReport]:
    """The most recent :class:`StepReport` (None before the first step)."""
    return registry().last_step_report


def record_step_report(report: StepReport) -> None:
    """Store ``report`` and feed the step-level families."""
    reg = registry()
    if not reg.enabled:
        return
    reg.record_step_report(report)
    k = max(int(report.steps_per_exec), 1)
    reg.counter("horovod_step_total",
                "Optimizer steps completed").inc(k)
    reg.histogram("horovod_step_time_seconds",
                  "Per-step dispatch wall time (scan loops amortize "
                  "one dispatch over k steps)").observe(
                      report.wall_time_s / k)
    reg.counter("horovod_wire_bytes_total",
                "Cumulative per-chip gradient-exchange wire bytes"
                ).inc(report.exchanged_bytes * k)
    reg.gauge("horovod_wire_bytes_per_step",
              "Per-chip exchange wire bytes per optimizer step"
              ).set(report.exchanged_bytes)
    reg.gauge("horovod_uncompressed_bytes_per_step",
              "Equivalent uncompressed exchange bytes per optimizer step"
              ).set(report.uncompressed_bytes)
    if report.exchanged_bytes > 0 and report.uncompressed_bytes > 0:
        reg.gauge("horovod_compression_ratio",
                  "uncompressed / wire bytes of the gradient exchange"
                  ).set(report.uncompressed_bytes / report.exchanged_bytes)


def _collect_plan_cache() -> None:
    """The exchange-plan cache's totals (``controller.fusion.
    plan_cache_stats``) as the JAX package names them."""
    from ..controller.fusion import plan_cache_stats
    reg = registry()
    stats = plan_cache_stats()
    reg.counter("horovod_plan_cache_hits_total",
                "Fusion bucket-plan cache hits"
                ).set_cumulative(stats["hits"])
    reg.counter("horovod_plan_cache_misses_total",
                "Fusion bucket-plan cache misses"
                ).set_cumulative(stats["misses"])
    reg.counter("horovod_plan_cache_evictions_total",
                "Fusion bucket-plan cache evictions"
                ).set_cumulative(stats["evictions"])
    reg.gauge("horovod_plan_cache_size",
              "Fusion bucket-plan cache entries").set(stats["size"])


# (name, help) of the families install_default_metrics creates, by kind:
# the JAX package's, less those of the serving control plane, which the
# port does not have.
_DEFAULT_FAMILIES = {
    "counter": (
        ("horovod_step_total", "Optimizer steps completed"),
        ("horovod_wire_bytes_total",
         "Cumulative per-chip gradient-exchange wire bytes"),
        ("horovod_elastic_reset_total",
         "Elastic state resets (rank-change recoveries)"),
        ("horovod_elastic_host_updates_total",
         "Elastic host-set update notifications"),
        ("horovod_elastic_ranks_lost",
         "Ranks lost across elastic recoveries"),
        ("horovod_ef_residual_recovered_bytes",
         "Bytes of optimizer/EF carry state reconstructed "
         "checkpointlessly across elastic resizes"),
        ("horovod_ef_residual_zeroed_total",
         "EF residual buckets dropped (zeroed) during an elastic "
         "resize because shapes were irreconcilable"),
        ("horovod_chaos_faults_total", "Faults fired by the chaos injector"),
        ("horovod_kv_retries_total",
         "Control-plane requests retried after a transport failure"),
        ("horovod_autotune_samples_total",
         "Autotuner samples scored (one per sample window)"),
    ),
    "gauge": (
        ("horovod_wire_bytes_per_step",
         "Per-chip exchange wire bytes per optimizer step"),
        ("horovod_uncompressed_bytes_per_step",
         "Equivalent uncompressed exchange bytes per optimizer step"),
        ("horovod_compression_ratio",
         "uncompressed / wire bytes of the gradient exchange"),
        ("horovod_dispatch_gap_fraction",
         "Last DispatchGapMonitor window: host time NOT spent "
         "dispatching (0 = devices never starved)"),
        ("horovod_exchange_overlap_fraction",
         "Last OverlapMonitor window: fraction of the exchange "
         "hidden behind backward compute"),
        ("horovod_plan_buckets",
         "Bucket count of the most recently explained exchange plan"),
        ("horovod_elastic_steps_to_recover",
         "Steps rolled back to the last commit during the most "
         "recent elastic recovery"),
    ),
}


def _collect_deferred_fuse() -> None:
    from ..collectives.eager import deferred_fuse_stats
    reg = registry()
    stats = deferred_fuse_stats()
    reg.counter("horovod_deferred_flushes_total",
                "Deferred-async flush rounds"
                ).set_cumulative(stats["flushes"])
    reg.counter("horovod_deferred_fused_buckets_total",
                "Fusion-planner buckets dispatched by the deferred flush"
                ).set_cumulative(stats["fused_buckets"])
    reg.counter("horovod_deferred_fused_ops_total",
                "Deferred ops serviced through a fused bucket"
                ).set_cumulative(stats["fused_ops"])
    reg.counter("horovod_deferred_singleton_ops_total",
                "Deferred ops dispatched individually"
                ).set_cumulative(stats["singleton_ops"])


def _collect_eager() -> None:
    from ..collectives.eager import eager_op_stats
    reg = registry()
    stats = eager_op_stats()
    reg.counter("horovod_eager_ops_total",
                "Eager collective dispatches"
                ).set_cumulative(stats["ops"])
    reg.counter("horovod_eager_fences_total",
                "Eager coordination fences (join presence rounds)"
                ).set_cumulative(stats["fences"])


def install_default_metrics() -> None:
    """Create the default families and wire the pull collectors, so a
    scrape during a plain train loop shows the full family set before
    every source has fired.  Idempotent; called from ``init()`` and by
    the metrics server."""
    reg = registry()
    if not reg.enabled:
        return
    reg.histogram("horovod_step_time_seconds",
                  "Per-step dispatch wall time (scan loops amortize "
                  "one dispatch over k steps)")
    for kind, families in _DEFAULT_FAMILIES.items():
        for name, help in families:
            getattr(reg, kind)(name, help)
    reg.add_collector(_collect_plan_cache)
    reg.add_collector(_collect_deferred_fuse)
    reg.add_collector(_collect_eager)


def histogram_window(curr: dict, base: Optional[dict]) -> dict:
    """``curr`` minus an older cumulative ``Histogram.snapshot()``
    ``base``: the observations made between them (PromQL's
    ``increase()``)."""
    if not base:
        return curr
    base_buckets = base.get("buckets", {})
    return {
        "buckets": {le: int(c) - int(base_buckets.get(le, 0))
                    for le, c in curr["buckets"].items()},
        "sum": float(curr.get("sum", 0.0)) - float(base.get("sum", 0.0)),
        "count": int(curr.get("count", 0)) - int(base.get("count", 0)),
    }


def histogram_quantile(snap: dict, q: float) -> Optional[float]:
    """Prometheus ``histogram_quantile`` over a cumulative snapshot: the
    first bucket covering rank ``q * count``, interpolated linearly;
    the ``+Inf`` overflow clamps to the highest finite bound; None when
    empty."""
    total = int(snap.get("count", 0))
    if total <= 0:
        return None
    items = sorted(
        (float("inf") if le == "+Inf" else float(le), int(c))
        for le, c in snap.get("buckets", {}).items())
    rank = max(0.0, min(1.0, float(q))) * total
    prev_bound, prev_count = 0.0, 0
    for bound, count in items:
        if count >= rank and count > prev_count:
            if bound == float("inf"):
                return prev_bound
            frac = (rank - prev_count) / (count - prev_count)
            return prev_bound + (bound - prev_bound) * frac
        prev_count = count
        if bound != float("inf"):
            prev_bound = bound
    return None


def bench_block(snap: Optional[dict] = None) -> dict:
    """The compact snapshot block the JAX package's ``bench.py`` records
    (the same keys), from :func:`metrics_snapshot` unless given."""
    if snap is None:
        snap = metrics_snapshot()

    def val(name: str, default: float = 0.0) -> float:
        fam = snap.get(name) or {}
        return float(fam.get("value", default))

    hist = snap.get("horovod_step_time_seconds") or {}
    ratio = val("horovod_compression_ratio")
    return {
        "families": len(snap),
        "step_total": int(val("horovod_step_total")),
        "step_time_count": int(hist.get("count", 0)),
        "step_time_sum_s": round(float(hist.get("sum", 0.0)), 6),
        "wire_bytes_total": int(val("horovod_wire_bytes_total")),
        "wire_bytes_per_step": int(val("horovod_wire_bytes_per_step")),
        "uncompressed_bytes_per_step": int(
            val("horovod_uncompressed_bytes_per_step")),
        "compression_ratio": round(ratio, 4) if ratio > 0 else None,
        "plan_cache_hits": int(val("horovod_plan_cache_hits_total")),
        "plan_cache_misses": int(val("horovod_plan_cache_misses_total")),
    }


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
