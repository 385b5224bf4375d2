"""Tensor fusion and the exchange-plan IR.

Counterpart of ``horovod_tpu/controller/fusion.py``.

Bucket planning: ``FusionSpec``, ``plan_key``, ``plan_buckets`` /
``_plan_buckets_uncached``, ``pack`` and ``unpack``: leaves are walked in
order (or last-to-first with ``reverse=True``, the bucket-ready order of
a backward pass), grouped by dtype, and packed greedily into flat
buckets of at most the fusion threshold (``HOROVOD_FUSION_THRESHOLD``,
default 64 MiB); a leaf larger than the threshold gets a bucket of its
own.  The plan depends only on shapes, dtypes and the threshold, and is
memoized in a bounded LRU.  For the same leaves it is the same layout as
the JAX planner's, bucket for bucket, and :func:`plan_key` is the same
key.

The exchange-plan IR: every exchange the package runs asks
:func:`plan_exchange` (``family``, spec) for its typed rows
(:class:`ExchangeLeg`), notes each row into the span registry
(``timeline.spans.note_leg``) and prices its counters from them.  The
families are ``flat``, ``hier``, ``chunked``, ``powersgd``, ``topk``,
``fp8``, ``ef``, ``zero``, ``microbatch``, ``guard`` (the SDC screen's
8-byte allreduce), ``serving`` (the tensor-parallel decode and verify
steps' row-parallel sums), ``moe`` (the MoE layer's all_to_all pair,
:func:`plan_moe_alltoall`) and ``kernel``; a new one
needs :func:`register_leg_kind` and :func:`register_plan_family` and no
consumer code.  :func:`schedule_legs`, :func:`overlap_phases` and
:func:`simulate_issue` order and price legs on a two-link model whose
rates the caller passes (``links``), by default the NVLink and NIC rates
of ``utils.scaling.H100_SXM``;
:func:`explain_plan` / :func:`render_plan` show a model's buckets.
The rows equal the JAX package's field by field but ``fence``, which
carries the port's eager fence policy (:func:`_fence_policy`: NCCL's
stream order or gloo's blocking wait, ``""`` before ``init()``).

The eager flush: :func:`plan_eager_flush` packs the compatible deferred
async allreduces of one flush (per-rank rows, the same greedy packing),
:func:`exchange_schedule_mode` (``HOROVOD_EXCHANGE_SCHEDULE``) orders
its units, and :func:`plan_executable` memoizes its packing and
unpacking closures by plan fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.state import global_state
from .cache import LRUCache

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class _LeafSpec:
    index: int            # position in the original leaf list
    shape: Tuple[int, ...]
    size: int


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """How leaves were packed into flat buffers: ``buffers`` is a tuple of
    ``(dtype, leaves)`` in bucket order."""
    buffers: Tuple[Tuple[torch.dtype, Tuple[_LeafSpec, ...]], ...]
    num_leaves: int

    def bucket_bytes(self) -> List[int]:
        return [sum(s.size for s in leaves) * dt.itemsize
                for dt, leaves in self.buffers]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's / JAX's name)."""
    return str(dtype).replace("torch.", "")


def fusion_threshold() -> int:
    """The threshold once ``init()`` has run (the autotuner's current
    sample while one is active, else ``HOROVOD_FUSION_THRESHOLD``), else
    64 MiB."""
    st = global_state()
    if st.config is None:
        return DEFAULT_FUSION_THRESHOLD
    if st.autotuner is not None:
        return st.autotuner.fusion_threshold()
    return st.config.fusion_threshold


def exchange_chunk_bytes() -> int:
    """The chunked exchange's chunk size in bytes (the autotuner's chunk
    axis while one is active, else ``HOROVOD_EXCHANGE_CHUNK_MB``; 0, the
    default, is off)."""
    st = global_state()
    if st.config is None:
        return 0
    if st.autotuner is not None:
        return st.autotuner.exchange_chunk_bytes()
    return st.config.exchange_chunk_bytes


def hier_requested(compression=None) -> bool:
    """Whether the two-level exchange is in effect for the gradient
    path: a per-leg codec always asks for it; while the autotuner's
    hierarchical axis is open (a two-level layout), its sample decides,
    as in the JAX ``allreduce_gradients``; otherwise
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` or a ``HOROVOD_HIERARCHICAL``
    topology spec does."""
    from ..collectives.compression import is_hier_legs
    from ..core.topology import parse_topology_spec
    if compression is not None and is_hier_legs(compression):
        return True
    st = global_state()
    cfg = st.config
    if cfg is None:
        return False
    tuner = st.autotuner
    if tuner is not None and tuner.tunes_hier:
        return tuner.hierarchical_explicit()
    if cfg.hierarchical_allreduce:
        return True
    if cfg.hierarchical:
        try:
            return parse_topology_spec(cfg.hierarchical)[0]
        except ValueError:
            pass
    return False


PLAN_CACHE_CAPACITY = 1024

_plan_cache: Optional[LRUCache] = None


def _get_plan_cache() -> LRUCache:
    global _plan_cache
    if _plan_cache is None:
        _plan_cache = LRUCache(capacity=PLAN_CACHE_CAPACITY)
    return _plan_cache


def plan_cache_stats() -> dict:
    """Hit/miss/eviction counters of the memoized planner."""
    c = _get_plan_cache()
    return {"hits": c.hits, "misses": c.misses, "evictions": c.evictions,
            "size": len(c)}


def clear_plan_cache() -> None:
    global _plan_cache
    _plan_cache = None


def plan_cache_enabled() -> bool:
    """Whether plan memoization is on (``HOROVOD_PLAN_CACHE``, default 1;
    ``0`` / ``false`` / ``off`` rebuild every plan)."""
    return os.environ.get("HOROVOD_PLAN_CACHE", "1").strip().lower() \
        not in ("0", "false", "off")


def _memo(key: Tuple, build):
    """``build()`` through the shared plan cache (or directly when
    ``HOROVOD_PLAN_CACHE`` is off)."""
    if not plan_cache_enabled():
        return build()
    return _get_plan_cache().get_or_build(key, build)


def plan_key(leaves: Sequence[Any], threshold_bytes: int,
             extra: Tuple = ()) -> Tuple:
    """Hashable memo key: per-leaf (shape, dtype name), the threshold and
    any caller context."""
    return (tuple((tuple(x.shape), dtype_name(x.dtype)) for x in leaves),
            int(threshold_bytes)) + tuple(extra)


def plan_buckets(leaves: Sequence[Any],
                 threshold_bytes: Optional[int] = None,
                 reverse: bool = False,
                 extra: Tuple = ()) -> FusionSpec:
    """Greedily pack leaves (anything with ``.shape`` and ``.dtype``) into
    per-dtype buckets of at most ``threshold_bytes``.

    ``reverse=True`` walks the leaves last-to-first: module parameters
    are registered in forward order, so the last leaves are the ones whose
    gradients the backward pass produces first, and their buckets come
    first.  Unpack is index-addressed, so leaf recovery does not depend on
    the order.
    """
    if threshold_bytes is None:
        threshold_bytes = fusion_threshold()
    key = plan_key(leaves, threshold_bytes,
                   extra=(("rev",) if reverse else ()) + tuple(extra))
    return _memo(key, lambda: _plan_buckets_uncached(leaves,
                                                     threshold_bytes,
                                                     reverse))


def _plan_buckets_uncached(leaves: Sequence[Any], threshold_bytes: int,
                           reverse: bool = False) -> FusionSpec:
    by_dtype: dict = {}
    indexed = list(enumerate(leaves))
    if reverse:
        indexed.reverse()
    for i, x in indexed:
        by_dtype.setdefault(x.dtype, []).append(
            _LeafSpec(i, tuple(x.shape), int(math.prod(x.shape))))
    buffers: List[Tuple[torch.dtype, Tuple[_LeafSpec, ...]]] = []
    for dt, specs in by_dtype.items():
        itemsize = dt.itemsize
        cur: List[_LeafSpec] = []
        cur_bytes = 0
        for s in specs:
            nbytes = s.size * itemsize
            if cur and cur_bytes + nbytes > threshold_bytes:
                buffers.append((dt, tuple(cur)))
                cur, cur_bytes = [], 0
            cur.append(s)
            cur_bytes += nbytes
        if cur:
            buffers.append((dt, tuple(cur)))
    return FusionSpec(buffers=tuple(buffers), num_leaves=len(leaves))


class _Row:
    """A flat per-rank row standing for a leaf (shape and dtype only)."""

    def __init__(self, size: int, dtype: torch.dtype):
        self.shape = (int(size),)
        self.dtype = dtype


def plan_eager_flush(leaves: Sequence[Any], k: int,
                     threshold_bytes: Optional[int] = None,
                     extra: Tuple = ()) -> FusionSpec:
    """Bucket plan for the fused deferred-async flush (the JAX
    ``plan_eager_flush``).

    The same greedy per-dtype packing as :func:`plan_buckets`, counted
    over each op's per-rank row -- ``k`` local ranks, so a row is
    ``numel // k``; the port runs one rank a process, ``k = 1``.  Each
    leaf spec's shape and size describe that flat row; ``index``
    addresses the caller's leaf list.  Memoized under an
    eager-flush-scoped key (``extra`` carries the caller's context, such
    as the process set's name)."""
    if threshold_bytes is None:
        threshold_bytes = fusion_threshold()
    k = max(int(k), 1)
    key = plan_key(leaves, threshold_bytes,
                   extra=("eager_flush", k) + tuple(extra))

    def build():
        rows = [_Row(math.prod(x.shape) // k, x.dtype) for x in leaves]
        return _plan_buckets_uncached(rows, threshold_bytes)

    return _memo(key, build)


def exchange_schedule_mode() -> str:
    """Issue-order policy of the eager flush's units
    (``HOROVOD_EXCHANGE_SCHEDULE``): ``bandwidth`` (the default) issues
    the fused units first, by wire bytes descending; ``program`` keeps
    issue order.  Anything else reads as ``bandwidth``."""
    mode = os.environ.get("HOROVOD_EXCHANGE_SCHEDULE", "bandwidth")
    mode = mode.strip().lower()
    return mode if mode in ("bandwidth", "program") else "bandwidth"


def _fence_policy() -> str:
    """The fence the eager plane applies to a collective issued now, in
    torch terms: ``stream-ordered(nccl)`` (the collective is ordered on
    the device stream; the host does not wait) or ``blocking(gloo)``
    (the host waits for each collective), ``""`` before ``init()``."""
    st = global_state()
    if not st.initialized or st.device is None:
        return ""
    if st.device.type == "cuda":
        return "stream-ordered(nccl)"
    return "blocking(gloo)"


def pack_bucket(leaves: Sequence[torch.Tensor], lspecs) -> torch.Tensor:
    """One bucket's leaves raveled and concatenated into a NEW flat buffer
    (never a view of a leaf, so an in-place collective cannot touch the
    caller's tensors)."""
    return torch.cat([leaves[s.index].reshape(-1) for s in lspecs])


def pack(leaves: Sequence[torch.Tensor],
         spec: FusionSpec) -> List[torch.Tensor]:
    """Ravel + concat leaves into flat buffers per the spec."""
    return [pack_bucket(leaves, lspecs) for _, lspecs in spec.buffers]


def unpack_bucket(buf: torch.Tensor, lspecs):
    """``(leaf index, view)`` pairs slicing one flat buffer back out."""
    out, off = [], 0
    for s in lspecs:
        out.append((s.index, buf[off:off + s.size].view(s.shape)))
        off += s.size
    return out


def unpack(buffers: Sequence[torch.Tensor],
           spec: FusionSpec) -> List[torch.Tensor]:
    """Slice flat buffers back into the original leaf order (views)."""
    leaves: List[Optional[torch.Tensor]] = [None] * spec.num_leaves
    for buf, (_, lspecs) in zip(buffers, spec.buffers):
        for i, view in unpack_bucket(buf, lspecs):
            leaves[i] = view
    assert all(x is not None for x in leaves)
    return leaves  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# The exchange-plan IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeLeg:
    """One typed row of the exchange-plan IR (the JAX ``ExchangeLeg``,
    every field): the span ``tag``, the ``axis`` (mesh axis names; the
    port's groups are named the same way), the ``collective`` the leg
    issues (``reduce_scatter``, ``psum``, ``all_gather``, ``fp8_gather``,
    ``powersgd``, ``topk``, ``ledger``, ``none``), its ``codec``, the
    ``wire_dtype`` name, the first operand's ``elements``, the wire
    ``nbytes`` the leg is priced at, its ``kind`` (a :data:`LEG_KINDS`
    key), its ``bucket`` / arena index, the ``leaves`` packed into it,
    the ``fence`` policy (:func:`_fence_policy`), the ``audit`` rows
    ``(collective, dtype, elements, label)`` the leg stands for, and the
    ``kernel`` family of a ``kind="kernel"`` row."""
    tag: str
    axis: str
    collective: str
    codec: str
    wire_dtype: str
    elements: int
    nbytes: int
    kind: str = ""
    bucket: int = 0
    leaves: int = 0
    fence: str = ""
    audit: Tuple[Tuple[str, str, int, str], ...] = ()
    kernel: str = ""


#: Leg kinds -> ``{"bandwidth": dcn|ici|local, "doc": ...}``: the
#: scheduler orders and prices a leg by its kind's bandwidth class.
LEG_KINDS: Dict[str, dict] = {}


def register_leg_kind(kind: str, *, bandwidth: str = "ici",
                      doc: str = "") -> None:
    """Register (or re-register) a leg kind with its bandwidth class."""
    if bandwidth not in ("dcn", "ici", "local"):
        raise ValueError(f"bandwidth class must be dcn|ici|local, "
                         f"got {bandwidth!r}")
    LEG_KINDS[kind] = {"bandwidth": bandwidth, "doc": doc}


for _kind, _bw, _doc in (
        ("flat_ar", "ici", "flat fused-bucket allreduce"),
        ("ici_rs", "ici", "two-level exchange: in-node reduce-scatter"),
        ("dcn_ar", "dcn", "two-level exchange: cross-node hop under the "
                          "DCN codec"),
        ("ici_ag", "ici", "two-level exchange: in-node allgather"),
        ("chunked", "ici", "chunked reduce-scatter + allgather sweep"),
        ("zero_rs", "ici", "ZeRO-1 arena reduce-scatter"),
        ("zero_ag", "ici", "ZeRO-1 arena shard allgather"),
        ("ef", "ici", "error-feedback exchange (ledger + factored legs)"),
        ("fp8", "ici", "quantized fp8 all-to-all + allgather allreduce"),
        ("mb_rs", "ici", "microbatch pipe: per-microbatch reduce-scatter"),
        ("mb_ag", "ici", "microbatch pipe: closing allgather"),
        ("guard", "ici", "SDC guard screen vector psum"),
        ("serving_psum", "ici", "serving TP decode row-parallel activation "
                                "psum"),
        ("serving_verify", "ici", "speculative-verify row-parallel "
                                  "activation psum"),
        ("moe_a2a", "ici", "MoE dispatch/combine all_to_all"),
        ("kernel", "local", "kernel contract: no wire traffic")):
    register_leg_kind(_kind, bandwidth=_bw, doc=_doc)


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """An ordered tuple of legs, memoized by :func:`plan_exchange`;
    ``fingerprint`` keys whole-plan memoization
    (:func:`plan_executable`)."""
    family: str
    legs: Tuple[ExchangeLeg, ...]

    @property
    def fingerprint(self) -> str:
        digest = hashlib.sha1(
            repr((self.family, self.legs)).encode()).hexdigest()[:16]
        return f"{self.family}:{len(self.legs)}:{digest}"


def ops_from_legs(legs: Sequence[ExchangeLeg],
                  tag: Optional[str] = None
                  ) -> List[Tuple[str, str, int, str]]:
    """The legs' audit rows as ``(collective, dtype, elements, label)``,
    each label prefixed with the leg's tag (or ``tag``; ``""`` for
    none)."""
    out: List[Tuple[str, str, int, str]] = []
    for leg in legs:
        prefix = leg.tag if tag is None else tag
        for kind, dt, elements, suffix in leg.audit:
            out.append((kind, dt, int(elements),
                        f"{prefix}/{suffix}" if prefix else suffix))
    return out


def _dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype or a numpy / JAX dtype name."""
    if isinstance(d, torch.dtype):
        return d
    name = str(getattr(d, "name", d)).replace("torch.", "")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {d!r}")
    return dt


def _wire_cast_dtype(comp, dtype) -> torch.dtype:
    """The dtype a cast codec puts on the wire for a ``dtype`` bucket."""
    dt = _dtype(dtype)
    wd = getattr(comp, "wire_dtype", None)
    if wd is not None and dt.is_floating_point and \
            dt.itemsize > wd.itemsize:
        return wd
    return dt


_XPLAN_BUILDERS: Dict[str, Any] = {}
_XPLAN_CANON: Dict[str, Any] = {}


def register_plan_family(family: str, builder, canon=None) -> None:
    """Register an exchange-plan family: ``builder(spec) ->
    [ExchangeLeg]`` from a canonical spec dict, and ``canon(spec) ->
    spec`` turning caller arguments into that hashable form (so two
    callers meaning the same exchange share one cache entry)."""
    _XPLAN_BUILDERS[family] = builder
    if canon is not None:
        _XPLAN_CANON[family] = canon


def plan_exchange(family: str, **spec) -> ExchangePlan:
    """The one planner of every exchange: canonicalizes ``spec`` and
    builds the family's legs at most once per distinct exchange (the
    plan cache, ``HOROVOD_PLAN_CACHE``)."""
    if family not in _XPLAN_BUILDERS:
        raise ValueError(
            f"unknown exchange-plan family {family!r} "
            f"(registered: {sorted(_XPLAN_BUILDERS)})")
    canon = _XPLAN_CANON.get(family)
    cspec = canon(spec) if canon is not None \
        else {k: spec[k] for k in sorted(spec)}
    fence = _fence_policy()
    key = ("xplan", family, fence) + tuple(sorted(cspec.items()))

    def build() -> ExchangePlan:
        legs = tuple(dataclasses.replace(leg, fence=fence)
                     for leg in _XPLAN_BUILDERS[family](cspec))
        return ExchangePlan(family=family, legs=legs)

    return _memo(key, build)


def plan_executable(plan: ExchangePlan, build, extra: Tuple = ()):
    """``build()`` memoized by ``plan``'s fingerprint and ``extra`` in the
    plan cache (the JAX ``plan_executable``): the eager flush keeps its
    packing and unpacking closures here, built once per distinct fused
    layout."""
    return _memo(("plan_exec", plan.fingerprint) + tuple(extra), build)


def _parse_comp(comp):
    from ..collectives.compression import Compression, parse_compression
    return parse_compression(comp) if comp is not None else Compression.none


def _canon_flat(spec: dict) -> dict:
    comp = _parse_comp(spec.get("compression"))
    dt = _wire_cast_dtype(comp, spec.get("dtype", "float32"))
    return {"size": int(spec["size"]), "wire_dtype": dtype_name(dt),
            "axis": str(spec.get("axis", ""))}


def _build_flat(spec: dict) -> List[ExchangeLeg]:
    dt, size = _dtype(spec["wire_dtype"]), spec["size"]
    return [ExchangeLeg(
        tag="flat_ar", axis=spec["axis"], collective="psum", codec="none",
        wire_dtype=dtype_name(dt), elements=size, nbytes=size * dt.itemsize,
        kind="flat_ar", audit=(("psum", dtype_name(dt), size, "allreduce"),))]


def _canon_hier(spec: dict) -> dict:
    from ..collectives.compression import Compression, is_hier_legs
    dt = _dtype(spec.get("dtype", "float32"))
    floating = dt.is_floating_point
    ici_c, dcn_c = spec.get("ici_codec"), spec.get("dcn_codec")
    if ici_c is None and dcn_c is None:
        comp = _parse_comp(spec.get("compression"))
        if is_hier_legs(comp):
            ici_c, dcn_c = comp.ici, comp.dcn
        elif getattr(comp, "wire_format", ""):
            raise ValueError(
                f"{comp.__name__} is an exchange-level codec; the "
                f"two-level path takes it per leg (ici:...,dcn:...)")
        else:
            # A cast codec compresses the bucket before the exchange:
            # every leg lives in the wire dtype.
            dt = _wire_cast_dtype(comp, dt)
            ici_c = dcn_c = Compression.none
    else:
        ici_c = _parse_comp(ici_c)
        dcn_c = _parse_comp(dcn_c)
    if not floating:
        ici_c = dcn_c = Compression.none
    return {"size": int(spec["size"]), "dtype": dtype_name(dt),
            "n_dcn": int(spec["n_dcn"]), "n_ici": int(spec["n_ici"]),
            "ici": ici_c, "dcn": dcn_c,
            "dcn_axis": str(spec.get("dcn_axis", "dcn")),
            "ici_axis": str(spec.get("ici_axis", "ici"))}


def _build_hier(spec: dict) -> List[ExchangeLeg]:
    from ..collectives.compression import (is_error_feedback, is_fp8,
                                           is_powersgd,
                                           powersgd_factor_widths,
                                           topk_count, wire_payload_bytes)
    from ..collectives.ops import microbatch_pad_quantum
    size, dt = spec["size"], _dtype(spec["dtype"])
    name = dtype_name(dt)
    floating = dt.is_floating_point
    n_dcn, n_ici = spec["n_dcn"], spec["n_ici"]
    ici_c, dcn_c = spec["ici"], spec["dcn"]
    dcn_axis, ici_axis = spec["dcn_axis"], spec["ici_axis"]
    if n_dcn <= 1:
        # One node: the op is the flat allreduce.
        return [ExchangeLeg(
            tag="flat_ar", axis=f"{dcn_axis},{ici_axis}",
            collective="psum", codec="none", wire_dtype=name,
            elements=size, nbytes=size * dt.itemsize, kind="flat_ar",
            audit=(("psum", name, size, "flat-ar"),))]
    padded = size + (-size) % microbatch_pad_quantum(n_ici)
    shard = padded // n_ici
    ici_dt = _wire_cast_dtype(ici_c, dt) if floating else dt
    ici_name = dtype_name(ici_dt)
    if floating and is_powersgd(dcn_c):
        dcn_coll, dcn_dt = "powersgd", "float32"
        pw, qw = powersgd_factor_widths(shard, dcn_c.rank)
        dcn_audit = (("psum", "float32", pw, "dcn-psum-P"),
                     ("psum", "float32", qw, "dcn-psum-Q"))
    elif floating and is_error_feedback(dcn_c):
        dcn_coll, dcn_dt = "topk", "float32"
        k = min(topk_count(shard, dcn_c.fraction), shard)
        dcn_audit = (("all_gather", "float32", k, "dcn-gather-values"),
                     ("all_gather", "int32", k, "dcn-gather-indices"))
    elif floating and is_fp8(dcn_c):
        dcn_coll, dcn_dt = "fp8_gather", "float8_e4m3fn"
        dcn_audit = (("all_gather", "float8_e4m3fn", shard, "dcn-gather-q"),
                     ("all_gather", "float32", 1, "dcn-gather-scale"))
    else:
        dcn_coll = "psum"
        dcn_dt = dtype_name(_wire_cast_dtype(dcn_c, dt))
        dcn_audit = (("psum", dcn_dt, shard, "dcn-ar"),)
    return [
        ExchangeLeg(tag="hier/ici_rs", axis=ici_axis,
                    collective="reduce_scatter", codec=ici_c.__name__,
                    wire_dtype=ici_name, elements=padded,
                    nbytes=padded * ici_dt.itemsize, kind="ici_rs",
                    audit=(("reduce_scatter", ici_name, padded, "ici-rs"),)),
        ExchangeLeg(tag="hier/dcn_ar", axis=dcn_axis, collective=dcn_coll,
                    codec=dcn_c.__name__, wire_dtype=dcn_dt, elements=shard,
                    nbytes=wire_payload_bytes(dcn_c, shard, dt.itemsize),
                    kind="dcn_ar", audit=dcn_audit),
        ExchangeLeg(tag="hier/ici_ag", axis=ici_axis,
                    collective="all_gather", codec=ici_c.__name__,
                    wire_dtype=ici_name, elements=shard,
                    nbytes=padded * ici_dt.itemsize, kind="ici_ag",
                    audit=(("all_gather", ici_name, shard, "ici-ag"),)),
    ]


def plan_hier_legs(size: int, dtype, *, n_dcn: int, n_ici: int,
                   compression=None, dcn_axis: str = "dcn",
                   ici_axis: str = "ici", ici_codec=None,
                   dcn_codec=None) -> List[ExchangeLeg]:
    """The rows of ``hierarchical_allreduce`` on one ``size``-element
    bucket of ``dtype`` over ``n_dcn`` nodes of ``n_ici`` ranks: a front
    end of ``plan_exchange("hier")`` (the JAX ``plan_hier_legs``).

    ``compression`` is ``None``, a cast codec (the bucket is cast before
    the exchange, so every leg rides its wire dtype) or a per-leg codec;
    or pass ``ici_codec``/``dcn_codec`` directly.  With one node the op
    is the flat allreduce: one ``flat_ar`` row.  Otherwise three rows:
    the ICI reduce-scatter and allgather each priced at the whole padded
    bucket at the ICI wire width, the DCN hop at its codec's
    ``wire_payload_bytes`` of the ``padded / n_ici`` shard."""
    return list(plan_exchange(
        "hier", size=int(size), dtype=dtype_name(_dtype(dtype)),
        n_dcn=int(n_dcn), n_ici=int(n_ici), compression=compression,
        ici_codec=ici_codec, dcn_codec=dcn_codec, dcn_axis=dcn_axis,
        ici_axis=ici_axis).legs)


def _canon_chunked(spec: dict) -> dict:
    comp = _parse_comp(spec.get("compression"))
    dt = _wire_cast_dtype(comp, spec.get("dtype", "float32"))
    return {"size": int(spec["size"]), "wire_dtype": dtype_name(dt),
            "chunk_bytes": int(spec["chunk_bytes"]),
            "world": int(spec["world"])}


def _build_chunked(spec: dict) -> List[ExchangeLeg]:
    dt = _dtype(spec["wire_dtype"])
    name = dtype_name(dt)
    size, world = spec["size"], spec["world"]
    chunk = max(1, spec["chunk_bytes"] // dt.itemsize)
    chunk += (-chunk) % world
    audit: List[Tuple[str, str, int, str]] = []
    for j, off in enumerate(range(0, size, chunk)):
        piece = min(chunk, size - off)
        padded = piece + (-piece) % world
        audit.append(("reduce_scatter", name, padded, f"chunk{j}-rs"))
        audit.append(("all_gather", name, padded // world, f"chunk{j}-ag"))
    return [ExchangeLeg(
        tag="chunked_rs_ag", axis="", collective="reduce_scatter",
        codec="none", wire_dtype=name, elements=size,
        nbytes=size * dt.itemsize, kind="chunked", audit=tuple(audit))]


def _canon_powersgd(spec: dict) -> dict:
    return {"size": int(spec["size"]), "rank": int(spec["rank"])}


def _build_powersgd(spec: dict) -> List[ExchangeLeg]:
    from ..collectives.compression import (powersgd_compressor,
                                           powersgd_factor_widths,
                                           powersgd_matrix_shape)
    size, rank = spec["size"], spec["rank"]
    m, c = powersgd_matrix_shape(size)
    r = max(1, min(rank, m, c))
    pw, qw = powersgd_factor_widths(size, rank)
    return [ExchangeLeg(
        tag="powersgd_allreduce", axis="", collective="powersgd",
        codec=powersgd_compressor(rank).__name__, wire_dtype="float32",
        elements=size, nbytes=2 * r * (m + c) * 4, kind="ef",
        audit=(("psum", "float32", pw, "psum-P"),
               ("psum", "float32", qw, "psum-Q")))]


def _canon_topk(spec: dict) -> dict:
    return {"size": int(spec["size"]), "fraction": float(spec["fraction"])}


def _build_topk(spec: dict) -> List[ExchangeLeg]:
    from ..collectives.compression import topk_compressor, topk_count
    size = spec["size"]
    k = min(topk_count(size, spec["fraction"]), size)
    return [ExchangeLeg(
        tag="topk_allreduce", axis="", collective="topk",
        codec=topk_compressor(spec["fraction"]).__name__,
        wire_dtype="float32", elements=size, nbytes=8 * k, kind="ef",
        audit=(("all_gather", "float32", k, "gather-values"),
               ("all_gather", "int32", k, "gather-indices")))]


def _canon_fp8(spec: dict) -> dict:
    return {"size": int(spec["size"]), "world": int(spec["world"])}


def _build_fp8(spec: dict) -> List[ExchangeLeg]:
    size, world = spec["size"], spec["world"]
    padded = size + (-size) % world
    return [ExchangeLeg(
        tag="fp8_allreduce", axis="", collective="fp8_gather", codec="fp8",
        wire_dtype="float8_e4m3fn", elements=padded, nbytes=2 * padded,
        kind="fp8", audit=())]


def _canon_ef(spec: dict) -> dict:
    return {"size": int(spec["size"]),
            "dtype": dtype_name(_dtype(spec["dtype"])),
            "comp": _parse_comp(spec["compression"])}


def _build_ef(spec: dict) -> List[ExchangeLeg]:
    from ..collectives.compression import is_powersgd, wire_payload_bytes
    comp, size, dt = spec["comp"], spec["size"], _dtype(spec["dtype"])
    ledger_nbytes = wire_payload_bytes(comp, size, dt.itemsize)
    if not dt.is_floating_point:
        # A non-floating bucket rides the flat allreduce.
        return [ExchangeLeg(
            tag="ef_exchange", axis="", collective="psum",
            codec=comp.__name__, wire_dtype=dtype_name(dt), elements=size,
            nbytes=ledger_nbytes, kind="ef",
            audit=(("psum", dtype_name(dt), size, "allreduce"),))]
    # The ledger row prices the factored payload once; the nested
    # powersgd / topk row is the collective's own.
    ledger = ExchangeLeg(
        tag="ef_exchange", axis="", collective="ledger", codec=comp.__name__,
        wire_dtype="float32", elements=size, nbytes=ledger_nbytes,
        kind="ef", audit=())
    if is_powersgd(comp):
        nested = _build_powersgd({"size": size, "rank": int(comp.rank)})
    else:
        nested = _build_topk({"size": size, "fraction": float(comp.fraction)})
    return [ledger] + nested


def _canon_zero(spec: dict) -> dict:
    ax_shape = spec.get("axes_shape")
    ax_shape = tuple(int(a) for a in ax_shape) \
        if ax_shape and len(ax_shape) == 2 else None
    axes = tuple(str(a) for a in (spec.get("axes") or ())) \
        if ax_shape is not None else ()
    return {"buffers": tuple((dtype_name(_dtype(d)), int(s), int(p), int(sh))
                             for d, s, p, sh in spec["buffers"]),
            "world": int(spec["world"]),
            "comp": _parse_comp(spec.get("compression")),
            "axes_shape": ax_shape, "axes": axes,
            "use_rs": bool(spec["use_rs"])}


def _build_zero(spec: dict) -> List[ExchangeLeg]:
    from ..collectives.compression import is_hier_legs
    comp, use_rs, two_level = spec["comp"], spec["use_rs"], \
        spec["axes_shape"]
    hier = is_hier_legs(comp) and two_level is not None
    axis = ",".join(spec["axes"])
    if two_level is not None:
        n_dcn, n_ici = two_level
        # The extents in the order the reduce-scatter runs over them: a
        # per-leg codec scatters within the node first.
        rs_order = (n_ici, n_dcn) if hier else (n_dcn, n_ici)
    rs_legs: List[ExchangeLeg] = []
    ag_legs: List[ExchangeLeg] = []
    for i, (dts, size, padded, shard) in enumerate(spec["buffers"]):
        item = _dtype(dts).itemsize
        rs_audit: Tuple = ()
        ag_audit: Tuple = ()
        if size >= 1:
            if use_rs and two_level is not None:
                rows, running = [], padded
                for j, n_a in enumerate(rs_order):
                    rows.append(("reduce_scatter", dts, running,
                                 f"reduce-scatter-ax{j}"))
                    running //= n_a
                rs_audit = tuple(rows)
            elif use_rs:
                rs_audit = (("reduce_scatter", dts, padded,
                             "reduce-scatter"),)
            else:
                rs_audit = (("psum", dts, padded, "allreduce"),)
            if hier:
                ag_audit = (
                    ("all_gather", dtype_name(_wire_cast_dtype(comp.dcn, dts)),
                     shard, "allgather-dcn"),
                    ("all_gather", dtype_name(_wire_cast_dtype(comp.ici, dts)),
                     shard * n_dcn, "allgather-ici"))
            elif two_level is not None:
                wire = dtype_name(_wire_cast_dtype(comp, dts))
                ag_audit = (("all_gather", wire, shard, "allgather-ici"),
                            ("all_gather", wire, shard * n_ici,
                             "allgather-dcn"))
            else:
                ag_audit = (("all_gather",
                             dtype_name(_wire_cast_dtype(comp, dts)), shard,
                             "allgather"),)
        rs_legs.append(ExchangeLeg(
            tag="zero_rs" if use_rs else "zero_allreduce", axis=axis,
            collective="reduce_scatter" if use_rs else "psum",
            codec="none", wire_dtype=dts, elements=padded,
            nbytes=padded * item, kind="zero_rs", bucket=i, audit=rs_audit))
        ag_legs.append(ExchangeLeg(
            tag="zero_ag", axis=axis, collective="all_gather",
            codec=comp.__name__, wire_dtype=dts, elements=shard,
            nbytes=shard * item, kind="zero_ag", bucket=i, audit=ag_audit))
    # Every arena's reduce-scatter row, then every allgather row: the
    # executor's order.
    return rs_legs + ag_legs


def _canon_microbatch(spec: dict) -> dict:
    return {"buffers": tuple((dtype_name(_dtype(d)), int(s))
                             for d, s in spec["buffers"]),
            "k": int(spec["k"]), "world": int(spec["world"]),
            "comp": _parse_comp(spec.get("compression"))}


def _build_microbatch(spec: dict) -> List[ExchangeLeg]:
    from ..collectives.ops import microbatch_pad_quantum
    comp, k, world = spec["comp"], spec["k"], spec["world"]
    q = microbatch_pad_quantum(world)
    rs_legs: List[ExchangeLeg] = []
    ag_legs: List[ExchangeLeg] = []
    for i, (dts, size) in enumerate(spec["buffers"]):
        padded = size + (-size) % q
        wire = _wire_cast_dtype(comp, dts)
        name = dtype_name(wire)
        rs_legs.append(ExchangeLeg(
            tag="microbatch_rs", axis="", collective="reduce_scatter",
            codec=comp.__name__, wire_dtype=name, elements=padded,
            nbytes=size * wire.itemsize, kind="mb_rs", bucket=i,
            audit=tuple(("reduce_scatter", name, padded, f"scatter-mb{j}")
                        for j in range(k))))
        ag_legs.append(ExchangeLeg(
            tag="microbatch_ag", axis="", collective="all_gather",
            codec=comp.__name__, wire_dtype=name, elements=padded // world,
            nbytes=(padded // world) * wire.itemsize, kind="mb_ag",
            bucket=i,
            audit=(("all_gather", name, padded // world, "allgather"),)))
    return rs_legs + ag_legs


def _canon_kernel(spec: dict) -> dict:
    return {"kernel": str(spec["kernel"]), "nbytes": int(spec["nbytes"])}


def _build_guard(spec: dict) -> List[ExchangeLeg]:
    # The 2-wide screen vector the SDC guard sums over the ranks a step.
    return [ExchangeLeg(
        tag="guard/screen", axis="", collective="psum", codec="none",
        wire_dtype="float32", elements=2, nbytes=8, kind="guard",
        audit=(("psum", "float32", 2, "guard/screen"),))]


def _canon_serving(spec: dict) -> dict:
    return {"kind": str(spec.get("kind", "serving_decode")),
            "layers": int(spec["layers"]), "slots": int(spec["slots"]),
            "width": int(spec.get("width", 1)),
            "d_model": int(spec["d_model"]),
            "dtype": dtype_name(_dtype(spec.get("dtype", "float32"))),
            "axis": str(spec.get("axis", "tp"))}


def _build_serving(spec: dict) -> List[ExchangeLeg]:
    # The rows of what the port's step runs: two row-parallel sums a
    # layer (``attn_wo``, ``mlp_down``) of ``slots x d_model``.  The
    # verify step is ``width`` calls of the decode step's shapes, so its
    # rows are ``width x 2`` a layer of the same size, column by column
    # (the JAX verify step sums ``slots x width x d_model`` twice a
    # layer: a deliberate difference, ROADMAP section 3).
    kind = spec["kind"]
    leg_kind = "serving_verify" if kind == "serving_verify" \
        else "serving_psum"
    dt = spec["dtype"]
    elements = spec["slots"] * spec["d_model"]
    nbytes = elements * _dtype(dt).itemsize
    cols = [""] if kind != "serving_verify" else \
        [f"col{j}/" for j in range(spec["width"])]
    legs = []
    for col in cols:
        for li in range(spec["layers"]):
            for part in ("attn_wo", "mlp_down"):
                legs.append(ExchangeLeg(
                    tag=f"{kind}/{col}layer{li}/{part}", axis=spec["axis"],
                    collective="psum", codec="none", wire_dtype=dt,
                    elements=elements, nbytes=nbytes, kind=leg_kind,
                    bucket=li,
                    audit=(("psum", dt, elements,
                            f"{col}layer{li}/{part}/allreduce"),)))
    return legs


def _canon_moe(spec: dict) -> dict:
    from ..parallel.moe import resolve_moe_compression
    return {"n_experts": int(spec["n_experts"]),
            "capacity": int(spec["capacity"]),
            "d_model": int(spec["d_model"]),
            "dtype": dtype_name(_dtype(spec.get("dtype", "float32"))),
            "codec": resolve_moe_compression(spec.get("compression")),
            "axis": str(spec.get("axis", "model"))}


def _build_moe(spec: dict) -> List[ExchangeLeg]:
    # The dispatch and combine all_to_all of one MoE layer: the (E, C, d)
    # slot tensor each way, at the codec's wire dtype.
    from ..parallel.moe import _MOE_CODECS
    wire = _MOE_CODECS[spec["codec"]]
    wire_dt = dtype_name(wire if wire is not None else _dtype(spec["dtype"]))
    elements = spec["n_experts"] * spec["capacity"] * spec["d_model"]
    nbytes = elements * _dtype(wire_dt).itemsize
    return [ExchangeLeg(
        tag=f"moe/a2a_{name}", axis=spec["axis"],
        collective="all_to_all", codec=spec["codec"],
        wire_dtype=wire_dt, elements=elements, nbytes=nbytes,
        kind="moe_a2a",
        audit=(("all_to_all", wire_dt, elements, f"a2a-{name}"),))
        for name in ("dispatch", "combine")]


def plan_moe_alltoall(n_experts: int, capacity: int, d_model: int, *,
                      dtype=torch.float32, compression=None,
                      axis: str = "model") -> List[ExchangeLeg]:
    """The rows of one MoE layer's all_to_all pair (the JAX function;
    ``plan_exchange("moe")``): the dispatch leg moves the f32 ``(E, C,
    d)`` slot tensor, the combine leg the same back, both at the wire
    dtype of ``compression`` (``parallel.moe.resolve_moe_compression``).
    ``nbytes`` is what ``moe_ffn`` notes a leg."""
    return list(plan_exchange(
        "moe", n_experts=int(n_experts), capacity=int(capacity),
        d_model=int(d_model), dtype=dtype, compression=compression,
        axis=axis).legs)


def _build_kernel(spec: dict) -> List[ExchangeLeg]:
    # A kernel contract: its HBM bytes, no wire collective.  The tag is
    # the JAX package's, so the rows compare equal.
    return [ExchangeLeg(
        tag=f"pallas/{spec['kernel']}", axis="", collective="none",
        codec="none", wire_dtype="", elements=0, nbytes=spec["nbytes"],
        kind="kernel", kernel=spec["kernel"], audit=())]


register_plan_family("flat", _build_flat, _canon_flat)
register_plan_family("hier", _build_hier, _canon_hier)
register_plan_family("chunked", _build_chunked, _canon_chunked)
register_plan_family("powersgd", _build_powersgd, _canon_powersgd)
register_plan_family("topk", _build_topk, _canon_topk)
register_plan_family("fp8", _build_fp8, _canon_fp8)
register_plan_family("ef", _build_ef, _canon_ef)
register_plan_family("zero", _build_zero, _canon_zero)
register_plan_family("microbatch", _build_microbatch, _canon_microbatch)
register_plan_family("serving", _build_serving, _canon_serving)
register_plan_family("guard", _build_guard)
register_plan_family("moe", _build_moe, _canon_moe)
register_plan_family("kernel", _build_kernel, _canon_kernel)


# ---------------------------------------------------------------------------
# Scheduling and pricing legs on a two-link model
# ---------------------------------------------------------------------------


_BW_RANK = {"dcn": 2, "ici": 1, "local": 0}


def leg_bandwidth(leg: ExchangeLeg) -> str:
    """The bandwidth class a leg occupies: its kind's, promoted to
    ``dcn`` when its axis list names the DCN axis."""
    cls = LEG_KINDS.get(leg.kind, {}).get("bandwidth", "ici")
    if cls == "local":
        return "local"
    axes = tuple(a.strip() for a in leg.axis.split(",") if a.strip())
    return "dcn" if cls == "dcn" or "dcn" in axes else cls


def _link_rate(links, bw: str) -> float:
    if links is None:
        from ..utils.scaling import H100_SXM
        links = H100_SXM.links()
    return float(links[bw])


def leg_cost_seconds(leg: ExchangeLeg, links=None) -> float:
    """A leg's modeled issue cost: its wire bytes over its bandwidth
    class's rate in ``links`` (a mapping with ``ici`` and ``dcn`` in
    bytes/s; ``None``: ``utils.scaling.H100_SXM``'s NVLink and NIC
    rates).  A ``local`` leg costs nothing."""
    bw = leg_bandwidth(leg)
    if bw == "local":
        return 0.0
    return float(leg.nbytes) / max(_link_rate(links, bw), 1.0)


def schedule_legs(legs: Sequence[ExchangeLeg], mode: str = "program",
                  links=None) -> List[ExchangeLeg]:
    """Order legs for issue.  ``program`` mode keeps plan order.
    ``bandwidth`` mode (``links`` as :func:`leg_cost_seconds` takes them)
    is greedy list scheduling on the two-link model of
    :func:`simulate_issue`: legs sharing a ``bucket``
    stay a chain in plan order, and across chains the head that can
    start earliest goes first -- ties to the slower class (DCN, ICI,
    local), then the costlier leg, then plan order."""
    ordered = list(legs)
    if mode == "program":
        return ordered
    if mode != "bandwidth":
        raise ValueError(
            f"schedule mode must be 'program' or 'bandwidth', got {mode!r}")
    if len(ordered) <= 1:
        return ordered
    chains: Dict[int, List[int]] = {}
    for idx, leg in enumerate(ordered):
        chains.setdefault(int(leg.bucket), []).append(idx)
    heads = {b: 0 for b in chains}
    free = {"dcn": 0.0, "ici": 0.0}
    done: Dict[int, float] = {}
    out: List[ExchangeLeg] = []
    while len(out) < len(ordered):
        best = None
        for b in chains:
            if heads[b] >= len(chains[b]):
                continue
            idx = chains[b][heads[b]]
            leg = ordered[idx]
            bw = leg_bandwidth(leg)
            start = max(free.get(bw, 0.0), done.get(b, 0.0))
            score = (start, -_BW_RANK.get(bw, 1),
                     -leg_cost_seconds(leg, links), idx)
            if best is None or score < best[0]:
                best = (score, b, idx)
        _, b, idx = best
        heads[b] += 1
        leg = ordered[idx]
        bw = leg_bandwidth(leg)
        end = max(free.get(bw, 0.0), done.get(b, 0.0)) + \
            leg_cost_seconds(leg, links)
        if bw in free:
            free[bw] = end
        done[b] = end
        out.append(leg)
    return out


def overlap_phases(legs: Sequence[ExchangeLeg], k: int,
                   mode: str = "program",
                   links=None) -> List[List[ExchangeLeg]]:
    """The scheduled legs dealt round-robin into ``k`` issue phases, one
    a backward microbatch."""
    k = max(int(k), 1)
    phases: List[List[ExchangeLeg]] = [[] for _ in range(k)]
    for i, leg in enumerate(schedule_legs(legs, mode=mode, links=links)):
        phases[i % k].append(leg)
    return phases


def simulate_issue(legs: Sequence[ExchangeLeg], links=None) -> dict:
    """Price an issue order on the two-link model: a leg starts once its
    link is free and its bucket's previous leg has finished.  Returns the
    makespan, each link's busy seconds and the dispatch-gap fraction
    (the share of the makespan the busiest link sits idle).  A host-side
    model: nothing goes on the wire."""
    free = {"dcn": 0.0, "ici": 0.0}
    busy = {"dcn": 0.0, "ici": 0.0}
    done: Dict[int, float] = {}
    makespan = 0.0
    for leg in legs:
        bw = leg_bandwidth(leg)
        cost = leg_cost_seconds(leg, links)
        end = max(free.get(bw, 0.0), done.get(int(leg.bucket), 0.0)) + cost
        if bw in free:
            free[bw] = end
            busy[bw] += cost
        done[int(leg.bucket)] = end
        makespan = max(makespan, end)
    crit = max(busy.values())
    gap = max(0.0, 1.0 - crit / makespan) if makespan > 0 else 0.0
    return {"makespan_s": makespan, "busy_s": dict(busy),
            "dispatch_gap_fraction": gap}


# ---------------------------------------------------------------------------
# Plan introspection
# ---------------------------------------------------------------------------


def explain_plan(leaves: Sequence[Any],
                 threshold_bytes: Optional[int] = None, compression=None,
                 reverse: bool = False,
                 register: bool = True,
                 moe: Optional[dict] = None) -> List[dict]:
    """The planner's buckets for ``leaves`` (anything with ``.shape`` and
    ``.dtype``, in the JAX package's leaf order to get its rows) as one
    dict a bucket: ``bucket``, ``dtype``, ``leaves``, ``elements``, raw
    ``bytes``, ``wire_bytes`` under ``compression``, the ``codec``, the
    ``fence`` (``""``), the ``fuse_key`` and -- on the two-level layout
    -- the bucket's ``legs`` (:func:`plan_hier_legs`, as dicts).  The
    buckets come from the same :func:`plan_buckets` call the exchange
    makes (an error-feedback codec folds ``("ef", codec)`` into its key,
    as ``ef_bucket_plan`` does).  ``register`` publishes them as the
    ``horovod_plan_*`` gauges.  ``moe`` (``n_experts``, ``capacity``,
    ``d_model``; optional ``layers``, ``dtype``, ``compression``,
    ``axis``) prices a model's MoE all_to_all traffic beside the
    buckets: one more row, its legs :func:`plan_moe_alltoall`'s pair a
    layer."""
    from ..collectives.compression import (is_error_feedback,
                                           parse_compression,
                                           wire_payload_bytes)
    from ..core.topology import hier_mesh_shape
    leaves = list(leaves)
    comp = parse_compression(compression) if compression is not None \
        else None
    if threshold_bytes is None:
        threshold_bytes = fusion_threshold()
    plan_extra: Tuple = ()
    if comp is not None and is_error_feedback(comp):
        plan_extra = ("ef", comp.__name__)
    spec = plan_buckets(leaves, threshold_bytes, reverse=reverse,
                        extra=plan_extra)
    codec = comp.__name__ if comp is not None else "none"
    hier_shape = hier_mesh_shape() if hier_requested(comp) else None
    rows = []
    for i, (dt, lspecs) in enumerate(spec.buffers):
        dtype = dtype_name(dt)
        size = sum(s.size for s in lspecs)
        raw = size * dt.itemsize
        legs = None
        if hier_shape is not None:
            try:
                legs = plan_hier_legs(size, dt, n_dcn=hier_shape[0],
                                      n_ici=hier_shape[1], compression=comp)
            except ValueError:
                legs = None      # a codec the two-level path does not take
        if legs is not None:
            wire = sum(leg.nbytes for leg in legs)
        elif comp is not None:
            wire = wire_payload_bytes(comp, size, dt.itemsize)
        else:
            wire = raw
        rows.append({
            "bucket": i, "dtype": dtype, "leaves": len(lspecs),
            "elements": int(size), "bytes": int(raw),
            "wire_bytes": int(wire), "codec": codec, "fence": "",
            "fuse_key": "|".join([dtype, f"thr={int(threshold_bytes)}",
                                  codec] + (["rev"] if reverse else [])),
            "legs": [dataclasses.asdict(leg) for leg in legs]
            if legs is not None else None,
        })
    if moe is not None:
        layers = int(moe.get("layers", 1))
        mdt = _dtype(moe.get("dtype", "float32"))
        pair = plan_moe_alltoall(
            moe["n_experts"], moe["capacity"], moe["d_model"], dtype=mdt,
            compression=moe.get("compression"),
            axis=moe.get("axis", "model"))
        moe_legs = pair * layers
        elements = sum(leg.elements for leg in moe_legs)
        rows.append({
            "bucket": len(rows), "dtype": pair[0].wire_dtype,
            "leaves": 0, "elements": int(elements),
            "bytes": int(elements * mdt.itemsize),
            "wire_bytes": int(sum(leg.nbytes for leg in moe_legs)),
            "codec": pair[0].codec, "fence": "",
            "fuse_key": "|".join(
                ["moe", f"E={int(moe['n_experts'])}",
                 f"C={int(moe['capacity'])}", f"d={int(moe['d_model'])}",
                 f"L={layers}", pair[0].codec]),
            "legs": [dataclasses.asdict(leg) for leg in moe_legs],
        })
    if register:
        register_plan_gauges(rows)
    return rows


def register_plan_gauges(rows: List[dict]) -> None:
    """Publish :func:`explain_plan` rows as the ``horovod_plan_*``
    gauges of the metrics registry."""
    from ..timeline import metrics as _metrics
    reg = _metrics.registry()
    reg.gauge("horovod_plan_buckets",
              "Bucket count of the most recently explained exchange plan"
              ).set(len(rows))
    by_bytes = reg.gauge("horovod_plan_bucket_bytes",
                         "Raw bytes per bucket of the explained plan",
                         labelnames=("bucket", "dtype"))
    by_wire = reg.gauge("horovod_plan_bucket_wire_bytes",
                        "Wire bytes per bucket of the explained plan",
                        labelnames=("bucket", "dtype"))
    for r in rows:
        labels = {"bucket": str(r["bucket"]), "dtype": r["dtype"]}
        by_bytes.labels(**labels).set(r["bytes"])
        by_wire.labels(**labels).set(r["wire_bytes"])


def render_plan(rows: List[dict]) -> str:
    """A fixed-width table of :func:`explain_plan` rows."""
    if not rows:
        return "(empty plan: no leaves)"
    cols = ("bucket", "dtype", "leaves", "elements", "bytes",
            "wire_bytes", "codec", "fence", "fuse_key")
    table = [cols] + [tuple(str(r[c]) for c in cols) for r in rows]
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    for r in rows:
        for leg in r.get("legs") or ():
            lines.append(
                f"    bucket {r['bucket']} leg {leg['tag']}: "
                f"{leg['collective']}@{leg['axis']} codec={leg['codec']} "
                f"{leg['wire_dtype']} {leg['elements']}el {leg['nbytes']}B")
    total_raw = sum(r["bytes"] for r in rows)
    total_wire = sum(r["wire_bytes"] for r in rows)
    ratio = f" (ratio {total_raw / total_wire:.1f}x)" \
        if 0 < total_wire < total_raw else ""
    lines.append(f"total: {len(rows)} bucket(s), {total_raw} bytes raw, "
                 f"{total_wire} bytes wire{ratio}")
    return "\n".join(lines)
