"""Tensor fusion: greedy per-dtype bucket planning, pack and unpack.

Counterpart of ``horovod_tpu/controller/fusion.py``'s ``FusionSpec``,
``plan_key``, ``plan_buckets`` / ``_plan_buckets_uncached``, ``pack`` and
``unpack``: leaves are walked in order (or last-to-first with
``reverse=True``, the bucket-ready order of a backward pass), grouped by
dtype, and packed greedily into flat buckets of at most the fusion
threshold (``HOROVOD_FUSION_THRESHOLD``, default 64 MiB); a leaf larger
than the threshold gets a bucket of its own.  The plan depends only on
shapes, dtypes and the threshold, and is memoized in a bounded LRU.  For
the same leaves it is the same layout as the JAX planner's, bucket for
bucket, and :func:`plan_key` is the same key.

The exchange variants' knobs and accounting live here too, as in the
JAX module: :func:`exchange_chunk_bytes` (``HOROVOD_EXCHANGE_CHUNK_MB``),
:func:`hier_requested` (whether the two-level exchange is in effect)
and :func:`plan_hier_legs`, the closed-form leg rows of one bucket of
``hierarchical_allreduce`` (the JAX ``plan_exchange("hier")`` rows;
the ``ExchangeLeg`` / ``plan_exchange`` plan IR itself is not ported).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

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
    """The configured threshold once ``init()`` has run, else 64 MiB."""
    cfg = global_state().config
    return cfg.fusion_threshold if cfg is not None else \
        DEFAULT_FUSION_THRESHOLD


def exchange_chunk_bytes() -> int:
    """The chunked exchange's chunk size in bytes
    (``HOROVOD_EXCHANGE_CHUNK_MB``; 0, the default, is off)."""
    cfg = global_state().config
    return cfg.exchange_chunk_bytes if cfg is not None else 0


def hier_requested(compression=None) -> bool:
    """Whether the two-level exchange is in effect for the gradient
    path: a per-leg codec always asks for it; otherwise
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` or a ``HOROVOD_HIERARCHICAL``
    topology spec does."""
    from ..collectives.compression import is_hier_legs
    from ..core.topology import parse_topology_spec
    if compression is not None and is_hier_legs(compression):
        return True
    cfg = global_state().config
    if cfg is None:
        return False
    if cfg.hierarchical_allreduce:
        return True
    if cfg.hierarchical:
        try:
            return parse_topology_spec(cfg.hierarchical)[0]
        except ValueError:
            pass
    return False


@dataclasses.dataclass(frozen=True)
class HierLeg:
    """One leg of the two-level exchange of one bucket: the JAX
    ``ExchangeLeg``'s ``tag``, ``collective``, ``codec``, ``wire_dtype``,
    ``elements`` and ``nbytes`` (the wire bytes the leg is priced at)."""
    tag: str
    collective: str
    codec: str
    wire_dtype: str
    elements: int
    nbytes: int


def plan_hier_legs(size: int, dtype, *, n_dcn: int, n_ici: int,
                   compression=None, ici_codec=None,
                   dcn_codec=None) -> List[HierLeg]:
    """Closed-form leg rows of ``hierarchical_allreduce`` on one
    ``size``-element bucket of ``dtype`` over ``n_dcn`` nodes of
    ``n_ici`` ranks (``horovod_tpu/controller/fusion.py::
    plan_hier_legs``).

    ``compression`` is ``None``, a cast codec (the bucket is cast before
    the exchange, so every leg rides its wire dtype) or a per-leg codec;
    or pass ``ici_codec``/``dcn_codec`` directly.  With one node the op
    is the flat allreduce: one ``flat_ar`` row.  Otherwise three rows:
    the ICI reduce-scatter and allgather each priced at the whole padded
    bucket at the ICI wire width, the DCN hop at its codec's
    ``wire_payload_bytes`` of the ``padded / n_ici`` shard.
    """
    from ..collectives.compression import (Compression, is_error_feedback,
                                           is_fp8, is_hier_legs,
                                           is_powersgd, parse_compression,
                                           wire_payload_bytes)
    from ..collectives.ops import microbatch_pad_quantum
    dt = dtype if isinstance(dtype, torch.dtype) else \
        getattr(torch, str(dtype))
    floating = dt.is_floating_point
    if ici_codec is None and dcn_codec is None:
        comp = parse_compression(compression)
        if is_hier_legs(comp):
            ici_codec, dcn_codec = comp.ici, comp.dcn
        elif getattr(comp, "wire_format", ""):
            raise ValueError(
                f"{comp.__name__} is an exchange-level codec; the "
                f"two-level path takes it per leg (ici:...,dcn:...)")
        else:
            wd = getattr(comp, "wire_dtype", None)
            if floating and wd is not None and wd.itemsize < dt.itemsize:
                dt = wd
            ici_codec = dcn_codec = Compression.none
    ici_codec = ici_codec or Compression.none
    dcn_codec = dcn_codec or Compression.none
    if not floating:
        ici_codec = dcn_codec = Compression.none
    size, n_dcn, n_ici = int(size), int(n_dcn), int(n_ici)
    if n_dcn <= 1:
        return [HierLeg("flat_ar", "psum", "none", dtype_name(dt), size,
                        size * dt.itemsize)]
    quantum = microbatch_pad_quantum(n_ici)
    padded = size + (-size) % quantum
    shard = padded // n_ici
    ici_dt = dt
    wd = getattr(ici_codec, "wire_dtype", None)
    if floating and wd is not None and wd.itemsize < dt.itemsize:
        ici_dt = wd
    if floating and is_powersgd(dcn_codec):
        dcn_coll, dcn_dt = "powersgd", "float32"
    elif floating and is_error_feedback(dcn_codec):
        dcn_coll, dcn_dt = "topk", "float32"
    elif floating and is_fp8(dcn_codec):
        dcn_coll, dcn_dt = "fp8_gather", "float8_e4m3fn"
    else:
        dcn_coll = "psum"
        dwd = getattr(dcn_codec, "wire_dtype", None)
        dcn_dt = dtype_name(dwd if floating and dwd is not None
                            and dwd.itemsize < dt.itemsize else dt)
    return [
        HierLeg("hier/ici_rs", "reduce_scatter", ici_codec.__name__,
                dtype_name(ici_dt), padded, padded * ici_dt.itemsize),
        HierLeg("hier/dcn_ar", dcn_coll, dcn_codec.__name__, dcn_dt, shard,
                wire_payload_bytes(dcn_codec, shard, dt.itemsize)),
        HierLeg("hier/ici_ag", "all_gather", ici_codec.__name__,
                dtype_name(ici_dt), shard, padded * ici_dt.itemsize),
    ]


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
    return _get_plan_cache().get_or_build(
        key, lambda: _plan_buckets_uncached(leaves, threshold_bytes,
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
