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
