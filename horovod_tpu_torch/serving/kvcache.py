"""Paged KV cache for the serving data plane.

Counterpart of ``horovod_tpu/serving/kvcache.py`` (``CacheConfig``,
``PagedKVCache``).  The physical layout is a fixed page pool per
layer::

    k, v: [num_layers, num_pages + 1, page_size, num_kv_heads, head_dim]

whose trailing page is scratch: the decode step writes every slot's K/V
(fixed batch shape), and idle slots write there instead of clobbering a
live page.  The logical view -- which pages belong to which slot, how
many tokens are live -- is host metadata: an int32 ``page_table[slots,
pages_per_slot]`` and ``lengths[slots]``, copied to the device for each
step.  Correctness never depends on page contents being zeroed: every
read masks positions ``>= lengths``, so a recycled page's stale keys are
unreachable.

Pages come from a free list as a slot grows and go back wholesale when
it is freed; a page carries a refcount, as in the reference, so
``free_slot`` is a decrement.  Without the prefix cache no page has a
second holder, so the reference's copy-on-write divergence
(``reserve(writable_from=...)``) has nothing to do and is not ported.
The pools are updated in place (the reference's functional
``.at[].set`` becomes ``index_put_``), which keeps one copy of the cache
on the device.

Not in this package yet: fp8 cold-page compression and the prefix cache
(``PrefixCache``); ``CacheConfig(compress=True)`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..core.device import resolve_device


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/a torch dtype -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Static shape of the pool."""

    num_layers: int
    num_kv_heads: int
    head_dim: int
    slots: int
    page_size: int
    max_len: int
    dtype: str = "float32"
    compress: bool = False

    def __post_init__(self):
        if self.max_len % self.page_size:
            raise ValueError(
                f"max_len {self.max_len} not a multiple of page_size "
                f"{self.page_size}")
        if self.compress:
            raise NotImplementedError(
                "fp8 KV-cache compression is not ported yet (ROADMAP: "
                "serving features left out of slice 1 -- fp8 KV)")

    @property
    def pages_per_slot(self) -> int:
        return self.max_len // self.page_size

    @property
    def num_pages(self) -> int:
        return self.slots * self.pages_per_slot

    @property
    def scratch_page(self) -> int:
        """The write sink for idle slots, past the allocatable pool."""
        return self.num_pages

    def layout(self) -> dict:
        return {
            "kv_shape": [self.num_layers, self.num_pages + 1,
                         self.page_size, self.num_kv_heads, self.head_dim],
            "page_table_shape": [self.slots, self.pages_per_slot],
            "page_size": self.page_size,
            "pages_per_slot": self.pages_per_slot,
            "num_pages": self.num_pages,
            "scratch_page": self.scratch_page,
            "dtype": str(torch_dtype(self.dtype)).replace("torch.", ""),
        }


class PagedKVCache:
    """Device page pool + host page table / free list for one model."""

    def __init__(self, config: CacheConfig, device=None):
        self.config = c = config
        self.device = resolve_device(device)
        shape = (c.num_layers, c.num_pages + 1, c.page_size,
                 c.num_kv_heads, c.head_dim)
        dt = torch_dtype(c.dtype)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        # Host-side logical view.  Unallocated table entries point at
        # page 0 -- harmless, reads beyond ``lengths`` are masked.
        self.page_table = np.zeros((c.slots, c.pages_per_slot), np.int32)
        self.lengths = np.zeros((c.slots,), np.int32)
        self._allocated = np.zeros((c.slots,), np.int32)
        self._free = list(range(c.num_pages - 1, -1, -1))  # pop() -> 0, 1..
        self._refcount = np.zeros((c.num_pages,), np.int32)

    # -- page accounting ---------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return int(self._allocated.sum())

    @property
    def live_pages(self) -> int:
        return int((self._refcount > 0).sum())

    def refcounts_balanced(self) -> bool:
        """Every page is on the free list (refcount 0) or held."""
        ok = len(self._free) + self.live_pages == self.config.num_pages
        return bool(ok and not any(self._refcount[p] for p in self._free))

    def can_admit(self, length: int) -> bool:
        """Whether a sequence of ``length`` tokens fits the pool now."""
        need = -(-max(int(length), 1) // self.config.page_size)
        return need <= len(self._free)

    def reserve(self, slot: int, length: int) -> None:
        """Ensure ``slot`` has pages for ``length`` tokens."""
        c = self.config
        if length > c.max_len:
            raise ValueError(f"length {length} exceeds max_len {c.max_len}")
        need = -(-int(length) // c.page_size)
        have = int(self._allocated[slot])
        if need > have:
            if need - have > len(self._free):
                raise RuntimeError(
                    f"KV page pool exhausted: slot {slot} needs "
                    f"{need - have} page(s), {len(self._free)} free")
            for i in range(have, need):
                pid = self._free.pop()
                self._refcount[pid] = 1
                self.page_table[slot, i] = pid
            self._allocated[slot] = need

    def free_slot(self, slot: int) -> None:
        """Refcount-decrement the slot's pages and mark it idle.  Page
        contents stay in place: masking, not zeroing, isolates them."""
        for i in range(int(self._allocated[slot]) - 1, -1, -1):
            pid = int(self.page_table[slot, i])
            self._refcount[pid] -= 1
            if self._refcount[pid] == 0:
                self._free.append(pid)
        self._allocated[slot] = 0
        self.lengths[slot] = 0

    def release_all(self) -> int:
        """Free every slot; returns how many pages that recovered."""
        freed = 0
        for slot in range(self.config.slots):
            n = int(self._allocated[slot])
            if n:
                freed += n
                self.free_slot(slot)
        return freed

    # -- device writes -----------------------------------------------------
    def write_prefill(self, slot: int, k_layers, v_layers,
                      start: int = 0) -> None:
        """Scatter a prefilled prompt's K/V into the slot's pages.

        ``k_layers``/``v_layers``: ``[num_layers, t, num_kv_heads,
        head_dim]`` post-RoPE.  Reserves pages for ``start + t`` tokens
        and sets ``lengths[slot] = start + t``."""
        c = self.config
        t = int(k_layers.shape[1])
        self.reserve(slot, start + t)
        pos = np.arange(start, start + t)
        pages = torch.tensor(self.page_table[slot][pos // c.page_size],
                             dtype=torch.long, device=self.device)
        offs = torch.tensor(pos % c.page_size, dtype=torch.long,
                            device=self.device)
        # One scatter per pool: [L, t, H, D] lands at (page, off) pairs.
        self.k[:, pages, offs] = k_layers.to(self.k.dtype)
        self.v[:, pages, offs] = v_layers.to(self.v.dtype)
        self.lengths[slot] = start + t

    def grow(self, slot: int) -> None:
        """Account one decoded token (the decode step already wrote its
        K/V); reserves the next page at a boundary crossing."""
        new_len = int(self.lengths[slot]) + 1
        self.reserve(slot, new_len)
        self.lengths[slot] = new_len

    # -- step operands -----------------------------------------------------
    # torch.tensor always copies.  torch.from_numpy would ALIAS the
    # mutable host arrays (the trap the reference documents for
    # jnp.asarray on CPU): host updates after the step is issued would
    # race the step that reads them.
    def table_device(self) -> torch.Tensor:
        return torch.tensor(self.page_table, dtype=torch.int32,
                            device=self.device)

    def lengths_device(self) -> torch.Tensor:
        return torch.tensor(self.lengths, dtype=torch.int32,
                            device=self.device)

    def layout(self) -> dict:
        return self.config.layout()
