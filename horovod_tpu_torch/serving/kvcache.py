"""Paged KV cache for the serving data plane.

Counterpart of ``horovod_tpu/serving/kvcache.py`` (``CacheConfig``,
``PagedKVCache``, ``PrefixCache``).  The physical layout is a fixed page
pool per layer::

    k, v: [num_layers, num_pages + 1, page_size, num_kv_heads, head_dim]

whose trailing page is scratch: the decode step writes every slot's K/V
(fixed batch shape), and idle slots write there instead of clobbering a
live page.  The logical view -- which pages belong to which slot, how
many tokens are live -- is host metadata: an int32 ``page_table[slots,
pages_per_slot]`` and ``lengths[slots]``, copied to the device for each
step.  Correctness never depends on page contents being zeroed: every
read masks positions ``>= lengths``, so a recycled page's stale keys are
unreachable.

Pages are refcounted.  A page popped off the free list starts at
refcount 1 (its slot); :meth:`PagedKVCache.attach_pages` maps a resident
page into another slot with refcount + 1 (a prefix-cache hit, or an
imported page), and :meth:`PagedKVCache.free_slot` is a decrement, so a
page returns to the free list when its last holder lets go.  Shared
pages are never written: every write path (``reserve(writable_from=)``,
``write_prefill``, ``grow``) first clones a still-shared page covering
the write range into a private one (``index_copy_`` on the pools), so a
divergent continuation never changes the bytes other holders read.

fp8 cold pages (``CacheConfig(compress=True)``): a page ``hot_pages``
full pages behind a slot's write head is only read from then on.
:meth:`PagedKVCache.compress_cold` moves it into a parallel e4m3 pool
(``kq``/``vq``, one f32 max-abs scale per (layer, page, offset) row in
``kscale``/``vscale``) through
:func:`~horovod_tpu_torch.collectives.compression.fp8_quantize`, and its
f32 page goes back to the free list; ``comp_mask`` marks the slot's
table entries that now read the e4m3 pool through ``cpage_table``.
Admission prices cold pages at their compressed cost: ``can_admit`` and
``reserve`` count cold pages as reclaimable and compress on demand.

:class:`PrefixCache` is a radix tree over page-sized token-id chunks of
prompts, mapping shared prefixes to resident pages, with session pins,
TTL expiry, the e4m3 pool as its demotion tier and LRU eviction under
page pressure (installed as the cache's ``reclaim_cb``).

The pools are updated in place (the reference's functional
``.at[].set`` becomes indexed assignment; the e4m3 pools are written
through a ``uint8`` view), which keeps one copy of the cache on the
device.

Tensor parallelism (:func:`cache_sharding`): a tp mesh splits the pool
on its kv-head dim, as the reference's ``NamedSharding`` does, so a
rank's pool pairs with its ``wk``/``wv`` shards.  Here each rank holds
only its own ``num_kv_heads / tp`` heads (a :class:`CacheShard`); the
host metadata, the layout and the reported sizes stay the whole pool's.
:meth:`PagedKVCache.write_prefill` takes full-head K/V and keeps the
rank's heads.  Two operations read a row across heads: the e4m3 scale
of a (layer, page, offset) row is the max over every rank's heads (one
``Max`` allreduce over the tp set before quantizing, so the codes equal
the reference's on its global pool), and :meth:`PagedKVCache.
gather_pages` returns full heads (each rank's heads summed into zeros
over the set).  A rank outside the mesh (the control plane keeps such
ranks in step) holds no heads and runs neither.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..collectives.compression import fp8_absmax, fp8_quantize
from ..core.device import resolve_device
from ..timeline.metrics import registry as _registry

FP8 = torch.float8_e4m3fn


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/a torch dtype -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dtype_name(dt: torch.dtype) -> str:
    """The NumPy spelling of a torch dtype (``"float32"``,
    ``"bfloat16"``), as the reference's layouts and wire headers write
    it."""
    return str(dt).replace("torch.", "")


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
    compress: bool = False         # fp8 cold pages on/off
    hot_pages: int = 1             # full pages behind the head kept f32

    def __post_init__(self):
        if self.max_len % self.page_size:
            raise ValueError(
                f"max_len {self.max_len} not a multiple of page_size "
                f"{self.page_size}")
        if self.hot_pages < 0:
            raise ValueError(f"hot_pages must be >= 0: {self.hot_pages}")

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
            "dtype": dtype_name(torch_dtype(self.dtype)),
        }


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """This rank's share of a page pool split on its kv-head dim over a
    tp set: its ``device``, its ``index`` on the tp axis and the axis's
    ``size``, whether the rank is a ``member`` of the mesh (a rank
    outside it holds no heads), and the tp ``process_set`` (``None`` at
    size 1 and outside the mesh)."""

    device: torch.device
    index: int = 0
    size: int = 1
    member: bool = True
    process_set: object = None

    def heads(self, num_kv_heads: int) -> Tuple[int, int]:
        """``(first, count)`` of this rank's kv heads."""
        if num_kv_heads % self.size:
            raise ValueError(f"num_kv_heads={num_kv_heads} not divisible "
                             f"by tp={self.size}")
        n = num_kv_heads // self.size if self.member else 0
        return self.index * n, n


def cache_sharding(mesh, tp_axis: str = "tp", device=None):
    """This rank's :class:`CacheShard` of a pool split over ``mesh``'s
    ``tp_axis`` (the reference's ``NamedSharding(mesh, P(None, None,
    None, tp_axis, None))``); ``None`` without a mesh.  ``device``
    defaults to ``init()``'s."""
    from ..core.state import global_state
    if mesh is None:
        return None
    st = global_state()
    if device is None:
        device = st.device
    member = bool((mesh.ranks == st.rank).any())
    size = mesh.axis_size(tp_axis)
    return CacheShard(
        device=resolve_device(device), size=size, member=member,
        index=mesh.axis_index(tp_axis) if member else 0,
        process_set=mesh.group(tp_axis) if member and size > 1 else None)


def _ids(ids, device) -> torch.Tensor:
    """Host page ids -> a long index tensor (always a copy)."""
    return torch.tensor(np.asarray(ids, np.int64), dtype=torch.long,
                        device=device)


def _set_fp8(pool: torch.Tensor, idx: torch.Tensor, q) -> None:
    """``pool[:, idx] = q`` for an e4m3 pool, through ``uint8`` views
    (indexed writes of float8 tensors are not implemented everywhere)."""
    pool.view(torch.uint8)[:, idx] = q.to(FP8).view(torch.uint8).to(
        pool.device)


class PagedKVCache:
    """Device page pool + host page table / free list for one model.

    ``sharding``: a :class:`CacheShard` (:func:`cache_sharding`) for a
    tp mesh, else the device of a whole pool (or ``device=``; ``None``:
    ``cuda``)."""

    def __init__(self, config: CacheConfig, sharding=None, *, device=None):
        self.config = c = config
        if not isinstance(sharding, CacheShard):
            sharding = CacheShard(resolve_device(
                device if sharding is None else sharding))
        self.sharding = sharding
        self.device = sharding.device
        self.head0, self.local_heads = sharding.heads(c.num_kv_heads)
        shape = (c.num_layers, c.num_pages + 1, c.page_size,
                 self.local_heads, c.head_dim)
        dt = torch_dtype(c.dtype)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        # Host-side logical view.  Unallocated table entries point at
        # page 0 -- harmless, reads beyond ``lengths`` are masked.
        self.page_table = np.zeros((c.slots, c.pages_per_slot), np.int32)
        self.lengths = np.zeros((c.slots,), np.int32)
        self._allocated = np.zeros((c.slots,), np.int32)
        self._free = list(range(c.num_pages - 1, -1, -1))  # pop() -> 0, 1..
        # Holders per page: 0 on the free list, 1 private, > 1 shared
        # across slots and/or held by the prefix tree.
        self._refcount = np.zeros((c.num_pages,), np.int32)
        # Page-pressure hook (the PrefixCache installs itself): called
        # with the shortfall before admission or reservation gives up.
        self.reclaim_cb = None
        self.compress = bool(c.compress)
        if self.compress:
            self.kq = torch.zeros(shape, dtype=FP8, device=self.device)
            self.vq = torch.zeros(shape, dtype=FP8, device=self.device)
            sshape = (c.num_layers, c.num_pages + 1, c.page_size)
            self.kscale = torch.ones(sshape, dtype=torch.float32,
                                     device=self.device)
            self.vscale = torch.ones(sshape, dtype=torch.float32,
                                     device=self.device)
            self.cpage_table = np.zeros((c.slots, c.pages_per_slot),
                                        np.int32)
            self.comp_mask = np.zeros((c.slots, c.pages_per_slot), bool)
            self._cfree = list(range(c.num_pages - 1, -1, -1))
            self._cheld = np.zeros((c.slots,), np.int32)
            self._crefcount = np.zeros((c.num_pages,), np.int32)

    # -- page accounting ---------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        """Table entries that read the f32 pool (a page shared by two
        slots counts twice; compressed entries are
        :attr:`compressed_pages`)."""
        total = int(self._allocated.sum())
        if self.compress:
            total -= int(self._cheld.sum())
        return total

    @property
    def compressed_pages(self) -> int:
        return int(self._cheld.sum()) if self.compress else 0

    @property
    def live_pages(self) -> int:
        """Physical f32 pages with a holder: ``free_pages + live_pages
        == num_pages`` under sharing."""
        return int((self._refcount > 0).sum())

    def refcounts_balanced(self) -> bool:
        """Every page is on its free list (refcount 0) or held, in both
        pools."""
        ok = len(self._free) + self.live_pages == self.config.num_pages
        ok = ok and not any(self._refcount[p] for p in self._free)
        if self.compress:
            live_c = int((self._crefcount > 0).sum())
            ok = ok and len(self._cfree) + live_c == self.config.num_pages
            ok = ok and not any(self._crefcount[p] for p in self._cfree)
        return bool(ok)

    # -- refcount primitives -----------------------------------------------
    def add_page_ref(self, pid: int, kind: str = "f") -> None:
        if kind == "c":
            self._crefcount[pid] += 1
        else:
            self._refcount[pid] += 1

    def drop_page_ref(self, pid: int, kind: str = "f") -> bool:
        """Drop one holder; True when that freed the page (it rejoins its
        free list unzeroed: the masking keeps its bytes dark)."""
        if kind == "c":
            self._crefcount[pid] -= 1
            if self._crefcount[pid] == 0:
                self._cfree.append(int(pid))
                return True
            return False
        self._refcount[pid] -= 1
        if self._refcount[pid] == 0:
            self._free.append(int(pid))
            return True
        return False

    @property
    def resident_bytes(self) -> int:
        """KV residency at compressed accounting: pool-dtype pages at
        full price, e4m3 pages at a byte an element plus the f32 scale
        a row."""
        c = self.config
        row = c.num_kv_heads * c.head_dim
        page_f = c.num_layers * c.page_size * row * 2 \
            * torch_dtype(c.dtype).itemsize
        page_fp8 = c.num_layers * c.page_size * (row + 4) * 2
        return (self.allocated_pages * page_f
                + self.compressed_pages * page_fp8)

    def _cold_candidates(self, exclude: Optional[int] = None) -> List[int]:
        """Slots by how many uncompressed cold pages they hold,
        descending: the reclaim sweep order."""
        out = []
        for slot in range(self.config.slots):
            if slot == exclude:
                continue
            n = self._cold_count(slot)
            if n > 0:
                out.append((n, slot))
        return [slot for _, slot in sorted(out, reverse=True)]

    def _cold_indices(self, slot: int) -> List[int]:
        """Table indices of ``slot``'s cold pages still in the f32 pool:
        full pages at least ``hot_pages`` behind the write head, not yet
        compressed and not shared (another holder reads them through the
        f32 table).  Pages at or past ``lengths`` are never cold: the
        verify step may still write them."""
        c = self.config
        full = int(self.lengths[slot]) // c.page_size
        out = []
        for i in range(max(0, full - c.hot_pages)):
            if self.comp_mask[slot, i]:
                continue
            if self._refcount[int(self.page_table[slot, i])] != 1:
                continue
            out.append(i)
        return out

    def _cold_count(self, slot: int) -> int:
        return len(self._cold_indices(slot))

    def can_admit(self, length: int) -> bool:
        """Whether a sequence of ``length`` tokens fits the pool now.
        With compression, cold pages reclaimable by a sweep (bounded by
        the e4m3 pool's room) count as free; under page pressure the
        prefix tree's ``reclaim_cb`` demotes or evicts first."""

        def avail() -> int:
            a = len(self._free)
            if self.compress:
                cold = sum(self._cold_count(s)
                           for s in range(self.config.slots))
                a += min(cold, len(self._cfree))
            return a

        need = -(-max(int(length), 1) // self.config.page_size)
        if need > avail() and self.reclaim_cb is not None:
            self.reclaim_cb(need - avail())
        return need <= avail()

    def reserve(self, slot: int, length: int,
                writable_from: Optional[int] = None) -> None:
        """Ensure ``slot`` has pages for ``length`` tokens, compressing
        other slots' cold pages on demand when the free list runs short.
        ``writable_from``: the position of the first upcoming write;
        every page covering it and after is made private first (the
        copy-on-write guard)."""
        c = self.config
        if length > c.max_len:
            raise ValueError(f"length {length} exceeds max_len {c.max_len}")
        need = -(-int(length) // c.page_size)
        have = int(self._allocated[slot])
        if need > have:
            short = need - have - len(self._free)
            if short > 0 and self.reclaim_cb is not None:
                self.reclaim_cb(short)
                short = need - have - len(self._free)
            if short > 0 and self.compress:
                self._reclaim(short, exclude=slot)
            if need - have > len(self._free):
                raise RuntimeError(
                    f"KV page pool exhausted: slot {slot} needs "
                    f"{need - have} page(s), {len(self._free)} free")
            for i in range(have, need):
                pid = self._free.pop()
                self._refcount[pid] = 1
                self.page_table[slot, i] = pid
            self._allocated[slot] = need
        if writable_from is not None:
            self._make_writable(slot, writable_from)

    def _make_writable(self, slot: int, from_pos: int) -> None:
        """Clone every still-shared page covering positions ``>=
        from_pos`` into a private page before the slot writes there; the
        shared original keeps its bytes."""
        c = self.config
        for i in range(int(from_pos) // c.page_size,
                       int(self._allocated[slot])):
            if self.compress and self.comp_mask[slot, i]:
                raise RuntimeError(
                    f"slot {slot} page {i} is fp8-demoted inside the "
                    "write range; demotion must stay strictly below "
                    "the write head")
            pid = int(self.page_table[slot, i])
            if self._refcount[pid] <= 1:
                continue
            if not self._free and self.reclaim_cb is not None:
                self.reclaim_cb(1)
            if not self._free and self.compress:
                self._reclaim(1, exclude=slot)
            if not self._free:
                raise RuntimeError(
                    "KV page pool exhausted during copy-on-write "
                    f"divergence of slot {slot}")
            new = self._free.pop()
            self._refcount[new] = 1
            dst, src = _ids([new], self.device), _ids([pid], self.device)
            self.k.index_copy_(1, dst, self.k.index_select(1, src))
            self.v.index_copy_(1, dst, self.v.index_select(1, src))
            self.page_table[slot, i] = new
            self.drop_page_ref(pid)

    def _reclaim(self, pages: int, exclude: Optional[int] = None) -> int:
        """Compress cold pages across slots until ``pages`` f32 pages
        came back (or the candidates ran out)."""
        got = 0
        for slot in self._cold_candidates(exclude=exclude):
            if got >= pages:
                break
            got += self.compress_cold(slot, max_pages=pages - got)
        return got

    def _store_fp8(self, cpids, kq, vq, ksc, vsc) -> None:
        cp = _ids(cpids, self.device)
        _set_fp8(self.kq, cp, kq)
        _set_fp8(self.vq, cp, vq)
        self.kscale[:, cp] = ksc.to(self.device, torch.float32)
        self.vscale[:, cp] = vsc.to(self.device, torch.float32)

    def compress_cold(self, slot: int, max_pages: Optional[int] = None
                      ) -> int:
        """Move up to ``max_pages`` of ``slot``'s cold pages into the
        e4m3 pool, lowest table index first, and return their f32 pages
        to the free list; their f32 table entries point at the scratch
        page (never read: ``comp_mask`` picks the e4m3 page)."""
        if not self.compress:
            raise RuntimeError("cache built without compress=True")
        c = self.config
        idxs = self._cold_indices(slot)
        if max_pages is not None:
            idxs = idxs[:max_pages]
        idxs = idxs[:len(self._cfree)]
        if not idxs:
            return 0
        pids = [int(self.page_table[slot, i]) for i in idxs]
        cpids = [self._cfree.pop() for _ in idxs]
        dev = _ids(pids, self.device)
        kq, ksc = self._quantize(self.k, dev)
        vq, vsc = self._quantize(self.v, dev)
        self._store_fp8(cpids, kq, vq, ksc, vsc)
        for i, cpid, pid in zip(idxs, cpids, pids):
            self.cpage_table[slot, i] = cpid
            self.comp_mask[slot, i] = True
            self._crefcount[cpid] = 1
            self.page_table[slot, i] = c.scratch_page
            self.drop_page_ref(pid)
        self._cheld[slot] += len(idxs)
        return len(idxs)

    def _quantize(self, pool: torch.Tensor, pids: torch.Tensor):
        """:func:`_quantize_pages` over the whole row: at tp > 1 each
        row's max-abs is the ``Max`` over the tp set's heads."""
        return _quantize_pages(pool, pids, self.sharding.process_set)

    def _my_heads(self, x):
        """``x`` (``[..., num_kv_heads, head_dim]``, every head, as the
        wire carries a page) cut to this rank's heads: all of them at tp
        1, none on a rank outside the mesh."""
        if self.local_heads == self.config.num_kv_heads:
            return x
        return torch.as_tensor(x)[..., self.head0:self.head0
                                   + self.local_heads, :]

    def free_slot(self, slot: int) -> None:
        """Refcount-decrement the slot's pages and mark it idle.  A
        shared page stays resident until its last holder lets go; page
        contents stay in place either way (masking, not zeroing,
        isolates them)."""
        for i in range(int(self._allocated[slot]) - 1, -1, -1):
            if self.compress and self.comp_mask[slot, i]:
                self.drop_page_ref(int(self.cpage_table[slot, i]), "c")
                self.comp_mask[slot, i] = False
            else:
                self.drop_page_ref(int(self.page_table[slot, i]))
        self._allocated[slot] = 0
        if self.compress:
            self._cheld[slot] = 0
        self.lengths[slot] = 0

    def release_all(self) -> int:
        """Free every slot; returns how many table entries that
        released (0 after a clean drain: the leak check)."""
        freed = 0
        for slot in range(self.config.slots):
            n = int(self._allocated[slot])
            if n:
                freed += n
                self.free_slot(slot)
        return freed

    # -- prefix sharing and imports ----------------------------------------
    def attach_pages(self, slot: int, entries: Sequence[Tuple[str, int]],
                     length: int) -> None:
        """Map resident pages into an empty slot's table, refcount + 1
        each: ``("f", page)`` in the pool, ``("c", cpage)`` in the e4m3
        pool.  The slot's first ``length`` tokens (``len(entries)`` full
        pages) are then readable; a tail continues at ``start=length``
        through :meth:`write_prefill`."""
        c = self.config
        if int(self._allocated[slot]):
            raise RuntimeError(f"attach_pages: slot {slot} is not empty")
        if len(entries) * c.page_size != int(length):
            raise ValueError(
                f"attach_pages: {len(entries)} page(s) cannot back "
                f"{length} tokens at page_size {c.page_size}")
        for i, (kind, pid) in enumerate(entries):
            if kind == "c":
                if not self.compress:
                    raise RuntimeError(
                        "compressed prefix entry on a compress=False cache")
                self.cpage_table[slot, i] = pid
                self.comp_mask[slot, i] = True
                self.page_table[slot, i] = c.scratch_page
                self._cheld[slot] += 1
            else:
                self.page_table[slot, i] = pid
            self.add_page_ref(pid, kind)
        self._allocated[slot] = len(entries)
        self.lengths[slot] = int(length)

    def adopt_pages(self, k_pages, v_pages) -> List[Tuple[str, int]]:
        """Land streamed full pages (``[L, n, page_size, H, D]``, the
        :mod:`.kvwire` f32 tier) in the pool at refcount 1, owned by the
        caller, who maps them with :meth:`attach_pages` and drops its
        own reference.  Written verbatim (a cast to the pool dtype at
        most), so an f32-tier import is bitwise a local
        ``write_prefill``.  On a kv-head-sharded pool the rank keeps its
        heads of each page, ``[..., head0:head0 + local_heads, :]``, as
        ``write_prefill`` does; a rank outside the mesh keeps none but
        takes the pages off its free list all the same, so the ranks'
        lists stay in step."""
        n = int(k_pages.shape[1])
        if n == 0:
            return []
        short = n - len(self._free)
        if short > 0 and self.reclaim_cb is not None:
            self.reclaim_cb(short)
            short = n - len(self._free)
        if short > 0 and self.compress:
            self._reclaim(short)
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: adopting {n} streamed "
                f"page(s), {len(self._free)} free")
        pids = [self._free.pop() for _ in range(n)]
        for pid in pids:
            self._refcount[pid] = 1
        idx = _ids(pids, self.device)
        self.k[:, idx] = self._my_heads(k_pages).to(self.device,
                                                    self.k.dtype)
        self.v[:, idx] = self._my_heads(v_pages).to(self.device,
                                                    self.v.dtype)
        return [("f", int(p)) for p in pids]

    def adopt_compressed_pages(self, kq, vq, kscale, vscale
                               ) -> List[Tuple[str, int]]:
        """:meth:`adopt_pages` for the e4m3 pool: streamed e4m3 pages and
        their scales (the :mod:`.kvwire` fp8 tier) at refcount 1.  The
        wire quantizes as :func:`_quantize_pages` does, so an imported
        page is bitwise :meth:`demote_page` of the same resident bytes.
        On a kv-head-sharded pool the rank keeps its heads of ``kq`` /
        ``vq`` and the sender's whole-row scales unchanged: a sharded
        pool's row scale is the ``Max`` over the tp set's heads, which is
        the whole row's max-abs the wire was quantized with, so the
        imported shard is bitwise this rank's heads of the same
        quantization."""
        if not self.compress:
            raise RuntimeError("cache built without compress=True")
        n = int(kq.shape[1])
        if n == 0:
            return []
        if n > len(self._cfree):
            raise RuntimeError(
                f"e4m3 pool exhausted: adopting {n} streamed cold "
                f"page(s), {len(self._cfree)} free")
        cpids = [self._cfree.pop() for _ in range(n)]
        for cpid in cpids:
            self._crefcount[cpid] = 1
        self._store_fp8(cpids, self._my_heads(kq), self._my_heads(vq),
                        torch.as_tensor(kscale), torch.as_tensor(vscale))
        return [("c", int(p)) for p in cpids]

    def dequantized(self, pool: str, cpids) -> torch.Tensor:
        """e4m3 pages ``cpids`` of ``"k"``/``"v"`` as the pool dtype:
        ``f32(e4m3) * scale`` rounded to the pool dtype, the order the
        decode steps blend them in."""
        q = getattr(self, f"{pool}q")[:, cpids]
        s = getattr(self, f"{pool}scale")[:, cpids]
        return (q.float() * s[..., None, None]).to(self.k.dtype)

    def gather_pages(self, entries: Sequence[Tuple[str, int]]) -> tuple:
        """Page contents as chunked-prefill ``past``: ``(k, v)`` each
        ``[num_layers, 1, n * page_size, num_kv_heads, head_dim]``,
        e4m3 pages dequantized through their scales; at tp > 1 every
        rank of the set gets every head (collective over the set)."""
        if not self.sharding.member:
            raise RuntimeError("gather_pages on a rank outside the mesh: "
                               "it holds no heads")
        c = self.config
        fp = _ids([pid if kind == "f" else c.scratch_page
                   for kind, pid in entries], self.device)
        cp = _ids([pid if kind == "c" else 0 for kind, pid in entries],
                  self.device)
        cmask = torch.tensor([kind == "c" for kind, _ in entries],
                             device=self.device)
        any_c = bool(cmask.any())
        out = []
        for name, pool in (("k", self.k), ("v", self.v)):
            view = pool[:, fp]                  # [L, n, ps, H, D]
            if any_c:
                view = torch.where(cmask[None, :, None, None, None],
                                   self.dequantized(name, cp), view)
            l, n, ps, hh, dd = view.shape
            out.append(self._all_heads(
                view.reshape(l, n * ps, hh, dd)[:, None]))
        return tuple(out)

    def _all_heads(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (this rank's heads on dim -2) with every head of the tp
        set: each rank's block summed into zeros (exact; gloo runs only
        allreduce and broadcast on CUDA tensors)."""
        ps = self.sharding.process_set
        if ps is None:
            return x
        from ..collectives.ops import exchange_allreduce_async_
        from ..collectives.reduce_op import Sum
        shape = list(x.shape)
        shape[-2] = self.config.num_kv_heads
        full = x.new_zeros(shape)
        full[..., self.head0:self.head0 + self.local_heads, :] = x
        return exchange_allreduce_async_(full, Sum, process_set=ps).wait()

    def demote_page(self, pid: int) -> int:
        """Quantize one tree-held page into the e4m3 pool and return the
        compressed page id at refcount 1 (the caller drops its f32
        reference): the prefix tree's demotion tier."""
        if not self.compress:
            raise RuntimeError("cache built without compress=True")
        if not self._cfree:
            raise RuntimeError("e4m3 pool exhausted")
        cpid = int(self._cfree.pop())
        dev = _ids([pid], self.device)
        kq, ksc = self._quantize(self.k, dev)
        vq, vsc = self._quantize(self.v, dev)
        self._store_fp8([cpid], kq, vq, ksc, vsc)
        self._crefcount[cpid] = 1
        return cpid

    # -- device writes -----------------------------------------------------
    def write_prefill(self, slot: int, k_layers, v_layers,
                      start: int = 0) -> None:
        """Scatter a prefilled prompt's K/V into the slot's pages.

        ``k_layers``/``v_layers``: ``[num_layers, t, num_kv_heads,
        head_dim]`` post-RoPE (every head: a rank of a tp mesh keeps its
        own).  Reserves pages for ``start + t`` tokens through the
        copy-on-write guard and sets ``lengths[slot] = start + t``.
        ``start`` is where a matched or imported prefix ends: only the
        tail is written."""
        c = self.config
        t = int(k_layers.shape[1])
        if self.local_heads != c.num_kv_heads:
            hs = slice(self.head0, self.head0 + self.local_heads)
            k_layers, v_layers = k_layers[..., hs, :], v_layers[..., hs, :]
        self.reserve(slot, start + t, writable_from=start)
        pos = np.arange(start, start + t)
        pages = _ids(self.page_table[slot][pos // c.page_size],
                     self.device)
        offs = _ids(pos % c.page_size, self.device)
        # One scatter per pool: [L, t, H, D] lands at (page, off) pairs.
        self.k[:, pages, offs] = torch.as_tensor(k_layers).to(
            self.device, self.k.dtype)
        self.v[:, pages, offs] = torch.as_tensor(v_layers).to(
            self.device, self.v.dtype)
        self.lengths[slot] = start + t

    def grow(self, slot: int) -> None:
        """Account one decoded token (the decode step already wrote its
        K/V); reserves the next page at a boundary crossing."""
        new_len = int(self.lengths[slot]) + 1
        self.reserve(slot, new_len, writable_from=new_len - 1)
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

    def ctable_device(self) -> torch.Tensor:
        return torch.tensor(self.cpage_table, dtype=torch.int32,
                            device=self.device)

    def cmask_device(self) -> torch.Tensor:
        return torch.tensor(self.comp_mask, dtype=torch.bool,
                            device=self.device)

    def compress_operands(self) -> tuple:
        """The six operands a ``compress=True`` decode or verify step
        takes after ``active``: the e4m3 pools, their scales, the
        compressed page table and the mask."""
        return (self.kq, self.vq, self.kscale, self.vscale,
                self.ctable_device(), self.cmask_device())

    def layout(self) -> dict:
        return self.config.layout()


class _PrefixNode:
    """One full page of prompt tokens in the radix tree: ``key`` the
    page's token ids, ``page`` its backing page (``kind`` ``"f"`` or
    ``"c"``), ``touch`` the LRU clock, ``pins`` the session pins."""

    __slots__ = ("key", "parent", "children", "kind", "page", "touch",
                 "pins", "dead")

    def __init__(self, key, parent, kind, page, touch):
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.kind = kind
        self.page = page
        self.touch = touch
        self.pins = 0
        self.dead = False


class PrefixCache:
    """Radix tree over token-id prefixes -> refcounted KV pages.

    The tree's unit is one full page of token ids.  :meth:`match` walks a
    prompt chunk by chunk; :meth:`PagedKVCache.attach_pages` then makes
    the matched prefix live with no prefill, and only the tail is
    prefilled.  After a prefill :meth:`insert` registers the slot's full
    prompt pages (the tree holds its own reference, so they outlive the
    slot).  Sessions pin their node path (:meth:`pin_session`), and the
    pins expire after ``session_ttl_steps`` engine steps without reuse
    (:meth:`tick`).  Under page pressure (:meth:`release_pages`, the
    cache's ``reclaim_cb``) tree-only pages are demoted to the e4m3 pool
    first (still matchable), then evicted leaf first in LRU order,
    unpinned before pinned.
    """

    def __init__(self, cache: PagedKVCache, session_ttl_steps: int = 0):
        self.cache = cache
        self.session_ttl_steps = int(session_ttl_steps)
        self._children: Dict[tuple, _PrefixNode] = {}
        self._clock = 0
        self._sessions: "collections.OrderedDict[object, dict]" = \
            collections.OrderedDict()
        self.queries = 0
        self.hits = 0
        self.nodes = 0
        reg = _registry()
        self._g_hit = reg.gauge(
            "horovod_serving_prefix_hit_rate",
            "Fraction of prefill queries that matched a cached prefix")
        self._g_pages = reg.gauge(
            "horovod_serving_prefix_pages",
            "KV pages pinned by the prefix tree")
        self._g_sessions = reg.gauge(
            "horovod_serving_sessions_live",
            "Sessions with pinned warm KV context")
        self._m_tok = reg.counter(
            "horovod_serving_prefix_tokens_total",
            "Prefill tokens by provenance (cached = prefill FLOPs "
            "avoided)", labelnames=("source",))
        cache.reclaim_cb = self.release_pages

    # -- stats -------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0

    @property
    def sessions_live(self) -> int:
        return len(self._sessions)

    def stats(self) -> dict:
        return {"queries": self.queries, "hits": self.hits,
                "hit_rate": self.hit_rate, "nodes": self.nodes,
                "sessions": len(self._sessions)}

    # -- the radix walk ----------------------------------------------------
    def _chunk(self, prompt, i: int) -> tuple:
        ps = self.cache.config.page_size
        return tuple(int(x) for x in prompt[i * ps:(i + 1) * ps])

    def match(self, prompt) -> Tuple[int, List[Tuple[str, int]]]:
        """Deepest cached prefix of ``prompt`` in full pages, capped at
        ``len(prompt) - 1`` tokens so the tail has a token to give the
        first-token logits.  Returns ``(matched_tokens, [(kind, page),
        ...])`` for :meth:`PagedKVCache.attach_pages`."""
        ps = self.cache.config.page_size
        limit = (len(prompt) - 1) // ps
        entries: List[Tuple[str, int]] = []
        children = self._children
        for i in range(limit):
            node = children.get(self._chunk(prompt, i))
            if node is None:
                break
            node.touch = self._clock
            entries.append((node.kind, node.page))
            children = node.children
        self.queries += 1
        if entries:
            self.hits += 1
        matched = len(entries) * ps
        self._m_tok.labels(source="cached").inc(matched)
        self._m_tok.labels(source="computed").inc(len(prompt) - matched)
        self._g_hit.set(self.hit_rate)
        return matched, entries

    def insert(self, prompt, slot: int) -> int:
        """Register ``slot``'s resident full prompt pages under their
        token chunks (tree reference + 1 each); chunks already present
        are touched.  Returns the pages newly registered."""
        cache = self.cache
        n = min(len(prompt), int(cache.lengths[slot])) \
            // cache.config.page_size
        children = self._children
        parent = None
        new = 0
        for i in range(n):
            key = self._chunk(prompt, i)
            node = children.get(key)
            if node is None:
                if cache.compress and cache.comp_mask[slot, i]:
                    kind, pid = "c", int(cache.cpage_table[slot, i])
                else:
                    kind, pid = "f", int(cache.page_table[slot, i])
                node = _PrefixNode(key, parent, kind, pid, self._clock)
                cache.add_page_ref(pid, kind)
                children[key] = node
                self.nodes += 1
                new += 1
            node.touch = self._clock
            parent = node
            children = node.children
        self._g_pages.set(self.nodes)
        return new

    # -- sessions ----------------------------------------------------------
    def pin_session(self, sid, prompt) -> None:
        """Pin the node path of ``prompt``'s full pages under session
        ``sid``; pinning again releases the old pins first and refreshes
        the TTL."""
        nodes: List[_PrefixNode] = []
        children = self._children
        for i in range(len(prompt) // self.cache.config.page_size):
            node = children.get(self._chunk(prompt, i))
            if node is None:
                break
            nodes.append(node)
            children = node.children
        old = self._sessions.pop(sid, None)
        if old is not None:
            for nd in old["nodes"]:
                if not nd.dead:
                    nd.pins -= 1
        for nd in nodes:
            nd.pins += 1
        self._sessions[sid] = {"nodes": nodes, "step": self._clock}
        self._g_sessions.set(len(self._sessions))

    def touch_session(self, sid) -> bool:
        """Refresh a session's TTL on reuse; True when it was warm."""
        entry = self._sessions.get(sid)
        if entry is None:
            return False
        entry["step"] = self._clock
        self._sessions.move_to_end(sid)
        return True

    def _expire_session(self, sid) -> None:
        for nd in self._sessions.pop(sid)["nodes"]:
            if not nd.dead:
                nd.pins -= 1
        self._g_sessions.set(len(self._sessions))

    def tick(self, steps: int = 1) -> None:
        """Advance the LRU/TTL clock (one call an engine step); sessions
        idle past ``session_ttl_steps`` lose their pins."""
        self._clock += int(steps)
        if not self.session_ttl_steps:
            return
        while self._sessions:
            sid, entry = next(iter(self._sessions.items()))
            if self._clock - entry["step"] <= self.session_ttl_steps:
                break
            self._expire_session(sid)

    # -- pressure: demote, then evict --------------------------------------
    def _iter_nodes(self):
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _drop(self, node: _PrefixNode) -> bool:
        """Remove one leaf; True when its f32 page was freed."""
        owner = self._children if node.parent is None \
            else node.parent.children
        owner.pop(node.key, None)
        node.dead = True
        self.nodes -= 1
        freed = self.cache.drop_page_ref(node.page, node.kind)
        self._g_pages.set(self.nodes)
        return freed and node.kind == "f"

    def _demote(self, need: int) -> int:
        """Quantize LRU tree-only f32 pages into the e4m3 pool, freeing
        their f32 pages while the prefix stays matchable."""
        cache = self.cache
        if not cache.compress:
            return 0
        cand = [nd for nd in self._iter_nodes()
                if nd.kind == "f" and cache._refcount[nd.page] == 1]
        cand.sort(key=lambda nd: nd.touch)
        freed = 0
        for nd in cand:
            if freed >= need or not cache._cfree:
                break
            cpid = cache.demote_page(nd.page)
            if cache.drop_page_ref(nd.page):
                freed += 1
            nd.kind, nd.page = "c", cpid
        return freed

    def _evict(self, need: int) -> int:
        """LRU leaf eviction, unpinned entries before pinned ones."""
        freed = 0
        for take_pinned in (False, True):
            while freed < need:
                leaves = [nd for nd in self._iter_nodes()
                          if not nd.children
                          and (nd.pins > 0) == take_pinned]
                if not leaves:
                    break
                if self._drop(min(leaves, key=lambda nd: nd.touch)):
                    freed += 1
            if freed >= need:
                break
        return freed

    def release_pages(self, need: int) -> int:
        """Give ``need`` f32 pages back to live traffic: demote first,
        evict after.  The cache's ``reclaim_cb``."""
        freed = self._demote(need)
        if freed < need:
            freed += self._evict(need - freed)
        return freed

    def drop_all(self) -> None:
        """Release every tree reference and session pin (afterwards the
        pool must be whole again: the leak check)."""
        for sid in list(self._sessions):
            self._expire_session(sid)
        while True:
            leaves = [nd for nd in self._iter_nodes() if not nd.children]
            if not leaves:
                break
            for nd in leaves:
                self._drop(nd)


def _quantize_pages(pool: torch.Tensor, pids: torch.Tensor,
                    process_set=None):
    """e4m3-quantize pages ``pids`` of one pool: one max-abs scale per
    (layer, page, offset) row over its ``kv_heads * head_dim`` values --
    the reference's reshape and axis -- so a never-written row comes
    back as exact zeros with scale 1.  ``process_set``: the tp set whose
    ranks hold the row's other heads; the row's max-abs is the ``Max``
    over it (one allreduce of ``L * n * page`` f32).  Returns ``(q [L,
    n, page, H, D] e4m3, scales [L, n, page] f32)``."""
    x = pool[:, pids]
    l, n, pg, hh, dd = x.shape
    rows = x.reshape(l * n * pg, hh * dd)
    absmax = None
    if process_set is not None:
        from ..collectives.ops import exchange_allreduce_async_
        from ..collectives.reduce_op import Max
        absmax = exchange_allreduce_async_(
            fp8_absmax(rows, axis=0), Max, process_set=process_set).wait()
    q, s = fp8_quantize(rows, axis=0, absmax=absmax)
    return q.reshape(l, n, pg, hh, dd), s.reshape(l, n, pg)


__all__ = ["CacheConfig", "CacheShard", "PagedKVCache", "PrefixCache",
           "cache_sharding", "torch_dtype"]
