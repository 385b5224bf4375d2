"""Versioned wire codec for KV-page streaming (prefill -> decode).

Counterpart of ``horovod_tpu/serving/kvwire.py``, byte for byte: a
payload either package encodes decodes in the other.  Disaggregated
serving splits an engine into a prefill worker and a decode worker; the
only thing that moves between them is a prompt's finished K/V pages,
published as bytes over the rendezvous KV plane (``run/http_kv.py``).  A
decode worker lands them in its own :class:`~.kvcache.PagedKVCache`
through ``adopt_pages`` + ``attach_pages`` (:func:`import_pages`).

Two tiers, selected by ``HOROVOD_KV_PAGE_WIRE``:

* ``f32`` (default) -- full pages travel as the pool dtype's raw bytes,
  so the decode worker's pool holds exactly the bytes the prefill
  worker computed and its streams are bitwise a colocated engine's.
* ``fp8`` -- full pages travel through the cold-page codec
  (:func:`~..collectives.compression.fp8_quantize`, one max-abs e4m3
  scale per (layer, page, offset) row) with the reshape and axis of the
  cache's ``demote_page``, so an imported page is bitwise a locally
  demoted one.

The partial tail page always travels in the pool dtype: it is at the
write head, and the pool never holds a hot page in e4m3.

Framing: ``b"HVKW" | u16 version | u32 header_len | header JSON |
payload``.  The header (sorted keys) carries the geometry, the payload
byte count and a SHA-256 of the payload; :func:`decode_kv` refuses a
wrong magic, a version mismatch, a truncation and a hash mismatch with
distinct ``ValueError`` messages.  Arrays cross as little-endian raw
bytes (``float32``, ``bfloat16``, e4m3 as one byte each), the layouts
the JAX package's NumPy arrays have.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from typing import List, Optional, Tuple

import torch

from ..collectives.compression import fp8_quantize
from ..core.config import _env
from .kvcache import FP8, dtype_name, torch_dtype

MAGIC = b"HVKW"
WIRE_VERSION = 1
TIER_F32 = "f32"
TIER_FP8 = "fp8"
_FRAME = struct.Struct("<4sHI")


def wire_tier() -> str:
    """Tier selected by ``HOROVOD_KV_PAGE_WIRE`` (``f32`` default)."""
    tier = (_env("KV_PAGE_WIRE") or TIER_F32).lower()
    if tier not in (TIER_F32, TIER_FP8):
        raise ValueError(
            f"HOROVOD_KV_PAGE_WIRE must be '{TIER_F32}' or '{TIER_FP8}', "
            f"got {tier!r}")
    return tier


@dataclasses.dataclass
class WirePages:
    """A decoded payload, ready for :func:`import_pages`.  The tensors
    are CPU tensors over the payload's bytes."""

    tier: str
    length: int                    # tokens covered (full pages + tail)
    page_size: int
    dtype: str                     # pool dtype of the f32 tier and tail
    # f32 tier: [L, full, page_size, H, D] in the pool dtype.
    k_pages: Optional[torch.Tensor] = None
    v_pages: Optional[torch.Tensor] = None
    # fp8 tier: e4m3 pages + one f32 scale per (layer, page, offset) row.
    kq: Optional[torch.Tensor] = None
    vq: Optional[torch.Tensor] = None
    kscale: Optional[torch.Tensor] = None
    vscale: Optional[torch.Tensor] = None
    # Partial tail page, always the pool dtype: [L, tail, H, D].
    k_tail: Optional[torch.Tensor] = None
    v_tail: Optional[torch.Tensor] = None

    @property
    def full_pages(self) -> int:
        return self.length // self.page_size

    @property
    def tail_tokens(self) -> int:
        return self.length - self.full_pages * self.page_size


def _bytes(t: torch.Tensor) -> bytes:
    """A tensor's elements as contiguous raw bytes, on the host."""
    t = t.detach().to("cpu").contiguous()
    return t.view(torch.uint8).numpy().tobytes()


def _quantize_full_pages(pages: torch.Tensor):
    """The cold-page codec over ``[L, n, ps, H, D]``, with the reshape
    and axis of ``kvcache._quantize_pages``."""
    l, n, pg, hh, dd = pages.shape
    q, s = fp8_quantize(pages.reshape(l * n * pg, hh * dd), axis=0)
    return q.reshape(l, n, pg, hh, dd), s.reshape(l, n, pg)


def encode_kv(k_layers, v_layers, *, page_size: int,
              tier: Optional[str] = None) -> bytes:
    """Serialize a prompt's post-RoPE K/V (``[L, T, H, D]``, one
    sequence of ``prefill_forward``'s output) into one framed payload of
    ``T // page_size`` full pages plus a tail in the pool dtype."""
    tier = tier or wire_tier()
    if tier not in (TIER_F32, TIER_FP8):
        raise ValueError(f"unknown KV wire tier {tier!r}")
    k, v = torch.as_tensor(k_layers), torch.as_tensor(v_layers)
    if k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"expected matching [L, T, H, D] K/V, got {tuple(k.shape)} "
            f"vs {tuple(v.shape)}")
    layers, length, heads, hd = k.shape
    if length < 1:
        raise ValueError("cannot encode an empty context")
    full = length // page_size
    tail = length - full * page_size
    chunks = []
    if full:
        kp = k[:, :full * page_size].reshape(layers, full, page_size,
                                             heads, hd)
        vp = v[:, :full * page_size].reshape(layers, full, page_size,
                                             heads, hd)
        if tier == TIER_FP8:
            kq, ks = _quantize_full_pages(kp)
            vq, vs = _quantize_full_pages(vp)
            chunks += [_bytes(kq), _bytes(vq), _bytes(ks.float()),
                       _bytes(vs.float())]
        else:
            chunks += [_bytes(kp), _bytes(vp)]
    if tail:
        chunks += [_bytes(k[:, full * page_size:]),
                   _bytes(v[:, full * page_size:])]
    payload = b"".join(chunks)
    header = json.dumps({
        "tier": tier, "layers": layers, "kv_heads": heads,
        "head_dim": hd, "page_size": page_size, "length": length,
        "dtype": dtype_name(k.dtype), "payload_bytes": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }, sort_keys=True).encode()
    return _FRAME.pack(MAGIC, WIRE_VERSION, len(header)) + header + payload


def decode_kv(buf: bytes) -> WirePages:
    """Parse and check one framed payload; every malformation is a
    ``ValueError``, so a half-written or stale entry never reaches
    ``attach_pages``."""
    if len(buf) < _FRAME.size:
        raise ValueError(
            f"truncated KV-page payload: {len(buf)} byte(s) is shorter "
            f"than the {_FRAME.size}-byte frame")
    magic, version, hlen = _FRAME.unpack_from(buf)
    if magic != MAGIC:
        raise ValueError(f"not a KV-page wire payload (magic {magic!r})")
    if version != WIRE_VERSION:
        raise ValueError(
            f"KV wire version mismatch: payload v{version}, this codec "
            f"speaks v{WIRE_VERSION} -- refusing a cross-version import")
    if len(buf) < _FRAME.size + hlen:
        raise ValueError("truncated KV-page payload: header cut short")
    try:
        hdr = json.loads(buf[_FRAME.size:_FRAME.size + hlen])
    except ValueError as e:
        raise ValueError(f"corrupt KV wire header: {e}") from e
    payload = bytes(buf[_FRAME.size + hlen:])
    want = int(hdr["payload_bytes"])
    if len(payload) != want:
        raise ValueError(
            f"truncated KV-page payload: have {len(payload)} payload "
            f"byte(s), header promises {want}")
    if hashlib.sha256(payload).hexdigest() != hdr["sha256"]:
        raise ValueError(
            "KV-page content hash mismatch: payload bytes do not match "
            "the header's sha256 (partial write or in-flight corruption)")
    tier = hdr["tier"]
    layers, heads = int(hdr["layers"]), int(hdr["kv_heads"])
    hd, ps = int(hdr["head_dim"]), int(hdr["page_size"])
    length = int(hdr["length"])
    dt = torch_dtype(hdr["dtype"])
    full = length // ps
    tail = length - full * ps
    wp = WirePages(tier=tier, length=length, page_size=ps,
                   dtype=dtype_name(dt))
    raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
        if payload else torch.empty(0, dtype=torch.uint8)
    off = 0

    def take(dtype: torch.dtype, shape) -> torch.Tensor:
        nonlocal off
        nbytes = dtype.itemsize
        for n in shape:
            nbytes *= n
        # A copy starts at offset 0, so any element size can view it.
        arr = raw[off:off + nbytes].clone().view(dtype).reshape(shape)
        off += nbytes
        return arr

    if full:
        pshape = (layers, full, ps, heads, hd)
        if tier == TIER_FP8:
            wp.kq = take(FP8, pshape)
            wp.vq = take(FP8, pshape)
            wp.kscale = take(torch.float32, (layers, full, ps))
            wp.vscale = take(torch.float32, (layers, full, ps))
        else:
            wp.k_pages = take(dt, pshape)
            wp.v_pages = take(dt, pshape)
    if tail:
        tshape = (layers, tail, heads, hd)
        wp.k_tail = take(dt, tshape)
        wp.v_tail = take(dt, tshape)
    return wp


def import_pages(cache, slot: int, wp: WirePages) -> int:
    """Land a decoded payload in an empty slot of ``cache``: full pages
    are adopted (into the pool or the e4m3 pool) and mapped in through
    :meth:`~.kvcache.PagedKVCache.attach_pages`, the prefix-hit entry
    point, then the tail is written through ``write_prefill``.  Returns
    the full pages streamed in; the slot ends at ``lengths[slot] ==
    wp.length`` with every page held once, by the slot."""
    c = cache.config
    if wp.page_size != c.page_size:
        raise ValueError(
            f"wire page_size {wp.page_size} != pool page_size "
            f"{c.page_size}")
    if wp.tier == TIER_FP8 and not cache.compress:
        raise ValueError(
            "fp8 wire tier needs a compress=True decode-side cache "
            "(HOROVOD_KV_COMPRESS)")
    entries: List[Tuple[str, int]] = []
    if wp.full_pages:
        if wp.tier == TIER_FP8:
            entries = cache.adopt_compressed_pages(
                wp.kq, wp.vq, wp.kscale, wp.vscale)
        else:
            entries = cache.adopt_pages(wp.k_pages, wp.v_pages)
        cache.attach_pages(slot, entries, wp.full_pages * c.page_size)
        # attach_pages took the slot's reference; drop the importer's so
        # the slot is the only holder (free_slot then frees the page).
        for kind, pid in entries:
            cache.drop_page_ref(pid, kind)
    if wp.tail_tokens:
        cache.write_prefill(slot, wp.k_tail, wp.v_tail,
                            start=wp.full_pages * c.page_size)
    return len(entries)


__all__ = ["WirePages", "encode_kv", "decode_kv", "import_pages",
           "wire_tier", "MAGIC", "WIRE_VERSION", "TIER_F32", "TIER_FP8"]
