"""Gradient compression (``hvd.Compression`` parity).

Counterpart of ``horovod_tpu/collectives/compression.py``:

* the cast codecs -- ``Compression.fp16`` and ``Compression.bf16`` cast a
  floating tensor wider than the wire type down before the allreduce and
  back up after, halving the bytes on the wire for f32 gradients;
  anything else passes through;
* the error-feedback codec ``Compression.powersgd(rank)`` (Vogels et al.,
  2019) -- an EXCHANGE-level codec: ``compress``/``decompress`` are
  identities, and the exchange itself becomes
  :func:`~horovod_tpu_torch.collectives.ops.powersgd_allreduce` (two
  factor allreduces of a near-square matricized bucket), with the
  compression error fed back into the next step by the
  ``DistributedOptimizer``;
* ``Compression.fp8`` -- e4m3 on the wire with per-shard max-abs scales
  (:func:`fp8_quantize`), another EXCHANGE-level codec: a plain
  allreduce would accumulate in fp8 (3 mantissa bits, overflow at 448),
  so the exchange becomes
  :func:`~horovod_tpu_torch.collectives.ops.fp8_allreduce` (all-to-all
  of e4m3 shards, an f32 reduce, an e4m3 allgather) for Sum/Average and
  the quantized VHDD exchanges for Adasum; all arithmetic stays f32;
* the top-``fraction`` codec ``Compression.topk(fraction)`` (DGC-style,
  Lin et al., 2018), error feedback like PowerSGD, through
  :func:`~horovod_tpu_torch.collectives.ops.topk_allreduce`;
* the per-leg codec ``ici:<codec>,dcn:<codec>`` of the two-level
  exchange (:func:`~horovod_tpu_torch.collectives.ops.
  hierarchical_allreduce`): a cast codec on the intra-node legs, any
  codec on the cross-node hop;
* :func:`parse_compression` for ``HOROVOD_COMPRESSION`` specs, and the
  wire accounting the exchange counters use.

``float8_e4m3fn`` rides the wire as its ``uint8`` bytes (gloo carries no
fp8 dtype); the scales travel as f32.
"""

from __future__ import annotations

import math
import re
from typing import Tuple

import torch

E4M3_MAX = 448.0
_SCALE_FLOOR = 1e-30


def fp8_absmax(x: torch.Tensor, axis=None) -> torch.Tensor:
    """The f32 max-abs :func:`fp8_quantize` scales by: of the whole
    tensor, or per index of ``axis`` (0 where there is nothing)."""
    x32 = x.float()
    if axis is None:
        return x32.abs().amax() if x32.numel() else x32.new_zeros(())
    axis = axis % x32.dim()
    red = tuple(i for i in range(x32.dim()) if i != axis)
    return x32.abs().amax(dim=red) if x32.numel() else \
        x32.new_zeros(x32.shape[axis])


def fp8_quantize(x: torch.Tensor, axis=None, absmax=None):
    """Quantize to e4m3 with a max-abs scale: one for the whole tensor,
    or one per index of ``axis`` (a row each for ``axis=0``).

    Returns ``(q, scale)`` with ``x ~= q.float() * scale``: ``scale =
    max(absmax / 448, 1e-30)`` in f32, and 1 for an all-zero or empty
    row, so that it comes back exact; ``q = (x / scale)`` in f32, cast
    to ``float8_e4m3fn`` (round to nearest even) -- the JAX package's
    codes, bit for bit.  ``absmax``: the f32 max-abs to scale by in
    place of :func:`fp8_absmax` of ``x`` (the max over a row that ranks
    hold in parts: the kv-head-sharded page pool).
    """
    x32 = x.float()
    if absmax is None:
        absmax = fp8_absmax(x32, axis)
    if axis is not None:
        axis = axis % x32.dim()
    # A tensor divisor, not a Python float: on the card torch divides by
    # a host scalar as a multiply by its reciprocal, one ulp off now and
    # then.
    scale = torch.where(
        absmax > 0.0,
        torch.clamp_min(absmax / absmax.new_full((), E4M3_MAX),
                        _SCALE_FLOOR),
        torch.ones_like(absmax))
    if axis is None:
        q = (x32 / scale).to(torch.float8_e4m3fn)
    else:
        shape = [1] * x32.dim()
        shape[axis] = -1
        q = (x32 / scale.view(shape)).to(torch.float8_e4m3fn)
    return q, scale


def fp8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``(q.float() * scale).to(dtype)``: the inverse of
    :func:`fp8_quantize` up to its rounding."""
    return (q.float() * scale).to(dtype)


class Compressor:
    """Compress/decompress around a collective."""

    wire_dtype = None

    @staticmethod
    def compress(tensor):
        """Return ``(compressed_tensor, context_for_decompress)``."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None  # set by subclasses

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and \
                dtype.itemsize > cls.wire_dtype.itemsize:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class _ErrorFeedbackCompressor(Compressor):
    """Base for the error-feedback EXCHANGE-level codecs (PowerSGD,
    top-k).

    ``compress``/``decompress`` are identities: the codec cannot ride a
    plain allreduce, so the exchange recognises ``wire_format`` and swaps
    itself for the factored one.  The exchange is lossy in a way that
    biases training unless each rank's compression error is fed back into
    its next gradient -- the ``DistributedOptimizer`` carries that
    residual (``optim/distributed.py``).
    """
    wire_format = ""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP8Compressor(Compressor):
    """e4m3 wire with per-shard scales -- an EXCHANGE-level codec:
    ``compress``/``decompress`` are identities and the exchange itself
    changes (module docstring)."""
    wire_format = "fp8_e4m3"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


def is_fp8(compression) -> bool:
    return getattr(compression, "wire_format", "").startswith("fp8")


def is_powersgd(compression) -> bool:
    return getattr(compression, "wire_format", "") == "powersgd"


def is_topk(compression) -> bool:
    return getattr(compression, "wire_format", "") == "topk"


class _HierLegCompressor(Compressor):
    """Per-leg EXCHANGE-level codec of the two-level exchange: ``ici``
    rides the intra-node reduce-scatter and allgather (none/fp16/bf16),
    ``dcn`` only the cross-node hop of the 1/n_ici shard (any codec; an
    error-feedback one keeps its residual in the shard's domain).
    ``compress``/``decompress`` are identities: the exchange becomes
    :func:`~horovod_tpu_torch.collectives.ops.hierarchical_allreduce`."""
    wire_format = "hier_legs"
    ici = NoneCompressor
    dcn = NoneCompressor

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


def is_hier_legs(compression) -> bool:
    return getattr(compression, "wire_format", "") == "hier_legs"


def hier_leg_compressor(ici, dcn):
    """Memoized per-leg codec class, registered on :class:`Compression`
    under its ``__name__`` (``Hier<ici>Dcn<dcn>``, the JAX package's
    name).  The ICI leg must be none/fp16/bf16, and per-leg codecs do
    not nest."""
    ici = parse_compression(ici)
    dcn = parse_compression(dcn)
    if is_hier_legs(ici) or is_hier_legs(dcn):
        raise ValueError("per-leg codecs do not nest")
    if getattr(ici, "wire_format", ""):
        raise ValueError(
            f"ICI leg codec must be psum-compatible (none|fp16|bf16), "
            f"got {ici.__name__}")
    name = f"Hier{ici.__name__}Dcn{dcn.__name__}"
    cls = getattr(Compression, name, None)
    if cls is None:
        cls = type(name, (_HierLegCompressor,), {"ici": ici, "dcn": dcn})
        setattr(Compression, name, cls)
    return cls


def is_error_feedback(compression) -> bool:
    """True for codecs whose exchange needs error-feedback residual
    state (PowerSGD, top-k); a per-leg codec is one iff its DCN leg is."""
    if is_hier_legs(compression):
        return is_error_feedback(compression.dcn)
    return is_powersgd(compression) or is_topk(compression)


def _fraction_token(fraction: float) -> str:
    # "0.01" -> "0p01", "1e-05" -> "1em05": a valid identifier that
    # resolve_compressor_name can invert.
    return ("%g" % fraction).replace(".", "p").replace("-", "m")


def _parse_fraction_token(token: str) -> float:
    return float(token.replace("p", ".").replace("m", "-"))


def powersgd_compressor(rank: int):
    """Memoized rank-``rank`` PowerSGD codec class, registered on
    :class:`Compression` under its ``__name__`` (``PowerSGD<r>Compressor``,
    the JAX package's name)."""
    rank = int(rank)
    if rank < 1:
        raise ValueError(f"powersgd rank must be >= 1, got {rank}")
    name = f"PowerSGD{rank}Compressor"
    cls = getattr(Compression, name, None)
    if cls is None:
        cls = type(name, (_ErrorFeedbackCompressor,),
                   {"wire_format": "powersgd", "rank": rank})
        setattr(Compression, name, cls)
    return cls


def topk_compressor(fraction: float):
    """Memoized top-``fraction`` codec class (``TopK<f>Compressor``),
    registered on :class:`Compression` like :func:`powersgd_compressor`;
    ``fraction`` in (0, 1]."""
    fraction = float(fraction)
    if not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"topk fraction must be in (0, 1], got {fraction}")
    name = f"TopK{_fraction_token(fraction)}Compressor"
    cls = getattr(Compression, name, None)
    if cls is None:
        cls = type(name, (_ErrorFeedbackCompressor,),
                   {"wire_format": "topk", "fraction": fraction})
        setattr(Compression, name, cls)
    return cls


def resolve_compressor_name(name: str):
    """Codec class from its ``__name__``: a builtin or already made
    codec off :class:`Compression`, else a parameterized one re-derived
    from the parameters its name encodes."""
    for c in vars(Compression).values():
        if isinstance(c, type) and c.__name__ == name:
            return c
    m = re.fullmatch(r"PowerSGD(\d+)Compressor", name)
    if m:
        return powersgd_compressor(int(m.group(1)))
    m = re.fullmatch(r"TopK(.+)Compressor", name)
    if m:
        return topk_compressor(_parse_fraction_token(m.group(1)))
    m = re.fullmatch(r"Hier(.+?)Dcn(.+)", name)
    if m:
        return hier_leg_compressor(resolve_compressor_name(m.group(1)),
                                   resolve_compressor_name(m.group(2)))
    raise KeyError(f"unknown compressor {name!r}")


def parse_compression(spec):
    """``HOROVOD_COMPRESSION`` spec -> codec class.

    Accepts ``none``/``fp16``/``bf16``/``fp8``, ``powersgd:<rank>`` and
    ``topk:<fraction>``; a codec class passes through unchanged and
    ``None`` means no compression.  A per-leg spec names a codec per hop
    of the two-level exchange, e.g. ``ici:none,dcn:fp8`` (an omitted leg
    is ``none``).  Anything else raises ``ValueError``, as in the JAX
    package.
    """
    if spec is None:
        return Compression.none
    if isinstance(spec, type):
        return spec
    s = str(spec).strip().lower()
    if "ici:" in s or "dcn:" in s:
        legs = {}
        for part in s.split(","):
            leg, sep, sub = part.strip().partition(":")
            if leg not in ("ici", "dcn") or not sep:
                raise ValueError(
                    f"bad per-leg compression spec {spec!r}: expected "
                    f"comma-separated ici:<codec>,dcn:<codec> entries")
            if leg in legs:
                raise ValueError(
                    f"bad per-leg compression spec {spec!r}: duplicate "
                    f"{leg} leg")
            legs[leg] = sub
        return hier_leg_compressor(legs.get("ici", "none"),
                                   legs.get("dcn", "none"))
    plain = {"none": Compression.none, "fp16": Compression.fp16,
             "bf16": Compression.bf16, "fp8": Compression.fp8}
    if s in plain:
        return plain[s]
    kind, sep, arg = s.partition(":")
    if sep:
        try:
            if kind == "powersgd":
                return powersgd_compressor(int(arg))
            if kind == "topk":
                return topk_compressor(float(arg))
        except ValueError as e:
            raise ValueError(f"bad compression spec {spec!r}: {e}") from None
    raise ValueError(
        f"bad compression spec {spec!r}: expected none|fp16|bf16|fp8|"
        f"powersgd:<rank>|topk:<fraction>|ici:<codec>,dcn:<codec>")


def powersgd_matrix_shape(size: int) -> Tuple[int, int]:
    """Near-square matricization of a flat bucket: ``m = ceil(sqrt(size))``
    rows, ``c = ceil(size / m)`` columns (zero-padded to ``m * c``)."""
    size = int(size)
    if size < 1:
        raise ValueError(f"bucket size must be >= 1, got {size}")
    m = int(math.ceil(math.sqrt(size)))
    c = int(math.ceil(size / m))
    return m, c


def powersgd_effective_rank(size: int, rank: int) -> int:
    m, c = powersgd_matrix_shape(size)
    return max(1, min(int(rank), m, c))


def powersgd_factor_widths(size: int, rank: int) -> Tuple[int, int]:
    """Flat widths of the (P, Q) factors a rank-``rank`` exchange puts on
    the wire for a ``size``-element bucket: ``(r_eff * m, r_eff * c)``."""
    m, c = powersgd_matrix_shape(size)
    r = powersgd_effective_rank(size, rank)
    return r * m, r * c


def topk_count(size: int, fraction: float) -> int:
    """Number of (value, index) pairs a top-``fraction`` exchange keeps:
    ``max(1, ceil(size * fraction))``."""
    return max(1, int(math.ceil(int(size) * float(fraction))))


def wire_payload_bytes(compression, size: int, itemsize: int = 4,
                       world: int = 1) -> int:
    """Allreduce-equivalent on-wire payload of one exchange of a
    ``size``-element bucket of ``itemsize``-byte elements (the JAX
    package's accounting):

    * cast codecs: the whole bucket at the wire itemsize;
    * fp8: one byte an element (the f32 scales are left out);
    * PowerSGD: the P and Q factor allreduces, ``r*m + r*c`` f32
      elements;
    * top-k: ``k`` f32 values and ``k`` int32 indices allgathered, at
      half weight (an allgather moves half the link bytes of an
      allreduce of the same payload): ``8k / 2``;
    * per-leg codecs (``world`` is then the ICI extent): the whole
      bucket at the ICI codec's width plus the ``ceil(size / world)``
      shard at the DCN codec's.
    """
    size = int(size)
    if size < 1:
        return 0
    if is_hier_legs(compression):
        n_ici = max(int(world), 1)
        shard = max(1, (size + n_ici - 1) // n_ici)
        return (wire_payload_bytes(compression.ici, size, itemsize)
                + wire_payload_bytes(compression.dcn, shard, itemsize))
    if is_powersgd(compression):
        pw, qw = powersgd_factor_widths(size, compression.rank)
        return 4 * (pw + qw)
    if is_topk(compression):
        return 8 * topk_count(size, compression.fraction) // 2
    if is_fp8(compression):
        return size
    wd = getattr(compression, "wire_dtype", None)
    wire_itemsize = itemsize if wd is None else min(itemsize, wd.itemsize)
    return size * wire_itemsize


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16,bf16,fp8}`` plus
    the parameterized factories ``powersgd(rank)``, ``topk(fraction)``
    and ``hier(ici, dcn)`` (instantiated classes are registered here by
    name)."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    fp8 = FP8Compressor
    powersgd = staticmethod(powersgd_compressor)
    topk = staticmethod(topk_compressor)
    hier = staticmethod(hier_leg_compressor)
