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
* :func:`parse_compression` for ``HOROVOD_COMPRESSION`` specs, and the
  wire accounting the exchange counters use.

fp8, ``topk:<fraction>`` and the per-leg ``ici:/dcn:`` grammar are not
ported yet: their specs raise ``NotImplementedError`` (ROADMAP item 1.9).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_NOT_PORTED = ("is not ported to horovod_tpu_torch yet (ROADMAP item 1.9: "
               "fp8, topk and the ici:/dcn: per-leg codecs)")


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
    """Base for the error-feedback EXCHANGE-level codecs.

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


def is_powersgd(compression) -> bool:
    return getattr(compression, "wire_format", "") == "powersgd"


def is_error_feedback(compression) -> bool:
    """True for codecs whose exchange needs error-feedback residual
    state (PowerSGD; top-k is not ported)."""
    return is_powersgd(compression)


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


def parse_compression(spec):
    """``HOROVOD_COMPRESSION`` spec -> codec class.

    Accepts ``none``/``fp16``/``bf16`` and ``powersgd:<rank>``; a codec
    class passes through unchanged and ``None`` means no compression.
    ``fp8``, ``topk:<fraction>`` and ``ici:``/``dcn:`` specs raise
    ``NotImplementedError``.
    """
    if spec is None:
        return Compression.none
    if isinstance(spec, type):
        return spec
    s = str(spec).strip().lower()
    if "ici:" in s or "dcn:" in s or s == "fp8" or s.startswith("topk:"):
        raise NotImplementedError(f"compression {spec!r} {_NOT_PORTED}")
    plain = {"none": Compression.none, "fp16": Compression.fp16,
             "bf16": Compression.bf16}
    if s in plain:
        return plain[s]
    kind, sep, arg = s.partition(":")
    if sep and kind == "powersgd":
        try:
            return powersgd_compressor(int(arg))
        except ValueError as e:
            raise ValueError(f"bad compression spec {spec!r}: {e}") from None
    raise ValueError(
        f"bad compression spec {spec!r}: expected none|fp16|bf16|"
        f"powersgd:<rank>")


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


def wire_payload_bytes(compression, size: int, itemsize: int = 4) -> int:
    """Allreduce-equivalent on-wire payload of one exchange of a
    ``size``-element bucket of ``itemsize``-byte elements: the whole
    bucket at the wire itemsize for the cast codecs; the P and Q factor
    allreduces, ``r*m + r*c`` f32 elements, for PowerSGD."""
    size = int(size)
    if size < 1:
        return 0
    if is_powersgd(compression):
        pw, qw = powersgd_factor_widths(size, compression.rank)
        return 4 * (pw + qw)
    wd = getattr(compression, "wire_dtype", None)
    wire_itemsize = itemsize if wd is None else min(itemsize, wd.itemsize)
    return size * wire_itemsize


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16,bf16}`` plus the
    parameterized ``powersgd(rank)`` factory (instantiated classes are
    registered here by name)."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    powersgd = staticmethod(powersgd_compressor)
