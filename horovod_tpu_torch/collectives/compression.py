"""Gradient compression (``hvd.Compression`` parity): the cast codecs.

Counterpart of ``horovod_tpu/collectives/compression.py``'s
``NoneCompressor`` / ``_CastCompressor`` / ``Compression``:
``Compression.fp16`` and ``Compression.bf16`` cast a floating tensor wider
than the wire type down before the allreduce and back up after, halving
the bytes on the wire for f32 gradients; anything else passes through.
fp8, PowerSGD and top-k are not ported yet.
"""

from __future__ import annotations

import torch


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


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16,bf16}``."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
