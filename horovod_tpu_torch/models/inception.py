"""Inception-v3 in PyTorch, NHWC and bf16-first, as the flax one.

Counterpart of ``horovod_tpu/models/inception.py``: ``ConvBN``, the
``InceptionA``-``E`` blocks and ``InceptionV3`` with its optional
auxiliary head.  The original architecture (Szegedy et al. 2015): 299 x
299 input, factorized 7x7 branches, grid reductions 35 -> 17 -> 8 and
2048 channels at the end.

Every convolution is followed by a BatchNorm (the ``ConvBN`` unit:
bias-free conv, :class:`~horovod_tpu_torch.ops.bn.BatchNorm` at momentum
0.9 and epsilon 1e-3, ReLU), so the classifier has 94 BN sites (96 with
the auxiliary head) and every one runs the BN backward kernels in train
mode, at widths from 32 to 448 channels and from 710,432 rows (the stem
at batch 32) down to 2,048 (the 8 x 8 grid).

What carries over from flax, and how:

* Pools.  ``max_pool`` with VALID padding in the stem and the grid
  reductions; the branch pools are ``avg_pool`` 3x3/1 SAME, which divides
  every window by 9, the padded zeros included (flax's
  ``count_include_pad=True``), so border outputs differ from a pool that
  skips the padding.
* Padding.  Convolutions are SAME unless stated, with flax's asymmetric
  split, which for the ``(1, 7)`` and ``(7, 1)`` kernels pads 3 on both
  sides of one axis and nothing on the other.
* Concatenations.  Along the channel axis, in flax's branch order (the
  1x1 branch first, the pool branch last).  A concatenation's backward
  hands each branch a strided slice of the gradient; the ReLU after each
  BN turns it into a contiguous gradient before the BN kernels see it.
* Names.  flax's automatic names -- ``ConvBN_0..4`` in the stem,
  ``InceptionA_0..2``, ``InceptionB_0``, ``InceptionC_0..3``,
  ``InceptionD_0``, ``InceptionE_0..1``, each holding ``ConvBN_<i>``
  (``Conv_0``, ``BatchNorm_0``) in call order, ``ConvBN_5..6`` and
  ``aux_head`` for the auxiliary head, ``Dense_0`` -- so a flax
  checkpoint converts through
  :func:`~horovod_tpu_torch.models.convert.flax_state_from_jax`.
* The auxiliary head's second convolution covers the whole 5 x 5 grid at
  299 (flax sizes it from its input), so the model is built for one
  ``image_size``; at 75 x 75 the 17 x 17 grid is 3 x 3 and no auxiliary
  head fits.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.bn import BatchNorm
from .layers import Conv, Dense, Dropout, avg_pool, max_pool


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU (the Inception "BasicConv2d")."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=(1, 1), padding: str = "SAME", *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides,
                           padding=padding, use_bias=False, dtype=dtype,
                           device=device)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-3,
                                     dtype=dtype, device=device)
        self.out_features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Block(nn.Module):
    """An Inception block: its ``ConvBN_<i>`` units, named in flax's
    call order."""

    def __init__(self, cbn, in_features: int,
                 units: Sequence[Tuple[Optional[int], int, tuple, tuple,
                                       str]]):
        """``units``: ``(input unit or None for the block input, features,
        kernel, strides, padding)`` for each ``ConvBN``, in call order."""
        super().__init__()
        for i, (src, features, kernel, strides, padding) in enumerate(
                units):
            fin = in_features if src is None else \
                self.unit(src).out_features
            self.add_module(f"ConvBN_{i}", cbn(fin, features, kernel,
                                               strides, padding))

    def unit(self, i: int) -> ConvBN:
        return getattr(self, f"ConvBN_{i}")


def _same(features, kernel, src=None):
    return (src, features, kernel, (1, 1), "SAME")


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int, cbn):
        super().__init__(cbn, in_features, [
            _same(64, (1, 1)),
            _same(48, (1, 1)), _same(64, (5, 5), 1),
            _same(64, (1, 1)), _same(96, (3, 3), 3), _same(96, (3, 3), 4),
            _same(pool_features, (1, 1))])
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b5 = u(2)(u(1)(x))
        b3 = u(5)(u(4)(u(3)(x)))
        bp = u(6)(avg_pool(x, 3, 1, "SAME"))
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, in_features: int, cbn):
        super().__init__(cbn, in_features, [
            (None, 384, (3, 3), (2, 2), "VALID"),
            _same(64, (1, 1)), _same(96, (3, 3), 1),
            (2, 96, (3, 3), (2, 2), "VALID")])
        self.out_features = 384 + 96 + in_features

    def forward(self, x):
        u = self.unit
        b3 = u(0)(x)
        bd = u(3)(u(2)(u(1)(x)))
        bp = max_pool(x, 3, 2, "VALID")
        return torch.cat([b3, bd, bp], dim=-1)


class InceptionC(_Block):
    """Factorized 7x7 branches at 17x17."""

    def __init__(self, in_features: int, channels_7x7: int, cbn):
        c7 = channels_7x7
        super().__init__(cbn, in_features, [
            _same(192, (1, 1)),
            _same(c7, (1, 1)), _same(c7, (1, 7), 1), _same(192, (7, 1), 2),
            _same(c7, (1, 1)), _same(c7, (7, 1), 4), _same(c7, (1, 7), 5),
            _same(c7, (7, 1), 6), _same(192, (1, 7), 7),
            _same(192, (1, 1))])
        self.out_features = 4 * 192

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b7 = u(3)(u(2)(u(1)(x)))
        bd = u(8)(u(7)(u(6)(u(5)(u(4)(x)))))
        bp = u(9)(avg_pool(x, 3, 1, "SAME"))
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, in_features: int, cbn):
        super().__init__(cbn, in_features, [
            _same(192, (1, 1)), (0, 320, (3, 3), (2, 2), "VALID"),
            _same(192, (1, 1)), _same(192, (1, 7), 2),
            _same(192, (7, 1), 3), (4, 192, (3, 3), (2, 2), "VALID")])
        self.out_features = 320 + 192 + in_features

    def forward(self, x):
        u = self.unit
        b3 = u(1)(u(0)(x))
        b7 = u(5)(u(4)(u(3)(u(2)(x))))
        bp = max_pool(x, 3, 2, "VALID")
        return torch.cat([b3, b7, bp], dim=-1)


class InceptionE(_Block):
    """Expanded filter banks at 8x8 (2048 channels out)."""

    def __init__(self, in_features: int, cbn):
        super().__init__(cbn, in_features, [
            _same(320, (1, 1)),
            _same(384, (1, 1)), _same(384, (1, 3), 1), _same(384, (3, 1), 1),
            _same(448, (1, 1)), _same(384, (3, 3), 4),
            _same(384, (1, 3), 5), _same(384, (3, 1), 5),
            _same(192, (1, 1))])
        self.out_features = 320 + 2 * 768 + 192

    def forward(self, x):
        u = self.unit
        b1 = u(0)(x)
        b3 = u(1)(x)
        b3 = torch.cat([u(2)(b3), u(3)(b3)], dim=-1)
        bd = u(5)(u(4)(x))
        bd = torch.cat([u(6)(bd), u(7)(bd)], dim=-1)
        bp = u(8)(avg_pool(x, 3, 1, "SAME"))
        return torch.cat([b1, b3, bd, bp], dim=-1)


def _valid(side: int, k: int, s: int = 1) -> int:
    return (side - k) // s + 1


class InceptionV3(nn.Module):
    """Inception-v3 on NHWC images ``[N, image_size, image_size,
    in_channels]``; returns f32 logits ``[N, num_classes]``, and in train
    mode with ``aux_logits=True`` the pair ``(logits, aux_logits)`` (the
    auxiliary head on the 17 x 17 grid)."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 299,
                 in_channels: int = 3, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.aux_logits = dtype, aux_logits
        cbn = partial(ConvBN, dtype=dtype, device=dev)
        self.ConvBN_0 = cbn(in_channels, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = cbn(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = cbn(32, 64, (3, 3))
        self.ConvBN_3 = cbn(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = cbn(80, 192, (3, 3), padding="VALID")
        self.InceptionA_0 = InceptionA(192, 32, cbn)
        self.InceptionA_1 = InceptionA(256, 64, cbn)
        self.InceptionA_2 = InceptionA(288, 64, cbn)
        self.InceptionB_0 = InceptionB(288, cbn)
        self.InceptionC_0 = InceptionC(768, 128, cbn)
        self.InceptionC_1 = InceptionC(768, 160, cbn)
        self.InceptionC_2 = InceptionC(768, 160, cbn)
        self.InceptionC_3 = InceptionC(768, 192, cbn)
        if aux_logits:
            # The 17 x 17 grid's side at this image size.
            side = _valid(_valid(_valid(_valid(_valid(
                image_size, 3, 2), 3), 3, 2), 3), 3, 2)
            side = _valid(_valid(side, 3, 2), 5, 3)
            self.ConvBN_5 = cbn(768, 128, (1, 1))
            self.ConvBN_6 = cbn(128, 768, (side, side), padding="VALID")
            self.aux_head = Dense(768, num_classes, dtype=dtype, device=dev)
        self.InceptionD_0 = InceptionD(768, cbn)
        self.InceptionE_0 = InceptionE(1280, cbn)
        self.InceptionE_1 = InceptionE(2048, cbn)
        self.Dropout_0 = Dropout(dropout_rate)
        self.Dense_0 = Dense(2048, num_classes, dtype=dtype, device=dev)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = max_pool(x, 3, 2, "VALID")
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = max_pool(x, 3, 2, "VALID")
        for name in ("InceptionA_0", "InceptionA_1", "InceptionA_2",
                     "InceptionB_0", "InceptionC_0", "InceptionC_1",
                     "InceptionC_2", "InceptionC_3"):
            x = getattr(self, name)(x)
        aux = None
        if self.aux_logits and self.training:
            a = self.ConvBN_6(self.ConvBN_5(avg_pool(x, 5, 3, "VALID")))
            aux = self.aux_head(a.reshape(a.shape[0], -1)).float()
        for name in ("InceptionD_0", "InceptionE_0", "InceptionE_1"):
            x = getattr(self, name)(x)
        x = self.Dropout_0(x.mean(dim=(1, 2)), dropout_generator)
        x = self.Dense_0(x).float()
        return (x, aux) if aux is not None else x
