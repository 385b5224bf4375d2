"""VGG-16/19 in PyTorch, NHWC and bf16-first, as the flax one.

Counterpart of ``horovod_tpu/models/vgg.py``: ``VGG``, ``VGG16`` and
``VGG19``.  VGG-16 is the reference's comm-bound workload: 138,357,544
parameters at 1000 classes, 102,764,544 of them in the first ``Dense``
layer, so a step sends 553 MB of f32 gradients through the fusion
planner, one tensor of 411 MB.

The classic configuration (Simonyan & Zisserman 2014): 3x3 SAME
convolutions with biases, 2x2/2 max-pools, two 4096-wide ``Dense`` layers
with dropout, 224 x 224 NHWC input; no BatchNorm, so the classic model
runs none of the port's kernels.  ``batch_norm=True`` is the modern
variant: bias-free convolutions, each followed by a
:class:`~horovod_tpu_torch.ops.bn.BatchNorm` (momentum 0.9), whose
train-mode backward runs the BN kernels.

Names are flax's automatic ones -- ``Conv_0..12`` (16 layers),
``BatchNorm_i``, ``Dense_0..2`` -- so a flax checkpoint converts through
:func:`~horovod_tpu_torch.models.convert.flax_state_from_jax`.  The
flatten is in NHWC order, as flax's, so ``Dense_0``'s input width is
``512 * (image_size // 32) ** 2``: the model is built for one
``image_size``.  Dropout draws its mask from the generator given to
``forward`` (:class:`~horovod_tpu_torch.models.layers.Dropout`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.bn import BatchNorm
from .layers import Conv, Dense, Dropout, max_pool

# Channel plan per conv stage; "M" = 2x2 max-pool.
_CFG = {
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    """VGG on NHWC images ``[N, image_size, image_size, in_channels]``;
    returns f32 logits ``[N, num_classes]``."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = False, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 in_channels: int = 3, device=None):
        super().__init__()
        if depth not in _CFG:
            raise ValueError(f"VGG depth {depth} not in {sorted(_CFG)}")
        dev = resolve_device(device)
        self.dtype, self.batch_norm = dtype, batch_norm
        self.plan = []
        features, side, convs = in_channels, image_size, 0
        for item in _CFG[depth]:
            if item == "M":
                self.plan.append("M")
                side //= 2
                continue
            self.add_module(f"Conv_{convs}", Conv(
                features, item, (3, 3), use_bias=not batch_norm,
                dtype=dtype, device=dev))
            if batch_norm:
                self.add_module(f"BatchNorm_{convs}", BatchNorm(
                    item, momentum=0.9, dtype=dtype, device=dev))
            self.plan.append(convs)
            features, convs = item, convs + 1
        dense = partial(Dense, dtype=dtype, device=dev)
        self.Dense_0 = dense(features * side * side, 4096)
        self.Dense_1 = dense(4096, 4096)
        self.Dense_2 = dense(4096, num_classes)
        self.Dropout_0 = Dropout(dropout_rate)
        self.Dropout_1 = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.to(self.dtype)
        for item in self.plan:
            if item == "M":
                x = max_pool(x, (2, 2), (2, 2))
                continue
            x = getattr(self, f"Conv_{item}")(x)
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{item}")(x)
            x = F.relu(x)
        x = x.reshape(x.shape[0], -1)
        x = self.Dropout_0(F.relu(self.Dense_0(x)), dropout_generator)
        x = self.Dropout_1(F.relu(self.Dense_1(x)), dropout_generator)
        return self.Dense_2(x).float()


def VGG16(**kw) -> VGG:
    return VGG(depth=16, **kw)


def VGG19(**kw) -> VGG:
    return VGG(depth=19, **kw)
