"""ResNet family (v1.5) in PyTorch, NHWC and bf16-first, as the flax one.

Counterpart of ``horovod_tpu/models/resnet.py``: ``space_to_depth``,
``s2d_conv_init_kernel``, ``BottleneckBlock``, ``BasicBlock``, ``ResNet``
and the ``ResNet18/34/50/101/152`` partials.  BASELINE.json config 2,
"ResNet-50 ImageNet", is ``ResNet50(num_classes=1000, dtype=bf16,
space_to_depth=True)`` at 224 x 224.

What carries over from flax, and how:

* Layout.  Activations are NHWC end to end (see
  :mod:`~horovod_tpu_torch.models.layers`), so every BatchNorm site sees
  the contiguous ``[N*H*W, C]`` view its backward kernels take, without
  a copy.
* Padding.  Every convolution and the stem's max-pool use flax's
  asymmetric SAME padding (``(2, 3)`` for the 7x7/2 stem at 224, ``(1,
  2)`` for the s2d stem's 4x4/1, ``(0, 1)`` for each 3x3/2 and the
  3x3/2 pool).
* Mixed precision.  Parameters and BN statistics are f32; convolutions
  cast input and kernel to ``dtype`` (bf16), BN normalizes in f32 and
  returns ``dtype``, the global mean over H, W stays in ``dtype``, and
  the classifier ``Dense`` runs in f32.
* Names.  Submodules carry flax's auto names -- ``conv_init``,
  ``bn_init``, ``BottleneckBlock_<i>.{Conv_0..2, BatchNorm_0..2,
  conv_proj, norm_proj}``, ``Dense_0`` -- so a flax checkpoint converts
  by a rename and a transpose
  (:func:`~horovod_tpu_torch.models.convert.resnet_state_from_jax`).
* BatchNorm.  Every site is :class:`~horovod_tpu_torch.ops.bn.BatchNorm`
  at momentum 0.9, epsilon 1e-5: a train-mode backward through the CUDA
  kernels on the GPU.  Each block's last BN starts with scale 0.

``model.train()`` / ``model.eval()`` take the place of flax's ``train``
argument.  ``forward(x, force_reference=True)`` runs every BN backward
through the plain version instead of the kernels.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.bn import BatchNorm
from .layers import Conv, Dense, init_params, max_pool


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: ``[N,H,W,C] -> [N,H/b,W/b,b*b*C]`` with the
    (dy, dx, c) intra-block order :func:`s2d_conv_init_kernel` assumes."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               block * block * c)


def s2d_conv_init_kernel(k7: torch.Tensor) -> torch.Tensor:
    """A standard 7x7 stem kernel -> the equivalent 4x4 space-to-depth
    kernel, both in the port's OIHW layout: ``[F, C, 7, 7] -> [F, 4C, 4,
    4]``.

    The 7x7 stride-2 SAME conv on ``[N,224,224,C]`` equals a 4x4 stride-1
    SAME conv on the 2x2 space-to-depth input: pad the kernel to 8x8 on
    the bottom/right (taps the 7-tap window never covers) and fold each
    2x2 tap block into the channel dim, in (dy, dx, c) order.
    """
    f, c = k7.shape[0], k7.shape[1]
    k8 = F.pad(k7, (0, 1, 0, 1))
    k = k8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k.reshape(f, 4 * c, 4, 4)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int, strides, *, conv,
                 norm):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, (1, 1))
        self.BatchNorm_2 = norm(out, scale_init=0.0)
        # flax projects the residual when its shape differs from y's.
        self.conv_proj = self.norm_proj = None
        if tuple(strides) != (1, 1) or in_features != out:
            self.conv_proj = conv(in_features, out, (1, 1), strides)
            self.norm_proj = norm(out)
        self.out_features = out

    def forward(self, x, force_reference: bool = False):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), force_reference))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), force_reference))
        y = self.BatchNorm_2(self.Conv_2(y), force_reference)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), force_reference)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int, strides, *, conv,
                 norm):
        super().__init__()
        self.Conv_0 = conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = norm(filters, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if tuple(strides) != (1, 1) or in_features != filters:
            self.conv_proj = conv(in_features, filters, (1, 1), strides)
            self.norm_proj = norm(filters)
        self.out_features = filters

    def forward(self, x, force_reference: bool = False):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), force_reference))
        y = self.BatchNorm_1(self.Conv_1(y), force_reference)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), force_reference)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 on NHWC images ``[N, H, W, in_channels]``; returns f32
    logits ``[N, num_classes]``.  ``space_to_depth=True`` is the
    MLPerf-style stem: the 2x2 space-to-depth input and a 4x4/1
    ``conv_init`` kernel of shape ``[F, 4 * in_channels, 4, 4]``
    (:func:`s2d_conv_init_kernel` converts a standard one)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 space_to_depth: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.space_to_depth = dtype, space_to_depth
        conv = partial(Conv, use_bias=False, dtype=dtype, device=dev)
        norm = partial(BatchNorm, momentum=0.9, epsilon=1e-5, dtype=dtype,
                       device=dev)
        if space_to_depth:
            self.conv_init = conv(4 * in_channels, num_filters, (4, 4))
        else:
            self.conv_init = conv(in_channels, num_filters, (7, 7), (2, 2))
        self.bn_init = norm(num_filters)
        self.block_names = []
        features = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = block_cls(features, num_filters * 2 ** i, strides,
                                  conv=conv, norm=norm)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block)
                self.block_names.append(name)
                features = block.out_features
        # Classifier in f32 for a numerically stable softmax.
        self.Dense_0 = Dense(features, num_classes, dtype=torch.float32,
                             device=dev)

    def forward(self, x: torch.Tensor,
                force_reference: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = space_to_depth(x, 2)
        x = F.relu(self.bn_init(self.conv_init(x), force_reference))
        x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        for name in self.block_names:
            x = getattr(self, name)(x, force_reference)
        return self.Dense_0(x.mean(dim=(1, 2)))


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)


def init_resnet_params(model: ResNet, *,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights for ``model`` from ``generator`` with flax's
    initialisers (``lecun_normal`` kernels, zero biases, BN scale 1 --
    0 for each block's last -- bias 0, running mean 0 and var 1), as a
    state dict on the model's device: ``model.load_state_dict(...)``.
    The numbers differ from flax's for the same seed: the tests feed
    both packages the same converted weights instead."""
    if not isinstance(model, ResNet):
        raise TypeError(f"init_resnet_params: a ResNet, got "
                        f"{type(model).__name__}")
    return init_params(model, generator=generator)
