"""flax-compatible convolution layers for the port's vision models.

Activations are carried NHWC, as flax carries them.  :class:`Conv` hands
``F.conv2d`` the ``x.permute(0, 3, 1, 2)`` view -- an NCHW-shaped tensor
in channels-last memory, so no copy -- and permutes its (channels-last)
output back, so the next layer again sees a contiguous NHWC tensor, and
a BatchNorm after it the contiguous ``[N*H*W, C]`` view its kernels
take.

``padding="SAME"`` is flax's (and XLA's): the total padding ``max((out -
1) * stride + k - in, 0)`` is split ``(total // 2, total - total // 2)``,
more at the bottom and right.  A symmetric ``padding=k // 2`` gives the
same output shape but another convolution, so SAME is applied with
``F.pad`` before a ``padding=0`` convolution (or pool, padded with
-inf).

Parameters keep flax's names and f32: a ``Conv`` kernel is stored OIHW
(the flax HWIO kernel transposed), a ``Dense`` kernel ``[in, out]`` as
flax stores it.  :func:`init_params` draws them with flax's
initialisers from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..ops.bn import BatchNorm
from .transformer import _lecun_normal_

Pair = Tuple[int, int]


def _pair(v: Union[int, Sequence[int]]) -> Pair:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def same_pads(size: int, k: int, stride: int) -> Pair:
    """flax / XLA ``SAME`` padding of one spatial dim: ``(before,
    after)``, the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Pair, strides: Pair,
             value: float = 0.0) -> torch.Tensor:
    """Pad NHWC ``x`` to flax's SAME for ``kernel`` / ``strides``."""
    top, bottom = same_pads(x.shape[1], kernel[0], strides[0])
    left, right = same_pads(x.shape[2], kernel[1], strides[1])
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom), value=value)
    return x


def max_pool(x: torch.Tensor, window: Union[int, Sequence[int]],
             strides: Union[int, Sequence[int]],
             padding: str = "VALID") -> torch.Tensor:
    """``flax.linen.max_pool`` on NHWC ``x``; SAME pads with -inf."""
    window, strides = _pair(window), _pair(strides)
    if padding == "SAME":
        x = pad_same(x, window, strides, value=-math.inf)
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r} not in ('SAME', 'VALID')")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NHWC input: ``kernel`` (OIHW, f32), optional
    ``bias``; input and kernel are cast to ``dtype`` (x's when ``None``)
    and the convolution runs in it."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1, *,
                 padding: str = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r} not in ('SAME', "
                             f"'VALID')")
        dev = resolve_device(device)
        self.kernel_size, self.strides = _pair(kernel_size), _pair(strides)
        self.padding, self.dtype = padding, dtype
        self.kernel = nn.Parameter(torch.zeros(
            features, in_features, *self.kernel_size, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev)) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        if self.padding == "SAME":
            x = pad_same(x, self.kernel_size, self.strides)
        # One cast-and-relayout of the kernel, so cuDNN finds input and
        # kernel both channels-last and the output comes back so too.
        w = self.kernel.to(dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.strides)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ kernel + bias`` in ``dtype`` (x's when
    ``None``), ``kernel`` ``[in, out]`` and ``bias`` f32."""

    def __init__(self, in_features: int, features: int, *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                               device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        return x.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


def init_params(model: nn.Module, *,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` drawn with flax's initialisers:
    ``lecun_normal`` (truncated normal, variance ``1 / fan_in``) for every
    ``Conv`` and ``Dense`` kernel (a conv's fan_in is ``in * kh * kw``),
    zeros for their biases; for every ``BatchNorm`` its ``scale_init``,
    zero bias, zero running mean and unit running var.  ``generator``
    must live on the model's device; ``model`` itself is left as it is.
    """
    out: Dict[str, torch.Tensor] = {}
    for prefix, mod in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(mod, (Conv, Dense)):
            k = torch.empty_like(mod.kernel)
            fan_in = k.shape[0] if isinstance(mod, Dense) else \
                math.prod(k.shape[1:])
            _lecun_normal_(k, generator, fan_in=fan_in)
            out[p + "kernel"] = k
            if mod.bias is not None:
                out[p + "bias"] = torch.zeros_like(mod.bias)
        elif isinstance(mod, BatchNorm):
            out[p + "scale"] = torch.full_like(mod.scale, mod.scale_init)
            out[p + "bias"] = torch.zeros_like(mod.bias)
            out[p + "mean"] = torch.zeros_like(mod.mean)
            out[p + "var"] = torch.ones_like(mod.var)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"init_params: no initialiser for "
                         f"{sorted(missing)}")
    return out
