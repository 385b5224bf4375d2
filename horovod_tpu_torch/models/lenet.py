"""LeNet-5 (MNIST) in PyTorch, NHWC as the flax one.

Counterpart of ``horovod_tpu/models/lenet.py``; parity workload of the
reference's ``examples/pytorch_mnist.py`` CPU config (BASELINE.json
configs[0]).  VALID convolutions and 2x2/2 max-pools, f32, flax's
submodule names (``Conv_0``, ``Conv_1``, ``Dense_0..2``), and the
flatten in NHWC order, so a flax checkpoint converts through
:func:`~horovod_tpu_torch.models.convert.resnet_state_from_jax`, and
:func:`~horovod_tpu_torch.models.layers.init_params` draws its weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from .layers import Conv, Dense, max_pool


class LeNet(nn.Module):
    """``[N, 28, 28, 1]`` images -> ``[N, num_classes]`` logits."""

    def __init__(self, num_classes: int = 10, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.Conv_0 = Conv(1, 6, (5, 5), padding="VALID", device=dev)
        self.Conv_1 = Conv(6, 16, (5, 5), padding="VALID", device=dev)
        self.Dense_0 = Dense(4 * 4 * 16, 120, device=dev)
        self.Dense_1 = Dense(120, 84, device=dev)
        self.Dense_2 = Dense(84, num_classes, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(F.relu(self.Conv_0(x)), (2, 2), (2, 2))
        x = max_pool(F.relu(self.Conv_1(x)), (2, 2), (2, 2))
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
