"""The ported kernels (CUDA, built on first use) and their plain versions:
attention, the BatchNorm backward, and the PowerSGD exchange's three
stages (``fused_update``)."""

from .attention import (attention_reference, decode_attention,  # noqa: F401
                        flash_attention, paged_decode_attention)
from .bn import (BatchNorm, batch_stats, bn_train,  # noqa: F401
                 fused_bn_backward)
from .registry import (KERNEL_CONTRACTS, launch_counts,  # noqa: F401
                       reset_launch_counts)
