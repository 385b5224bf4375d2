"""Attention kernels (CUDA, built on first use) and their plain versions."""

from .attention import (attention_reference, decode_attention,  # noqa: F401
                        flash_attention, paged_decode_attention)
from .registry import (KERNEL_CONTRACTS, launch_counts,  # noqa: F401
                       reset_launch_counts)
