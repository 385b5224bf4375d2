"""The ported kernel families and their launch counters.

Counterpart of ``horovod_tpu/ops/pallas.py::KERNEL_CONTRACTS``.  Each
family names the CUDA source that implements it and the TPU kernel it
replaces, and carries a plain-int launch counter: the wrapper adds one
where it launches the kernel and nowhere else, so a run can show that
its main path really went through the kernel.

There is no switch between kernel and plain version here: a CUDA tensor
goes through the kernel (or the wrapper raises), a CPU tensor through
the plain PyTorch version, and ``force_reference=True`` is the one
explicit way to call the plain version on the GPU.
"""

from __future__ import annotations

from typing import Dict

KERNEL_CONTRACTS = {
    "flash": {
        "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
        "site": "ops.attention.flash_attention",
        "replaces": "horovod_tpu/ops/attention.py::_flash_fwd",
        "note": "FlashAttention-2 forward (O and logsumexp); forward only",
    },
    "flash_decode": {
        "source": "horovod_tpu_torch/ops/csrc/flash_decode.cu",
        "site": "ops.attention.paged_decode_attention / decode_attention",
        "replaces": "horovod_tpu/ops/attention.py::_flash_decode",
        "note": "split-KV single-token attention read through the page "
                "table, plus a log-sum-exp merge pass",
    },
}

_launches: Dict[str, int] = {name: 0 for name in KERNEL_CONTRACTS}


def note_launch(family: str) -> None:
    """Count one kernel launch of ``family`` (called by its wrapper)."""
    _launches[family] += 1


def launches(family: str) -> int:
    return _launches[family]


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0

