"""Device resolution for the package's entry points.

Every entry point (``ServingEngine``, ``init_llama_params``, the kernel
wrappers) runs on the GPU unless its caller asks for the CPU by name --
``device="cpu"``, or the launcher's ``--cpu``, which sets
``HVD_TPU_FORCE_CPU=1`` in its workers.  With no GPU present and neither,
they raise: the package never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda`` (``cpu`` when ``HVD_TPU_FORCE_CPU`` is
    set); a CUDA device needs a visible GPU."""
    if device is None:
        from .config import _env_bool
        device = "cpu" if _env_bool("FORCE_CPU") else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
