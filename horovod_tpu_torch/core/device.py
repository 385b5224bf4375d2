"""Device resolution for the package's entry points.

Every entry point (``ServingEngine``, ``init_llama_params``, the kernel
wrappers) runs on the GPU unless its caller asks for the CPU by name.
With no GPU present and no explicit ``device="cpu"``, they raise: the
package never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device needs a visible GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
