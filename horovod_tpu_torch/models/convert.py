"""Carry flax Llama weights across into the port.

A flax ``LlamaLM`` param tree (``{"params": {"layer_0": {"attn": {"wq":
{"kernel": ...}}}, "tok_embed": ..., "final_norm": {"scale": ...}}}``),
given as numpy arrays, becomes the port's flat ``{dotted name: tensor}``
dict.  Both sides keep ``Dense`` kernels ``[in, out]``, so the
conversion is a rename: no transpose, no reshape.  A LoRA model's
``lora_a`` ``[in, r]`` / ``lora_b`` ``[r, out]`` leaves carry across the
same way, under ``...wq.lora_a`` etc., and stay f32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, name))
        else:
            out[name] = val
    return out


def params_from_jax(tree_of_numpy: Mapping[str, Any], *,
                    dtype: Optional[torch.dtype] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax ``LlamaLM`` params (numpy leaves, with or without the
    ``"params"`` wrapper) -> the port's flat param dict.

    ``dtype`` (optional) is the storage dtype for the ``Dense`` kernels;
    the embedding and norm scales keep their own dtype, as in
    :func:`~horovod_tpu_torch.models.transformer.init_llama_params`.
    Every tensor is an explicit copy: nothing aliases the caller's
    arrays.
    """
    dev = resolve_device(device)
    tree = tree_of_numpy.get("params", tree_of_numpy)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree).items():
        t = torch.tensor(np.asarray(leaf), device=dev)
        if dtype is not None and name.endswith(".kernel"):
            t = t.to(dtype)
        out[name] = t
    return out
