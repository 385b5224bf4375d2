"""Carry flax weights across into the port.

A flax ``LlamaLM`` param tree (``{"params": {"layer_0": {"attn": {"wq":
{"kernel": ...}}}, "tok_embed": ..., "final_norm": {"scale": ...}}}``),
given as numpy arrays, becomes the port's flat ``{dotted name: tensor}``
dict.  Both sides keep ``Dense`` kernels ``[in, out]``, so the
conversion is a rename: no transpose, no reshape.  A LoRA model's
``lora_a`` ``[in, r]`` / ``lora_b`` ``[r, out]`` leaves carry across the
same way, under ``...wq.lora_a`` etc., and stay f32.

A flax ResNet's or LeNet's ``{"params": ..., "batch_stats": ...}``
becomes a ``state_dict`` through :func:`resnet_state_from_jax`: the same
rename, plus HWIO -> OIHW for the 4-D convolution kernels; the
``batch_stats`` ``mean``/``var`` leaves become the BatchNorm buffers of
the same dotted names.
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


def resnet_state_from_jax(variables: Mapping[str, Any], *,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` of a ResNet or LeNet (numpy
    leaves) -> the port model's ``state_dict``.

    Convolution kernels go from flax's HWIO to the port's OIHW; ``Dense``
    kernels stay ``[in, out]``; ``batch_stats/<site>/{mean,var}`` become
    the buffers ``<site>.mean`` / ``<site>.var``.  Every tensor is an
    explicit copy: nothing aliases the caller's arrays.
    """
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for name, leaf in _flatten(variables.get(collection, {})).items():
            a = np.array(leaf, copy=True)
            if name.rsplit(".", 1)[-1] == "kernel" and a.ndim == 4:
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            out[name] = torch.tensor(a, device=dev)
    return out
