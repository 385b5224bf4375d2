"""Carry flax weights across into the port.

A flax ``LlamaLM`` param tree (``{"params": {"layer_0": {"attn": {"wq":
{"kernel": ...}}}, "tok_embed": ..., "final_norm": {"scale": ...}}}``),
given as numpy arrays, becomes the port's flat ``{dotted name: tensor}``
dict.  Both sides keep ``Dense`` kernels ``[in, out]``, so the
conversion is a rename: no transpose, no reshape.  A LoRA model's
``lora_a`` ``[in, r]`` / ``lora_b`` ``[r, out]`` leaves carry across the
same way, under ``...wq.lora_a`` etc., and stay f32.  An int8 base
(``base_dtype="int8"``) carries its ``kernel_q8`` / ``tok_embed_q8``
nodes across as ``...wq.kernel_q8.q`` (int8) and ``...wq.kernel_q8.scale``
(f32), untouched by ``dtype``.  A flax ``Bert``
tree (``layer_{i}.wq.kernel`` / ``.bias``, the LayerNorms' ``scale`` /
``bias``, ``tok_embed``, ``pos_embed``, ``type_embed``) goes through
:func:`params_from_jax` the same way, into ``Bert.from_params``.

A flax convolutional model's ``{"params": ..., "batch_stats": ...}``
(ResNet, LeNet, VGG, Inception-v3) becomes a ``state_dict`` through
:func:`flax_state_from_jax` (:func:`resnet_state_from_jax` is the same
function under its older name): the same rename, plus HWIO -> OIHW for
the 4-D convolution kernels; the ``batch_stats`` ``mean``/``var`` leaves
become the BatchNorm buffers of the same dotted names.

:func:`flax_leaf_order`, :func:`to_flax_layout` and
:func:`from_flax_layout` go the other way for code that must see the
port's parameters as the JAX package sees its own -- the PowerSGD
exchange, whose matricized bucket IS the matrix it approximates: the
order in which ``jax.tree.leaves`` visits a flax tree (keys sorted at
every level) and flax's HWIO layout of a 4-D kernel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

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
    """Flax ``LlamaLM`` or ``Bert`` params (numpy leaves, with or without
    the ``"params"`` wrapper) -> the port's flat param dict.

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


def flax_state_from_jax(variables: Mapping[str, Any], *,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Any flax ``{"params", "batch_stats"}`` tree of a convolutional
    model -- ResNet, LeNet, VGG, Inception-v3 (numpy leaves) -- -> the
    port model's ``state_dict``.

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


def resnet_state_from_jax(variables: Mapping[str, Any], *,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, torch.Tensor]:
    """A flax ResNet's or LeNet's variables -> the port model's
    ``state_dict``: :func:`flax_state_from_jax`."""
    return flax_state_from_jax(variables, device=device)


def flax_leaf_order(names: Sequence[str]) -> List[int]:
    """Positions of ``names`` (flax dotted paths, e.g.
    ``BottleneckBlock_10.Conv_0.kernel``) in the order ``jax.tree.leaves``
    visits the flax tree they name: dict keys sorted at every level, so
    ``BottleneckBlock_10`` comes before ``BottleneckBlock_2`` and
    ``conv_init`` after every capitalised name."""
    return sorted(range(len(names)), key=lambda i: tuple(names[i].split(".")))


def _is_conv_kernel(name: str, t: torch.Tensor) -> bool:
    return t.dim() == 4 and name.rsplit(".", 1)[-1] == "kernel"


def to_flax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of the port's tensor ``name`` in flax's layout: HWIO for a
    4-D ``.kernel`` (the port's OIHW), ``t`` itself otherwise."""
    return t.permute(2, 3, 1, 0) if _is_conv_kernel(name, t) else t


def from_flax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_flax_layout`: a view of a flax-layout
    tensor in the port's layout (OIHW for a 4-D ``.kernel``)."""
    return t.permute(3, 2, 0, 1) if _is_conv_kernel(name, t) else t
