"""Llama-3 family decoder LM with LoRA adapters, in PyTorch.

Counterpart of ``horovod_tpu/models/transformer.py``: ``LlamaConfig`` and
its presets, ``Dense`` with its rank-``r`` LoRA pair, ``RMSNorm``,
``rotary_embedding``, ``LlamaLM``, and the LoRA helpers
:func:`lora_parameters` / :func:`freeze_base` (the counterparts of
``lora_mask`` / ``split_frozen``).  Parameter
names and layouts follow the flax tree exactly -- ``layer_{i}.attn.wq.
kernel`` is ``[in, out]`` as flax's ``Dense`` stores it, ``tok_embed`` is
the tied ``[vocab, d_model]`` table -- so converting a flax tree is a
rename (:mod:`horovod_tpu_torch.models.convert`), never a transpose.

Weights travel as a flat ``{dotted name: tensor}`` dict (a state dict):
:func:`init_llama_params` makes one from a ``torch.Generator``, the
serving path (``serving/decode.py``) reads it directly, and
``LlamaLM.load_state_dict`` takes it as is.

Casts mirror the flax model: ``Dense`` computes ``x.to(dtype) @
kernel.to(dtype)`` (plus ``x @ A @ B * alpha/r`` in the compute dtype with
LoRA), RMSNorm normalizes in f32, RoPE rotates in f32, and the
tied-embedding readout runs in f32.  The frozen base may be stored in the
compute dtype (bf16 on the GPU): the flax ``Dense`` casts its f32 kernel to
the compute dtype before every product, so a bf16-stored base computes the
same function and halves its memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    d_model: int = 4096
    ffn_hidden: int = 14336
    rope_theta: float = 500000.0
    max_seq_len: int = 8192


# Llama-3 8B architecture (public config: 32 layers, 32 heads / 8 KV heads,
# d_model 4096, FFN 14336, vocab 128256, rope theta 5e5).
LLAMA3_8B = LlamaConfig()
LLAMA_1B = LlamaConfig(vocab_size=32000, num_layers=16, num_heads=16,
                       num_kv_heads=8, head_dim=128, d_model=2048,
                       ffn_hidden=5632, max_seq_len=4096)
LLAMA_TINY = LlamaConfig(vocab_size=256, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=16, d_model=64,
                         ffn_hidden=128, max_seq_len=128)
# Full-MHA head counts (8 query and 8 kv heads): the serving tests' model.
LLAMA_SERVE = LlamaConfig(vocab_size=256, num_layers=2, num_heads=8,
                          num_kv_heads=8, head_dim=16, d_model=64,
                          ffn_hidden=128, max_seq_len=128)

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_LORA = ("lora_a", "lora_b")


# ---------------------------------------------------------------------------
# Shared math
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, kernel: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``Dense.__call__``: ``x.astype(dtype) @ kernel.astype(dtype)``."""
    return x.to(dtype) @ kernel.to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, dtype,
            epsilon: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + epsilon)
    return (norm * scale.float()).to(dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     theta: float = 500000.0) -> torch.Tensor:
    """Apply RoPE. x: (b, h, t, d) with even d; positions: (b, t)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def tied_readout(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x @ embed.T`` over the tied embedding, in true f32.

    The JAX readout is a full-f32 product.  On the GPU a caller's
    ``torch.backends.cuda.matmul.allow_tf32 = True`` would drop this one
    to TF32 (about three decimal digits), so TF32 is held off for it."""
    x32, e32 = x.float(), embed.float()
    if x.device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        return x32 @ e32.T
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x32 @ e32.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def default_positions(tokens: torch.Tensor,
                      segment_ids: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Positions ``0..t-1``; with packed ``segment_ids`` they restart at
    every segment boundary (``LlamaLM``'s convention)."""
    b, t = tokens.shape
    idx = torch.arange(t, device=tokens.device).expand(b, t)
    if segment_ids is None:
        return idx
    first = torch.cat(
        [torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
         segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=1).values
    return idx - seg_start


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """Bias-free linear layer with a flax-layout ``[in, out]`` kernel and,
    with ``lora_rank > 0``, a LoRA pair ``lora_a`` ``[in, r]`` and
    ``lora_b`` ``[r, out]``, kept in f32 and added as ``(x @ A @ B) *
    alpha/r`` in the compute dtype, as the flax ``Dense`` does.  Tensors
    are allocated here and filled by :func:`init_llama_params` (``lora_a``
    from normal(0.02), ``lora_b`` zero, so the adapter starts as the
    identity) or by a loaded state dict."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype=torch.float32, device=None, lora_rank: int = 0,
                 lora_alpha: float = 16.0):
        super().__init__()
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=param_dtype, device=device),
            requires_grad=False)
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_features, lora_rank, device=device))
            self.lora_b = nn.Parameter(torch.empty(
                lora_rank, out_features, device=device))

    def forward(self, x):
        y = dense(x, self.kernel, self.dtype)
        if self.lora_rank > 0:
            xd = x.to(self.dtype)
            lora = xd @ self.lora_a.to(self.dtype) @ self.lora_b.to(self.dtype)
            y = y + lora * (self.lora_alpha / self.lora_rank)
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, epsilon: float = 1e-5,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim, device=device),
                                  requires_grad=False)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.dtype, self.epsilon)


class CausalSelfAttention(nn.Module):
    """GQA causal attention with RoPE over the flash forward kernel."""

    def __init__(self, cfg: LlamaConfig, dtype, param_dtype, device=None,
                 **lora):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = Dense(d, cfg.num_heads * hd, dtype, param_dtype, device,
                        **lora)
        self.wk = Dense(d, cfg.num_kv_heads * hd, dtype, param_dtype, device,
                        **lora)
        self.wv = Dense(d, cfg.num_kv_heads * hd, dtype, param_dtype, device,
                        **lora)
        self.wo = Dense(cfg.num_heads * hd, d, dtype, param_dtype, device,
                        **lora)

    def forward(self, x, positions, segment_ids=None,
                force_reference: bool = False):
        cfg = self.cfg
        b, t, _ = x.shape
        q = self.wq(x).view(b, t, cfg.num_heads, cfg.head_dim)
        k = self.wk(x).view(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = self.wv(x).view(b, t, cfg.num_kv_heads, cfg.head_dim)
        q = rotary_embedding(q.transpose(1, 2), positions, cfg.rope_theta)
        k = rotary_embedding(k.transpose(1, 2), positions, cfg.rope_theta)
        o = flash_attention(q.contiguous(), k.contiguous(),
                            v.transpose(1, 2).contiguous(), causal=True,
                            segment_ids=segment_ids,
                            force_reference=force_reference)
        return self.wo(o.transpose(1, 2).reshape(b, t, -1))


class SwiGLU(nn.Module):
    def __init__(self, d: int, hidden: int, dtype, param_dtype,
                 device=None, **lora):
        super().__init__()
        self.w_gate = Dense(d, hidden, dtype, param_dtype, device, **lora)
        self.w_up = Dense(d, hidden, dtype, param_dtype, device, **lora)
        self.w_down = Dense(hidden, d, dtype, param_dtype, device, **lora)

    def forward(self, x):
        return self.w_down(nn.functional.silu(self.w_gate(x)) * self.w_up(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, param_dtype, device=None,
                 **lora):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, dtype, device=device)
        self.attn = CausalSelfAttention(cfg, dtype, param_dtype, device,
                                        **lora)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype, device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.ffn_hidden, dtype, param_dtype,
                          device, **lora)

    def forward(self, x, positions, segment_ids=None,
                force_reference: bool = False):
        x = x + self.attn(self.attn_norm(x), positions, segment_ids,
                          force_reference)
        return x + self.mlp(self.mlp_norm(x))


class LlamaLM(nn.Module):
    """Decoder-only LM (Llama-3 family).

    ``dtype`` is the compute dtype; ``param_dtype`` the storage dtype of
    the ``Dense`` kernels (f32 master weights by default, as in flax; the
    serving path and the LoRA trainer store the frozen base in the compute
    dtype once).  ``tok_embed`` stays f32 for the f32 tied readout.
    ``lora_rank > 0`` gives all seven projections of every layer (``wq,
    wk, wv, wo, w_gate, w_up, w_down``) a LoRA pair.  The base (kernels,
    norms, embedding) is built frozen and the adapters trainable, which
    :func:`freeze_base` re-asserts on any model.  Returns f32 logits
    ``[b, t, vocab]``.
    """

    def __init__(self, config: LlamaConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, *,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.lora_rank = lora_rank
        dev = device if str(device) == "meta" else resolve_device(device)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.tok_embed = nn.Parameter(torch.empty(
            config.vocab_size, config.d_model, device=dev),
            requires_grad=False)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}",
                            DecoderBlock(config, dtype, param_dtype, dev,
                                         **lora))
        self.final_norm = RMSNorm(config.d_model, dtype, device=dev)

    @classmethod
    def from_params(cls, config: LlamaConfig, params: Dict[str, torch.Tensor],
                    dtype=torch.float32, *, lora_rank: int = 0,
                    lora_alpha: float = 16.0) -> "LlamaLM":
        """A model that holds ``params`` (a flat dict, e.g. from
        :func:`init_llama_params`) as its parameters, without a copy:
        built on the meta device and assigned, so an 8B model never
        exists twice in device memory.  Keeps each tensor's dtype."""
        model = cls(config, dtype, device="meta", lora_rank=lora_rank,
                    lora_alpha=lora_alpha)
        model.load_state_dict(params, strict=True, assign=True)
        return model

    def forward(self, tokens, positions=None, *, segment_ids=None,
                force_reference: bool = False):
        """f32 logits; ``force_reference=True`` runs attention through the
        plain version under autograd instead of the kernels."""
        if positions is None:
            positions = default_positions(tokens, segment_ids)
        x = self.tok_embed[tokens].to(self.dtype)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x, positions, segment_ids,
                                            force_reference)
        return tied_readout(self.final_norm(x), self.tok_embed)


# ---------------------------------------------------------------------------
# Seeded random initialisation
# ---------------------------------------------------------------------------


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator,
                   fan_in: Optional[int] = None) -> None:
    """flax ``lecun_normal``: truncated normal in [-2, 2] standard
    deviations, variance ``1 / fan_in`` after truncation (fan_in defaults
    to the kernel's first dim, the ``[in, out]`` layout)."""
    fan_in = t.shape[0] if fan_in is None else fan_in
    # Std of a unit normal truncated to [-2, 2] (flax's constant).
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    t.mul_(std)


def param_shapes(config: LlamaConfig,
                 lora_rank: int = 0) -> Dict[str, tuple]:
    """Flat ``{dotted name: shape}`` of a ``LlamaLM``'s parameters; with
    ``lora_rank > 0`` each projection's ``lora_a``/``lora_b`` follow its
    kernel."""
    c = config
    hd = c.head_dim
    shapes = {"tok_embed": (c.vocab_size, c.d_model)}

    def dense(name, fan_in, fan_out):
        shapes[f"{name}.kernel"] = (fan_in, fan_out)
        if lora_rank > 0:
            shapes[f"{name}.lora_a"] = (fan_in, lora_rank)
            shapes[f"{name}.lora_b"] = (lora_rank, fan_out)

    for i in range(c.num_layers):
        p = f"layer_{i}"
        shapes[f"{p}.attn_norm.scale"] = (c.d_model,)
        dense(f"{p}.attn.wq", c.d_model, c.num_heads * hd)
        dense(f"{p}.attn.wk", c.d_model, c.num_kv_heads * hd)
        dense(f"{p}.attn.wv", c.d_model, c.num_kv_heads * hd)
        dense(f"{p}.attn.wo", c.num_heads * hd, c.d_model)
        shapes[f"{p}.mlp_norm.scale"] = (c.d_model,)
        dense(f"{p}.mlp.w_gate", c.d_model, c.ffn_hidden)
        dense(f"{p}.mlp.w_up", c.d_model, c.ffn_hidden)
        dense(f"{p}.mlp.w_down", c.ffn_hidden, c.d_model)
    shapes["final_norm.scale"] = (c.d_model,)
    return shapes


def init_llama_params(config: LlamaConfig, *, generator: torch.Generator,
                      dtype=torch.float32,
                      device: Optional[Union[str, torch.device]] = None,
                      lora_rank: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights from ``generator``, mirroring flax's initialisers:
    ``normal(0.02)`` for the embedding, ``lecun_normal`` for the ``Dense``
    kernels, ones for the norm scales; with ``lora_rank > 0``,
    ``normal(0.02)`` for ``lora_a`` and zeros for ``lora_b``, both f32.

    Kernels are drawn in f32 and stored in ``dtype`` (the serving dtype);
    the embedding and norm scales stay f32.  ``generator`` must live on
    ``device`` (``torch.Generator(device="cuda")`` for the GPU).  The
    numbers differ from flax's for the same seed: the tests feed both
    packages the same converted weights instead.
    """
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in param_shapes(config, lora_rank).items():
        if name == "tok_embed" or name.endswith(".lora_a"):
            t = torch.empty(shape, device=dev)
            t.normal_(0.0, 0.02, generator=generator)
        elif name.endswith(".lora_b"):
            t = torch.zeros(shape, device=dev)
        elif name.endswith(".scale"):
            t = torch.ones(shape, device=dev)
        else:
            t = torch.empty(shape, device=dev)
            _lecun_normal_(t, generator)
            t = t.to(dtype)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# LoRA helpers
# ---------------------------------------------------------------------------


def is_lora_name(name: str) -> bool:
    """True for a ``lora_a`` / ``lora_b`` parameter name (the JAX
    ``lora_mask`` matches the same leaf names)."""
    return name.rsplit(".", 1)[-1] in _LORA


def lora_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """``(name, parameter)`` of every LoRA adapter, in registration order
    (layer by layer, forward order): the trainable set of a LoRA
    fine-tune, ready for ``DistributedOptimizer(named_parameters=...)``."""
    return [(n, p) for n, p in model.named_parameters() if is_lora_name(n)]


def freeze_base(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """Leave only the adapters trainable: ``requires_grad`` off on every
    base parameter (kernels, norms, the embedding), on for every LoRA
    tensor -- the counterpart of ``lora_mask`` + ``split_frozen``, so
    gradients, the fused allreduce and the optimizer state span only the
    adapters.  Returns :func:`lora_parameters`."""
    for name, p in model.named_parameters():
        p.requires_grad_(is_lora_name(name))
    return lora_parameters(model)
