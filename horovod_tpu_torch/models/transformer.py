"""Llama-3 family decoder LM with LoRA adapters, and the BERT encoder,
in PyTorch.

Counterpart of ``horovod_tpu/models/transformer.py``: ``LlamaConfig`` and
its presets, ``Dense`` with its rank-``r`` LoRA pair, ``RMSNorm``,
``rotary_embedding``, ``LlamaLM``, and the LoRA helpers
:func:`lora_parameters` / :func:`freeze_base` (the counterparts of
``lora_mask`` / ``split_frozen``); ``BertConfig`` and its presets,
flax's ``LayerNorm``, ``EncoderBlock`` and ``Bert`` (MLM + NSP heads),
with :func:`init_bert_params`.  Parameter
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
same function and halves its memory.  ``base_dtype="int8"`` stores each
frozen kernel and the tied embedding at int8 with one f32 scale per
output channel (:func:`quantize_int8`, the flax ``kernel_q8`` /
``tok_embed_q8`` nodes), a quarter of the f32 base; ``remat=True``
recomputes each block in the backward (``torch.utils.checkpoint``, as
``nn.remat``).  :func:`quantize_frozen_base` and :func:`merge_lora`
convert a trained flat dict, as their JAX namesakes convert a tree.

BERT trains every tensor: its dense layers are flax's ``Dense`` with a
bias (:class:`horovod_tpu_torch.models.layers.Dense`), ``LayerNorm``
normalizes in f32 with flax's fast variance, the embeddings are summed
in f32 before the cast, and the tied MLM readout runs in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..ops.attention import flash_attention
from . import layers
from .layers import _lecun_normal_


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


def quantize_int8(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """Per-channel symmetric int8 quantization of a 2-D kernel.

    ``axis`` is the reduction axis (one scale per entry of the other
    axis: per output channel for ``axis=0``).  Returns ``{"q": int8,
    "scale": f32}`` with ``w ~= q * scale``; ``scale`` is clamped at
    1e-12 and the rounding is half-to-even, as ``jnp.round``."""
    w32 = w.float()
    # A 0-dim divisor: CUDA turns division by a Python float into a
    # multiply by its reciprocal, an ulp off now and then.
    scale = torch.clamp(w32.abs().amax(dim=axis)
                        / torch.tensor(127.0, device=w32.device), min=1e-12)
    q = torch.round(w32 / scale.unsqueeze(axis)).to(torch.int8)
    return {"q": q, "scale": scale}


class _Q8Matmul(torch.autograd.Function):
    """``(x @ q.to(dtype)) * scale.to(dtype)``, or with ``transpose``
    ``x @ q.to(dtype).T`` (no scale), saving the int8 ``q`` for the
    backward.  A plain ``x @ q.to(dtype)`` under autograd would keep the
    compute-dtype copy of every base kernel alive until the backward,
    the memory the int8 base exists to save; here the copy is made again
    in the backward.  Plain PyTorch around ``torch.matmul``: the JAX
    package leaves this product to XLA, which fuses the convert."""

    @staticmethod
    def forward(ctx, x, q, scale, dtype, transpose: bool):
        ctx.save_for_backward(q, scale)
        ctx.dtype, ctx.x_dtype, ctx.transpose = dtype, x.dtype, transpose
        w = q.to(dtype)
        y = x.to(dtype) @ (w.T if transpose else w)
        return y if scale is None else y * scale.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        q, scale = ctx.saved_tensors
        dz = dy if scale is None else dy * scale.to(ctx.dtype)
        w = q.to(ctx.dtype)
        dx = dz @ (w if ctx.transpose else w.T)
        return dx.to(ctx.x_dtype), None, None, None, None


def q8_dense(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
             dtype) -> torch.Tensor:
    """The int8 ``Dense``: ``(x.astype(dtype) @ q.astype(dtype)) *
    scale.astype(dtype)`` (:class:`_Q8Matmul`)."""
    return _Q8Matmul.apply(x, q, scale, dtype, False)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _Q8(nn.Module):
    """A frozen int8 tensor ``q`` and its f32 per-channel ``scale``: the
    flax ``kernel_q8`` / ``tok_embed_q8`` node."""

    def __init__(self, shape: Tuple[int, int], channels: int, device=None):
        super().__init__()
        self.q = nn.Parameter(torch.empty(shape, dtype=torch.int8,
                                          device=device), requires_grad=False)
        self.scale = nn.Parameter(torch.empty(channels, device=device),
                                  requires_grad=False)


class Dense(nn.Module):
    """Bias-free linear layer with a flax-layout ``[in, out]`` kernel and,
    with ``lora_rank > 0``, a LoRA pair ``lora_a`` ``[in, r]`` and
    ``lora_b`` ``[r, out]``, kept in f32 and added as ``(x @ A @ B) *
    alpha/r`` in the compute dtype, as the flax ``Dense`` does.  Tensors
    are allocated here and filled by :func:`init_llama_params` (``lora_a``
    from normal(0.02), ``lora_b`` zero, so the adapter starts as the
    identity) or by a loaded state dict.  ``base_dtype="int8"`` holds the
    frozen kernel as ``kernel_q8`` (``q`` int8 ``[in, out]``, ``scale``
    f32 ``[out]``) and computes :func:`q8_dense`."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype=torch.float32, device=None, lora_rank: int = 0,
                 lora_alpha: float = 16.0, base_dtype: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.base_dtype = _check_base_dtype(base_dtype)
        if base_dtype == "int8":
            self.kernel_q8 = _Q8((in_features, out_features), out_features,
                                 device)
        else:
            self.kernel = nn.Parameter(torch.empty(
                in_features, out_features, dtype=param_dtype,
                device=device), requires_grad=False)
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_features, lora_rank, device=device))
            self.lora_b = nn.Parameter(torch.empty(
                lora_rank, out_features, device=device))

    def forward(self, x):
        if self.base_dtype == "int8":
            y = q8_dense(x, self.kernel_q8.q, self.kernel_q8.scale,
                         self.dtype)
        else:
            y = dense(x, self.kernel, self.dtype)
        if self.lora_rank > 0:
            xd = x.to(self.dtype)
            lora = xd @ self.lora_a.to(self.dtype) @ self.lora_b.to(self.dtype)
            y = y + lora * (self.lora_alpha / self.lora_rank)
        return y


def _check_base_dtype(base_dtype: Optional[str]) -> Optional[str]:
    if base_dtype not in (None, "int8"):
        raise ValueError(f"unsupported base_dtype {base_dtype!r}")
    return base_dtype


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
                 **dense_kw):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = Dense(d, cfg.num_heads * hd, dtype, param_dtype, device,
                        **dense_kw)
        self.wk = Dense(d, cfg.num_kv_heads * hd, dtype, param_dtype, device,
                        **dense_kw)
        self.wv = Dense(d, cfg.num_kv_heads * hd, dtype, param_dtype, device,
                        **dense_kw)
        self.wo = Dense(cfg.num_heads * hd, d, dtype, param_dtype, device,
                        **dense_kw)

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
                 device=None, **dense_kw):
        super().__init__()
        self.w_gate = Dense(d, hidden, dtype, param_dtype, device, **dense_kw)
        self.w_up = Dense(d, hidden, dtype, param_dtype, device, **dense_kw)
        self.w_down = Dense(hidden, d, dtype, param_dtype, device, **dense_kw)

    def forward(self, x):
        return self.w_down(nn.functional.silu(self.w_gate(x)) * self.w_up(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, param_dtype, device=None,
                 **dense_kw):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, dtype, device=device)
        self.attn = CausalSelfAttention(cfg, dtype, param_dtype, device,
                                        **dense_kw)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype, device=device)
        self.mlp = SwiGLU(cfg.d_model, cfg.ffn_hidden, dtype, param_dtype,
                          device, **dense_kw)

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

    ``base_dtype="int8"``: every kernel is ``kernel_q8`` and the tied
    embedding ``tok_embed_q8`` (int8, one f32 scale per ``d_model``
    channel).  The gather dequantizes per row; the readout folds the
    scales into the activations and runs in the COMPUTE dtype, cast up
    to f32 after (the flax model's int8 readout), unlike the f32 readout
    of the f32 base.  ``remat=True`` recomputes each ``DecoderBlock`` in
    the backward (``torch.utils.checkpoint``, non-reentrant), as
    ``nn.remat``.
    """

    def __init__(self, config: LlamaConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, *,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 remat: bool = False, base_dtype: Optional[str] = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.remat = remat
        self.base_dtype = _check_base_dtype(base_dtype)
        dev = device if str(device) == "meta" else resolve_device(device)
        dense_kw = dict(lora_rank=lora_rank, lora_alpha=lora_alpha,
                        base_dtype=base_dtype)
        if base_dtype == "int8":
            self.tok_embed_q8 = _Q8((config.vocab_size, config.d_model),
                                    config.d_model, dev)
        else:
            self.tok_embed = nn.Parameter(torch.empty(
                config.vocab_size, config.d_model, device=dev),
                requires_grad=False)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}",
                            DecoderBlock(config, dtype, param_dtype, dev,
                                         **dense_kw))
        self.final_norm = RMSNorm(config.d_model, dtype, device=dev)

    @classmethod
    def from_params(cls, config: LlamaConfig, params: Dict[str, torch.Tensor],
                    dtype=torch.float32, *, lora_rank: int = 0,
                    lora_alpha: float = 16.0, remat: bool = False,
                    base_dtype: Optional[str] = None) -> "LlamaLM":
        """A model that holds ``params`` (a flat dict, e.g. from
        :func:`init_llama_params`) as its parameters, without a copy:
        built on the meta device and assigned, so an 8B model never
        exists twice in device memory.  Keeps each tensor's dtype."""
        model = cls(config, dtype, device="meta", lora_rank=lora_rank,
                    lora_alpha=lora_alpha, remat=remat,
                    base_dtype=base_dtype)
        model.load_state_dict(params, strict=True, assign=True)
        return model

    def forward(self, tokens, positions=None, *, segment_ids=None,
                force_reference: bool = False):
        """f32 logits; ``force_reference=True`` runs attention through the
        plain version under autograd instead of the kernels."""
        if positions is None:
            positions = default_positions(tokens, segment_ids)
        if self.base_dtype == "int8":
            emb = self.tok_embed_q8
            x = emb.q[tokens].to(self.dtype) * emb.scale.to(self.dtype)
        else:
            x = self.tok_embed[tokens].to(self.dtype)
        for i in range(self.config.num_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat:
                x = checkpoint(block, x, positions, segment_ids,
                               force_reference, use_reentrant=False)
            else:
                x = block(x, positions, segment_ids, force_reference)
        h = self.final_norm(x)
        if self.base_dtype == "int8":
            hs = (h.float() * emb.scale).to(self.dtype)
            return _Q8Matmul.apply(hs, emb.q, None, self.dtype,
                                   True).float()
        return tied_readout(h, self.tok_embed)


# ---------------------------------------------------------------------------
# Seeded random initialisation
# ---------------------------------------------------------------------------


def param_shapes(config: LlamaConfig, lora_rank: int = 0,
                 base_dtype: Optional[str] = None) -> Dict[str, tuple]:
    """Flat ``{dotted name: shape}`` of a ``LlamaLM``'s parameters; with
    ``lora_rank > 0`` each projection's ``lora_a``/``lora_b`` follow its
    kernel.  ``base_dtype="int8"``: ``<p>.kernel`` is ``<p>.kernel_q8.q``
    and ``.scale``, ``tok_embed`` is ``tok_embed_q8.q`` and ``.scale``."""
    c = config
    hd = c.head_dim
    int8 = _check_base_dtype(base_dtype) == "int8"
    if int8:
        shapes = {"tok_embed_q8.q": (c.vocab_size, c.d_model),
                  "tok_embed_q8.scale": (c.d_model,)}
    else:
        shapes = {"tok_embed": (c.vocab_size, c.d_model)}

    def dense(name, fan_in, fan_out):
        if int8:
            shapes[f"{name}.kernel_q8.q"] = (fan_in, fan_out)
            shapes[f"{name}.kernel_q8.scale"] = (fan_out,)
        else:
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
                      lora_rank: int = 0, base_dtype: Optional[str] = None
                      ) -> Dict[str, torch.Tensor]:
    """Random weights from ``generator``, mirroring flax's initialisers:
    ``normal(0.02)`` for the embedding, ``lecun_normal`` for the ``Dense``
    kernels, ones for the norm scales; with ``lora_rank > 0``,
    ``normal(0.02)`` for ``lora_a`` and zeros for ``lora_b``, both f32.

    Kernels are drawn in f32 and stored in ``dtype`` (the serving dtype);
    the embedding and norm scales stay f32.  ``base_dtype="int8"`` (the
    counterpart of ``_q8_init``) draws the same f32 values and stores the
    kernels and the embedding as :func:`quantize_int8` of them, under
    the names of :func:`param_shapes`.  ``generator`` must live on
    ``device`` (``torch.Generator(device="cuda")`` for the GPU).  The
    numbers differ from flax's for the same seed: the tests feed both
    packages the same converted weights instead.
    """
    dev = resolve_device(device)
    int8 = _check_base_dtype(base_dtype) == "int8"
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
            if not int8:
                t = t.to(dtype)
        if int8 and (name == "tok_embed" or name.endswith(".kernel")):
            q8 = quantize_int8(t)
            out[f"{name}_q8.q"], out[f"{name}_q8.scale"] = q8["q"], \
                q8["scale"]
        else:
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


def quantize_frozen_base(params: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A trained f32-base flat dict in the ``base_dtype="int8"`` layout:
    every ``<p>.kernel`` becomes ``<p>.kernel_q8.q`` / ``.scale``
    (:func:`quantize_int8`, one scale per output channel) and
    ``tok_embed`` becomes ``tok_embed_q8.q`` / ``.scale``, each in the
    place of the name it replaces.  Norm scales, biases and the LoRA
    adapters pass through.  The result loads into
    ``LlamaLM(base_dtype="int8")``."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "tok_embed"):
            q8 = quantize_int8(t)
            out[f"{name}_q8.q"], out[f"{name}_q8.scale"] = q8["q"], \
                q8["scale"]
        else:
            out[name] = t
    return out


def merge_lora(params: Dict[str, torch.Tensor],
               alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """Fold trained adapters into the base kernels (inference export).

    Every ``<p>.kernel`` with a ``<p>.lora_a``/``.lora_b`` pair becomes
    ``kernel + a @ b * alpha/r``, added in f32 and returned in the
    kernel's own dtype, and the pair is dropped.  An int8 node
    (``kernel_q8``, no ``kernel``) keeps its node and its adapters, as
    the JAX function does.  ``alpha`` must be the model's
    ``lora_alpha``: the dict does not carry it."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        head, _, leaf = name.rpartition(".")
        if leaf in _LORA and f"{head}.kernel" in params:
            continue
        if leaf == "kernel" and f"{head}.lora_a" in params:
            a, b = params[f"{head}.lora_a"], params[f"{head}.lora_b"]
            delta = (a.float() @ b.float()) * (alpha / a.shape[1])
            t = (t.float() + delta).to(t.dtype)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# BERT encoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    num_layers: int = 24
    num_heads: int = 16
    d_model: int = 1024
    ffn_hidden: int = 4096
    max_seq_len: int = 512
    type_vocab_size: int = 2


# BERT-Large (Devlin et al., 2018: 24 layers, 16 heads, d_model 1024, FFN
# 4096, WordPiece vocab 30522, 512 positions, 2 token types).
BERT_LARGE = BertConfig()
BERT_BASE = BertConfig(num_layers=12, num_heads=12, d_model=768,
                       ffn_hidden=3072)
BERT_TINY = BertConfig(vocab_size=256, num_layers=2, num_heads=4,
                       d_model=64, ffn_hidden=128, max_seq_len=128)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              dtype, epsilon: float = 1e-12) -> torch.Tensor:
    """``flax.linen.LayerNorm`` over the last dim: statistics in f32 with
    flax's fast variance ``E[x^2] - E[x]^2`` clamped at 0, then ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias`` in f32, cast to
    ``dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + epsilon) * scale.float()
    return ((x32 - mean) * mul + bias.float()).to(dtype)


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` (f32 ``scale`` and ``bias``, output in
    ``dtype``); see :func:`layernorm`."""

    def __init__(self, dim: int, dtype, epsilon: float = 1e-12,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias, self.dtype, self.epsilon)


class EncoderBlock(nn.Module):
    """Pre-LN BERT block: ``x + wo(attention(attn_norm(x)))``, then ``x +
    w_out(gelu(w_in(mlp_norm(x))))`` with the tanh GELU.  Attention is
    bidirectional over the flash kernels; ``segment_ids`` (packed
    sequences) keeps each token to keys of its own segment."""

    def __init__(self, cfg: BertConfig, dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.ffn_hidden
        self.num_heads = cfg.num_heads
        self.attn_norm = LayerNorm(d, dtype, device=device)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name,
                    layers.Dense(d, d, dtype=dtype, device=device))
        self.mlp_norm = LayerNorm(d, dtype, device=device)
        self.w_in = layers.Dense(d, f, dtype=dtype, device=device)
        self.w_out = layers.Dense(f, d, dtype=dtype, device=device)

    def forward(self, x, segment_ids=None, force_reference: bool = False):
        b, t, d = x.shape
        shape = (b, t, self.num_heads, d // self.num_heads)
        h = self.attn_norm(x)
        q, k, v = (w(h).view(shape).transpose(1, 2).contiguous()
                   for w in (self.wq, self.wk, self.wv))
        o = flash_attention(q, k, v, causal=False, segment_ids=segment_ids,
                            force_reference=force_reference)
        x = x + self.wo(o.transpose(1, 2).reshape(b, t, d))
        h = nn.functional.gelu(self.w_in(self.mlp_norm(x)),
                               approximate="tanh")
        return x + self.w_out(h)


class Bert(nn.Module):
    """BERT encoder with the MLM and NSP heads (the pretraining
    objective), the flax ``Bert``'s parameters under its names.

    ``dtype`` is the compute dtype; every parameter is f32.  Returns
    ``(mlm_logits [b, t, vocab], nsp_logits [b, 2])``, both f32: the MLM
    readout is ``mlm_norm(gelu(mlm_transform(x))) @ tok_embed.T`` in f32,
    NSP reads ``tanh(pooler(x[:, 0]))``.  ``remat=True`` recomputes each
    ``EncoderBlock`` in the backward, as :class:`LlamaLM`'s.
    """

    def __init__(self, config: BertConfig, dtype=torch.float32, device=None,
                 *, remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        c = config
        dev = device if str(device) == "meta" else resolve_device(device)
        self.tok_embed = nn.Parameter(torch.empty(c.vocab_size, c.d_model,
                                                  device=dev))
        self.pos_embed = nn.Parameter(torch.empty(c.max_seq_len, c.d_model,
                                                  device=dev))
        self.type_embed = nn.Parameter(torch.empty(
            c.type_vocab_size, c.d_model, device=dev))
        self.embed_norm = LayerNorm(c.d_model, dtype, device=dev)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", EncoderBlock(c, dtype, dev))
        self.final_norm = LayerNorm(c.d_model, dtype, device=dev)
        self.mlm_transform = layers.Dense(c.d_model, c.d_model, dtype=dtype,
                                          device=dev)
        self.mlm_norm = LayerNorm(c.d_model, dtype, device=dev)
        self.pooler = layers.Dense(c.d_model, c.d_model, dtype=dtype,
                                   device=dev)
        self.nsp = layers.Dense(c.d_model, 2, dtype=dtype, device=dev)

    @classmethod
    def from_params(cls, config: BertConfig, params: Dict[str, torch.Tensor],
                    dtype=torch.float32, *, remat: bool = False) -> "Bert":
        """A model holding ``params`` (a flat dict, e.g. from
        :func:`init_bert_params`) as its parameters, without a copy."""
        model = cls(config, dtype, device="meta", remat=remat)
        model.load_state_dict(params, strict=True, assign=True)
        return model

    def forward(self, tokens, token_types=None, *, pack_segment_ids=None,
                force_reference: bool = False):
        """``token_types`` is BERT's sentence A/B input (zeros when
        ``None``); ``pack_segment_ids`` the attention isolation of packed
        sequences.  ``force_reference=True`` runs attention through the
        plain version under autograd instead of the kernels."""
        t = tokens.shape[1]
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        x = (self.tok_embed[tokens] + self.pos_embed[None, :t]
             + self.type_embed[token_types]).to(self.dtype)
        x = self.embed_norm(x)
        for i in range(self.config.num_layers):
            block = getattr(self, f"layer_{i}")
            if self.remat:
                x = checkpoint(block, x, pack_segment_ids, force_reference,
                               use_reentrant=False)
            else:
                x = block(x, pack_segment_ids, force_reference)
        x = self.final_norm(x)
        h = nn.functional.gelu(self.mlm_transform(x), approximate="tanh")
        mlm_logits = tied_readout(self.mlm_norm(h), self.tok_embed)
        cls = torch.tanh(self.pooler(x[:, 0]))
        return mlm_logits, self.nsp(cls).float()


def bert_param_shapes(config: BertConfig) -> Dict[str, tuple]:
    """Flat ``{dotted name: shape}`` of a ``Bert``'s parameters (the flax
    tree's paths)."""
    c = config
    d, f = c.d_model, c.ffn_hidden
    shapes = {"tok_embed": (c.vocab_size, d), "pos_embed": (c.max_seq_len, d),
              "type_embed": (c.type_vocab_size, d)}

    def norm(name):
        shapes[f"{name}.scale"] = shapes[f"{name}.bias"] = (d,)

    def dense(name, fan_in, fan_out):
        shapes[f"{name}.kernel"] = (fan_in, fan_out)
        shapes[f"{name}.bias"] = (fan_out,)

    norm("embed_norm")
    for i in range(c.num_layers):
        p = f"layer_{i}"
        norm(f"{p}.attn_norm")
        for w in ("wq", "wk", "wv", "wo"):
            dense(f"{p}.{w}", d, d)
        norm(f"{p}.mlp_norm")
        dense(f"{p}.w_in", d, f)
        dense(f"{p}.w_out", f, d)
    norm("final_norm")
    dense("mlm_transform", d, d)
    norm("mlm_norm")
    dense("pooler", d, d)
    dense("nsp", d, 2)
    return shapes


def init_bert_params(config: BertConfig, *, generator: torch.Generator,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Random f32 weights from ``generator`` with flax's initialisers:
    ``normal(0.02)`` for the three embeddings, ``lecun_normal`` for the
    ``Dense`` kernels, zero biases, LayerNorm scales one and biases zero.
    ``generator`` must live on ``device``.  The numbers differ from
    flax's for the same seed."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in bert_param_shapes(config).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            t = torch.empty(shape, device=dev)
            _lecun_normal_(t, generator)
        elif leaf == "scale":
            t = torch.ones(shape, device=dev)
        elif leaf == "bias":
            t = torch.zeros(shape, device=dev)
        else:
            t = torch.empty(shape, device=dev)
            t.normal_(0.0, 0.02, generator=generator)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# BERT under tensor parallelism
# ---------------------------------------------------------------------------


def _tp_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  dtype) -> torch.Tensor:
    """``bert_tp_apply``'s layer norm (the JAX function's own): f32 mean
    and two-pass variance, ``(x - mean) * rsqrt(var + 1e-12) * scale +
    bias``, cast to ``dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + 1e-12)
    return (y * scale + bias).to(dtype)


def bert_tp_apply(params: Dict[str, torch.Tensor], config: BertConfig,
                  tokens: torch.Tensor, token_types=None, *,
                  axis="model", dtype=torch.float32, mesh=None,
                  force_reference: bool = False):
    """Tensor-parallel :class:`Bert` forward over this rank's shards (the
    JAX ``bert_tp_apply``): ``(mlm_logits, nsp_logits)``, both f32.

    ``params`` is the flat dict of :func:`init_bert_params` cut by
    :func:`~horovod_tpu_torch.parallel.tp.shard_params` with
    :func:`~horovod_tpu_torch.parallel.tp.tp_param_specs`: per block,
    ``wq`` / ``wk`` / ``wv`` / ``w_in`` column shards (heads and FFN
    columns split over the set of ``axis``, their biases with them),
    ``wo`` / ``w_out`` row shards closing in one allreduce each, the rest
    whole.  Two allreduces a block forward (``reduce_from_tp``) and two
    backward (``copy_to_tp``), each of the full ``(b, t, d_model)``
    activation; attention runs the port's ``flash_attention`` on the
    ``heads / tp`` local heads (the local head count comes off the
    sliced kernel).  ``force_reference`` runs attention through the
    plain version under autograd."""
    from ..parallel.tp import copy_to_tp, row_parallel
    p = params
    b, t = tokens.shape
    if token_types is None:
        token_types = torch.zeros_like(tokens)

    def ln(x, node):
        return _tp_layernorm(x, p[f"{node}.scale"], p[f"{node}.bias"], dtype)

    def dense(x, node):
        return x @ p[f"{node}.kernel"].to(dtype) + p[f"{node}.bias"].to(dtype)

    emb = p["tok_embed"]
    x = (emb[tokens] + p["pos_embed"][None, :t]
         + p["type_embed"][token_types]).to(dtype)
    x = ln(x, "embed_norm")
    head_dim = config.d_model // config.num_heads
    for i in range(config.num_layers):
        blk = f"layer_{i}"
        h = copy_to_tp(ln(x, f"{blk}.attn_norm"), axis=axis, mesh=mesh)
        d_local = p[f"{blk}.wq.kernel"].shape[-1]
        shape = (b, t, d_local // head_dim, head_dim)
        q, k, v = (dense(h, f"{blk}.{w}").view(shape).transpose(1, 2)
                   .contiguous() for w in ("wq", "wk", "wv"))
        o = flash_attention(q, k, v, causal=False,
                            force_reference=force_reference)
        o = o.transpose(1, 2).reshape(b, t, d_local)
        x = x + row_parallel(o, p[f"{blk}.wo.kernel"].to(dtype),
                             p[f"{blk}.wo.bias"].to(dtype), axis=axis,
                             mesh=mesh)
        h = copy_to_tp(ln(x, f"{blk}.mlp_norm"), axis=axis, mesh=mesh)
        h = nn.functional.gelu(dense(h, f"{blk}.w_in"), approximate="tanh")
        x = x + row_parallel(h, p[f"{blk}.w_out.kernel"].to(dtype),
                             p[f"{blk}.w_out.bias"].to(dtype), axis=axis,
                             mesh=mesh)
    x = ln(x, "final_norm")
    h = nn.functional.gelu(dense(x, "mlm_transform"), approximate="tanh")
    h = ln(h, "mlm_norm")
    mlm_logits = tied_readout(h, emb)
    cls = torch.tanh(dense(x[:, 0], "pooler"))
    return mlm_logits, dense(cls, "nsp").float()


class ParamTree(nn.Module):
    """A module holding a flat ``{dotted name: tensor}`` dict as its
    parameters under those names (nested container modules, registered
    in the dict's order), without a copy: what an optimizer, a
    ``DistributedOptimizer`` and the train step see of a model computed
    by a function of the dict, as :class:`BertTP` is."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in params.items():
            *path, leaf = name.split(".")
            mod: nn.Module = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(
                leaf, t if isinstance(t, nn.Parameter) else nn.Parameter(t))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


class BertTP(ParamTree):
    """This rank's tensor-parallel shard of a :class:`Bert`: the sharded
    flat dict as parameters (Bert's names, local shapes) and
    :func:`bert_tp_apply` as the forward, so ``make_train_step(...,
    tp=...)`` trains it.  ``axis`` is the tensor-parallel mesh axis."""

    def __init__(self, config: BertConfig, params: Dict[str, torch.Tensor],
                 dtype=torch.float32, *, axis="model", mesh=None):
        super().__init__(params)
        self.config, self.dtype = config, dtype
        self.axis, self.mesh = axis, mesh

    def forward(self, tokens, token_types=None, *,
                force_reference: bool = False):
        return bert_tp_apply(self.params(), self.config, tokens, token_types,
                             axis=self.axis, dtype=self.dtype,
                             mesh=self.mesh,
                             force_reference=force_reference)
