"""Expert parallelism: the Switch mixture-of-experts layer.

Counterpart of ``horovod_tpu/parallel/moe.py``: a top-k router with
per-expert capacity, an all_to_all over the set of a mesh axis (``"ep"``
by default) that moves each token slot to the rank owning its expert,
the experts' FFNs batched as one einsum, the return all_to_all and the
gate-weighted combine -- the one-hot dispatch/combine formulation of the
Switch Transformer (arXiv:2101.03961).  A token over capacity passes
with no expert contribution.

Layout: this rank's ``t_l`` tokens, the router replicated, ``E / ep``
experts a rank (``w_up`` ``(E_l, d, f)``, ``w_down`` ``(E_l, f, d)``).
Both shuffle legs come from the exchange-plan IR
(``plan_exchange("moe")``, rows ``moe/a2a_dispatch`` and
``moe/a2a_combine``, noted in the span registry) and carry the wire
codec of :func:`resolve_moe_compression`: the f32 slot tensors are cast
down for the all_to_all and back up after it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..collectives.ops import alltoall
from ..core.process_sets import ProcessSet
from .mesh import EP_AXIS
from .tp import resolve_set

_MOE_CODECS = {"none": None, "bf16": torch.bfloat16, "fp16": torch.float16}


def resolve_moe_compression(compression=None) -> str:
    """The MoE wire codec: ``compression``, else the autotuner's MoE axis
    (``HOROVOD_AUTOTUNE_MOE=1``), else ``HOROVOD_MOE_COMPRESSION``;
    ``"none"``, ``"bf16"`` or ``"fp16"``."""
    if compression is None:
        from ..core.state import global_state
        st = global_state()
        tuner = st.autotuner
        if tuner is not None and getattr(tuner, "tunes_moe", False):
            compression = tuner.moe_codec()
        elif st.config is not None and st.config.moe_compression:
            compression = st.config.moe_compression
    name = str(compression or "none").lower()
    if name not in _MOE_CODECS:
        raise ValueError(
            f"unknown MoE compression {compression!r}: expected one of "
            f"{sorted(_MOE_CODECS)}")
    return name


def _a2a_leg(slots: torch.Tensor, ps: ProcessSet, *, split_axis: int,
             concat_axis: int, codec: str, leg) -> torch.Tensor:
    """One MoE all_to_all leg: note its plan row, cast to the wire dtype,
    shuffle, back to f32."""
    from ..timeline.spans import note_leg
    wire = _MOE_CODECS[codec]
    note_leg(leg)
    if wire is not None:
        slots = slots.to(wire)
    out = alltoall(slots, process_set=ps, split_axis=split_axis,
                   concat_axis=concat_axis)
    return out.float()


def _axis_name(axis) -> str:
    if isinstance(axis, ProcessSet):
        return axis.name
    return axis if isinstance(axis, str) else ",".join(axis)


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *,
            capacity_factor: float = 1.25, top_k: int = 1, axis=EP_AXIS,
            activation: Callable = lambda h: F.gelu(h, approximate="tanh"),
            router_noise: Optional[torch.Generator] = None,
            compression: Optional[str] = None, mesh=None):
    """The MoE FFN over the set of ``axis``: ``(y, aux_loss)``, the
    ``(t_l, d)`` output and the scalar Switch load-balance loss.

    Capacity is per source rank, ``C = ceil(top_k * t_l / E *
    capacity_factor)`` (at least 4) slots a (rank, expert), the same on
    every rank.  ``router_noise`` (a ``torch.Generator``) adds Gumbel
    noise to the router logits.  ``compression`` picks the legs' wire
    codec (``None``: :func:`resolve_moe_compression`)."""
    codec = resolve_moe_compression(compression)
    ps = resolve_set(axis, mesh)
    ep = ps.size()
    t_l, d = x.shape
    e_local = w_up.shape[0]
    n_experts = e_local * ep
    capacity = int(max(4, -(-top_k * t_l * capacity_factor // n_experts)))

    logits = x.float() @ router_kernel.float()
    if router_noise is not None:
        u = torch.rand(logits.shape, generator=router_noise,
                       device=logits.device).clamp_min(1e-20)
        logits = logits - torch.log(-torch.log(u))
    probs = torch.softmax(logits, dim=-1)                       # (t_l, E)

    dispatch = x.new_zeros((t_l, n_experts, capacity), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    position_base = torch.zeros(n_experts, dtype=torch.int32,
                                device=x.device)
    slots_ix = torch.arange(capacity, device=x.device)
    remaining = probs
    for _ in range(top_k):
        idx = remaining.argmax(-1)                              # (t_l,)
        onehot = F.one_hot(idx, n_experts).float()
        pos = (onehot.cumsum(0) - 1.0) * onehot                 # (t_l, E)
        pos = pos + position_base[None, :] * onehot
        keep = (pos < capacity) * onehot
        # one_hot of a position past capacity is all zeros, as jax's.
        slot = (pos.sum(-1).long()[:, None] == slots_ix).float()
        gate = (probs * onehot).sum(-1, keepdim=True)           # (t_l, 1)
        dispatch = dispatch + keep[:, :, None] * slot[:, None, :]
        combine = combine + gate[..., None] * keep[:, :, None] \
            * slot[:, None, :]
        position_base = position_base + onehot.sum(0).to(torch.int32)
        remaining = remaining * (1.0 - onehot)

    from ..controller.fusion import plan_exchange
    legs = plan_exchange("moe", n_experts=n_experts, capacity=capacity,
                         d_model=d, compression=codec,
                         axis=_axis_name(axis)).legs
    slots = torch.einsum("tec,td->ecd", dispatch, x.float())
    slots = _a2a_leg(slots, ps, split_axis=0, concat_axis=1, codec=codec,
                     leg=legs[0])                     # (E_l, ep * C, d)
    h = activation(torch.einsum("ecd,edf->ecf", slots.to(x.dtype), w_up))
    out = torch.einsum("ecf,efd->ecd", h, w_down)
    out = _a2a_leg(out.float(), ps, split_axis=1, concat_axis=0,
                   codec=codec, leg=legs[1])          # (E, C, d)
    y = torch.einsum("tec,ecd->td", combine, out)
    return y.to(x.dtype), _load_balance_loss(probs, dispatch)


def _load_balance_loss(probs: torch.Tensor,
                       dispatch: torch.Tensor) -> torch.Tensor:
    """Switch aux loss: ``E * dot(mean router prob, mean tokens routed
    per expert)``."""
    n_experts = probs.shape[-1]
    density = dispatch.sum(-1).mean(0)
    density_proxy = probs.mean(0)
    return n_experts * torch.sum(density * density_proxy)


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32, device=None):
    """Replicated-layout parameters from ``generator`` (on ``device``):
    ``router`` ``(d, E)``, ``w_up`` ``(E, d, f)``, ``w_down`` ``(E, f,
    d)``, normal with std ``d ** -0.5`` (``f ** -0.5`` for ``w_down``).
    Slice the expert dim over the set before :func:`moe_ffn`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    scale_in = d_model ** -0.5
    return {"router": normal(d_model, n_experts) * scale_in,
            "w_up": (normal(n_experts, d_model, d_ff) * scale_in).to(dtype),
            "w_down": (normal(n_experts, d_ff, d_model)
                       * d_ff ** -0.5).to(dtype)}


__all__ = ["init_moe_params", "moe_ffn", "resolve_moe_compression"]
