"""The fused PowerSGD + error-feedback exchange's three stages:
hand-written CUDA + plain PyTorch.

Counterpart of ``horovod_tpu/ops/fused_update.py``.  The rank-``r``
PowerSGD exchange (:func:`~horovod_tpu_torch.collectives.ops.
powersgd_allreduce`) views a flat gradient bucket of ``size`` elements as
an ``[m, c]`` matrix (zero past its end) and runs three stages around its
two factor allreduces, which stay outside the kernels:

1. :func:`matricize_p` -- ``acc = x * prescale (+ residual)`` in f32 and
   ``P = acc @ Q0`` (``[m, r]``);
2. (allreduce of P, then ``/ n``) :func:`orthonormalize_q` -- one modified
   Gram-Schmidt round over the mean P, and ``Q_local = acc^T @ P_orth``
   (``[c, r]``);
3. (allreduce of Q, then ``/ n``) :func:`reconstruct_residual` -- ``out =
   (P_orth Q^T) * n_scale * postscale`` and the error-feedback residual
   ``acc - P_orth Q_local^T``, both flat at ``size`` elements.

Dispatch, as in :mod:`~horovod_tpu_torch.ops.bn`: a CPU tensor takes the
plain PyTorch version -- torch operations in the order of the JAX
package's unfused exchange (``collectives/ops.py::powersgd_allreduce``),
so the CPU path is also the reference the JAX tests hold the kernels to;
a CUDA tensor launches the kernels of ``csrc/fused_update.cu``
(families ``fused_update_matricize_p``, ``fused_update_orthonormalize_q``
and ``fused_update_reconstruct``), or the wrapper raises -- there is no
fallback.  ``force_reference=True`` is the one explicit way to the plain
version on the GPU.  The kernels take contiguous tensors and never copy
one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import registry
from ._build import check_launch, entry, stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132                 # H100 SXM streaming multiprocessors
_CTAS_PER_SM = 8           # stage 2 projection CTAs aimed at per SM
_TILE_COLUMNS = 128        # stage 2 projection: columns per CTA
_MIN_ROWS_PER_CHUNK = 16


def q_chunks(m: int, c: int) -> int:
    """Row chunks of the stage-2 projection for an ``[m, c]`` arena:
    enough CTAs (column tiles x chunks) to give every SM
    ``_CTAS_PER_SM``, but at least ``_MIN_ROWS_PER_CHUNK`` rows a chunk."""
    tiles = -(-c // _TILE_COLUMNS)
    want = max(1, _SMS * _CTAS_PER_SM // tiles)
    return max(1, min(want, -(-m // _MIN_ROWS_PER_CHUNK)))


def _gram_schmidt(p: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt over the (few) columns of ``p``, f32: each
    column minus its projections on the finished ones, one after another,
    then divided by ``max(norm, 1e-12)`` (``_orthonormalize_columns``)."""
    cols = []
    for k in range(p.shape[1]):
        v = p[:, k]
        for u in cols:
            v = v - torch.dot(u, v) * u
        norm = torch.sqrt(torch.sum(v * v))
        cols.append(v / torch.clamp_min(norm, 1e-12))
    return torch.stack(cols, dim=1)


def _check_cuda(name: str, t: torch.Tensor, device: torch.device,
                shape: Optional[Tuple[int, ...]] = None,
                dtype: Optional[torch.dtype] = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name}: tensors must share device {device}, got "
                         f"{t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensors must be contiguous (the kernel "
                         f"never copies)")


def _on_gpu(name: str, t: torch.Tensor, force_reference: bool) -> bool:
    """False: take the plain version (a CPU tensor, or forced); True:
    launch the kernel (a CUDA tensor); anything else raises."""
    if force_reference or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------


def matricize_p(x: torch.Tensor, residual: Optional[torch.Tensor],
                q0: torch.Tensor, *, rows: int, prescale: float = 1.0,
                force_reference: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(acc, p)``: ``acc = x * prescale + residual`` (f32, ``[rows, c]``
    with ``c = q0.shape[0]``, zero past x's last element) and ``p = acc @
    q0`` (``[rows, r]``).  ``x`` is the flat bucket (f32 or bf16; any
    shape, read raveled), ``residual`` a flat f32 tensor of as many
    elements or ``None`` (zeros)."""
    c, r = q0.shape
    size = x.numel()
    if not 0 < size <= rows * c:
        raise ValueError(f"matricize_p: {size} elements do not fit "
                         f"[{rows}, {c}]")
    if residual is not None and residual.numel() != size:
        raise ValueError(f"matricize_p: residual has {residual.numel()} "
                         f"elements, x {size}")
    if not _on_gpu("matricize_p", x, force_reference):
        acc = x.reshape(-1).to(torch.float32, copy=True)
        if prescale != 1.0:
            acc = acc * prescale
        if residual is not None:
            acc = acc + residual.reshape(-1).float()
        pad = rows * c - size
        if pad:
            acc = torch.cat([acc, acc.new_zeros(pad)])
        mat = acc.view(rows, c)
        return mat, mat @ q0.float()
    if x.dtype not in _DTYPES:
        raise ValueError(f"matricize_p: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    _check_cuda("matricize_p", x, x.device, dtype=None)
    _check_cuda("matricize_p", q0, x.device, (c, r))
    if residual is not None:
        _check_cuda("matricize_p", residual, x.device)
    acc = torch.empty((rows, c), dtype=torch.float32, device=x.device)
    p = torch.empty((rows, r), dtype=torch.float32, device=x.device)
    err = entry("fused_update_matricize_p")(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        q0.data_ptr(), acc.data_ptr(), p.data_ptr(), size, rows, c, r,
        float(prescale), _DTYPES[x.dtype], stream(x))
    check_launch("fused_update_matricize_p", err)
    registry.note_launch("fused_update_matricize_p")
    return acc, p


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------


def orthonormalize_q(acc: torch.Tensor, p_mean: torch.Tensor, *,
                     force_reference: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(p_orth, q_local)``: the mean left factor ``p_mean`` (``[m, r]``)
    orthonormalized by one modified Gram-Schmidt round, and ``q_local =
    acc^T @ p_orth`` (``[c, r]``) for the f32 arena ``acc`` (``[m, c]``)."""
    m, c = acc.shape
    r = p_mean.shape[1]
    if tuple(p_mean.shape) != (m, r):
        raise ValueError(f"orthonormalize_q: p {tuple(p_mean.shape)} does "
                         f"not match acc {tuple(acc.shape)}")
    if not _on_gpu("orthonormalize_q", acc, force_reference):
        p_orth = _gram_schmidt(p_mean.float())
        return p_orth, acc.float().T @ p_orth
    _check_cuda("orthonormalize_q", acc, acc.device)
    _check_cuda("orthonormalize_q", p_mean, acc.device)
    chunks = q_chunks(m, c)
    p_orth = torch.empty((m, r), dtype=torch.float32, device=acc.device)
    workspace = torch.empty((chunks, c, r), dtype=torch.float32,
                            device=acc.device)
    q_local = torch.empty((c, r), dtype=torch.float32, device=acc.device)
    err = entry("fused_update_orthonormalize_q")(
        acc.data_ptr(), p_mean.data_ptr(), p_orth.data_ptr(),
        workspace.data_ptr(), q_local.data_ptr(), m, c, r, chunks,
        stream(acc))
    check_launch("fused_update_orthonormalize_q", err)
    registry.note_launch("fused_update_orthonormalize_q")
    return p_orth, q_local


# ---------------------------------------------------------------------------
# Stage 3
# ---------------------------------------------------------------------------


def reconstruct_residual(acc: torch.Tensor, p_orth: torch.Tensor,
                         q_mean: torch.Tensor, q_local: torch.Tensor, *,
                         size: Optional[int] = None, n_scale: float = 1.0,
                         postscale: float = 1.0,
                         force_reference: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, new_residual)``, flat f32 at ``size`` elements (default
    ``m * c``): ``out = (p_orth @ q_mean^T) * n_scale * postscale`` (in
    that order) and ``new_residual = acc - p_orth @ q_local^T`` -- this
    rank's mass the averaged factors did not carry."""
    m, c = acc.shape
    r = p_orth.shape[1]
    size = m * c if size is None else int(size)
    if not 0 < size <= m * c:
        raise ValueError(f"reconstruct_residual: size {size} outside "
                         f"[1, {m * c}]")
    for name, t, shape in (("p_orth", p_orth, (m, r)), ("q", q_mean, (c, r)),
                           ("q_local", q_local, (c, r))):
        if tuple(t.shape) != shape:
            raise ValueError(f"reconstruct_residual: {name} "
                             f"{tuple(t.shape)} != {shape}")
    if not _on_gpu("reconstruct_residual", acc, force_reference):
        approx = (p_orth @ q_mean.T).reshape(-1)[:size]
        own = (p_orth @ q_local.T).reshape(-1)[:size]
        new_residual = acc.reshape(-1)[:size] - own
        out = approx * n_scale if n_scale != 1.0 else approx
        if postscale != 1.0:
            out = out * postscale
        return out, new_residual
    for t in (acc, p_orth, q_mean, q_local):
        _check_cuda("reconstruct_residual", t, acc.device)
    out = torch.empty(size, dtype=torch.float32, device=acc.device)
    new_residual = torch.empty_like(out)
    err = entry("fused_update_reconstruct")(
        acc.data_ptr(), p_orth.data_ptr(), q_mean.data_ptr(),
        q_local.data_ptr(), out.data_ptr(), new_residual.data_ptr(), size,
        m, c, r, float(n_scale), float(postscale), stream(acc))
    check_launch("fused_update_reconstruct", err)
    registry.note_launch("fused_update_reconstruct")
    return out, new_residual


__all__ = ["matricize_p", "orthonormalize_q", "reconstruct_residual",
           "q_chunks"]
