"""The three PowerSGD ``fused_update`` stages of the PyTorch port
(``horovod_tpu_torch/ops/fused_update.py``) against the JAX package's
Pallas kernels (``horovod_tpu/ops/fused_update.py``, interpret mode on
the CPU), stage by stage, on shapes the exchange's own tests do not
reach: rank 1, matrices given directly at non-square ``m x c`` with a
partial last row, and a zero residual.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
are held against the same plain versions on the card by
``chip_smoke.py``), so this is the kernels' CPU coverage.  Tolerance:
``acc`` bitwise (one multiply and one add per element in both), every
product within ``REL`` of the reference's largest entry.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_update as jfu
from horovod_tpu_torch.ops import fused_update as tfu
from horovod_tpu_torch.ops import registry

REL = 1e-5                  # of max |reference|: f32 sums reordered

# (m, c, r, size): non-square arenas, the last row partial where size <
# m * c, rank 1 among them.
SHAPES = [(6, 10, 1, 57), (12, 5, 3, 60), (9, 31, 4, 270), (40, 7, 1, 280)]
RESIDUALS = ["none", "zero", "random"]


def _close(got, want, msg=""):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _padded(a, m, c):
    return np.concatenate([a, np.zeros(m * c - a.size, a.dtype)]).reshape(
        m, c)


def _inputs(m, c, r, size, residual, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(size).astype(np.float32)
    q0 = rng.randn(c, r).astype(np.float32)
    res = {"none": None, "zero": np.zeros(size, np.float32),
           "random": rng.randn(size).astype(np.float32)}[residual]
    return x, q0, res


def _stage1(m, c, r, size, residual, seed, prescale=0.5):
    x, q0, res = _inputs(m, c, r, size, residual, seed)
    acc_j, p_j = jfu.matricize_p(
        jnp.asarray(_padded(x, m, c)),
        None if res is None else jnp.asarray(_padded(res, m, c)),
        jnp.asarray(q0), prescale=prescale)
    acc_t, p_t = tfu.matricize_p(
        torch.from_numpy(x), None if res is None else torch.from_numpy(res),
        torch.from_numpy(q0), rows=m, prescale=prescale)
    return acc_j, p_j, acc_t, p_t


@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("m,c,r,size", SHAPES)
def test_matricize_p_matches_jax_kernel(m, c, r, size, residual):
    """Stage 1 (``acc = x * prescale + residual`` over the ``[m, c]``
    view, zero past the bucket; ``p = acc @ q0``) against the Pallas
    kernel."""
    acc_j, p_j, acc_t, p_t = _stage1(m, c, r, size, residual, seed=m * c)
    assert tuple(acc_t.shape) == (m, c) and tuple(p_t.shape) == (m, r)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(acc_t.reshape(-1)[size:].numpy(), 0.0)
    _close(p_t, p_j, msg="p")
    assert not any(registry.launch_counts().values())


@pytest.mark.parametrize("m,c,r,size", SHAPES)
def test_zero_residual_is_no_residual(m, c, r, size):
    """A zero residual adds nothing: stage 1 bitwise the call without
    one (``x * 0.5 + 0`` is exact)."""
    _, _, acc0, p0 = _stage1(m, c, r, size, "zero", seed=3)
    _, _, acc1, p1 = _stage1(m, c, r, size, "none", seed=3)
    np.testing.assert_array_equal(acc0.numpy(), acc1.numpy())
    np.testing.assert_array_equal(p0.numpy(), p1.numpy())


@pytest.mark.parametrize("m,c,r,size", SHAPES)
def test_orthonormalize_q_matches_jax_kernel(m, c, r, size):
    """Stage 2 (modified Gram-Schmidt of the mean P, ``q_local = acc^T
    @ p_orth``) on the JAX stage 1's outputs, against the Pallas
    kernel; ``p_orth`` orthonormal."""
    acc_j, p_j, _, _ = _stage1(m, c, r, size, "random", seed=m + c)
    po_j, ql_j = jfu.orthonormalize_q(acc_j, p_j)
    po_t, ql_t = tfu.orthonormalize_q(torch.tensor(np.asarray(acc_j)),
                                      torch.tensor(np.asarray(p_j)))
    _close(po_t, po_j, msg="p_orth")
    _close(ql_t, ql_j, msg="q_local")
    np.testing.assert_allclose((po_t.T @ po_t).numpy(), np.eye(r),
                               atol=1e-5)


@pytest.mark.parametrize("n_scale,postscale", [(1.0, 1.0), (4.0, 0.125)])
@pytest.mark.parametrize("m,c,r,size", SHAPES)
def test_reconstruct_residual_matches_jax_kernel(m, c, r, size, n_scale,
                                                 postscale):
    """Stage 3 (``out = p_orth q_mean^T * n_scale * postscale``,
    ``residual = acc - p_orth q_local^T``) at the bucket's flat length,
    with a mean Q unlike Q_local, against the Pallas kernel."""
    acc_j, p_j, _, _ = _stage1(m, c, r, size, "random", seed=2 * m + c)
    po_j, ql_j = jfu.orthonormalize_q(acc_j, p_j)
    q_mean = np.asarray(ql_j) * 0.75 - 0.02
    out_j, res_j = jfu.reconstruct_residual(
        acc_j, po_j, jnp.asarray(q_mean), ql_j, n_scale=n_scale,
        postscale=postscale)
    out_t, res_t = tfu.reconstruct_residual(
        *(torch.tensor(np.asarray(a)) for a in
          (acc_j, po_j, q_mean, ql_j)), size=size, n_scale=n_scale,
        postscale=postscale)
    assert out_t.shape == res_t.shape == (size,)
    _close(out_t, np.asarray(out_j).ravel()[:size], msg="out")
    _close(res_t, np.asarray(res_j).ravel()[:size], msg="residual")


@pytest.mark.parametrize("m,c,r,size", SHAPES)
def test_zero_bucket_leaves_zero_residual(m, c, r, size):
    """An all-zero bucket and residual: every stage's output and the new
    residual are exactly zero (Gram-Schmidt's clamp keeps P finite)."""
    x = torch.zeros(size)
    q0 = torch.from_numpy(np.random.RandomState(1).randn(c, r)
                          .astype(np.float32))
    acc, p = tfu.matricize_p(x, torch.zeros(size), q0, rows=m)
    po, ql = tfu.orthonormalize_q(acc, p)
    out, res = tfu.reconstruct_residual(acc, po, ql, ql, size=size)
    for t in (acc, p, ql, out, res):
        assert bool(torch.isfinite(t).all())
        np.testing.assert_array_equal(t.numpy(), 0.0)
