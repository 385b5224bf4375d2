"""PyTorch/CUDA port: the BatchNorm backward and module vs the JAX package.

The same inputs, made with numpy from a seed, go through the port's plain
PyTorch versions (the CPU path of ``horovod_tpu_torch/ops/bn.py``) and
through ``horovod_tpu/ops/bn.py``: its two Pallas kernels in interpret
mode (``HOROVOD_PALLAS_BN=1``) and its XLA closed form
(``HOROVOD_PALLAS_BN=0``), each called anew under its setting, as
``tests/test_ops_bn.py`` does.

Tolerances: f32 rtol 1e-5 with atol 1e-5 (the sums only run in another
order); bf16 activations: dx within 1e-2 (one bf16 rounding of values of
order 1, in f32 after it), dgamma / dbeta within 1e-4 (f32 sums of the
same bf16 inputs).  The module's running statistics 1e-6 (one f32 EMA
step of equal statistics).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import bn as jbn
from horovod_tpu_torch.ops import bn as tbn
from horovod_tpu_torch.ops import registry

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_DX = dict(rtol=1e-2, atol=1e-2)
BF16_SUMS = dict(rtol=1e-4, atol=1e-4)
STATS = dict(rtol=1e-6, atol=1e-6)
EPS = 1e-5


def _bf16_exact(a):
    """f32 numpy values that bf16 represents exactly (both packages then
    start from the same bf16 tensor)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(n, c, dtype, seed=0, shape=None):
    rng = np.random.RandomState(seed)
    shape = shape or (n, c)
    x = (2.0 * rng.randn(*shape) + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    if dtype == "bfloat16":
        x, dy = _bf16_exact(x), _bf16_exact(dy)
    return x, dy, scale


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, dtype=np.float32)


# ---------------------------------------------------------------------------
# fused_bn_backward and batch_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [37, 512])
@pytest.mark.parametrize("c", [3, 8, 64])
def test_fused_bn_backward_matches_jax(monkeypatch, c, n, dtype):
    x, dy, scale = _inputs(n, c, dtype, seed=c + n)
    jx, jdy = _jax(x, dtype), _jax(dy, dtype)
    jmean, jvar = jbn.batch_stats(jx)
    tx, tdy = _torch(x, dtype), _torch(dy, dtype)
    mean, var = tbn.batch_stats(tx)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **F32)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **F32)
    registry.reset_launch_counts()
    got = tbn.fused_bn_backward(tx, torch.from_numpy(scale), mean, var,
                                tdy, eps=EPS)
    assert not any(registry.launch_counts().values())
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32
    tols = (F32, F32, F32) if dtype == "float32" else \
        (BF16_DX, BF16_SUMS, BF16_SUMS)
    for flag in ("1", "0"):           # interpret-mode kernels, closed form
        monkeypatch.setenv("HOROVOD_PALLAS_BN", flag)
        want = jbn.fused_bn_backward(jx, jnp.asarray(scale), jmean, jvar,
                                     jdy, eps=EPS)
        for g, w, tol in zip(got, want, tols):
            assert g.shape == tuple(w.shape)
            np.testing.assert_allclose(_np(g), _np(w), **tol)


def test_fused_bn_backward_reduces_over_every_axis_but_the_last():
    """An NHWC tensor and its [N*H*W, C] view give the same result."""
    x, dy, scale = _inputs(0, 16, "float32", seed=3, shape=(2, 5, 5, 16))
    tx, tdy, ts = map(torch.from_numpy, (x, dy, scale))
    mean, var = tbn.batch_stats(tx)
    four = tbn.fused_bn_backward(tx, ts, mean, var, tdy, eps=EPS)
    two = tbn.fused_bn_backward(tx.view(50, 16), ts, mean, var,
                                tdy.view(50, 16), eps=EPS)
    assert four[0].shape == (2, 5, 5, 16)
    for a, b in zip(four, two):
        assert torch.equal(a.reshape(b.shape), b)


def test_fused_bn_backward_passes_are_the_closed_form():
    """Each pass alone: ``bn_backward_reduce`` gives the two sums, and
    ``bn_backward_dx`` the closed form from them."""
    x, dy, scale = _inputs(40, 8, "float32", seed=4)
    tx, tdy, ts = map(torch.from_numpy, (x, dy, scale))
    mean, var = tbn.batch_stats(tx)
    inv = torch.rsqrt(var + EPS)
    dbeta, dgamma = tbn.bn_backward_reduce(tx, tdy, mean, inv)
    xhat = (x - mean.numpy()) * inv.numpy()
    np.testing.assert_allclose(dbeta.numpy(), dy.sum(0), **F32)
    np.testing.assert_allclose(dgamma.numpy(), (dy * xhat).sum(0), **F32)
    dx = tbn.bn_backward_dx(tx, tdy, mean, inv, ts, dbeta, dgamma)
    want = scale * inv.numpy() * (dy - dbeta.numpy() / 40
                                  - xhat * dgamma.numpy() / 40)
    np.testing.assert_allclose(dx.numpy(), want, **F32)


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 3)
    stats = (torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="dy"):
        tbn.bn_backward_reduce(x, torch.zeros(4, 2), *stats)
    with pytest.raises(ValueError, match="empty"):
        tbn.bn_backward_reduce(torch.zeros(0, 3), torch.zeros(0, 3), *stats)
    # Neither CPU nor CUDA: no path, and no silent fallback.
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbn.bn_backward_reduce(meta, meta, *(s.to("meta") for s in stats))


@pytest.mark.parametrize("n,c,chunks", [
    (37, 3, 1), (1000, 8, 16), (3211264, 64, 1056), (802816, 256, 1056),
    (12544, 2048, 132)])
def test_reduce_chunks_fill_the_card(n, c, chunks):
    """The chunk plan: 1056 CTAs (8 per SM) over the channel tiles, at
    least 64 rows a chunk."""
    assert tbn.reduce_chunks(n, c) == chunks


# ---------------------------------------------------------------------------
# bn_train under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_matches_jax_vjp(monkeypatch, dtype):
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")
    x, dy, scale = _inputs(0, 32, dtype, seed=5, shape=(2, 6, 6, 32))
    bias = np.random.RandomState(6).randn(32).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, s, b: jbn.bn_train(a, s, b, EPS),
                      _jax(x, dtype), jnp.asarray(scale), jnp.asarray(bias))
    jgrads = vjp(_jax(dy, dtype))
    tx = _torch(x, dtype).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    ty = tbn.bn_train(tx, ts, tb, EPS)
    assert ty.dtype == tx.dtype
    ty.backward(_torch(dy, dtype))
    if dtype == "float32":
        tols = (F32, F32, F32, F32)
    else:
        tols = (BF16_DX, BF16_DX, BF16_SUMS, BF16_SUMS)
    for g, w, tol in zip((ty, tx.grad, ts.grad, tb.grad),
                         (jy, *jgrads), tols):
        np.testing.assert_allclose(_np(g.detach()), _np(w), **tol)


# ---------------------------------------------------------------------------
# The BatchNorm module
# ---------------------------------------------------------------------------


def _flax_variables(c, seed):
    """flax BatchNorm variables with every leaf drawn away from its
    initial value (so a swapped or ignored leaf shows)."""
    rng = np.random.RandomState(seed)
    return {"params": {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                       "bias": (0.1 * rng.randn(c)).astype(np.float32)},
            "batch_stats": {
                "mean": (0.1 * rng.randn(c)).astype(np.float32),
                "var": (1 + 0.1 * rng.rand(c)).astype(np.float32)}}


def _port_bn(variables, c):
    m = tbn.BatchNorm(c, momentum=0.9, epsilon=EPS, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for col in variables.values()
                       for k, v in col.items()})
    return m


@pytest.mark.parametrize("reference", ["horovod_tpu.ops.bn",
                                       "flax.linen"])
def test_batchnorm_module_matches_jax(monkeypatch, reference):
    """Train output and running-stat update, then the eval output, against
    the JAX package's BatchNorm (kernels in interpret mode) and flax's,
    both at momentum 0.9."""
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")
    cls = jbn.BatchNorm if reference == "horovod_tpu.ops.bn" else \
        nn.BatchNorm
    c = 16
    variables = _flax_variables(c, seed=7)
    x = np.random.RandomState(8).randn(4, 6, 6, c).astype(np.float32)
    theirs = cls(momentum=0.9, epsilon=EPS)
    jv = jax.tree.map(jnp.asarray, variables)
    y_want, mutated = theirs.apply(jv, jnp.asarray(x),
                                   use_running_average=False,
                                   mutable=["batch_stats"])
    eval_want = theirs.apply(jv, jnp.asarray(x), use_running_average=True)

    ours = _port_bn(variables, c)
    assert set(ours.state_dict()) == {"scale", "bias", "mean", "var"}
    y = ours(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), **F32)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(ours, name).numpy(),
            np.asarray(mutated["batch_stats"][name]), **STATS)
    ours.eval()
    stats = {k: v.clone() for k, v in ours.named_buffers()}
    ours.load_state_dict({k: torch.from_numpy(v) for col in
                          variables.values() for k, v in col.items()})
    y_eval = ours(torch.from_numpy(x))
    np.testing.assert_allclose(y_eval.detach().numpy(),
                               np.asarray(eval_want), **F32)
    # Eval mode leaves the running statistics alone.
    assert torch.equal(ours.mean, torch.from_numpy(
        variables["batch_stats"]["mean"]))
    assert not torch.equal(stats["mean"], ours.mean)


def test_batchnorm_running_stats_are_flax_not_torch():
    """``ra = m * ra + (1 - m) * batch`` with the BIASED variance;
    ``torch.nn.BatchNorm2d`` at momentum 0.9 keeps the unbiased variance
    and weights the batch by 0.9 instead."""
    c = 4
    x = torch.from_numpy(np.random.RandomState(9).randn(3, 2, 2, c).astype(
        np.float32))
    ours = tbn.BatchNorm(c, momentum=0.9, device="cpu")
    ours(x)
    flat = x.reshape(-1, c).double()
    mean = flat.mean(0)
    biased = flat.var(0, unbiased=False)
    np.testing.assert_allclose(ours.mean.numpy(), 0.1 * mean.numpy(),
                               **STATS)
    np.testing.assert_allclose(ours.var.numpy(),
                               0.9 + 0.1 * biased.numpy(), **STATS)
    theirs = torch.nn.BatchNorm2d(c, momentum=0.9)
    theirs(x.permute(0, 3, 1, 2))
    assert not np.allclose(theirs.running_var.numpy(), ours.var.numpy(),
                           rtol=1e-3)


def test_batchnorm_dtype_and_scale_init():
    m = tbn.BatchNorm(8, dtype=torch.bfloat16, scale_init=0.0,
                      device="cpu")
    assert m.scale.dtype == m.bias.dtype == m.mean.dtype == torch.float32
    assert torch.equal(m.scale, torch.zeros(8))
    y = m(torch.randn(2, 3, 3, 8))
    assert y.dtype == torch.bfloat16
    # A zero scale passes the bias through: here, zeros.
    assert torch.equal(y.float(), torch.zeros_like(y.float()))
