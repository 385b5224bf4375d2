"""PyTorch/CUDA port: flash attention's backward vs the JAX package.

The same inputs, made with numpy from a seed, go through ``jax.grad`` of
``horovod_tpu.ops.attention.flash_attention`` -- with
``HOROVOD_PALLAS_FLASH=1``, i.e. its ``_flash_bwd`` Pallas kernels in
interpret mode, as ``tests/test_ops_attention.py`` runs them; at a prime
length the JAX dispatcher takes its reference, and so does this test --
and through the port on the CPU, two ways:

* its plain backward, :func:`flash_attention_backward_reference`, from
  the forward's saved ``o`` and ``lse``;
* its autograd path, ``flash_attention(...).backward()``, whose backward
  on CPU tensors is that plain backward.

f32 throughout; tolerance 2e-5 absolute on dq/dk/dv (the two packages
compute the same sums in another order; gradients sum over a whole
sequence, hence twice the forward's 1e-5).  The CUDA kernels are held
against the plain backward on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as jattn
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import registry

torch.set_num_threads(2)

ATOL = 2e-5
D = 16


def _inputs(seed, b, h, h_kv, tq, tk):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((b, h, tq, D), (b, h_kv, tk, D), (b, h_kv, tk, D),
             (b, h, tq, D))]


def _jax_grads(q, k, v, do, **kw):
    """``d sum(flash_attention(q, k, v) * do) / d(q, k, v)`` in JAX."""
    do = jnp.asarray(do)

    def f(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, **kw) * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, do, **kw):
    """``(plain backward, autograd path)`` grads from the port."""
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    seg = {n: torch.from_numpy(np.asarray(kw[n]))
           for n in ("segment_ids", "kv_segment_ids") if n in kw}
    kw = {**kw, **seg}
    o, lse = tattn.flash_attention(tq_, tk_, tv_, return_lse=True, **kw)
    plain = tattn.flash_attention_backward_reference(tq_, tk_, tv_, o, lse,
                                                     tdo, **kw)
    leaves = [x.clone().requires_grad_() for x in (tq_, tk_, tv_)]
    (tattn.flash_attention(*leaves, **kw) * tdo).sum().backward()
    return ([g.numpy() for g in plain], [x.grad.numpy() for x in leaves])


CASES = [
    # (causal, rep, tq, tk)
    (False, 1, 16, 16), (True, 1, 16, 16),
    (False, 4, 16, 16), (True, 4, 16, 16),
    (True, 1, 8, 24), (True, 4, 8, 24),        # tq < tk: bottom-right
    (False, 4, 8, 24),
]


@pytest.mark.parametrize("causal,rep,tq,tk", CASES)
def test_backward_matches_jax_interpret_kernels(monkeypatch, causal, rep,
                                                tq, tk):
    """dq/dk/dv against ``_flash_bwd``'s interpret-mode dq and dk/dv
    kernels (blocks of 8, so several q and kv blocks, with the causal
    block skipping and the per-query-head dk/dv group sum)."""
    monkeypatch.setenv("HOROVOD_PALLAS_FLASH", "1")
    q, k, v, do = _inputs(0, 2, 2 * rep, 2, tq, tk)
    want = _jax_grads(q, k, v, do, causal=causal, block_q=8, block_kv=8)
    plain, auto = _port_grads(q, k, v, do, causal=causal)
    for got in (plain, auto):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [13, 37])
def test_backward_prime_length_matches_jax(monkeypatch, t):
    """Lengths no 8-multiple block divides: the JAX dispatcher falls back
    to its reference (and differentiates it); the port's kernels mask the
    ragged edge and its plain backward is held to the same numbers."""
    monkeypatch.setenv("HOROVOD_PALLAS_FLASH", "1")
    q, k, v, do = _inputs(1, 1, 4, 1, t, t)
    want = _jax_grads(q, k, v, do, causal=True)
    for got in _port_grads(q, k, v, do, causal=True):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_segment_ids_dead_rows_give_zero(monkeypatch, causal):
    """Packed segments, query rows whose id no key has (DEAD rows) and
    keys whose id no query has: exactly zero dq on those rows and zero
    dk/dv on those keys, in both packages (the Pallas kernels run with one
    block over the whole 16-token sequence)."""
    monkeypatch.setenv("HOROVOD_PALLAS_FLASH", "1")
    q, k, v, do = _inputs(2, 1, 4, 2, 16, 16)
    qseg = np.array([[0] * 6 + [1] * 7 + [5] * 3], np.int32)
    kseg = np.array([[0] * 6 + [1] * 8 + [6] * 2], np.int32)
    kw = dict(causal=causal, segment_ids=qseg, kv_segment_ids=kseg)
    want = _jax_grads(q, k, v, do, **{**kw, "segment_ids": jnp.asarray(
        qseg), "kv_segment_ids": jnp.asarray(kseg)})
    assert np.all(want[0][:, :, -3:] == 0.0)
    for got in _port_grads(q, k, v, do, **kw):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        dq, dk, dv = got
        assert np.all(dq[:, :, -3:] == 0.0)
        assert np.all(dk[:, :, -2:] == 0.0) and np.all(dv[:, :, -2:] == 0.0)


def test_backward_entry_points_agree_and_never_count_on_cpu():
    """``flash_attention_backward`` = dq kernel's plain version + dk/dv
    kernel's plain version from ``delta = rowsum(dO * O)``; the CPU path
    counts no launch."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 2, 4, 2, 12, 12))
    o, lse = tattn.flash_attention(q, k, v, causal=True, return_lse=True)
    registry.reset_launch_counts()
    dq, dk, dv = tattn.flash_attention_backward(q, k, v, o, lse, do,
                                                causal=True)
    delta = (do * o).sum(-1)
    assert torch.equal(dq, tattn.flash_backward_dq(q, k, v, do, lse, delta,
                                                   causal=True))
    dk2, dv2 = tattn.flash_backward_dkv(q, k, v, do, lse, delta, causal=True)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert dk.shape == k.shape and dq.dtype == q.dtype
    assert not any(registry.launch_counts().values())


def test_backward_flops_count_three_and_four_products():
    """The bounds' accounting: dq does 3 products per kept pair, dk/dv 4,
    the forward 2 (Llama-3 8B training shape: 134.3 M kept pairs)."""
    pairs = 2 * 32 * 2048 * 2049 // 2
    assert tattn.attention_flops(2, 32, 2048, 2048, 128, True, 3) == \
        2 * 3 * 128 * pairs
    assert tattn.attention_flops(2, 32, 2048, 2048, 128, True, 4) == \
        2 * 4 * 128 * pairs
    assert tattn.attention_flops(1, 1, 4, 4, 8, True) == \
        tattn.attention_flops(1, 1, 4, 4, 8, True, 2)
