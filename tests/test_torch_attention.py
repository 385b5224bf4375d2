"""PyTorch/CUDA port: attention vs the JAX package.

The same inputs, made with numpy from a seed, go through the JAX
functions and their ``horovod_tpu_torch`` counterparts.  On the CPU the
port runs its plain PyTorch versions (the CUDA kernels only build and run
on the card); the JAX side runs its Pallas kernels in interpret mode
(``HOROVOD_PALLAS_FLASH`` / ``HOROVOD_PALLAS_DECODE`` = 1) and through
``force_reference=True``.  f32 throughout, atol 1e-5 unless stated: the
two compute the same sums in another order.

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as jattn
from horovod_tpu_torch.ops import _build, registry
from horovod_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

ATOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _qkv(seed, b, h, h_kv, tq, tk, d):
    rng = np.random.RandomState(seed)
    return (_np(rng, b, h, tq, d), _np(rng, b, h_kv, tk, d),
            _np(rng, b, h_kv, tk, d))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# 1. flash_attention (plain) vs JAX flash_attention and _flash_fwd's lse
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (causal, rep, tq, tk)
    (False, 1, 16, 16), (True, 1, 16, 16),
    (False, 2, 16, 16), (True, 2, 16, 16),
    (False, 4, 16, 16), (True, 4, 16, 16),
    (True, 2, 8, 24),        # tq < tk: bottom-right causal
    (False, 2, 8, 24),
]


@pytest.mark.parametrize("causal,rep,tq,tk", FLASH_CASES)
def test_flash_matches_jax_kernel_and_lse(monkeypatch, causal, rep, tq, tk):
    h_kv = 2
    q, k, v = _qkv(0, 2, h_kv * rep, h_kv, tq, tk, 16)
    monkeypatch.setenv("HOROVOD_PALLAS_FLASH", "1")
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=8, block_kv=8))
    want_ref = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        force_reference=True))
    _, want_lse = jattn._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        scale=16 ** -0.5, causal=causal, bq=8, bk=8)
    got, lse = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                     return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [13, 37])
def test_flash_prime_length_matches_jax(t):
    """Lengths no 8-multiple block divides: the JAX dispatcher falls back
    to its reference there; the port's kernel masks the ragged edge
    itself, and its plain version is held to the same numbers."""
    q, k, v = _qkv(1, 1, 4, 2, t, t, 16)
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = tattn.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_segment_ids_dead_row(monkeypatch, causal):
    """Packed segments plus rows whose id no key carries: those DEAD rows
    give exactly zero output and lse +1e30, in both packages."""
    q, k, v = _qkv(2, 1, 4, 2, 16, 16, 16)
    qseg = np.array([[0] * 6 + [1] * 7 + [5] * 3], np.int32)
    kseg = np.array([[0] * 6 + [1] * 10], np.int32)
    monkeypatch.setenv("HOROVOD_PALLAS_FLASH", "1")
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg)))
    _, want_lse = jattn._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qseg),
        jnp.asarray(kseg), scale=16 ** -0.5, causal=causal, bq=16, bk=16)
    got, lse = tattn.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, segment_ids=_t(qseg),
        kv_segment_ids=_t(kseg), return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[:, :, -3:] == 0.0)
    assert np.all(lse.numpy()[:, :, -3:] == 1e30)
    live = np.asarray(want_lse)[:, :, :-3]
    np.testing.assert_allclose(lse.numpy()[:, :, :-3], live, atol=ATOL)


def test_attention_reference_matches_jax():
    q, k, v = _qkv(3, 2, 2, 2, 8, 12, 16)
    seg_q = np.array([[0] * 4 + [1] * 4, [2] * 8], np.int32)
    seg_k = np.array([[0] * 6 + [1] * 6, [2] * 12], np.int32)
    want = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        segment_ids=jnp.asarray(seg_q), kv_segment_ids=jnp.asarray(seg_k)))
    got = tattn.attention_reference(
        _t(q), _t(k), _t(v), causal=True, segment_ids=_t(seg_q),
        kv_segment_ids=_t(seg_k))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_flash_plain_version_is_differentiable_on_cpu():
    q, k, v = (x.requires_grad_() for x in map(_t, _qkv(4, 1, 4, 2, 8, 8,
                                                        16)))
    out = tattn.flash_attention(q, k, v, causal=True)
    out.sin().sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in (q, k, v))


def test_flash_validation():
    q, k, v = map(_t, _qkv(5, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tattn.flash_attention(q, k, v)
    q, k, v = map(_t, _qkv(5, 1, 4, 2, 8, 4, 16))
    with pytest.raises(ValueError, match="tq <= tk"):
        tattn.flash_attention(q, k, v, causal=True)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_segment_ids is required"):
        tattn.flash_attention(q, k, v, segment_ids=seg)
    with pytest.raises(ValueError, match="without segment_ids"):
        tattn.flash_attention(q, k, v, kv_segment_ids=seg)


# ---------------------------------------------------------------------------
# 2. decode_attention / paged_decode_attention (plain) vs JAX
# ---------------------------------------------------------------------------


def _decode_inputs(seed, b=4, h=4, h_kv=2, s=32, d=16, garbage=1e4):
    rng = np.random.RandomState(seed)
    q = _np(rng, b, h, 1, d)
    k = _np(rng, b, h_kv, s, d)
    v = _np(rng, b, h_kv, s, d)
    lengths = np.array([0, 1, 17, 32][:b], np.int32)
    for i, n in enumerate(lengths):
        # Large finite garbage past each length (NaN would poison both
        # packages alike through 0 * NaN).
        k[i, :, n:] = garbage
        v[i, :, n:] = -garbage
    return q, k, v, lengths


@pytest.mark.parametrize("h_kv", [1, 2, 4])
def test_decode_matches_jax_kernel_and_reference(monkeypatch, h_kv):
    q, k, v, lengths = _decode_inputs(6, h_kv=h_kv)
    args = [jnp.asarray(x) for x in (q, k, v)]
    monkeypatch.setenv("HOROVOD_PALLAS_DECODE", "1")
    want = np.asarray(jattn.decode_attention(
        *args, lengths=jnp.asarray(lengths), block_kv=8))
    want_ref = np.asarray(jattn.decode_attention(
        *args, lengths=jnp.asarray(lengths), force_reference=True))
    got = tattn.decode_attention(_t(q), _t(k), _t(v),
                                 lengths=_t(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    assert np.all(got[0] == 0.0)            # lengths == 0: exactly zero
    assert np.abs(got).max() < 10.0         # no garbage leaked


def _paged_from_contiguous(k, v, page_size, seed):
    """Scatter a contiguous (b, h_kv, s, d) cache into a shuffled page
    pool ``[b * pps + 1, page_size, h_kv, d]`` + its page table."""
    b, h_kv, s, d = k.shape
    pps = s // page_size
    rng = np.random.RandomState(seed)
    perm = rng.permutation(b * pps).astype(np.int32)
    table = perm.reshape(b, pps)
    kp = np.full((b * pps + 1, page_size, h_kv, d), 7e3, np.float32)
    vp = np.full_like(kp, -7e3)
    for i in range(b):
        for j in range(pps):
            blk = slice(j * page_size, (j + 1) * page_size)
            kp[table[i, j]] = k[i, :, blk].transpose(1, 0, 2)
            vp[table[i, j]] = v[i, :, blk].transpose(1, 0, 2)
    return kp, vp, table


def test_paged_decode_matches_gather_then_decode():
    q, k, v, lengths = _decode_inputs(7, h_kv=2)
    kp, vp, table = _paged_from_contiguous(k, v, page_size=8, seed=7)
    got = tattn.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                       _t(lengths))
    view_k = tattn.gather_pages(_t(kp), _t(table))
    np.testing.assert_array_equal(view_k.numpy(), k)
    want = tattn.decode_attention(_t(q), _t(k), _t(v), lengths=_t(lengths))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    jwant = jattn.decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=ATOL,
                               rtol=0)


def test_decode_validation():
    q, k, v, lengths = _decode_inputs(8)
    with pytest.raises(ValueError, match="single-token"):
        tattn.decode_attention(_t(k), _t(k), _t(v), lengths=_t(lengths))
    with pytest.raises(ValueError, match="lengths must be"):
        tattn.decode_attention(_t(q), _t(k), _t(v), lengths=_t(lengths[:2]))


@pytest.mark.parametrize("capacity,splits,per", [
    (4096, 8, 512), (64, 1, 512), (1000, 2, 512), (8192, 16, 512),
    (20000, 16, 1280)])
def test_decode_split_plan(capacity, splits, per):
    assert tattn.decode_splits(capacity) == (splits, per)
    assert splits * per >= capacity and per % 64 == 0


def test_attention_flops_counts_kept_pairs():
    assert tattn.attention_flops(1, 1, 4, 4, 8, False) == 4 * 16 * 8
    # causal square: 1 + 2 + 3 + 4 kept pairs
    assert tattn.attention_flops(1, 1, 4, 4, 8, True) == 4 * 10 * 8
    # tq < tk: bottom-right, row i sees tk - tq + i + 1 keys
    assert tattn.attention_flops(1, 1, 2, 5, 8, True) == 4 * (4 + 5) * 8


# ---------------------------------------------------------------------------
# Kernel plumbing: launch counters, the build command
# ---------------------------------------------------------------------------


def test_cpu_path_never_counts_a_launch():
    registry.reset_launch_counts()
    q, k, v = map(_t, _qkv(9, 1, 4, 2, 8, 8, 16))
    tattn.flash_attention(q.requires_grad_(), k, v, causal=True).sum(
        ).backward()
    qd, kd, vd, lengths = _decode_inputs(9)
    tattn.decode_attention(_t(qd), _t(kd), _t(vd), lengths=_t(lengths))
    pool = torch.zeros(5, 4, 2, 8)
    table = torch.arange(4, dtype=torch.int32).view(2, 2)
    tattn.paged_decode_attention_fp8(
        torch.ones(2, 4, 1, 8), pool, pool, table,
        torch.tensor([3, 8], dtype=torch.int32),
        pool.to(torch.float8_e4m3fn), pool.to(torch.float8_e4m3fn),
        torch.ones(5, 4), torch.ones(5, 4), table,
        torch.tensor([[True, False], [False, True]]))
    families = {"flash", "flash_decode", "flash_decode_fp8",
                "flash_bwd_dq", "flash_bwd_dkv",
                "bn_bwd_reduce", "bn_bwd_dx", "fused_update_matricize_p",
                "fused_update_orthonormalize_q", "fused_update_reconstruct"}
    assert registry.launch_counts() == dict.fromkeys(families, 0)
    assert set(registry.KERNEL_CONTRACTS) == families


def test_build_command_targets_sm90a_without_running_nvcc():
    out = os.path.join(_build.BUILD_DIR, "x.so")
    assert set(_build.SOURCES) == {"flash_fwd", "flash_decode", "flash_bwd",
                                   "bn_bwd", "fused_update"}
    for name in _build.SOURCES:
        cmd = _build.nvcc_command(name, out)
        joined = " ".join(cmd)
        assert "-gencode arch=compute_90a,code=sm_90a" in joined
        assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
        assert cmd[-1].endswith(os.path.join("csrc", f"{name}.cu"))
        assert os.path.exists(cmd[-1])
        # The library name carries a hash of the sources.
        path = _build.library_path(name)
        assert os.path.basename(path).startswith(f"lib{name}_")
        assert path == _build.library_path(name)


def test_cuda_sources_export_the_bound_symbols():
    """Every C entry point the ctypes binding declares is defined
    ``extern "C"`` in its source, with as many parameters as argtypes."""
    for name, (source, sym, argtypes) in _build.ENTRIES.items():
        src = open(os.path.join(_build.CSRC, f"{source}.cu")).read()
        head = src.split(f'extern "C" int {sym}(', 1)
        assert len(head) == 2, sym
        params = head[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(argtypes), sym
