"""PyTorch/CUDA port on the card: each CUDA kernel against its plain
PyTorch version, on the same inputs made with numpy from a seed, and the
GPU-only launch-count checks.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The module imports nothing of JAX, so it runs on a GPU machine that has
no JAX; run it there without the suite's JAX conftest::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 atol 1e-5 (the kernels only reorder the sums), and 1e-5
of max |grad| for the backward's gradients; bf16 2e-2 of the reference's
largest |value| (one bf16 rounding of the output, plus f32 sums in
another order).  The BatchNorm backward: dx within 1e-5 (f32) or 2e-2
(bf16) of max |dx|, dgamma and dbeta within 1e-4 of their max |value|
(sums over up to 3.2 M rows in another order).  The PowerSGD stages:
``acc`` bitwise (one f32 multiply and one add on both sides), every
other output within 1e-5 of its max |value| (sums over up to 3,880 terms
in another order).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.collectives.compression import powersgd_matrix_shape
from horovod_tpu_torch.collectives.ops import _powersgd_seed_matrix
from horovod_tpu_torch.models.transformer import tied_readout
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import bn as tbn
from horovod_tpu_torch.ops import fused_update as tfu
from horovod_tpu_torch.ops import registry

ATOL = 1e-5
F32_GRAD_REL = 1e-5
MODEL_F32_GRAD_REL = 1e-3   # a whole model's f32 backward: the sums'
                            # order compounds through the BN sites
BF16_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _tol(want, dtype):
    if dtype == torch.float32:
        return ATOL
    return BF16_REL * want.float().abs().max().item()


def _grad_tol(want, dtype):
    """Gradients sum over whole sequences (dk/dv over every query of a
    GQA group), so both tolerances are relative to max |grad|."""
    rel = F32_GRAD_REL if dtype == torch.float32 else BF16_REL
    return rel * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk", [(37, 37), (16, 80)])
def test_cuda_flash_kernel_matches_plain(cuda, dtype, tq, tk):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(10)
    q, k, v = (_randn(rng, *s).to(cuda, dt) for s in (
        (1, 8, tq, 128), (1, 2, tk, 128), (1, 2, tk, 128)))
    registry.reset_launch_counts()
    got, lse = tattn.flash_attention(q, k, v, causal=True, return_lse=True)
    assert registry.launches("flash") == 1
    want, want_lse = tattn.flash_attention(q, k, v, causal=True,
                                           return_lse=True,
                                           force_reference=True)
    assert (got.float() - want.float()).abs().max().item() <= _tol(want, dt)
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_flash_kernel_dead_rows_and_no_autograd(cuda):
    """Dead rows: O = 0 and lse = +1e30 from the forward kernel, and
    exactly zero gradients from the backward kernels (the forward-only
    refusal this test once checked is gone: autograd now runs them)."""
    rng = np.random.RandomState(13)
    q, k, v = (_randn(rng, 1, 4, 40, 64).to(cuda) for _ in range(3))
    seg = torch.tensor([[0] * 20 + [1] * 17 + [9] * 3], dtype=torch.int32,
                       device=cuda)
    kseg = torch.tensor([[0] * 20 + [1] * 20], dtype=torch.int32,
                        device=cuda)
    got, lse = tattn.flash_attention(q, k, v, segment_ids=seg,
                                     kv_segment_ids=kseg, return_lse=True)
    want = tattn.flash_attention(q, k, v, segment_ids=seg,
                                 kv_segment_ids=kseg, force_reference=True)
    assert (got - want).abs().max().item() <= ATOL
    assert got[:, :, -3:].abs().max().item() == 0.0
    assert bool((lse[:, :, -3:] == 1e30).all())
    q.requires_grad_()
    registry.reset_launch_counts()
    tattn.flash_attention(q, k, v, segment_ids=seg,
                          kv_segment_ids=kseg).sum().backward()
    assert registry.launches("flash_bwd_dq") == 1
    assert q.grad[:, :, -3:].abs().max().item() == 0.0


def _bwd_inputs(rng, b, h, h_kv, tq, tk, d, dtype, cuda):
    q = _randn(rng, b, h, tq, d).to(cuda, dtype)
    k = _randn(rng, b, h_kv, tk, d).to(cuda, dtype)
    v = _randn(rng, b, h_kv, tk, d).to(cuda, dtype)
    do = _randn(rng, b, h, tq, d).to(cuda, dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,rep,tq,tk,seg", [
    (True, 4, 37, 37, False), (True, 1, 70, 70, False),
    (True, 4, 16, 80, False), (False, 4, 37, 53, False),
    (True, 2, 64, 64, True)])
def test_cuda_flash_backward_kernels_match_plain(cuda, dtype, causal, rep,
                                                 tq, tk, seg):
    """dq and dk/dv from the kernels against the plain backward, on the
    same saved ``o``/``lse``; with segment ids the last rows are dead and
    their dq must be exactly zero."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(14)
    q, k, v, do = _bwd_inputs(rng, 2, 2 * rep, 2, tq, tk, 128, dt, cuda)
    kw = dict(causal=causal)
    if seg:
        qs = torch.zeros(2, tq, dtype=torch.int32, device=cuda)
        qs[:, tq // 2:] = 1
        qs[:, -5:] = 9
        ks = torch.zeros(2, tk, dtype=torch.int32, device=cuda)
        ks[:, tk // 2:] = 1
        kw.update(segment_ids=qs, kv_segment_ids=ks)
    o, lse = tattn.flash_attention(q, k, v, return_lse=True, **kw)
    registry.reset_launch_counts()
    got = tattn.flash_attention_backward(q, k, v, o, lse, do, **kw)
    assert registry.launches("flash_bwd_dq") == 1
    assert registry.launches("flash_bwd_dkv") == 1
    want = tattn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                    **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= \
            _grad_tol(w, dt)
    if seg:
        assert got[0][:, :, -5:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_flash_autograd_matches_plain_autograd(cuda):
    """``flash_attention`` under autograd (kernel forward + the two
    backward kernels) against plain attention under autograd."""
    rng = np.random.RandomState(15)
    base = _bwd_inputs(rng, 1, 8, 2, 48, 48, 64, torch.float32, cuda)
    grads = []
    for ref in (False, True):
        q, k, v = (x.clone().requires_grad_() for x in base[:3])
        registry.reset_launch_counts()
        out = tattn.flash_attention(q, k, v, causal=True,
                                    force_reference=ref)
        (out * base[3]).sum().backward()
        n = 0 if ref else 1
        assert registry.launch_counts() == {
            **dict.fromkeys(registry.KERNEL_CONTRACTS, 0),
            "flash": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        grads.append((q.grad, k.grad, v.grad))
    for g, w in zip(*grads):
        assert (g - w).abs().max().item() <= 1e-4


# The bf16 tensor-core kernels (flash_fwd_mma_kernel, 128-row query tiles
# over 64-key tiles; flash_bwd_dkv_mma_kernel, 64-key blocks over 64-row
# query tiles): shapes spanning several tiles with ragged ends, both head
# dims, GQA and not, causal and not.
MMA_SHAPES = [(300, 300), (1000, 1000), (200, 1000)]


def _mma_inputs(seed, rep, tq, tk, d, cuda):
    rng = np.random.RandomState(seed)
    return _bwd_inputs(rng, 1, 2 * rep, 2, tq, tk, d, torch.bfloat16, cuda)


def _mma_segments(tq, tk, cuda):
    """Two packed segments; the last 5 query rows carry an id no key has
    (DEAD rows) and the last 7 keys an id no query has (dead keys)."""
    qs = torch.zeros(1, tq, dtype=torch.int32, device=cuda)
    qs[:, tq // 3:] = 1
    qs[:, -5:] = 9
    ks = torch.zeros(1, tk, dtype=torch.int32, device=cuda)
    ks[:, tk - (2 * tq) // 3:] = 1
    ks[:, -7:] = 8
    return qs, ks


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", MMA_SHAPES)
def test_cuda_flash_mma_forward_matches_plain(cuda, tq, tk, d, rep, causal):
    q, k, v, _ = _mma_inputs(20, rep, tq, tk, d, cuda)
    registry.reset_launch_counts()
    got, lse = tattn.flash_attention(q, k, v, causal=causal,
                                     return_lse=True)
    assert registry.launches("flash") == 1
    want, want_lse = tattn.flash_attention(q, k, v, causal=causal,
                                           return_lse=True,
                                           force_reference=True)
    assert bool(torch.isfinite(got.float()).all())
    assert (got.float() - want.float()).abs().max().item() <= \
        _tol(want, torch.bfloat16)
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", MMA_SHAPES)
def test_cuda_flash_mma_dkv_matches_plain(cuda, tq, tk, d, rep, causal):
    q, k, v, do = _mma_inputs(21, rep, tq, tk, d, cuda)
    o, lse = tattn.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    registry.reset_launch_counts()
    got = tattn.flash_backward_dkv(*args, causal=causal)
    assert registry.launches("flash_bwd_dkv") == 1
    want = tattn.flash_backward_dkv(*args, causal=causal,
                                    force_reference=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert (g.float() - w.float()).abs().max().item() <= \
            _grad_tol(w, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", MMA_SHAPES)
def test_cuda_flash_mma_segments_dead_rows_and_keys(cuda, tq, tk, d):
    """Dead rows: O exactly 0 and lse +1e30; dead keys: dk and dv exactly
    0; the rest within the bf16 tolerance of the plain versions."""
    q, k, v, do = _mma_inputs(22, 4, tq, tk, d, cuda)
    qs, ks = _mma_segments(tq, tk, cuda)
    kw = dict(causal=True, segment_ids=qs, kv_segment_ids=ks)
    o, lse = tattn.flash_attention(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = tattn.flash_attention(q, k, v, return_lse=True,
                                           force_reference=True, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= \
        _tol(o_ref, torch.bfloat16)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert o[:, :, -5:].abs().max().item() == 0.0
    assert bool((lse[:, :, -5:] == 1e30).all())
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = tattn.flash_backward_dkv(*args, **kw)
    want = tattn.flash_backward_dkv(*args, force_reference=True, **kw)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() <= \
            _grad_tol(w, torch.bfloat16)
        assert g[:, :, -7:].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", MMA_SHAPES)
def test_cuda_flash_mma_dq_matches_plain(cuda, tq, tk, d, rep, causal):
    """flash_bwd_dq_mma_kernel (128-row query tiles over 64-key tiles)
    against the plain dq on the same saved ``lse`` and ``delta``."""
    q, k, v, do = _mma_inputs(24, rep, tq, tk, d, cuda)
    o, lse = tattn.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    registry.reset_launch_counts()
    got = tattn.flash_backward_dq(*args, causal=causal)
    assert registry.launches("flash_bwd_dq") == 1
    want = tattn.flash_backward_dq(*args, causal=causal,
                                   force_reference=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert (got.float() - want.float()).abs().max().item() <= \
        _grad_tol(want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tq,tk", MMA_SHAPES)
def test_cuda_flash_mma_dq_segments_dead_rows(cuda, tq, tk, d):
    """Dead rows (lse +1e30) get dq exactly 0; the rest within the bf16
    tolerance of the plain dq."""
    q, k, v, do = _mma_inputs(25, 4, tq, tk, d, cuda)
    qs, ks = _mma_segments(tq, tk, cuda)
    kw = dict(causal=True, segment_ids=qs, kv_segment_ids=ks)
    o, lse = tattn.flash_attention(q, k, v, return_lse=True, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = tattn.flash_backward_dq(*args, **kw)
    want = tattn.flash_backward_dq(*args, force_reference=True, **kw)
    assert (got.float() - want.float()).abs().max().item() <= \
        _grad_tol(want, torch.bfloat16)
    assert got[:, :, -5:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_flash_mma_kernels_repeat_bitwise(cuda):
    """No atomics and a fixed order of sums: two launches of each bf16
    kernel give the same bits."""
    q, k, v, do = _mma_inputs(23, 4, 1000, 1000, 128, cuda)
    o1, lse1 = tattn.flash_attention(q, k, v, causal=True, return_lse=True)
    o2, lse2 = tattn.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    delta = (do.float() * o1.float()).sum(-1)
    args = (q, k, v, do, lse1, delta)
    dk1, dv1 = tattn.flash_backward_dkv(*args, causal=True)
    dk2, dv2 = tattn.flash_backward_dkv(*args, causal=True)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    dq1 = tattn.flash_backward_dq(*args, causal=True)
    dq2 = tattn.flash_backward_dq(*args, causal=True)
    assert torch.equal(dq1, dq2)


@pytest.mark.cuda
def test_cuda_flash_mma_kernels_do_not_spill(cuda):
    """The bf16 tensor-core kernels, at both head dims, keep everything
    in registers: no local-memory stack and no spill stores or loads."""
    found = {}
    for src, kernel in (("flash_fwd", "flash_fwd_mma_kernel"),
                        ("flash_bwd", "flash_bwd_dkv_mma_kernel"),
                        ("flash_bwd", "flash_bwd_dq_mma_kernel")):
        usage = _build.resource_usage(src)
        mine = {n: u for n, u in usage.items() if kernel in n}
        assert len(mine) == 2, (kernel, sorted(usage))   # d = 64 and 128
        found.update(mine)
    for name, u in found.items():
        assert u.get("STACK", 0) == 0 and u.get("LOCAL", 0) == 0, (name, u)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_decode_kernel_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(11)
    slots, ps, pps, h, h_kv, d = 4, 8, 8, 8, 2, 128
    lengths = torch.tensor([0, 1, 17, 64], dtype=torch.int32, device=cuda)
    table = torch.from_numpy(rng.permutation(slots * pps).astype(np.int32)
                             ).view(slots, pps).to(cuda)
    # Large finite garbage everywhere the lengths do not reach.
    kp = torch.full((slots * pps + 1, ps, h_kv, d), 3e4)
    vp = torch.full_like(kp, -3e4)
    for s in range(slots):
        for pos in range(int(lengths[s])):
            pg = int(table[s, pos // ps])
            kp[pg, pos % ps] = _randn(rng, h_kv, d)
            vp[pg, pos % ps] = _randn(rng, h_kv, d)
    kp, vp = kp.to(cuda, dt), vp.to(cuda, dt)
    q = _randn(rng, slots, h, 1, d).to(cuda, dt)
    registry.reset_launch_counts()
    got = tattn.paged_decode_attention(q, kp, vp, table, lengths)
    view = tattn.decode_attention(
        q, tattn.gather_pages(kp, table).contiguous(),
        tattn.gather_pages(vp, table).contiguous(), lengths=lengths)
    assert registry.launches("flash_decode") == 2
    want = tattn.paged_decode_attention(q, kp, vp, table, lengths,
                                        force_reference=True)
    tol = _tol(want, dt)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (view.float() - want.float()).abs().max().item() <= tol
    assert got[0].abs().max().item() == 0.0


# Serving shapes (page 16, max_len 4096, 512-key splits of 64-key warp
# rounds): lengths at 0, one key, either side of a page and of a warp
# tile, either side of a split, and the whole slot.
DECODE_LENGTHS = [0, 1, 15, 16, 17, 64, 511, 512, 513, 4096]


def _decode_pool(rng, lengths, table, ps, h_kv, d, dtype, cuda):
    """K/V pools full of large finite garbage, with random live keys below
    each slot's length: any leak past a length shows as a huge error."""
    npages = table.numel()
    kp = torch.full((npages + 1, ps, h_kv, d), 3e4)
    vp = torch.full_like(kp, -3e4)
    tab = table.cpu()
    for s, n in enumerate(lengths):
        pos = torch.arange(n)
        pg, of = tab[s].long()[pos // ps], pos % ps
        kp[pg, of] = _randn(rng, n, h_kv, d)
        vp[pg, of] = _randn(rng, n, h_kv, d)
    return kp.to(cuda, dtype), vp.to(cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,h_kv", [(128, 32, 8), (64, 8, 1),
                                      (128, 8, 8)])
def test_cuda_decode_kernel_at_length_edges(cuda, dtype, d, h, h_kv):
    """The paged and the contiguous decode against the plain version at
    the edge lengths, with garbage past every length; a slot of length 0
    gives exactly 0."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(26)
    ps, max_len = 16, 4096
    slots, pps = len(DECODE_LENGTHS), max_len // ps
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=cuda)
    table = torch.from_numpy(rng.permutation(slots * pps).astype(np.int32)
                             ).view(slots, pps).to(cuda)
    kp, vp = _decode_pool(rng, DECODE_LENGTHS, table, ps, h_kv, d, dt, cuda)
    q = _randn(rng, slots, h, 1, d).to(cuda, dt)
    registry.reset_launch_counts()
    got = tattn.paged_decode_attention(q, kp, vp, table, lengths)
    view = tattn.decode_attention(
        q, tattn.gather_pages(kp, table).contiguous(),
        tattn.gather_pages(vp, table).contiguous(), lengths=lengths)
    assert registry.launches("flash_decode") == 2
    want = tattn.paged_decode_attention(q, kp, vp, table, lengths,
                                        force_reference=True)
    tol = _tol(want, dt)
    for out in (got, view):
        assert bool(torch.isfinite(out.float()).all())
        assert (out.float() - want.float()).abs().max().item() <= tol
        assert out[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_decode_kernel_repeats_bitwise(cuda):
    """No atomics, a fixed order of sums: two launches of the decode
    kernels at 8 slots x 2048 keys give the same bits."""
    rng = np.random.RandomState(27)
    ps, pps, slots = 16, 256, 8
    lens = [2048] * slots
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    table = torch.from_numpy(rng.permutation(slots * pps).astype(np.int32)
                             ).view(slots, pps).to(cuda)
    kp, vp = _decode_pool(rng, lens, table, ps, 8, 128, torch.bfloat16,
                          cuda)
    q = _randn(rng, slots, 32, 1, 128).to(cuda, torch.bfloat16)
    first = tattn.paged_decode_attention(q, kp, vp, table, lengths)
    second = tattn.paged_decode_attention(q, kp, vp, table, lengths)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_decode_kernels_do_not_spill(cuda):
    """Every decode instantiation (two dtypes x two head dims x four group
    sizes, and the merges) keeps everything in registers."""
    usage = _build.resource_usage("flash_decode")
    split = [n for n in usage if "decode_split_kernel" in n]
    merge = [n for n in usage if "decode_merge_kernel" in n]
    assert len(split) == 16 and len(merge) == 4, sorted(usage)
    for name, u in usage.items():
        assert u.get("STACK", 0) == 0 and u.get("LOCAL", 0) == 0, (name, u)


@pytest.mark.cuda
def test_cuda_readout_stays_f32_under_tf32(cuda):
    """The tied readout runs in true f32 even where the caller allows
    TF32 for matmuls, and leaves the caller's setting as it found it."""
    rng = np.random.RandomState(12)
    x = _randn(rng, 3, 4096).to(cuda)
    emb = _randn(rng, 512, 4096).to(cuda)
    want = (x.double() @ emb.double().T).float()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tied_readout(x, emb)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert (got - want).abs().max().item() < 1e-3


BN_SUM_REL = 1e-4


def _bn_inputs(rng, n, c, dtype, cuda):
    """x with an offset (so xhat differs from x), dy, scale near 1."""
    x = (2.0 * _randn(rng, n, c) + 0.5).to(cuda, dtype)
    dy = _randn(rng, n, c).to(cuda, dtype)
    scale = (1.0 + 0.1 * _randn(rng, c)).to(cuda)
    return x, dy, scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(37, 3), (1000, 8), (3211264, 64),
                                 (802816, 256), (12544, 2048),
                                 (2048, 80), (2048, 192), (2048, 2048),
                                 (710432, 32), (2048, 448), (9248, 384)])
def test_cuda_bn_backward_kernels_match_plain(cuda, dtype, n, c):
    """Both BN backward kernels against the plain closed form: a ragged N
    with C below one vector, C of one vector, three ResNet-50 sites at
    batch 256 (the stem, stage 1's widest, stage 4), and Inception-v3's
    widths at batch 32: C = 80, 192 and 2048 at the 2,048 rows of its
    8 x 8 grid, and its first stem site, 710,432 rows of 32; and two of its
    widths that span two 256-channel tiles and end in a partial one, 448
    on the 8 x 8 grid and 384 on the 17 x 17 grid (9,248 rows)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(16)
    x, dy, scale = _bn_inputs(rng, n, c, dt, cuda)
    mean, var = tbn.batch_stats(x)
    registry.reset_launch_counts()
    got = tbn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
    assert registry.launches("bn_bwd_reduce") == 1
    assert registry.launches("bn_bwd_dx") == 1
    want = tbn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5,
                                 force_reference=True)
    assert registry.launches("bn_bwd_reduce") == 1
    assert got[0].dtype == dt and got[1].dtype == got[2].dtype == \
        torch.float32
    rels = (ATOL if dt == torch.float32 else BF16_REL, BN_SUM_REL,
            BN_SUM_REL)
    for g, w, rel in zip(got, want, rels):
        assert g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= \
            rel * w.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_bn_backward_is_deterministic(cuda):
    """No atomics: two launches give bitwise the same dx, dgamma, dbeta."""
    rng = np.random.RandomState(17)
    x, dy, scale = _bn_inputs(rng, 802816, 256, torch.bfloat16, cuda)
    mean, var = tbn.batch_stats(x)
    first = tbn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
    second = tbn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_bn_backward_scalar_path_on_unaligned_views(cuda):
    """A view 2 bytes off 16-byte alignment takes the one-element path
    and still agrees with the plain version."""
    rng = np.random.RandomState(18)
    base = _randn(rng, 1 + 512 * 16).to(cuda, torch.bfloat16)
    x = base[1:].view(512, 16)
    dy = _randn(rng, 1 + 512 * 16).to(cuda, torch.bfloat16)[1:].view(
        512, 16)
    assert x.data_ptr() % 16 and x.is_contiguous()
    scale = (1.0 + 0.1 * _randn(rng, 16)).to(cuda)
    mean, var = tbn.batch_stats(x)
    got = tbn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
    want = tbn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5,
                                 force_reference=True)
    for g, w, rel in zip(got, want, (BF16_REL, BN_SUM_REL, BN_SUM_REL)):
        assert (g.float() - w.float()).abs().max().item() <= \
            rel * w.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_resnet_bn_sites_launch_the_kernels(cuda, monkeypatch):
    """A small bf16 ResNet in train mode on the card: one launch of each
    BN kernel per BN site, every site's input and gradient contiguous as
    they arrive (nothing to copy), and gradients within 2e-2 of max |grad|
    of the same backward through the plain versions."""
    from horovod_tpu_torch.models import ResNet, init_resnet_params
    from horovod_tpu_torch.models.resnet import BottleneckBlock
    from horovod_tpu_torch.training import softmax_xent
    model = ResNet(stage_sizes=[1, 1], block_cls=BottleneckBlock,
                   num_classes=10, num_filters=16, space_to_depth=True,
                   device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model.load_state_dict(init_resnet_params(model, generator=gen))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tbn.BatchNorm):
                m.scale.normal_(1.0, 0.1, generator=gen)
    seen = []
    real = tbn.fused_bn_backward

    def spy(x, scale, mean, var, dy, **kw):
        seen.append(x.is_contiguous() and dy.is_contiguous())
        return real(x, scale, mean, var, dy, **kw)

    monkeypatch.setattr(tbn, "fused_bn_backward", spy)
    rng = np.random.RandomState(19)
    x = _randn(rng, 4, 32, 32, 3).to(cuda)
    y = torch.from_numpy(rng.randint(0, 10, 4)).to(cuda)
    sites = sum(isinstance(m, tbn.BatchNorm) for m in model.modules())
    grads = []
    for ref in (False, True):
        model.zero_grad(set_to_none=True)
        registry.reset_launch_counts()
        softmax_xent(model(x, force_reference=ref), y).backward()
        n = 0 if ref else sites
        assert registry.launches("bn_bwd_reduce") == n
        assert registry.launches("bn_bwd_dx") == n
        grads.append({k: p.grad.float() for k, p in
                      model.named_parameters()})
    assert len(seen) == 2 * sites and all(seen)
    for k, w in grads[1].items():
        assert (grads[0][k] - w).abs().max().item() <= \
            BF16_REL * max(w.abs().max().item(), 1e-30), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bn_backward_dx_takes_the_global_count(cuda, dtype):
    """Pass 2 with sums over four ranks and their global count (sync BN)
    against the plain version; the count changes dx."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(60)
    x, dy, scale = _bn_inputs(rng, 2048, 192, dt, cuda)
    mean, var = tbn.batch_stats(x)
    inv = torch.rsqrt(var + 1e-3)
    dbeta, dgamma = tbn.bn_backward_reduce(x, dy, mean, inv)
    sums = [4 * s + _randn(rng, 192).to(cuda) for s in (dbeta, dgamma)]
    registry.reset_launch_counts()
    got = tbn.bn_backward_dx(x, dy, mean, inv, scale, *sums, count=8192)
    assert registry.launches("bn_bwd_dx") == 1
    want = tbn.bn_backward_dx(x, dy, mean, inv, scale, *sums, count=8192,
                              force_reference=True)
    local = tbn.bn_backward_dx(x, dy, mean, inv, scale, *sums)
    tol = _tol(want, dt)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (local.float() - want.float()).abs().max().item() > tol
    with pytest.raises(ValueError, match="count"):
        tbn.bn_backward_dx(x, dy, mean, inv, scale, *sums, count=0)


@pytest.fixture
def world1_cuda(cuda):
    import horovod_tpu_torch as hvd
    hvd.init()
    yield hvd
    hvd.shutdown()


@pytest.mark.cuda
def test_cuda_sync_batch_norm_at_world_one_is_the_plain_layer(world1_cuda):
    """Flax-style sync BN on the card at world 1 (NCCL): output, dx,
    dgamma, dbeta and running statistics bitwise the plain layer's, one
    launch of each BN kernel; Inception's stem width, bf16."""
    from horovod_tpu_torch.training import sync_batch_norm
    rng = np.random.RandomState(61)
    shape = (8, 37, 37, 32)
    x = (2.0 * _randn(rng, *shape) + 0.5).to("cuda", torch.bfloat16)
    dy = _randn(rng, *shape).to("cuda", torch.bfloat16)
    outs = []
    for sync in (False, True):
        m = (sync_batch_norm if sync else tbn.BatchNorm)(
            features=32, momentum=0.9, epsilon=1e-3, dtype=torch.bfloat16)
        registry.reset_launch_counts()
        xt = x.detach().requires_grad_(True)
        y = m(xt)
        y.backward(dy)
        torch.cuda.synchronize()
        assert registry.launches("bn_bwd_reduce") == 1
        assert registry.launches("bn_bwd_dx") == 1
        outs.append((y, xt.grad, m.scale.grad, m.bias.grad, m.mean, m.var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_hvd_sync_batch_norm_channels_last_matches_plain(world1_cuda):
    """``hvd.SyncBatchNorm`` on a channels_last bf16 input: the kernels'
    backward on the ``[rows, C]`` view (no copy) against autograd of the
    f32 formula; dx within 2e-2 of max |dx|, weight / bias gradients
    within 1e-4."""
    from horovod_tpu_torch.timeline.metrics import sync_bn_totals
    rng = np.random.RandomState(62)
    cl = dict(memory_format=torch.channels_last)
    x = (2.0 * _randn(rng, 8, 64, 37, 37) + 0.5).to(
        "cuda", torch.bfloat16).contiguous(**cl)
    dy = _randn(rng, 8, 64, 37, 37).to("cuda", torch.bfloat16).contiguous(
        **cl)
    m = world1_cuda.SyncBatchNorm(64)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.1 * _randn(rng, 64))
        m.bias.copy_(0.1 * _randn(rng, 64))
    copies = sync_bn_totals()["layout_copies"]
    registry.reset_launch_counts()
    xt = x.detach().requires_grad_(True)
    y = m(xt)
    y.backward(dy)
    assert registry.launches("bn_bwd_reduce") == 1
    assert registry.launches("bn_bwd_dx") == 1
    assert sync_bn_totals()["layout_copies"] == copies
    xf = x.detach().float().requires_grad_(True)
    w = m.weight.detach().clone().requires_grad_(True)
    b = m.bias.detach().clone().requires_grad_(True)
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = (xf.square().mean((0, 2, 3), keepdim=True) - mean.square())
    want = ((xf - mean) * torch.rsqrt(var + m.eps) * w.view(1, -1, 1, 1)
            + b.view(1, -1, 1, 1))
    want.backward(dy.float())
    for got, ref, rel in ((y, want, BF16_REL), (xt.grad, xf.grad, BF16_REL),
                          (m.weight.grad, w.grad, BN_SUM_REL),
                          (m.bias.grad, b.grad, BN_SUM_REL)):
        assert (got.float() - ref.detach()).abs().max().item() <= \
            rel * ref.detach().abs().max().item()


# ---------------------------------------------------------------------------
# The PowerSGD stages (fused_update.cu)
# ---------------------------------------------------------------------------

POWERSGD_REL = 1e-5


def _powersgd_stages(size, r, dtype, residual, cuda, seed, **kw):
    """The three stages on the card, each fed the plain chain's inputs:
    ``(kernel outputs, plain outputs)``, five tensors each."""
    rng = np.random.RandomState(seed)
    m, c = powersgd_matrix_shape(size)
    x = _randn(rng, size).to(cuda, dtype)
    res = _randn(rng, size).to(cuda) if residual else None
    q0 = _powersgd_seed_matrix(c, r, cuda)
    acc_w, p_w = tfu.matricize_p(x, res, q0, rows=m, prescale=0.5,
                                 force_reference=True)
    po_w, ql_w = tfu.orthonormalize_q(acc_w, p_w, force_reference=True)
    q = ql_w * 0.75 + 0.01             # a mean Q unlike this rank's own
    out_w, res_w = tfu.reconstruct_residual(
        acc_w, po_w, q, ql_w, size=size, force_reference=True, **kw)
    acc, p = tfu.matricize_p(x, res, q0, rows=m, prescale=0.5)
    po, ql = tfu.orthonormalize_q(acc_w, p_w)
    out, new_res = tfu.reconstruct_residual(acc_w, po_w, q, ql_w, size=size,
                                            **kw)
    return (acc, p, po, ql, out, new_res), (acc_w, p_w, po_w, ql_w, out_w,
                                            res_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,r", [(37, 1), (1000, 4), (100003, 4),
                                    (100003, 8), (1000003, 9), (64, 1),
                                    (1000003, 64), (15053824, 128),
                                    (13000000, 8), (52000000, 4)])
def test_cuda_powersgd_stages_match_plain(cuda, dtype, size, r):
    """Ragged tails (size < m * c), r = 1 / 4, and r = 8 / 9 / 64 / 128
    (passes of the kernels' 4 factor columns): each kernel against its
    plain version on the same inputs, one launch of each family per call.
    Gram-Schmidt: P's rows in registers (r <= 8, m <= 4096), [1001, 9] in
    shared memory, [1001, 64] and [3880, 128] past its 220 KB in device
    memory.  At [7212, 7211] r = 4, P is Gram-Schmidt in shared memory
    (m > 4096), Q0 (c x 4 f32) is staged in two column segments and each
    projection CTA stages its 902 rows of P_orth twice."""
    registry.reset_launch_counts()
    got, want = _powersgd_stages(size, r, dtype, True, cuda, seed=size + r,
                                 n_scale=2.0, postscale=0.25)
    torch.cuda.synchronize()
    assert registry.launch_counts()["fused_update_matricize_p"] == 1
    assert registry.launch_counts()["fused_update_orthonormalize_q"] == 1
    assert registry.launch_counts()["fused_update_reconstruct"] == 1
    m, c = powersgd_matrix_shape(size)
    assert torch.equal(got[0], want[0])
    if m * c > size:                   # the pad reads as zeros
        assert got[0].reshape(-1)[size:].abs().max().item() == 0.0
    for name, g, w in zip(("p", "p_orth", "q_local", "out", "residual"),
                          got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = (g - w).abs().max().item()
        assert err <= POWERSGD_REL * w.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_powersgd_stages_without_residual_and_deterministic(cuda):
    """No residual (the first step), and no atomics: two launches of each
    stage give bitwise the same outputs, at ResNet-50's second bucket."""
    size = 10506088
    first, want = _powersgd_stages(size, 4, torch.float32, False, cuda, 21)
    second, _ = _powersgd_stages(size, 4, torch.float32, False, cuda, 21)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for g, w in zip(first[1:], want[1:]):
        assert (g - w).abs().max().item() <= \
            POWERSGD_REL * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_off,res_off", [(1, 0), (4, 0), (0, 3), (2, 2)])
def test_cuda_matricize_p_takes_any_alignment(cuda, dtype, x_off, res_off):
    """Flat x and residual that start off a 16-byte boundary (views into
    larger buffers): stage 1 streams vectors only where x, the residual
    and acc share their phase, and gives the plain version's acc bitwise
    either way."""
    rng = np.random.RandomState(x_off * 8 + res_off)
    size = 100003
    m, c = powersgd_matrix_shape(size)
    x = _randn(rng, size + 8).to(cuda, dtype)[x_off:x_off + size]
    res = _randn(rng, size + 8).to(cuda)[res_off:res_off + size]
    q0 = _powersgd_seed_matrix(c, 4, cuda)
    acc, p = tfu.matricize_p(x, res, q0, rows=m, prescale=0.5)
    acc_w, p_w = tfu.matricize_p(x, res, q0, rows=m, prescale=0.5,
                                 force_reference=True)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_w)
    assert (p - p_w).abs().max().item() <= \
        POWERSGD_REL * p_w.abs().max().item()


@pytest.mark.cuda
def test_cuda_fused_update_kernels_do_not_spill(cuda):
    """Every PowerSGD stage kernel (stage 1: two dtypes; Gram-Schmidt in
    shared or device memory and in registers; the projection: two load
    widths; stage 3) keeps everything in registers."""
    usage = _build.resource_usage("fused_update")
    for kernel, n in (("matricize_p_kernel", 2), ("gram_schmidt_kernel", 1),
                      ("gram_schmidt_regs_kernel", 1),
                      ("q_project_kernel", 2), ("reconstruct_kernel", 1)):
        assert len([k for k in usage if kernel in k]) == n, sorted(usage)
    for name, u in usage.items():
        assert u.get("STACK", 0) == 0 and u.get("LOCAL", 0) == 0, (name, u)


@pytest.mark.cuda
def test_cuda_powersgd_stages_refuse_what_they_cannot_take(cuda):
    q0 = _powersgd_seed_matrix(4, 2, cuda)
    with pytest.raises(ValueError, match="dtype"):
        tfu.matricize_p(torch.zeros(16, device=cuda, dtype=torch.float16),
                        None, q0, rows=4)
    with pytest.raises(ValueError, match="contiguous"):
        tfu.matricize_p(torch.zeros(32, device=cuda)[::2], None, q0, rows=4)
    with pytest.raises(ValueError, match="do not fit"):
        tfu.matricize_p(torch.zeros(17, device=cuda), None, q0, rows=4)


# ---------------------------------------------------------------------------
# BERT: the attention kernels at BERT-Large's heads, and one encoder block
# ---------------------------------------------------------------------------


def _bert_segments(b, t, cuda):
    """Two packed segments of unequal lengths a row."""
    seg = torch.zeros(b, t, dtype=torch.int32, device=cuda)
    for r in range(b):
        seg[r, 3 * t // 8 + 16 * r:] = 1
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("t", [128, 512])
def test_cuda_attention_kernels_at_bert_shapes(cuda, t, segments):
    """Forward, dq and dk/dv at BERT-Large's 16 heads of 64,
    bidirectional, against their plain versions (bf16)."""
    rng = np.random.RandomState(30 + t)
    q, k, v, do = _bwd_inputs(rng, 2, 16, 16, t, t, 64, torch.bfloat16,
                              cuda)
    kw = dict(causal=False)
    if segments:
        seg = _bert_segments(2, t, cuda)
        kw.update(segment_ids=seg, kv_segment_ids=seg)
    registry.reset_launch_counts()
    o, lse = tattn.flash_attention(q, k, v, return_lse=True, **kw)
    o_ref, lse_ref = tattn.flash_attention(q, k, v, return_lse=True,
                                           force_reference=True, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= \
        _tol(o_ref, torch.bfloat16)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    got = (tattn.flash_backward_dq(*args, **kw),
           *tattn.flash_backward_dkv(*args, **kw))
    want = (tattn.flash_backward_dq(*args, force_reference=True, **kw),
            *tattn.flash_backward_dkv(*args, force_reference=True, **kw))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert (g.float() - w.float()).abs().max().item() <= \
            _grad_tol(w, torch.bfloat16)
    assert {f: registry.launches(f) for f in
            ("flash", "flash_bwd_dq", "flash_bwd_dkv")} == dict.fromkeys(
                ("flash", "flash_bwd_dq", "flash_bwd_dkv"), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bert_encoder_block_matches_plain_attention(cuda, dtype):
    """One ``EncoderBlock`` at BERT-Large's width (d 1024, 16 heads, FFN
    4096) on 2 x 256 tokens packed with two segments a row: output and
    every gradient through the kernels against the same block through
    the plain attention.  ``wk.bias``'s gradient is zero in exact
    arithmetic, so its difference is held relative to ``wk.kernel``'s."""
    from horovod_tpu_torch.models import BERT_LARGE
    from horovod_tpu_torch.models.transformer import EncoderBlock
    dt = getattr(torch, dtype)
    block = EncoderBlock(BERT_LARGE, dt, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(31)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("kernel"):
                p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
            else:
                p.normal_(1.0 if name.endswith("scale") else 0.0, 0.1,
                          generator=gen)
    x = torch.randn(2, 256, 1024, generator=gen, device=cuda).to(dt)
    seg = _bert_segments(2, 256, cuda)
    dy = torch.randn(2, 256, 1024, generator=gen, device=cuda).to(dt)
    runs = []
    for ref in (False, True):
        block.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_()
        y = block(xr, seg, force_reference=ref)
        y.backward(dy)
        runs.append((y.detach().float(), xr.grad.float(),
                     {n: p.grad.float() for n, p in block.named_parameters()}))
    (y, dx, g), (y_w, dx_w, g_w) = runs
    rel = F32_GRAD_REL if dt == torch.float32 else BF16_REL
    assert (y - y_w).abs().max().item() <= rel * y_w.abs().max().item()
    assert (dx - dx_w).abs().max().item() <= rel * dx_w.abs().max().item()
    for n in g_w:
        scale = g_w["wk.kernel" if n == "wk.bias" else n].abs().max().item()
        assert bool(torch.isfinite(g[n]).all()), n
        assert (g[n] - g_w[n]).abs().max().item() <= rel * scale, n


@pytest.mark.cuda
@pytest.mark.parametrize("d,h_kv", [(64, 16), (128, 4)])
def test_cuda_flash_forward_writes_o_residual_for_the_backward(cuda, d,
                                                              h_kv):
    """With a gradient wanted, the bf16 forward also saves O's rounding
    residual: ``o + o_lo`` is the kernel's f32 O, within 1e-3 of max |O|
    of the f32 plain attention (one bf16 rounding of O is up to 2^-9 of
    each value); without a gradient (serving) nothing is written."""
    rng = np.random.RandomState(40 + d)
    q, k, v, _ = _bwd_inputs(rng, 2, 16, h_kv, 256, 256, d, torch.bfloat16,
                             cuda)
    o, lse, o_lo = tattn._flash_forward(q, k, v, None, None, scale=d ** -0.5,
                                        causal=False, residual=True)
    want = tattn.attention_reference(
        q.float(), *(x.float().repeat_interleave(16 // h_kv, 1)
                     for x in (k, v)))
    top = want.abs().max().item()
    assert o_lo is not None and o_lo.dtype == torch.bfloat16
    assert (o.float() + o_lo.float() - want).abs().max().item() <= 1e-3 * top
    assert torch.equal(o, tattn._flash_forward(
        q, k, v, None, None, scale=d ** -0.5, causal=False)[0])
    assert tattn._flash_forward(q, k, v, None, None, scale=d ** -0.5,
                                causal=False)[2] is None


# ---------------------------------------------------------------------------
# The horovod.torch surface on NCCL (world 1)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("set_kind", ["global", "one_member"])
def test_cuda_torch_api_ops_on_nccl(world1_cuda, set_kind):
    """Every op of the surface on NCCL at world 1, on the global set and
    on ``add_process_set([0])``: each an identity or a slice, exactly."""
    hvd = world1_cuda
    ps = None if set_kind == "global" else hvd.add_process_set([0])
    rng = np.random.RandomState(80)
    x = _randn(rng, 8, 6).to("cuda")
    kw = dict(process_set=ps)
    for op in (hvd.Sum, hvd.Average, hvd.Min, hvd.Max, hvd.Product):
        assert torch.equal(hvd.allreduce(x, op=op, **kw), x)
        assert torch.equal(hvd.reducescatter(x, op=op, **kw), x)
        assert torch.equal(hvd.reducescatter(x, op=op, scatter_axis=1, **kw),
                           x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Adasum, **kw), x)
    assert torch.equal(hvd.alltoall(x, **kw), x)
    got, splits = hvd.alltoall(x, splits=torch.tensor([8]), **kw)
    assert torch.equal(got, x) and splits.tolist() == [8]
    ys = hvd.grouped_allgather([x, x[:3]], **kw)
    assert torch.equal(ys[0], x) and torch.equal(ys[1], x[:3])
    ys = hvd.grouped_reducescatter([x, x[:2]], op=hvd.Sum, **kw)
    assert torch.equal(ys[0], x) and torch.equal(ys[1], x[:2])
    assert torch.equal(hvd.broadcast(x, 0, **kw), x)
    sp = x.to_sparse()
    got = hvd.synchronize(hvd.sparse_allreduce_async(sp, op=hvd.Sum, **kw))
    assert got.is_sparse and torch.equal(got.to_dense(), x)
    assert hvd.allgather_object({"a": [1, 2]}, **kw) == [{"a": [1, 2]}]
    h = hvd.allreduce_async(x, op=hvd.Sum, **kw)
    out = hvd.synchronize(h)
    assert torch.equal(out, x)
    with pytest.raises(ValueError):
        hvd.poll(h)
    hvd.barrier(**kw)
    from horovod_tpu_torch.adasum.vhdd import adasum_allreduce_hierarchical
    assert torch.equal(adasum_allreduce_hierarchical(x, local_size=1), x)


@pytest.mark.cuda
def test_cuda_sync_batch_norm_process_set_at_resnet_width(world1_cuda):
    """``SyncBatchNorm(process_set={0})`` at ResNet-50's ``[256, 256, 56,
    56]`` channels-last bf16 (NHWC ``[256, 56, 56, 256]``) against
    autograd of the f32 formula: one launch of each BN kernel, two
    allreduces, no layout copy; the output takes an in-place ReLU."""
    from horovod_tpu_torch.timeline.metrics import sync_bn_totals
    hvd = world1_cuda
    ps = hvd.add_process_set([0])
    rng = np.random.RandomState(81)
    cl = dict(memory_format=torch.channels_last)
    shape = (256, 256, 56, 56)
    gen = torch.Generator(device="cuda").manual_seed(81)
    x = (2.0 * torch.randn(*shape, generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16).contiguous(**cl)
    dy = torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(**cl)
    m = hvd.SyncBatchNorm(256, process_set=ps)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.1 * _randn(rng, 256))
        m.bias.copy_(0.1 * _randn(rng, 256))
    before = sync_bn_totals()
    registry.reset_launch_counts()
    xt = x.detach().requires_grad_(True)
    y = m(xt)
    y.backward(dy)
    torch.cuda.synchronize()
    assert registry.launches("bn_bwd_reduce") == 1
    assert registry.launches("bn_bwd_dx") == 1
    moved = {k: v - before[k] for k, v in sync_bn_totals().items()}
    assert moved["allreduces"] == 2 and moved["layout_copies"] == 0
    xf = x.detach().float().requires_grad_(True)
    w = m.weight.detach().clone().requires_grad_(True)
    b = m.bias.detach().clone().requires_grad_(True)
    mean = xf.mean((0, 2, 3), keepdim=True)
    var = (xf.square().mean((0, 2, 3), keepdim=True) - mean.square())
    want = ((xf - mean) * torch.rsqrt(var + m.eps) * w.view(1, -1, 1, 1)
            + b.view(1, -1, 1, 1))
    want.backward(dy.float())
    for got, ref, rel in ((y, want, BF16_REL), (xt.grad, xf.grad, BF16_REL),
                          (m.weight.grad, w.grad, BN_SUM_REL),
                          (m.bias.grad, b.grad, BN_SUM_REL)):
        assert (got.float() - ref.detach()).abs().max().item() <= \
            rel * ref.detach().abs().max().item()
    z = m(x[:4].detach().requires_grad_(True))
    torch.relu_(z)                       # not a view: in place is allowed
    z.sum().backward()


# ---------------------------------------------------------------------------
# The compressed and sharded exchanges on the card (plain PyTorch)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [None, 0])
def test_cuda_fp8_codes_equal_the_cpu_codes(cuda, axis):
    """``fp8_quantize`` on the card: the same e4m3 codes and f32 scales
    as on the CPU, bitwise (values from 1e-6 to 1e2, an all-zero row)."""
    from horovod_tpu_torch.collectives.compression import fp8_quantize
    rng = np.random.RandomState(91)
    x = (rng.choice([-1.0, 1.0], (8, 4096))
         * 10.0 ** rng.uniform(-6, 2, (8, 4096))).astype(np.float32)
    x[3] = 0.0
    xc = torch.from_numpy(x)
    q, s = fp8_quantize(xc, axis=axis)
    qg, sg = fp8_quantize(xc.to(cuda), axis=axis)
    assert torch.equal(qg.view(torch.uint8).cpu(), q.view(torch.uint8))
    assert torch.equal(sg.cpu(), s)


@pytest.mark.cuda
@pytest.mark.parametrize("size,k", [(100_000, 25_000), (4099, 1025)])
def test_cuda_topk_selection_equals_the_cpu_on_ties(cuda, size, k):
    """The stable descending sort on the card picks the CPU's indices on
    integer-valued (heavily tied) magnitudes."""
    from horovod_tpu_torch.collectives.ops import _topk_select
    x = torch.from_numpy(np.random.RandomState(size).randint(
        -3, 4, size).astype(np.float32))
    assert torch.equal(_topk_select(x.to(cuda), k).cpu(), _topk_select(x, k))


@pytest.mark.cuda
def test_cuda_fp8_and_topk_allreduce_at_world_one(world1_cuda):
    """At world 1 on NCCL: ``fp8_allreduce`` is the round trip quantize,
    dequantize, quantize, dequantize; ``topk_allreduce`` sends its k
    largest and keeps the rest as the residual, ``own + residual ==
    acc`` bitwise."""
    from horovod_tpu_torch.collectives import ops
    from horovod_tpu_torch.collectives.compression import fp8_quantize
    hvd = world1_cuda
    x = torch.from_numpy(np.random.RandomState(92).randn(10_007).astype(
        np.float32)).cuda()
    q, s = fp8_quantize(x.view(1, -1), axis=0)
    q2, s2 = fp8_quantize((q.float() * s[:, None]).sum(0))
    assert torch.equal(ops.fp8_allreduce(x), q2.float() * s2)
    r = torch.randn(10_007, device="cuda")
    out, res = ops.topk_allreduce(x, hvd.Sum, fraction=0.25, residual=r)
    acc = x + r
    assert torch.equal(out + res, acc)
    assert int((out != 0).sum()) == 2502 and not res[out != 0].any()


@pytest.mark.cuda
def test_cuda_zero1_step_equals_the_plain_step(world1_cuda):
    """One ZeRO-1 step (SGD with momentum) of a small MLP on the card at
    world 1 against the bare optimizer's step: within 1e-6 of max
    |parameter| (the arena's flat update and the per-tensor update may
    contract their multiply-adds otherwise)."""
    from horovod_tpu_torch.optim import zero
    torch.manual_seed(93)
    make = lambda: torch.nn.Sequential(torch.nn.Linear(37, 64),  # noqa
                                       torch.nn.Tanh(),
                                       torch.nn.Linear(64, 5)).cuda()
    a, b = make(), make()
    b.load_state_dict(a.state_dict())
    oa = torch.optim.SGD(a.parameters(), lr=0.1, momentum=0.9)
    ob = torch.optim.SGD(b.parameters(), lr=0.1, momentum=0.9)
    state = zero.zero_init(oa, list(a.parameters()))
    x = torch.randn(16, 37, device="cuda")
    for _ in range(2):
        a(x).square().mean().backward()
        zero.zero_apply(oa, [p.grad for p in a.parameters()], state,
                        list(a.parameters()))
        oa.zero_grad()
        b(x).square().mean().backward()
        ob.step()
        ob.zero_grad()
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert (pa - pb).abs().max().item() <= \
            1e-6 * pb.abs().max().item()


# ---------------------------------------------------------------------------
# The steps-per-execution loop as a CUDA graph, the prefetcher and the
# asynchronous reduce-scatter
# ---------------------------------------------------------------------------


LOOP_K = 3


def _tiny_resnet_cuda(seed):
    from horovod_tpu_torch.models import BottleneckBlock, ResNet, init_params
    model = ResNet(stage_sizes=[1, 1], block_cls=BottleneckBlock,
                   num_classes=10, num_filters=8, dtype=torch.float32,
                   space_to_depth=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model.load_state_dict(init_params(model, generator=gen))
    return model


def _loop_batches(n, seed=5):
    rng = np.random.RandomState(seed)
    return [(_randn(rng, 8, 32, 32, 3).cuda(),
             torch.from_numpy(rng.randint(0, 10, 8)).cuda())
            for _ in range(n)]


@pytest.fixture
def deterministic():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        saved


#: case: (steps_per_execution, builder kwargs, DistributedOptimizer
#: kwargs or None for the bare optimizer).
LOOP_CASES = {
    "wrapped": (LOOP_K, {}, {}),
    "microbatches2": (LOOP_K, {"microbatches": 2}, {}),
    "fp16": (LOOP_K, {}, {"compression": "fp16"}),
    "topk_ef": (LOOP_K, {}, {"compression": "topk:0.25"}),
    "bpps2": (4, {}, {"backward_passes_per_step": 2}),
    "lr_schedule": (LOOP_K, {}, {}),
    "bare": (LOOP_K, {}, None),
    "zero1": (LOOP_K, {"zero_stage": 1}, None),
}


def _set_lr(opt, lr):
    for g in opt.param_groups:
        g["lr"] = lr


def _loop_state(model, opts, wrap):
    """Parameters, BN statistics, every optimizer state tensor and the
    error-feedback residuals, cloned."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for j, o in enumerate(opts):
        for i, st in enumerate(o.state.values()):
            state.update({f"opt{j}/{i}/{key}": v.clone()
                          for key, v in st.items() if torch.is_tensor(v)})
    state.update({f"residual{i}": r.clone()
                  for i, r in enumerate(getattr(wrap, "residuals", ()))})
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_cuda_graph_loop_equals_eager_steps(world1_cuda, deterministic,
                                            case):
    """Three windows of a tiny ResNet's ``make_flax_train_loop`` (eager,
    captured, replayed) bitwise equal to as many ``make_flax_train_step``
    calls from the same weights on the same batches: losses, parameters,
    BN statistics, optimizer state and residuals.  The cases: a wrapped
    SGD alone, with ``microbatches=2``, fp16 compression, top-k with
    error feedback, ``backward_passes_per_step=2`` over a window of 4,
    and an lr changed before the third window (the loop captures again);
    a bare SGD; ZeRO-1."""
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    hvd = world1_cuda
    k, build, wrap = LOOP_CASES[case]
    data = _loop_batches(3 * k)
    runs = []
    for use_loop in (False, True):
        model = _tiny_resnet_cuda(seed=1)
        named = list(model.named_parameters())
        opt = torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9)
        if wrap is not None:
            opt = hvd.DistributedOptimizer(opt, named_parameters=named,
                                           **wrap)
        if use_loop:
            loop = make_flax_train_loop(model, opt, steps_per_execution=k,
                                        **build)
            out = []
            for i in range(3):
                if case == "lr_schedule" and i == 2:
                    _set_lr(opt, 0.05)
                out.append(loop(stack_steps(data[i * k:(i + 1) * k]))
                           .clone())
            losses = torch.cat(out)
            assert loop._graph is not None
            if case == "lr_schedule":              # captured again
                assert loop._hyper[0][0]["lr"] == 0.05
            opts = loop._optimizers
        else:
            step = make_flax_train_step(model, opt, **build)
            out = []
            for i, b in enumerate(data):
                if case == "lr_schedule" and i == 2 * k:
                    _set_lr(opt, 0.05)
                out.append(step(b))
            losses = torch.stack(out)
            opts = [opt] + ([step.zero_state.inner]
                            if step.zero_state is not None else [])
        torch.cuda.synchronize()
        runs.append((losses, _loop_state(model, opts, opt)))
    (l1, s1), (l2, s2) = runs
    assert torch.equal(l1, l2), (l1, l2)
    assert s1.keys() == s2.keys()
    assert any(key.startswith("opt") for key in s1)
    if case == "topk_ef":
        assert any(key.startswith("residual") for key in s1)
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key


@pytest.mark.cuda
def test_cuda_graph_replays_count_launches_and_exchanges(world1_cuda,
                                                         deterministic):
    """The BN launch counters, the exchange and collective counters and
    the span leg registry count every replayed step: three windows count
    as nine steps' worth."""
    from horovod_tpu_torch.timeline import metrics, spans
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    hvd = world1_cuda
    data = _loop_batches(LOOP_K)

    def counts():
        return (registry.launch_counts(), metrics.exchange_totals(),
                metrics.collective_totals()[("allreduce", "global")],
                spans.recorder().leg_registry().get("flat_ar"))

    model = _tiny_resnet_cuda(seed=2)
    named = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named)
    step = make_flax_train_step(model, opt)
    step(data[0])
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    metrics.reset_metrics()
    spans.recorder().reset()
    step(data[0])
    one = counts()
    loop = make_flax_train_loop(model, opt, steps_per_execution=LOOP_K)
    registry.reset_launch_counts()
    metrics.reset_metrics()
    spans.recorder().reset()
    for _ in range(3):
        loop(stack_steps(data))
    torch.cuda.synchronize()
    got = counts()
    n = 3 * LOOP_K
    assert got[0] == {f: n * c for f, c in one[0].items()}
    assert one[0]["bn_bwd_reduce"] > 0
    assert got[1] == {k: n * v for k, v in one[1].items()}
    assert got[2] == {k: n * v for k, v in one[2].items()}
    assert got[3] == {k: n * v for k, v in one[3].items()}


@pytest.mark.cuda
def test_cuda_graph_loop_refuses_what_it_cannot_capture(world1_cuda):
    """No fallback to eager steps: AdamW without ``capturable``, a
    torch-style ``SyncBatchNorm`` (a host read of its row count) and a
    ``backward_passes_per_step`` that does not divide the window raise
    ``ValueError`` naming the cause before the first window runs."""
    from horovod_tpu_torch.training import make_train_loop, stack_steps
    hvd = world1_cuda
    batches = stack_steps([(torch.randn(4, 6, device="cuda"),)] * 2)
    lin = torch.nn.Linear(6, 3).cuda()
    adamw = hvd.DistributedOptimizer(torch.optim.AdamW(lin.parameters()),
                                     named_parameters=lin.named_parameters())
    loop = make_train_loop(lin, lambda m, b: m(b[0]).square().mean(), adamw,
                           steps_per_execution=2)
    before = lin.weight.detach().clone()
    with pytest.raises(ValueError, match="capturable"):
        loop(batches)
    assert torch.equal(lin.weight, before)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                              hvd.SyncBatchNorm(4)).cuda()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.1),
                                   named_parameters=net.named_parameters())
    loop = make_train_loop(net, lambda m, b: m(b[0]).square().mean(), opt,
                           steps_per_execution=2)
    images = stack_steps([(torch.randn(2, 3, 5, 5, device="cuda"),)] * 2)
    with pytest.raises(ValueError, match="SyncBatchNorm"):
        loop(images)
    # A window of 4 replayed over an accumulation of 3 passes a step
    # would start each replay partway through one: refused before the
    # first window runs.
    lin = torch.nn.Linear(6, 3).cuda()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                   named_parameters=lin.named_parameters(),
                                   backward_passes_per_step=3)
    loop = make_train_loop(lin, lambda m, b: m(b[0]).square().mean(), opt,
                           steps_per_execution=4)
    before = lin.weight.detach().clone()
    with pytest.raises(ValueError, match="backward_passes_per_step=3"):
        loop(stack_steps([(torch.randn(4, 6, device="cuda"),)] * 4))
    assert torch.equal(lin.weight, before)


@pytest.mark.cuda
def test_cuda_prefetcher_hands_over_through_a_stream_event(cuda):
    """Host batches come out on the card equal to the host's, stacked
    ``[k, ...]`` with ``stack_steps``, usable on the consumer's stream
    without a device-wide sync."""
    from horovod_tpu_torch.data import DevicePrefetcher
    rng = np.random.RandomState(71)
    host = [{"x": rng.randn(64, 1024).astype(np.float32),
             "y": rng.randint(0, 9, 64)} for _ in range(6)]
    with DevicePrefetcher(host, depth=2, device="cuda",
                          stack_steps=2) as pf:
        out = [(b["x"] * 2.0, b["y"]) for b in pf]
    assert pf.dropped_remainder == 0 and len(out) == 3
    for g, (x2, y) in enumerate(out):
        assert x2.device.type == "cuda" and tuple(x2.shape) == (2, 64, 1024)
        np.testing.assert_array_equal(
            x2.cpu().numpy(), 2.0 * np.stack([host[2 * g]["x"],
                                              host[2 * g + 1]["x"]]))
        np.testing.assert_array_equal(y[1].cpu().numpy(),
                                      host[2 * g + 1]["y"])


@pytest.mark.cuda
def test_cuda_async_psum_scatter_bucket_at_world_one(world1_cuda):
    """``psum_scatter_bucket_async`` on NCCL at world 1: the handle's
    shard is the bucket zero-padded to the quantum, and it equals the
    synchronous op's."""
    from horovod_tpu_torch.collectives import ops
    x = torch.randn(1000, device="cuda")
    h = ops.psum_scatter_bucket_async(x, quantum=256)
    shard = h.wait()
    assert h.poll()
    assert shard.shape == (1024,)
    assert torch.equal(shard[:1000], x) and not shard[1000:].any()
    assert torch.equal(ops.psum_scatter_bucket(x, quantum=256), shard)


# ---------------------------------------------------------------------------
# Elastic (ROADMAP item 1.11): re-init on NCCL, in-place restore, rollback
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_nccl_reinit_in_one_process(world1_cuda):
    """``shutdown()`` then ``init()`` builds a new NCCL communicator in the
    same process: collectives work on it, the generation moves, and the
    exchange-plan cache starts empty."""
    import torch.distributed as dist

    from horovod_tpu_torch.controller import fusion
    from horovod_tpu_torch.core.state import global_state
    hvd = world1_cuda
    x = torch.arange(8.0, device="cuda")
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    fusion.plan_buckets([x])
    gen, old = global_state().generation, dist.group.WORLD
    hvd.shutdown()
    assert not dist.is_initialized()
    hvd.init()
    assert global_state().generation == gen + 1
    assert dist.group.WORLD is not old
    assert dist.get_backend() == "nccl"
    assert fusion.plan_cache_stats()["size"] == 0
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    hvd.barrier()


def _elastic_run(hvd, model, opt, data, spec, loop_k=None):
    """Twelve steps under ``@hvd.elastic.run`` with a TorchState commit
    every 2 steps (and ``spec`` chaos installed after the constructor);
    the step, or the loop of ``loop_k``, rebuilt at every entry.  Returns
    ``(losses by step, entries)``."""
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.elastic import chaos
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    chaos.reset()
    state = elastic.TorchState(model=model, optimizer=opt, batch=0)
    if spec:
        chaos.install(spec, rank=0, size=1)
    losses, entries = {}, []

    @elastic.run
    def train(state):
        entries.append(state.batch)
        if loop_k:
            loop = make_flax_train_loop(model, opt, steps_per_execution=loop_k)
        else:
            step = make_flax_train_step(model, opt)
        while state.batch < len(data):
            b = state.batch
            if loop_k:
                out = loop(stack_steps(data[b:b + loop_k])).clone()
                for i in range(loop_k):
                    losses[b + 1 + i] = out[i]
                state.batch += loop_k
            else:
                losses[b + 1] = step(data[b])
                state.batch += 1
            if state.batch % 2 == 0:
                state.commit()
        return state.batch

    train(state)
    chaos.reset()
    return losses, entries


@pytest.mark.cuda
@pytest.mark.parametrize("loop_k", [None, 2])
def test_cuda_elastic_rollback_is_bitwise(world1_cuda, deterministic,
                                          monkeypatch, loop_k):
    """A tiny ResNet on the card through ``@hvd.elastic.run``: a comm
    fault at the fourth commit rolls back a commit, ``shutdown()`` /
    ``init()`` rebuild NCCL, the step (or the CUDA-graph loop, which must
    capture again and never replay its old graph) is rebuilt, and the
    run ends bitwise equal to an uninterrupted one: parameters, BN
    statistics, momentum, every loss.  ``TorchState.restore`` keeps the
    tensors the optimizer holds."""
    monkeypatch.setenv("HOROVOD_ELASTIC_NO_SIGTERM", "1")
    hvd = world1_cuda
    data = _loop_batches(12, seed=9)
    runs = []
    for spec in (None, "seed=7;comm@step=4,rank=0"):
        model = _tiny_resnet_cuda(seed=3)
        named = list(model.named_parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
            named_parameters=named)
        losses, entries = _elastic_run(hvd, model, opt, data, spec, loop_k)
        torch.cuda.synchronize()
        state = {k: v.clone() for k, v in model.state_dict().items()}
        state.update({f"m{i}": s["momentum_buffer"].clone()
                      for i, s in enumerate(opt.state.values())})
        runs.append((losses, state, entries))
    (l1, s1, e1), (l2, s2, e2) = runs
    assert e1 == [0] and len(e2) == 2 and e2[1] < 12
    assert sorted(l1) == sorted(l2) == list(range(1, 13))
    for k in l1:
        assert torch.equal(l1[k], l2[k]), k
    assert s1.keys() == s2.keys()
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


@pytest.mark.cuda
def test_cuda_torch_state_restore_keeps_tensor_objects(world1_cuda):
    from horovod_tpu_torch import elastic
    hvd = world1_cuda
    model = _tiny_resnet_cuda(seed=4)
    named = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named)
    from horovod_tpu_torch.training import make_flax_train_step
    step = make_flax_train_step(model, opt)
    data = _loop_batches(3, seed=2)
    step(data[0])
    state = elastic.TorchState(model=model, optimizer=opt, batch=1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    ptrs = [t.data_ptr() for t in list(model.parameters())
            + list(model.buffers())]
    bufs = [s["momentum_buffer"] for s in opt.state.values()]
    mom = [b.clone() for b in bufs]
    step(data[1])
    step(data[2])
    state.restore()
    assert [t.data_ptr() for t in list(model.parameters())
            + list(model.buffers())] == ptrs
    assert all(a is b for a, b in zip(
        [s["momentum_buffer"] for s in opt.state.values()], bufs))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for b, m in zip(bufs, mom):
        assert torch.equal(b, m) and b.device.type == "cuda"
    assert all(v.device.type == "cpu" for v in state._saved["model"].values())


@pytest.mark.cuda
def test_cuda_graph_loop_captures_again_after_a_reinit(world1_cuda,
                                                       deterministic):
    """The same ``TrainLoop`` object across ``shutdown()`` / ``init()``:
    its next call drops the graph that holds the old communicator (eager
    window, then a new capture) and stays bitwise equal to eager steps."""
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    hvd = world1_cuda
    data = _loop_batches(8, seed=6)
    out = []
    for use_loop in (False, True):
        model = _tiny_resnet_cuda(seed=5)
        named = list(model.named_parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
            named_parameters=named)
        if use_loop:
            loop = make_flax_train_loop(model, opt, steps_per_execution=2)
            losses = [loop(stack_steps(data[0:2])).clone(),
                      loop(stack_steps(data[2:4])).clone()]
            old = loop._graph
            assert old is not None
            hvd.shutdown()
            hvd.init()
            losses.append(loop(stack_steps(data[4:6])).clone())
            assert loop._graph is None and loop._calls == 1
            assert loop._generation == global_state().generation
            losses.append(loop(stack_steps(data[6:8])).clone())
            assert loop._graph is not None and loop._graph is not old
            losses = torch.cat(losses)
        else:
            step = make_flax_train_step(model, opt)
            losses = torch.stack([step(b) for b in data])
        torch.cuda.synchronize()
        out.append((losses, {k: v.clone()
                             for k, v in model.state_dict().items()}))
    (l1, s1), (l2, s2) = out
    assert torch.equal(l1, l2)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


# ---------------------------------------------------------------------------
# The silent-data-corruption plane on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32",
                                   "int8", "bool"])
def test_cuda_tripwire_checksum_equals_the_cpu(cuda, dtype):
    """The tripwire's bit checksum of a tensor on the card equals that of
    the same tensor on the CPU, past 2**16 elements; and a model's."""
    from horovod_tpu_torch.core import desync
    rng = np.random.RandomState(71)
    n = 300_001
    if dtype == "bool":
        t = torch.from_numpy(rng.rand(n) < 0.5)
    elif dtype in ("int32", "int8"):
        t = torch.from_numpy(rng.randint(-100, 100, n).astype(dtype))
    else:
        t = _randn(rng, n).to(getattr(torch, dtype))
    assert int(desync._traced_bit_checksum(t.to(cuda))) == \
        int(desync._traced_bit_checksum(t))
    model = _tiny_resnet_cuda(seed=7)
    tree = desync.module_tree(model)
    cpu = {k: v.cpu() for k, v in model.state_dict().items()}
    model_cpu = _tiny_resnet_cuda(seed=7).cpu()
    model_cpu.load_state_dict(cpu)
    assert desync.local_checksum(tree) == \
        desync.local_checksum(desync.module_tree(model_cpu))


def _guarded(hvd):
    """Turn the guard on for steps built from now (the config is read
    when a step is built)."""
    import dataclasses

    from horovod_tpu_torch.core import guard
    from horovod_tpu_torch.core.state import global_state
    st = global_state()
    st.config = dataclasses.replace(st.config, guard="1")
    guard.reset()
    return guard


def _nan_bytes(t):
    return t.detach().cpu().numpy().tobytes()


@pytest.mark.cuda
def test_cuda_guarded_graph_loop_equals_guarded_eager_steps(world1_cuda,
                                                            deterministic):
    """Guarded ``make_flax_train_loop(steps_per_execution=2)`` on the
    card -- eager window, capture, replays -- bitwise eight guarded
    eager steps, with step 6's batch poisoned inside a replayed window:
    skipped in the graph (parameters, momentum and BN statistics kept),
    the windows' rows fed to the policy."""
    from horovod_tpu_torch.elastic import chaos
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    hvd = world1_cuda
    guard = _guarded(hvd)
    data = _loop_batches(8, seed=7)
    data[5] = chaos.poison_batch(data[5])
    out = []
    for use_loop in (False, True):
        guard.reset()
        model = _tiny_resnet_cuda(seed=6)
        named = list(model.named_parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
            named_parameters=named)
        if use_loop:
            loop = make_flax_train_loop(model, opt, steps_per_execution=2)
            losses = torch.cat([loop(stack_steps(data[i:i + 2])).clone()
                                for i in range(0, 8, 2)])
            assert loop._graph is not None
        else:
            step = make_flax_train_step(model, opt)
            losses = torch.stack([step(b).clone() for b in data])
        torch.cuda.synchronize()
        pol = guard.policy()
        state = {k: v.clone() for k, v in model.state_dict().items()}
        state.update({f"m{i}": s["momentum_buffer"].clone()
                      for i, s in enumerate(opt.state.values())})
        out.append((losses, state, pol.steps, pol.skipped))
    (l1, s1, n1, k1), (l2, s2, n2, k2) = out
    assert (n1, k1) == (n2, k2) == (8, 1)
    assert _nan_bytes(l1) == _nan_bytes(l2)
    assert not torch.isfinite(l2[5])
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


@pytest.mark.cuda
def test_cuda_bn_kernels_equal_plain_under_the_guard(world1_cuda):
    """After guarded steps on the card, one loss and backward through the
    BN kernels equals the plain versions' (f32, through every BN site of
    the model: ``MODEL_F32_GRAD_REL`` of max |grad|, as ``chip_smoke.py``
    phase 7 holds ResNet-50), and the guarded steps launched both kernels
    at every BN site."""
    from horovod_tpu_torch.ops.bn import BatchNorm
    from horovod_tpu_torch.training import make_flax_train_step, softmax_xent
    hvd = world1_cuda
    _guarded(hvd)
    model = _tiny_resnet_cuda(seed=8)
    sites = sum(isinstance(m, BatchNorm) for m in model.modules())
    named = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named)
    step = make_flax_train_step(model, opt)
    data = _loop_batches(2, seed=8)
    registry.reset_launch_counts()
    for b in data:
        step(b)
    assert registry.launches("bn_bwd_reduce") == 2 * sites
    assert registry.launches("bn_bwd_dx") == 2 * sites
    # torch.autograd.grad: the wrap's gradient hooks do not fire.
    params = list(model.parameters())
    grads = []
    for ref in (False, True):
        x, y = data[0]
        grads.append(torch.autograd.grad(
            softmax_xent(model(x, force_reference=ref), y), params))
    for g, w in zip(*grads):
        assert (g - w).abs().max().item() <= \
            MODEL_F32_GRAD_REL * max(w.abs().max().item(), 1e-30)


def _tuned_run(hvd, n, tuner, loop_k=None):
    """``n`` steps of the tiny ResNet on the card (the step, or the loop
    of ``loop_k``) with ``tuner`` installed while it is built and run."""
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step,
                                            stack_steps)
    st = global_state()
    st.autotuner = tuner
    try:
        model = _tiny_resnet_cuda(seed=4)
        named = list(model.named_parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
            named_parameters=named)
        data = _loop_batches(n, seed=12)
        if loop_k:
            fn = make_flax_train_loop(model, opt, steps_per_execution=loop_k)
            losses = torch.cat([fn(stack_steps(data[i:i + loop_k])).clone()
                                for i in range(0, n, loop_k)])
        else:
            fn = make_flax_train_step(model, opt)
            losses = torch.stack([fn(b) for b in data])
        torch.cuda.synchronize()
        return losses, _loop_state(model, [opt], opt), fn
    finally:
        st.autotuner = None


@pytest.mark.cuda
@pytest.mark.parametrize("loop_k", [None, 2])
def test_cuda_tuned_step_and_loop_are_bitwise_untuned(world1_cuda,
                                                      deterministic, loop_k):
    """A tuned flax step and a tuned CUDA-graph loop on the card re-plan
    their buckets at every sampled threshold and end bitwise an untuned
    run: parameters, BN statistics, momentum, every loss.  The loop
    captures once a trace key, and no eager or capture window is
    scored."""
    from horovod_tpu_torch.autotune import Autotuner
    from horovod_tpu_torch.core.config import Config
    # A sample: one unscored step and two scored; through the loop an
    # eager window, a capture and two scored replays.
    n = 36 if loop_k else 14
    base = _tuned_run(world1_cuda, n, None, loop_k)
    tuner = Autotuner(Config(autotune=True), steps_per_sample=2,
                      candidates=[4096, 16384, 65536], max_samples=4)
    got = _tuned_run(world1_cuda, n, tuner, loop_k)
    assert tuner.done
    assert torch.equal(base[0], got[0])
    assert base[1].keys() == got[1].keys()
    for k in base[1]:
        assert torch.equal(base[1][k], got[1][k]), k
    trail = got[2].trail
    assert len({key for key, _, _ in trail}) == 4
    if loop_k:
        assert not [t for t in trail if t[1] != "replay" and t[2]]
        for key in {key for key, _, _ in trail}:
            kinds = [kind for k, kind, _ in trail if k == key]
            assert kinds[:2] == ["eager", "capture"] and \
                kinds.count("capture") == 1, (key, kinds)
            assert set(kinds[2:]) == {"replay"}


@pytest.mark.cuda
def test_cuda_replan_happens_with_no_handle_outstanding(world1_cuda):
    """The wrap refuses a re-plan with NCCL handles in flight (mid
    backward); the tuned step re-plans only between steps, when none
    is."""
    from horovod_tpu_torch.autotune import Autotuner
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.training import make_flax_train_step
    hvd = world1_cuda
    model = _tiny_resnet_cuda(seed=5)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        fusion_threshold=4096)
    x, y = _loop_batches(1, seed=3)[0]
    torch.nn.functional.cross_entropy(model(x), y.long()).backward()
    assert opt._handles
    with pytest.raises(RuntimeError, match="step boundary"):
        opt.replan()
    opt.step()
    opt.zero_grad()
    opt.replan()
    seen = []
    original = type(opt).replan

    def watched(self):
        seen.append(len(self._handles))
        return original(self)

    st = global_state()
    st.autotuner = Autotuner(Config(autotune=True), steps_per_sample=1,
                             candidates=[4096, 16384], max_samples=3)
    try:
        model2 = _tiny_resnet_cuda(seed=5)
        opt2 = hvd.DistributedOptimizer(
            torch.optim.SGD(model2.parameters(), lr=0.1),
            named_parameters=model2.named_parameters())
        opt2.replan = watched.__get__(opt2)
        step = make_flax_train_step(model2, opt2)
        for b in _loop_batches(8, seed=4):
            step(b)
    finally:
        st.autotuner = None
    assert seen and set(seen) == {0}


@pytest.mark.cuda
def test_cuda_sharded_checkpoint_restores_onto_the_card(world1_cuda,
                                                        tmp_path):
    """``save_checkpoint_sharded`` of CUDA tensors (f32, bf16, int64) and
    ``restore_checkpoint_sharded`` onto CUDA ``like`` leaves: bitwise, on
    the card, in ``like``'s dtypes."""
    hvd = world1_cuda
    g = torch.Generator(device="cuda").manual_seed(3)
    tree = {"w": torch.randn(64, 32, device="cuda", generator=g),
            "h": torch.randn(100, device="cuda", generator=g).bfloat16(),
            "n": torch.arange(5, device="cuda")}
    hvd.save_checkpoint_sharded(str(tmp_path), tree, step=3)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    got, step = hvd.restore_checkpoint_sharded(str(tmp_path), like)
    assert step == 3
    for k, v in tree.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v), k


def _cuda_bn_resnet(native: bool, steps: int = 3):
    """A small torch-idiom ResNet (the example's ``Bottleneck`` blocks,
    ``hvd.SyncBatchNorm``) on the card, deterministic cuDNN, through a
    batched (``native``) or planned ``DistributedOptimizer`` with fp16:
    the losses, the parameters and the BN launches of ``steps`` steps."""
    import dataclasses

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.examples.torch_resnet50 import Bottleneck
    st = global_state()
    st.config = dataclasses.replace(st.config, native_core=native)
    torch.manual_seed(5)

    def norm(c):
        return hvd.SyncBatchNorm(c, device="cuda")
    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, 1, 1, bias=False), norm(16),
        Bottleneck(16, 8, 2, norm), Bottleneck(32, 8, 1, norm),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(32, 10)).to("cuda", memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(16, 3, 32, 32, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)
    y = torch.randint(0, 10, (16,), device="cuda", generator=g)
    registry.reset_launch_counts()
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    counts = registry.launch_counts()
    return losses, [p.detach().clone() for p in model.parameters()], counts


@pytest.mark.cuda
def test_cuda_batched_optimizer_bitwise_planned(world1_cuda):
    """Phase 25 (a) small: the native batcher (deterministic on the GPU)
    on a sync-BN ResNet with fp16 is bitwise the planned buckets, the BN
    kernels launched at every site a step on both."""
    from horovod_tpu_torch.collectives import batching
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        bl, bp, bc = _cuda_bn_resnet(True)
        b = batching.current()
        assert b is not None and b.deterministic and b.batches() == 3
        pl, pp, pc = _cuda_bn_resnet(False)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
    assert bl == pl and all(np.isfinite(bl))
    assert all(torch.equal(a, c) for a, c in zip(bp, pp))
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        assert bc[f] == pc[f] == 8 * 3     # 8 sync-BN sites, 3 steps


@pytest.mark.cuda
def test_cuda_autotuner_cycle_axis_pinned(world1_cuda):
    """Phase 25 (c) small: the GPU's batcher is deterministic, so the
    tuner's cycle member stays the configured one and each sample's
    threshold (with that cycle time) reaches the batcher."""
    import dataclasses

    from horovod_tpu_torch.autotune import Autotuner
    from horovod_tpu_torch.collectives import batching
    from horovod_tpu_torch.core.state import global_state
    st = global_state()
    st.config = dataclasses.replace(st.config, native_core=True)
    cfg = dataclasses.replace(st.config, autotune=True, autotune_log=None)
    tuner = Autotuner(cfg, steps_per_sample=1)
    assert not tuner.tunes_cycle
    st.autotuner = tuner
    try:
        b = batching.batcher()
        assert b.deterministic
        for _ in range(4):
            tuner.record_step(0.01, 1 << 20)
            assert (b.cycle_ms, b.fusion_bytes) == \
                (cfg.cycle_time, tuner.fusion_threshold())
    finally:
        st.autotuner = None


@pytest.mark.cuda
def test_cuda_eager_ops_exact_at_world_one(world1_cuda, monkeypatch):
    """Phase 25 (b) small: ``allreduce_async`` immediate and as a fused
    deferred flush (forced through ``_defer_applies``), ``allgatherv``,
    ``alltoallv``, ``local_result``, ``local_rank_count`` and ``join`` on
    CUDA tensors, each exactly its definition."""
    hvd = world1_cuda
    from horovod_tpu_torch.collectives import eager
    g = torch.Generator(device="cuda").manual_seed(8)
    xs = [torch.randn(s, device="cuda", generator=g)
          for s in ((64, 3, 3, 3), (64,), (10, 64), (7,))]
    xs.append(torch.randn(5, device="cuda", generator=g).bfloat16())
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(eager, "_defer_applies", lambda ps: True)
        hs = [hvd.allreduce_async(x, op=hvd.Average) for x in xs]
        assert eager.deferred_count() == (len(xs) if forced else 0)
        for h, x in zip(hs, xs):
            got = hvd.synchronize(h)
            assert got.device.type == "cuda" and torch.equal(got, x)
    assert eager.deferred_fuse_stats() == {
        "flushes": 1, "fused_buckets": 1, "fused_ops": 4,
        "singleton_ops": 1}
    x = torch.randn(9, 4, device="cuda", generator=g)
    assert torch.equal(hvd.allgatherv(x), x)
    datas, recv = hvd.alltoallv([x], [[9]])
    assert torch.equal(datas[0], x) and recv[0].tolist() == [9]
    assert torch.equal(hvd.local_result(x), x[None])
    assert hvd.local_rank_count() == 1 and hvd.join() == -1
