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
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import bn as tbn
from horovod_tpu_torch.ops import fused_update as tfu
from horovod_tpu_torch.ops import registry

ATOL = 1e-5
F32_GRAD_REL = 1e-5
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
                                 (802816, 256), (12544, 2048)])
def test_cuda_bn_backward_kernels_match_plain(cuda, dtype, n, c):
    """Both BN backward kernels against the plain closed form: a ragged N
    with C below one vector, C of one vector, and three ResNet-50 sites
    at batch 256 (the stem, stage 1's widest, stage 4)."""
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
                                    (100003, 8), (1000003, 9), (64, 1)])
def test_cuda_powersgd_stages_match_plain(cuda, dtype, size, r):
    """Ragged tails (size < m * c), r = 1 / 4 / 8 and r = 9 (two passes
    of the kernels' 8 register columns): each kernel against its plain
    version on the same inputs, one launch of each family per call."""
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
def test_cuda_powersgd_stages_refuse_what_they_cannot_take(cuda):
    q0 = _powersgd_seed_matrix(4, 2, cuda)
    with pytest.raises(ValueError, match="dtype"):
        tfu.matricize_p(torch.zeros(16, device=cuda, dtype=torch.float16),
                        None, q0, rows=4)
    with pytest.raises(ValueError, match="contiguous"):
        tfu.matricize_p(torch.zeros(32, device=cuda)[::2], None, q0, rows=4)
    with pytest.raises(ValueError, match="do not fit"):
        tfu.matricize_p(torch.zeros(17, device=cuda), None, q0, rows=4)
