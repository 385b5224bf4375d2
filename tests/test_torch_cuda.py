"""PyTorch/CUDA port on the card: each CUDA kernel against its plain
PyTorch version, on the same inputs made with numpy from a seed.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
The module imports nothing of JAX, so it runs on a GPU machine that has
no JAX; run it there without the suite's JAX conftest::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 atol 1e-5 (the kernels only reorder the sums); bf16
2e-2 of the reference's largest |value| (one bf16 rounding of the
output, plus f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models.transformer import tied_readout
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import registry

ATOL = 1e-5
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
    with pytest.raises(NotImplementedError, match="forward only"):
        tattn.flash_attention(q.requires_grad_(), k, v)


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
