"""PyTorch/CUDA port: the precision of the bf16 tensor-core attention
kernels, emulated on the CPU and held against the JAX package.

The bf16 bodies of ``flash_fwd.cu`` (``flash_fwd_mma_kernel``) and
``flash_bwd.cu`` (``flash_bwd_dkv_mma_kernel``, ``flash_bwd_dq_mma_kernel``)
run their products on the tensor cores: bf16 operands, f32 accumulators.
Besides the bf16 inputs and outputs, they round these intermediates to
bf16, as operands:

* the forward's P (``exp(s - m)`` against the RUNNING row max of its
  128-row x 64-key tile walk) before ``P V``, in two bf16 parts:
  ``hi = bf16(P)`` and ``lo = bf16(P - hi)``, both multiplied by V and
  summed (one bf16 P alone moves a 2-layer Llama-3 8B's LoRA gradients
  past the 2e-2 the chip check holds them to); the row sums use the f32
  P;
* the dk/dv kernel's ``P^T = exp(S^T scale - lse)`` before ``P^T dO``,
  once;
* ``dS = P (dP - delta) scale`` before the dq kernel's ``dS K`` and the
  dk/dv kernel's ``dS^T Q``, in hi + lo parts like the forward's P.

And the backward's ``delta = rowsum(dO * O)`` reads O as the forward's
bf16 O plus its rounding residual, which the forward kernel writes when a
gradient is wanted.  Both serve one cancellation: dS sums to zero over a
query's keys, so a component every key shares drops out of dq, and
either a rounding of dS or a delta from the rounded O (about 2^-9 off)
leaks it back in -- a 2-layer BERT-Large-width model put its second
layer's wq and wk gradients several times further from the f32 reference
than the plain bf16 path's.

Every sum stays f32.  The emulations below repeat that arithmetic tile by
tile in f32 PyTorch (products of bf16 values are exact in f32, as on the
tensor cores) and are held against ``horovod_tpu.ops.attention``: the
output and ``jax.vjp``'s dk/dv of ``flash_attention`` through its XLA
reference, and lse from ``_flash_fwd`` in interpret mode (where a block
of 8 or more divides the length; else from the port's plain version,
which ``tests/test_torch_attention.py`` holds against ``_flash_fwd``).
Inputs are numpy draws from a seed, rounded to bf16 so that both sides
see the kernels' inputs; the JAX side computes in f32.

Bounds: O, dk and dv within ``2e-2 x max |ref|`` and lse within 1e-3
absolute -- the bounds ``chip_smoke.py`` holds the kernels to against
their plain versions on the card (phases 3-5).  So the chosen precision
is shown to fit the existing tolerances here, before any chip run.  And
dq, dk and dv within ``2**-8 x max |ref|`` (about their own output
rounding) of the JAX package's f32 gradients, also where every key
carries a common component several times its own spread -- where delta
from the rounded O and one rounding of dS miss that bound for dq.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as jattn
from horovod_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

REL = 2e-2          # O, dk, dv: relative to max |reference|
LSE_ATOL = 1e-3
NEG = -1e30         # masked logit (finite)
DEAD_LSE = 1e30
FWD_BQ, FWD_BK = 128, 64     # flash_fwd_mma_kernel's tiles
DKV_BK, DKV_BQ = 64, 64      # flash_bwd_dkv_mma_kernel's tiles
DQ_BQ, DQ_BK = 128, 64       # flash_bwd_dq_mma_kernel's tiles


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(p):
    """P as the forward kernel feeds it to ``P V``: hi + lo in bf16."""
    hi = _bf16(p)
    return hi + _bf16(p - hi)


def emulate_forward(q, k, v, *, causal, scale, qseg=None, kseg=None,
                    operand=_split, rounded=True):
    """``(o, lse)`` as the bf16 forward kernel computes them
    (``operand=_bf16``: with P rounded once instead; ``rounded=False``: O
    before its bf16 rounding, whose hi + lo parts the kernel writes for
    the backward's delta)."""
    b, h, tq, d = q.shape
    rep, tk = h // k.shape[1], k.shape[2]
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    off = tk - tq
    o = torch.zeros(b, h, tq, d)
    lse = torch.zeros(b, h, tq)
    for q0 in range(0, tq, FWD_BQ):
        rows = torch.arange(q0, min(q0 + FWD_BQ, tq))
        m = torch.full((b, h, len(rows)), NEG)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        kv_end = min(tk, q0 + FWD_BQ + off) if causal else tk
        for k0 in range(0, kv_end, FWD_BK):
            cols = torch.arange(k0, min(k0 + FWD_BK, tk))
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows],
                             kr[:, :, cols]) * scale
            if causal:
                s = s.masked_fill(cols[None, :] > rows[:, None] + off, NEG)
            if qseg is not None:
                s = s.masked_fill(qseg[:, None, rows, None]
                                  != kseg[:, None, None, cols], NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bhqk,bhkd->bhqd", operand(p), vr[:, :, cols])
            m = m_new
        dead = (m <= NEG / 2) if qseg is not None else torch.zeros_like(
            m, dtype=torch.bool)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, rows] = torch.where(dead[..., None], 0.0,
                                    acc / l_safe[..., None])
        lse[:, :, rows] = torch.where(dead, DEAD_LSE, m + torch.log(l_safe))
    return (_bf16(o) if rounded else o), lse


def _delta(q, k, v, do, *, causal, scale, **seg):
    """``delta = rowsum(dO * O)`` as the autograd path forms it: O from
    the forward kernel's hi + lo parts."""
    o, _ = emulate_forward(q, k, v, causal=causal, scale=scale,
                           rounded=False, **seg)
    return (do * _split(o)).sum(-1)


def emulate_dkv(q, k, v, do, lse, delta, *, causal, scale, qseg=None,
                kseg=None, operand=_split):
    """``(dk, dv)`` as the bf16 dk/dv kernel computes them: per 64-key
    block, over the group's query heads and the 64-row query tiles that
    can see it; ``P^T`` rounded once, ``dS^T`` in hi + lo parts
    (``operand=_bf16``: rounded once instead)."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    rep, off = h // h_kv, tk - tq
    dk = torch.zeros(b, h_kv, tk, d)
    dv = torch.zeros(b, h_kv, tk, d)
    for k0 in range(0, tk, DKV_BK):
        cols = torch.arange(k0, min(k0 + DKV_BK, tk))
        q_begin = max(0, k0 - off) // DKV_BQ * DKV_BQ if causal else 0
        for r in range(rep):
            heads = torch.arange(h_kv) * rep + r
            for q0 in range(q_begin, tq, DKV_BQ):
                rows = torch.arange(q0, min(q0 + DKV_BQ, tq))
                qt = q[:, heads][:, :, rows]
                dot = do[:, heads][:, :, rows]
                st = torch.einsum("bhkd,bhqd->bhkq", k[:, :, cols],
                                  qt) * scale
                live = torch.ones(len(cols), len(rows), dtype=torch.bool)
                if causal:
                    live = live & (cols[:, None] <= rows[None, :] + off)
                live = live[None, None].expand(b, h_kv, -1, -1)
                if qseg is not None:
                    live = live & (kseg[:, None, cols, None]
                                   == qseg[:, None, None, rows])
                lse_t = lse[:, heads][:, :, rows]
                delta_t = delta[:, heads][:, :, rows]
                p = torch.where(live, torch.exp(st - lse_t[:, :, None, :]),
                                0.0)
                dp = torch.einsum("bhkd,bhqd->bhkq", v[:, :, cols], dot)
                ds = p * (dp - delta_t[:, :, None, :]) * scale
                dv[:, :, cols] += torch.einsum("bhkq,bhqd->bhkd",
                                               _bf16(p), dot)
                dk[:, :, cols] += torch.einsum("bhkq,bhqd->bhkd",
                                               operand(ds), qt)
    return _bf16(dk), _bf16(dv)


def emulate_dq(q, k, v, do, lse, delta, *, causal, scale, qseg=None,
               kseg=None, operand=_split):
    """``dq`` as the bf16 dq kernel computes it: per 128-row query tile,
    over the 64-key tiles up to the tile's causal end, f32 ``S`` and
    ``dP``, ``dS = P (dP - delta) scale`` in hi + lo bf16 parts before
    ``dS K`` (``operand=_bf16``: rounded once instead), the sum in f32
    and one rounding of the result."""
    b, h, tq, d = q.shape
    rep, tk = h // k.shape[1], k.shape[2]
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    off = tk - tq
    dq = torch.zeros(b, h, tq, d)
    for q0 in range(0, tq, DQ_BQ):
        rows = torch.arange(q0, min(q0 + DQ_BQ, tq))
        kv_end = min(tk, q0 + DQ_BQ + off) if causal else tk
        for k0 in range(0, kv_end, DQ_BK):
            cols = torch.arange(k0, min(k0 + DQ_BK, tk))
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows],
                             kr[:, :, cols]) * scale
            live = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                live = live & (cols[None, :] <= rows[:, None] + off)
            live = live[None, None].expand(b, h, -1, -1)
            if qseg is not None:
                live = live & (qseg[:, None, rows, None]
                               == kseg[:, None, None, cols])
            p = torch.where(live, torch.exp(s - lse[:, :, rows, None]), 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, rows],
                              vr[:, :, cols])
            ds = p * (dp - delta[:, :, rows, None]) * scale
            dq[:, :, rows] += torch.einsum("bhqk,bhkd->bhqd", operand(ds),
                                           kr[:, :, cols])
    return _bf16(dq)


CASES = [
    # (name, causal, tq, tk, segments)
    ("causal_160", True, 160, 160, False),
    ("full_160", False, 160, 160, False),
    ("causal_ragged_150", True, 150, 150, False),
    ("causal_tq_lt_tk", True, 96, 160, False),
    ("segments_dead_128", True, 128, 128, True),
]
B, H, H_KV, D = 2, 4, 2, 64


def _case(seed, tq, tk, segments):
    rng = np.random.RandomState(seed)

    def bf16(*shape):
        return _bf16(torch.from_numpy(
            rng.randn(*shape).astype(np.float32))).numpy()

    q, do = bf16(B, H, tq, D), bf16(B, H, tq, D)
    k, v = bf16(B, H_KV, tk, D), bf16(B, H_KV, tk, D)
    seg = None
    if segments:
        # Two packed segments; the last 5 query rows carry an id no key
        # has (DEAD rows), the last 7 keys an id no query has.
        qseg = np.zeros((B, tq), np.int32)
        qseg[:, tq // 3:] = 1
        qseg[:, -5:] = 9
        kseg = np.zeros((B, tk), np.int32)
        kseg[:, tk // 3:] = 1
        kseg[:, -7:] = 8
        seg = (qseg, kseg)
    return q, k, v, do, seg


def _jax_lse(q, k, v, seg, causal, scale):
    """lse from ``_flash_fwd`` in interpret mode, where a block divides
    the lengths; else the port's plain lse."""
    tq, tk = q.shape[2], k.shape[2]
    if tq % 8 == 0 and tk % 8 == 0:
        qs, ks = (None, None) if seg is None else map(jnp.asarray, seg)
        _, lse = jattn._flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qs, ks,
            scale=scale, causal=causal, bq=32, bk=32)
        return torch.from_numpy(np.array(lse))
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = tattn.flash_attention(tq_, tk_, tv_, causal=causal,
                                   return_lse=True)
    return lse


def _jax_vjp(q, k, v, do, seg, causal):
    """``(o, (dq, dk, dv))`` of the JAX package's flash_attention through
    its XLA reference."""
    kw = dict(causal=causal, force_reference=True)
    if seg is not None:
        kw.update(segment_ids=jnp.asarray(seg[0]),
                  kv_segment_ids=jnp.asarray(seg[1]))
    o, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    return (torch.from_numpy(np.array(o)),
            [torch.from_numpy(np.array(g)) for g in grads])


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("name,causal,tq,tk,segments", CASES)
def test_bf16_forward_emulation_within_tolerance(name, causal, tq, tk,
                                                 segments):
    q, k, v, _, seg = _case(0, tq, tk, segments)
    scale = D ** -0.5
    tseg = {} if seg is None else dict(
        qseg=torch.from_numpy(seg[0]), kseg=torch.from_numpy(seg[1]))
    o, lse = emulate_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, scale=scale, **tseg)
    want, _ = _jax_vjp(q, k, v, np.zeros_like(q), seg, causal)
    want_lse = _jax_lse(q, k, v, seg, causal, scale)
    err = _rel_err(o, want)
    assert 0.0 < err <= REL, err
    # hi + lo carries P closer than one bf16 rounding: on average the
    # output lands nearer the f32 reference.
    o1, _ = emulate_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=causal, scale=scale, operand=_bf16,
                            **tseg)
    assert (o - want).abs().mean() < (o1 - want).abs().mean()
    if seg is None:
        assert (lse - want_lse).abs().max().item() <= LSE_ATOL
    else:
        assert torch.equal(o[:, :, -5:], torch.zeros_like(o[:, :, -5:]))
        assert bool((lse[:, :, -5:] == DEAD_LSE).all())
        live = want_lse[:, :, :-5]
        assert (lse[:, :, :-5] - live).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("name,causal,tq,tk,segments", CASES)
def test_bf16_dkv_emulation_within_tolerance(name, causal, tq, tk,
                                             segments):
    q, k, v, do, seg = _case(1, tq, tk, segments)
    scale = D ** -0.5
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = {} if seg is None else dict(
        qseg=torch.from_numpy(seg[0]), kseg=torch.from_numpy(seg[1]))
    # The backward reads the forward kernel's outputs: lse, and O as
    # hi + lo for delta.
    _, lse = emulate_forward(tq_, tk_, tv_, causal=causal, scale=scale,
                             **tseg)
    delta = _delta(tq_, tk_, tv_, tdo, causal=causal, scale=scale, **tseg)
    dk, dv = emulate_dkv(tq_, tk_, tv_, tdo, lse, delta, causal=causal,
                         scale=scale, **tseg)
    _, (_, want_dk, want_dv) = _jax_vjp(q, k, v, do, seg, causal)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert got.shape == want.shape
        assert 0.0 < _rel_err(got, want) <= REL
    if seg is not None:
        assert torch.equal(dk[:, :, -7:], torch.zeros_like(dk[:, :, -7:]))
        assert torch.equal(dv[:, :, -7:], torch.zeros_like(dv[:, :, -7:]))


@pytest.mark.parametrize("name,causal,tq,tk,segments", CASES)
def test_bf16_dq_emulation_within_tolerance(name, causal, tq, tk, segments):
    q, k, v, do, seg = _case(2, tq, tk, segments)
    scale = D ** -0.5
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = {} if seg is None else dict(
        qseg=torch.from_numpy(seg[0]), kseg=torch.from_numpy(seg[1]))
    _, lse = emulate_forward(tq_, tk_, tv_, causal=causal, scale=scale,
                             **tseg)
    delta = _delta(tq_, tk_, tv_, tdo, causal=causal, scale=scale, **tseg)
    dq = emulate_dq(tq_, tk_, tv_, tdo, lse, delta, causal=causal,
                    scale=scale, **tseg)
    _, (want_dq, _, _) = _jax_vjp(q, k, v, do, seg, causal)
    assert dq.shape == want_dq.shape
    assert 0.0 < _rel_err(dq, want_dq) <= REL
    if seg is not None:
        assert torch.equal(dq[:, :, -5:], torch.zeros_like(dq[:, :, -5:]))


@pytest.mark.parametrize("causal,segments,common", [
    (False, False, 0.0), (False, False, 4.0), (True, True, 8.0)])
def test_bf16_backward_holds_dq_when_every_key_shares_a_component(
        causal, segments, common):
    """The backward as the autograd path runs it (delta from O's hi + lo
    parts, dS in hi + lo parts): dq, dk and dv within 2**-8 of max |ref|
    of the JAX package's f32 gradients, also when every key carries a
    common component (``common`` times each key's own spread).  There,
    delta from the bf16 O with dS rounded once misses that bound for
    dq."""
    t = 160 if causal else 128
    q, k, v, do, seg = _case(3, t, t, segments)
    if common:
        shared = np.random.RandomState(9).randn(1, H_KV, 1, D)
        k = _bf16(torch.from_numpy((k + common * shared).astype(
            np.float32))).numpy()
    scale = D ** -0.5
    tq_, tk_, tv_, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = {} if seg is None else dict(
        qseg=torch.from_numpy(seg[0]), kseg=torch.from_numpy(seg[1]))
    o, lse = emulate_forward(tq_, tk_, tv_, causal=causal, scale=scale,
                             **tseg)
    args = (tq_, tk_, tv_, tdo, lse)
    kw = dict(causal=causal, scale=scale, **tseg)
    delta = _delta(tq_, tk_, tv_, tdo, **kw)
    got = (emulate_dq(*args, delta, **kw), *emulate_dkv(*args, delta, **kw))
    _, want = _jax_vjp(q, k, v, do, seg, causal)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 2.0 ** -8
    if common:
        once = emulate_dq(*args, (tdo * o).sum(-1), operand=_bf16, **kw)
        assert _rel_err(once, want[0]) > 2.0 ** -8
