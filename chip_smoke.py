"""GPU smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. card -- ``nvidia-smi`` name and power limit, ``torch.cuda`` device
   name; TF32 turned off for matmuls and cuDNN.
2. build -- every CUDA source in ``horovod_tpu_torch/ops/csrc`` compiled
   with ``nvcc`` for ``sm_90a``, one process per source, all at once.
3. kernels -- each kernel against its plain PyTorch version on the card
   at its path's shapes (serving: flash forward and decode; training:
   the flash backward's dq and dk/dv; ResNet: the BatchNorm backward's
   two passes, at a ragged N, a C below one vector and three ResNet-50
   sites at batch 256, bitwise repeatable; PowerSGD: the three
   ``fused_update`` stages at both ResNet-50 bucket shapes, r = 1 and
   4, with and without a residual, Average and Sum with a postscale,
   bitwise repeatable), with its time, the plain version's time, one
   PyTorch library call's time for the same function where one exists,
   and the least time the card could take (``bound_ms``).
4. serve -- Llama-3 8B at full width and depth (random bf16 weights from
   a seed) serves 8 requests through ``ServingEngine``; the kernels'
   launch counters must show the main path went through them, and the
   first request's first-token logits must match the same prefill run
   through the plain attention.
5. grad -- Llama-3 8B at full width, 2 layers, LoRA rank 8 with non-zero
   adapters: one loss and backward through the kernels against the same
   through the plain attention (loss within 1e-2 relative, every LoRA
   gradient within 2e-2 of its max |value|).
6. train -- Llama-3 8B at full width and depth, frozen bf16 base, LoRA
   rank 8 on all seven projections: ``init`` (world 1, NCCL) ->
   ``broadcast_parameters`` -> ``DistributedOptimizer(AdamW,
   compression=bf16)`` -> ``make_train_step``, one warm-up and five timed
   steps on a 2 x 2048-token batch.  The loss must stay finite and fall,
   every adapter change, every base tensor stay bitwise the same, each
   step launch 32 flash forwards and 32 of each backward kernel, and the
   optimizer send as many buckets per step as ``plan_buckets`` plans.
7. resnet_grad -- ResNet-50 at full width and depth (s2d stem, every BN
   scale from N(1, 0.1)) on 32 images: one loss and backward through the
   BN kernels and one through their plain versions, in bf16 and in f32
   from the same weights.  Losses bitwise equal; 53 launches of each BN
   kernel, 0 on the plain runs; f32 gradients within 1e-3 of their max;
   no bf16 gradient moved by the kernels as much as bf16 moves it from
   f32 (see ``check_resnet_grad``).
8. resnet_train -- ``bench.py``'s ResNet-50 configuration: 256 images of
   224 x 224, bf16 compute, ``init`` -> ``broadcast_parameters`` ->
   ``DistributedOptimizer(SGD(0.1, momentum 0.9))`` ->
   ``make_flax_train_step``, one warm-up and five timed steps.  Losses
   finite and falling, every parameter and running statistic changed,
   53 launches of each BN kernel a step, buckets as planned.
9. resnet_powersgd -- the same with ``compression="powersgd:4"``
   (``bench.py``'s ``HOROVOD_COMPRESSION=powersgd:4`` variant): the
   rank-4 PowerSGD exchange with its error-feedback residuals, each
   bucket through the three ``fused_update`` kernels and two factor
   allreduces.  One warm-up step, whose two real buckets are exchanged
   again through the plain versions (out and new residual within 1e-4 of
   their max), and five timed steps: losses finite and falling, 161 of
   161 parameters changed, residuals finite and non-zero, 2 buckets, 4
   handles and 227,888 wire bytes a step, 10 launches of each stage.
10. lenet -- ten LeNet steps on a synthetic MNIST-like batch with
   ``examples/mnist_lenet.py``'s SGD(0.01, momentum 0.9); the loss falls.

Then one JSON line of per-kernel numbers, the card line, and last the
``{"ok": true, "device": ...}`` line.  Without a GPU, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores (NVIDIA data sheet)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (NVIDIA data sheet)
F32_TOL = 1e-5             # f32: absolute, the sums only reorder
F32_GRAD_TOL = 1e-5        # f32 gradients: relative to max |reference grad|
BF16_TOL = 2e-2            # bf16: relative to max |reference output|
BN_SUM_TOL = 1e-4          # BN dgamma/dbeta: relative to max |reference|,
                           # sums over up to 3.2 M rows in another order


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls
    (CUDA events around the whole run, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = H100_BF16_FLOPS) -> tuple:
    t_ops = flops / peak_flops
    t_bytes = nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(attn, dev) -> dict:
    """Kernel A cases; returns the JSON entry at the headline shape
    (bf16, b=1, h=32, h_kv=8, d=128, causal, t=2048)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, hkv, d = 1, 32, 8, 128
    cases = [dict(tq=t, tk=t) for t in (37, 512, 2048)]
    cases.append(dict(tq=256, tk=1280))
    cases.append(dict(tq=512, tk=512, seg=True))
    head = None
    for dtype in (torch.bfloat16, torch.float32):
        for case in cases:
            tq, tk = case["tq"], case["tk"]
            q = torch.randn(b, h, tq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, hkv, tk, d, generator=gen, device=dev
                            ).to(dtype)
            v = torch.randn(b, hkv, tk, d, generator=gen, device=dev
                            ).to(dtype)
            kw = dict(causal=True, return_lse=True)
            if case.get("seg"):
                # Two packed segments; the last 6 query rows carry an id
                # no key has -> DEAD rows (O exactly 0, lse +1e30).
                qs = torch.zeros(b, tq, dtype=torch.int32, device=dev)
                qs[:, 256:] = 1
                qs[:, -6:] = 7
                ks = torch.zeros(b, tk, dtype=torch.int32, device=dev)
                ks[:, 256:] = 1
                kw.update(segment_ids=qs, kv_segment_ids=ks)
            o, lse = attn.flash_attention(q, k, v, **kw)
            o_ref, lse_ref = attn.flash_attention(q, k, v,
                                                  force_reference=True, **kw)
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            scale = o_ref.float().abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL * scale
            lse_err = (lse - lse_ref).abs().max().item()
            ok = err <= tol and lse_err <= 1e-3 and bool(
                torch.isfinite(o.float()).all())
            if case.get("seg"):
                ok = ok and o[:, :, -6:].abs().max().item() == 0.0 and bool(
                    (lse[:, :, -6:] == 1e30).all())
            rec = {"phase": "kernel", "kernel": "flash_fwd",
                   "dtype": str(dtype).replace("torch.", ""), "tq": tq,
                   "tk": tk, "segments": bool(case.get("seg")),
                   "max_abs_err": err, "tol": tol, "lse_err": lse_err,
                   "ok": ok}
            if dtype == torch.bfloat16 and tq == tk == 2048:
                flops = attn.attention_flops(b, h, tq, tk, d, True)
                nbytes = (2 * q.numel() + k.numel() + v.numel()
                          ) * q.element_size() + 4 * b * h * tq
                bms, by = bound_ms(flops, nbytes)
                ms = time_ms(lambda: attn.flash_attention(q, k, v,
                                                          causal=True))
                plain = time_ms(lambda: attn.flash_attention(
                    q, k, v, causal=True, force_reference=True), reps=5)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by)
                head = {"name": "flash_fwd", "route": "cuda",
                        "source": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                        "replaces": "horovod_tpu/ops/attention.py:469",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib}
            log(rec)
            if not ok:
                raise AssertionError(f"flash_fwd disagrees: {rec}")
    return head


def check_decode(attn, dev) -> dict:
    """Kernel B cases at the serving shapes (8 slots, page 16, max_len
    4096, Llama-3 8B heads); returns the JSON entry at the headline case
    (bf16, 8 slots x 2048 live keys)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    slots, ps, max_len, h, hkv, d = 8, 16, 4096, 32, 8, 128
    pps = max_len // ps
    npages = slots * pps
    perm = torch.randperm(npages, generator=gen, device=dev)
    table = perm.view(slots, pps).to(torch.int32).contiguous()
    head = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, lens in (
                ("edges", [0, 1, 15, 16, 17, 1000, 2048, 4096]),
                ("main", [2048] * slots)):
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            # Large finite garbage everywhere, then live keys below each
            # length: any leak past a length shows up as a huge error.
            kp = torch.full((npages + 1, ps, hkv, d), 3e4, device=dev)
            vp = torch.full_like(kp, -3e4)
            pos = torch.arange(max_len, device=dev)
            for s in range(slots):
                live = pos < lens[s]
                pg = table[s].long()[pos[live] // ps]
                of = pos[live] % ps
                kp[pg, of] = torch.randn(int(live.sum()), hkv, d,
                                         generator=gen, device=dev)
                vp[pg, of] = torch.randn(int(live.sum()), hkv, d,
                                         generator=gen, device=dev)
            kp, vp = kp.to(dtype), vp.to(dtype)
            q = torch.randn(slots, h, 1, d, generator=gen, device=dev
                            ).to(dtype)
            o = attn.paged_decode_attention(q, kp, vp, table, lengths)
            o_ref = attn.paged_decode_attention(q, kp, vp, table, lengths,
                                                force_reference=True)
            kc = attn.gather_pages(kp, table).contiguous()
            vc = attn.gather_pages(vp, table).contiguous()
            oc = attn.decode_attention(q, kc, vc, lengths=lengths)
            torch.cuda.synchronize()
            err = max((o.float() - o_ref.float()).abs().max().item(),
                      (oc.float() - o_ref.float()).abs().max().item())
            scale = o_ref.float().abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL * scale
            zero = [i for i, n in enumerate(lens) if n == 0]
            ok = err <= tol and bool(torch.isfinite(o.float()).all()) and \
                all(o[i].abs().max().item() == 0.0 for i in zero)
            rec = {"phase": "kernel", "kernel": "flash_decode",
                   "dtype": str(dtype).replace("torch.", ""),
                   "lengths": lens, "max_abs_err": err, "tol": tol,
                   "ok": ok}
            if dtype == torch.bfloat16 and name == "main":
                live = sum(lens)
                nbytes = (2 * live * hkv * d + 2 * q.numel()
                          ) * q.element_size() + 4 * slots * (pps + 1)
                flops = 4.0 * h * live * d
                bms, by = bound_ms(flops, nbytes)
                ms = time_ms(lambda: attn.paged_decode_attention(
                    q, kp, vp, table, lengths), reps=50)
                plain = time_ms(lambda: attn.paged_decode_attention(
                    q, kp, vp, table, lengths, force_reference=True),
                    reps=5)
                # Library yardstick: one SDPA call on the already
                # gathered contiguous view, length mask as attn_mask.
                mask = (pos[None, None, None, :]
                        < lengths[:, None, None, None])
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=mask, enable_gqa=True), reps=50)
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by)
                head = {"name": "flash_decode", "route": "cuda",
                        "source":
                            "horovod_tpu_torch/ops/csrc/flash_decode.cu",
                        "replaces": "horovod_tpu/ops/attention.py:312",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib}
            log(rec)
            if not ok:
                raise AssertionError(f"flash_decode disagrees: {rec}")
            del kp, vp, kc, vc
    return head


def check_flash_bwd(attn, dev) -> tuple:
    """The backward's dq and dk/dv kernels at the training shapes (b=2,
    h=32, h_kv=8, d=128, causal); returns the JSON entries of both at the
    headline case (bf16, t=2048)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, hkv, d = 2, 32, 8, 128
    cases = [dict(tq=t, tk=t) for t in (37, 512, 2048)]
    cases.append(dict(tq=256, tk=1280))
    cases.append(dict(tq=512, tk=512, seg=True))
    cases.append(dict(tq=512, tk=512, f32=True))
    heads = None
    for case in cases:
        tq, tk = case["tq"], case["tk"]
        dtype = torch.float32 if case.get("f32") else torch.bfloat16
        q, do = (torch.randn(b, h, tq, d, generator=gen, device=dev
                             ).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, hkv, tk, d, generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        kw = dict(causal=True)
        if case.get("seg"):
            # Two packed segments; the last 6 query rows carry an id no
            # key has (DEAD rows: dq exactly 0) and the last 4 keys an id
            # no query has (dk, dv exactly 0).
            qs = torch.zeros(b, tq, dtype=torch.int32, device=dev)
            qs[:, 256:] = 1
            qs[:, -6:] = 7
            ks = torch.zeros(b, tk, dtype=torch.int32, device=dev)
            ks[:, 256:] = 1
            ks[:, -4:] = 8
            kw.update(segment_ids=qs, kv_segment_ids=ks)
        o, lse = attn.flash_attention(q, k, v, return_lse=True, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        got = (attn.flash_backward_dq(*args, **kw),
               *attn.flash_backward_dkv(*args, **kw))
        want = (attn.flash_backward_dq(*args, force_reference=True, **kw),
                *attn.flash_backward_dkv(*args, force_reference=True, **kw))
        torch.cuda.synchronize()
        rel = F32_GRAD_TOL if dtype == torch.float32 else BF16_TOL
        errs, tols = [], []
        ok = True
        for g, w in zip(got, want):
            errs.append((g.float() - w.float()).abs().max().item())
            tols.append(rel * w.float().abs().max().item())
            ok = ok and errs[-1] <= tols[-1] and bool(
                torch.isfinite(g.float()).all())
        if case.get("seg"):
            ok = ok and got[0][:, :, -6:].abs().max().item() == 0.0 and \
                max(x[:, :, -4:].abs().max().item() for x in got[1:]) == 0.0
        rec = {"phase": "kernel", "kernel": "flash_bwd",
               "dtype": str(dtype).replace("torch.", ""), "tq": tq,
               "tk": tk, "segments": bool(case.get("seg")),
               "max_abs_err": dict(zip(("dq", "dk", "dv"), errs)),
               "tol": dict(zip(("dq", "dk", "dv"), tols)), "ok": ok}
        if dtype == torch.bfloat16 and tq == tk == 2048:
            rec["timing"], heads = time_flash_bwd(attn, args, errs)
        log(rec)
        if not ok:
            raise AssertionError(f"flash_bwd disagrees: {rec}")
        del q, k, v, do, o, lse, delta, args, got, want
    return heads


def time_flash_bwd(attn, args, errs) -> tuple:
    """Kernel, plain and bound times of dq and dk/dv at the headline
    shape, and the library yardstick: the backward of one SDPA call
    (``autograd.grad`` of its output, forward timed apart and
    subtracted), which computes dq, dk and dv together."""
    q, k, v, do, lse, delta = args
    b, h, t, d = q.shape
    hkv = k.shape[1]
    esz = q.element_size()
    stats = 2 * 4 * b * h * t                       # lse + delta, f32
    ms_dq = time_ms(lambda: attn.flash_backward_dq(*args, causal=True),
                    reps=10)
    ms_dkv = time_ms(lambda: attn.flash_backward_dkv(*args, causal=True),
                     reps=10)
    plain_dq = time_ms(lambda: attn.flash_backward_dq(
        *args, causal=True, force_reference=True), reps=3, warmup=1)
    plain_dkv = time_ms(lambda: attn.flash_backward_dkv(
        *args, causal=True, force_reference=True), reps=3, warmup=1)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                              enable_gqa=True)

    fwd = time_ms(sdpa)
    both = time_ms(lambda: torch.autograd.grad(sdpa(), (qr, kr, vr), do))
    lib = both - fwd
    # dq reads q, dO, k, v, lse, delta and writes dq; dk/dv reads the same
    # and writes dk, dv.
    q_bytes = (3 * b * h * t * d + 2 * b * hkv * t * d) * esz + stats
    kv_bytes = (2 * b * h * t * d + 4 * b * hkv * t * d) * esz + stats
    b_dq, by_dq = bound_ms(attn.attention_flops(b, h, t, t, d, True, 3),
                           q_bytes)
    b_dkv, by_dkv = bound_ms(attn.attention_flops(b, h, t, t, d, True, 4),
                             kv_bytes)
    src = "horovod_tpu_torch/ops/csrc/flash_bwd.cu"
    entries = (
        {"name": "flash_bwd_dq", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/attention.py:622",
         "max_abs_err": errs[0], "ms": ms_dq, "plain_ms": plain_dq,
         "bound_ms": b_dq, "bound_by": by_dq, "library_ms": lib},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/attention.py:655",
         "max_abs_err": max(errs[1:]), "ms": ms_dkv, "plain_ms": plain_dkv,
         "bound_ms": b_dkv, "bound_by": by_dkv, "library_ms": lib})
    timing = {"dq_ms": ms_dq, "dkv_ms": ms_dkv, "plain_dq_ms": plain_dq,
              "plain_dkv_ms": plain_dkv, "sdpa_fwd_ms": fwd,
              "sdpa_fwd_bwd_ms": both, "library_bwd_ms": lib,
              "bound_dq_ms": b_dq, "bound_dkv_ms": b_dkv}
    return timing, entries


# The BN cases: a ragged N with C below one vector and not a multiple of
# 8, a C of exactly one vector, and three ResNet-50 sites at batch 256
# (the stem, stage 1's widest, stage 4).
BN_CASES = ((37, 3), (1000, 8), (3211264, 64), (802816, 256), (12544, 2048))
BN_HEADLINE = (802816, 256)        # [256 x 56 x 56, 256], bf16


def check_bn_bwd(bn, dev) -> tuple:
    """The BatchNorm backward's two kernels against their plain versions
    on every case of ``BN_CASES``, bf16 and f32; returns the JSON entries
    of both at the headline case (bf16 ``[802816 x 256]``)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    heads = None
    for dtype in (torch.bfloat16, torch.float32):
        for n, c in BN_CASES:
            x = (2.0 * torch.randn(n, c, generator=gen, device=dev)
                 + 0.5).to(dtype)
            dy = torch.randn(n, c, generator=gen, device=dev).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
            mean, var = bn.batch_stats(x)
            inv = torch.rsqrt(var + 1e-5)
            got = bn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
            want = bn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5,
                                        force_reference=True)
            torch.cuda.synchronize()
            rels = (BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
                    BN_SUM_TOL, BN_SUM_TOL)
            errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)]
            tols = [r * w.float().abs().max().item()
                    for r, w in zip(rels, want)]
            ok = all(e <= t for e, t in zip(errs, tols)) and all(
                bool(torch.isfinite(g.float()).all()) for g in got) and \
                got[0].dtype == dtype and got[1].dtype == torch.float32
            rec = {"phase": "kernel", "kernel": "bn_bwd",
                   "dtype": str(dtype).replace("torch.", ""), "n": n,
                   "c": c, "chunks": bn.reduce_chunks(n, c),
                   "max_abs_err": dict(zip(("dx", "dgamma", "dbeta"), errs)),
                   "tol": dict(zip(("dx", "dgamma", "dbeta"), tols)),
                   "ok": ok}
            if dtype == torch.bfloat16 and (n, c) == BN_HEADLINE:
                rec["timing"], heads = time_bn_bwd(bn, x, dy, mean, var,
                                                   inv, scale, got, errs)
                ok = ok and rec["timing"]["deterministic"]
                rec["ok"] = ok
            log(rec)
            if not ok:
                raise AssertionError(f"bn_bwd disagrees: {rec}")
            del x, dy, got, want
    return heads


def time_bn_bwd(bn, x, dy, mean, var, inv, scale, got, errs) -> tuple:
    """Kernel, plain and bound times of both passes at the headline shape,
    a repeat launch that must give bitwise the same results, and the
    library yardstick: one ``native_batch_norm_backward`` on the
    channels-last 4-D view with the saved mean and inverse std, train
    mode, all three outputs (it computes both passes, so both rows carry
    its time)."""
    n, c = x.shape
    esz = x.element_size()
    dx, dgamma, dbeta = got
    again = bn.fused_bn_backward(x, scale, mean, var, dy, eps=1e-5)
    deterministic = all(torch.equal(a, b) for a, b in zip(again, got))
    ms_red = time_ms(lambda: bn.bn_backward_reduce(x, dy, mean, inv))
    ms_dx = time_ms(lambda: bn.bn_backward_dx(x, dy, mean, inv, scale,
                                              dbeta, dgamma))
    plain_red = time_ms(lambda: bn.bn_backward_reduce(
        x, dy, mean, inv, force_reference=True), reps=5)
    plain_dx = time_ms(lambda: bn.bn_backward_dx(
        x, dy, mean, inv, scale, dbeta, dgamma, force_reference=True),
        reps=5)
    side = int(round((n // 256) ** 0.5))
    lib_dtype = str(x.dtype).replace("torch.", "")

    def library(xl, dyl):
        x4 = xl.view(256, side, side, c).permute(0, 3, 1, 2)
        dy4 = dyl.view(256, side, side, c).permute(0, 3, 1, 2)
        return lambda: torch.ops.aten.native_batch_norm_backward(
            dy4, x4, scale, None, None, mean, inv, True, 1e-5,
            [True, True, True])
    try:
        lib = time_ms(library(x, dy))
    except RuntimeError:
        # bf16 input with an f32 weight refused: time it on f32 copies.
        lib_dtype = "float32"
        lib = time_ms(library(x.float(), dy.float()))
    rows = 4 * c
    # Pass 1 reads x, dy, mean, inv and writes dbeta, dgamma; pass 2 reads
    # x, dy and five rows and writes dx.  f32 work per element: xhat (2),
    # two sums (3); pass 2 xhat (2) and dx (4).
    b_red, by_red = bound_ms(5.0 * n * c, 2 * n * c * esz + 4 * rows,
                             H100_F32_FLOPS)
    b_dx, by_dx = bound_ms(6.0 * n * c, 3 * n * c * esz + 5 * rows,
                           H100_F32_FLOPS)
    src = "horovod_tpu_torch/ops/csrc/bn_bwd.cu"
    entries = (
        {"name": "bn_bwd_reduce", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/bn.py:107",
         "max_abs_err": max(errs[1:]), "ms": ms_red, "plain_ms": plain_red,
         "bound_ms": b_red, "bound_by": by_red, "library_ms": lib},
        {"name": "bn_bwd_dx", "route": "cuda", "source": src,
         "replaces": "horovod_tpu/ops/bn.py:116",
         "max_abs_err": errs[0], "ms": ms_dx, "plain_ms": plain_dx,
         "bound_ms": b_dx, "bound_by": by_dx, "library_ms": lib})
    timing = {"reduce_ms": ms_red, "dx_ms": ms_dx,
              "plain_reduce_ms": plain_red, "plain_dx_ms": plain_dx,
              "library_ms": lib, "library_dtype": lib_dtype,
              "bound_reduce_ms": b_red, "bound_dx_ms": b_dx,
              "deterministic": deterministic}
    return timing, entries


# ResNet-50's two error-feedback buckets under powersgd:4 (forward flax
# leaf order, 64 MiB threshold): 76 leaves of 15,053,824 values, viewed as
# [3880, 3880] (pad 576), and 85 of 10,506,088 as [3242, 3241] (pad 1234).
POWERSGD_RANK = 4
POWERSGD_BUCKETS = (15053824, 10506088)
POWERSGD_WIRE_BYTES = 227888   # 4 r (m + c) f32 over both buckets a step
POWERSGD_TOL = 1e-5            # stages: relative to max |plain|, sums of up
                               # to 3,880 terms in another order
POWERSGD_STEP_TOL = 1e-4       # a step's whole exchange, kernels vs plain
# Stage-3 scalings: Average at world 1, and Sum's n with a postscale.
POWERSGD_SCALINGS = (("average", 1.0, 1.0, 1.0),
                     ("sum_postscale", 0.5, 2.0, 0.25))


def powersgd_stage_pairs(fu, x, res, q0, m, size, pre, n_scale, post):
    """The three PowerSGD stages through the kernels and through their
    plain versions, each kernel fed the plain chain's inputs; a mean Q
    unlike this rank's own feeds stage 3.  Returns ``(kernel outputs,
    plain outputs)``: acc, p, p_orth, q_local, out, residual."""
    acc_w, p_w = fu.matricize_p(x, res, q0, rows=m, prescale=pre,
                                force_reference=True)
    po_w, ql_w = fu.orthonormalize_q(acc_w, p_w, force_reference=True)
    q = ql_w * 0.75 + 0.01
    out_w, res_w = fu.reconstruct_residual(
        acc_w, po_w, q, ql_w, size=size, n_scale=n_scale, postscale=post,
        force_reference=True)
    acc, p = fu.matricize_p(x, res, q0, rows=m, prescale=pre)
    po, ql = fu.orthonormalize_q(acc_w, p_w)
    out, new_res = fu.reconstruct_residual(acc_w, po_w, q, ql_w, size=size,
                                           n_scale=n_scale, postscale=post)
    return ((acc, p, po, ql, out, new_res),
            (acc_w, p_w, po_w, ql_w, out_w, res_w), q)


def check_fused_update(dev) -> tuple:
    """The PowerSGD exchange's three kernels against their plain versions
    at both ResNet-50 bucket shapes, with and without a residual, r = 1
    and r = 4, Average and Sum with a postscale; returns the JSON entries
    of the three at the headline case (the 3880 x 3880 bucket, r = 4,
    with a residual, Average)."""
    from horovod_tpu_torch.collectives.compression import \
        powersgd_matrix_shape
    from horovod_tpu_torch.collectives.ops import _powersgd_seed_matrix
    from horovod_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device=dev).manual_seed(7)
    names = ("acc", "p", "p_orth", "q_local", "out", "residual")
    worst = dict.fromkeys(names, 0.0)
    heads = None
    for size in POWERSGD_BUCKETS:
        m, c = powersgd_matrix_shape(size)
        for r in (1, POWERSGD_RANK):
            q0 = _powersgd_seed_matrix(c, r, dev)
            for residual in (False, True):
                x = torch.randn(size, generator=gen, device=dev)
                res = torch.randn(size, generator=gen, device=dev) \
                    if residual else None
                for scaling, pre, n_scale, post in POWERSGD_SCALINGS:
                    got, want, q = powersgd_stage_pairs(
                        fu, x, res, q0, m, size, pre, n_scale, post)
                    torch.cuda.synchronize()
                    errs = {n: (g - w).abs().max().item()
                            for n, g, w in zip(names, got, want)}
                    tols = {n: 0.0 if n == "acc" else
                            POWERSGD_TOL * w.abs().max().item()
                            for n, w in zip(names, want)}
                    ok = all(errs[n] <= tols[n] for n in names) and all(
                        bool(torch.isfinite(g).all()) for g in got) and \
                        bool((got[0].reshape(-1)[size:] == 0).all())
                    rec = {"phase": "kernel", "kernel": "fused_update",
                           "size": size, "m": m, "c": c, "r": r,
                           "residual": residual, "scaling": scaling,
                           "chunks": fu.q_chunks(m, c), "max_abs_err": errs,
                           "tol": tols, "ok": ok}
                    for n in names:
                        worst[n] = max(worst[n], errs[n])
                    if (size, r, residual, scaling) == (
                            POWERSGD_BUCKETS[0], POWERSGD_RANK, True,
                            "average"):
                        rec["timing"], heads = time_fused_update(
                            fu, x, res, q0, m, size, got, want, q)
                        ok = ok and rec["timing"]["deterministic"]
                        rec["ok"] = ok
                    log(rec)
                    if not ok:
                        raise AssertionError(f"fused_update disagrees: "
                                             f"{rec}")
                    del got, want, q
                del x, res
    errs = (max(worst["acc"], worst["p"]),
            max(worst["p_orth"], worst["q_local"]),
            max(worst["out"], worst["residual"]))
    for e, err in zip(heads, errs):
        e["max_abs_err"] = err
    return heads


def time_fused_update(fu, x, res, q0, m, size, got, want, q) -> tuple:
    """Kernel, plain and bound times of the three stages at the headline
    case, a repeat launch of each that must give bitwise the same outputs,
    and -- as information only, since no one PyTorch call computes any of
    the three -- cuBLAS-backed ``torch.add`` + ``torch.mm`` chains that do
    each stage's arithmetic."""
    c, r = q0.shape
    acc_w, p_w, po_w, ql_w = want[:4]
    again = (*fu.matricize_p(x, res, q0, rows=m),
             *fu.orthonormalize_q(acc_w, p_w),
             *fu.reconstruct_residual(acc_w, po_w, q, ql_w, size=size))
    deterministic = all(torch.equal(a, b) for a, b in zip(again, got))
    ms = (time_ms(lambda: fu.matricize_p(x, res, q0, rows=m)),
          time_ms(lambda: fu.orthonormalize_q(acc_w, p_w)),
          time_ms(lambda: fu.reconstruct_residual(acc_w, po_w, q, ql_w,
                                                  size=size)))
    plain = (time_ms(lambda: fu.matricize_p(x, res, q0, rows=m,
                                            force_reference=True), reps=5),
             time_ms(lambda: fu.orthonormalize_q(acc_w, p_w,
                                                 force_reference=True),
                     reps=5),
             time_ms(lambda: fu.reconstruct_residual(
                 acc_w, po_w, q, ql_w, size=size, force_reference=True),
                 reps=5))
    x_mat = F.pad(x, (0, m * c - size)).view(m, c)
    res_mat = F.pad(res, (0, m * c - size)).view(m, c)
    lib = (time_ms(lambda: torch.mm(torch.add(x_mat, res_mat), q0)),
           time_ms(lambda: torch.mm(acc_w.T, po_w)),
           time_ms(lambda: (torch.mm(po_w, q.T),
                            torch.sub(acc_w, torch.mm(po_w, ql_w.T)))))
    # Bytes each stage must move, each input read once and each output
    # written once; f32 work: stage 1 the residual add and r products
    # (2 r), stage 2 the projection (2 r) and Gram-Schmidt's r (r + 1) / 2
    # dot products and updates over m rows, stage 3 two r-term sums and
    # the subtraction.  All f32, off the tensor cores.
    mc, fac_m, fac_c = m * c, 4 * m * r, 4 * c * r
    nbytes = (size * (x.element_size() + 4) + 4 * mc + fac_c + fac_m,
              4 * mc + 3 * fac_m + fac_c,
              12 * size + fac_m + 2 * fac_c)
    flops = (size + 2.0 * r * mc,
             2.0 * r * mc + 4.0 * m * r * (r + 1) / 2 + 3.0 * m * r,
             (4.0 * r + 1) * size)
    bounds = [bound_ms(f, b, H100_F32_FLOPS) for f, b in zip(flops, nbytes)]
    src = "horovod_tpu_torch/ops/csrc/fused_update.cu"
    rows = (("fused_update_matricize_p", 99),
            ("fused_update_orthonormalize_q", 152),
            ("fused_update_reconstruct", 205))
    entries = tuple(
        {"name": name, "route": "cuda", "source": src,
         "replaces": f"horovod_tpu/ops/fused_update.py:{line}",
         "ms": t, "plain_ms": pt, "bound_ms": b[0], "bound_by": b[1],
         "library_ms": None}
        for (name, line), t, pt, b in zip(rows, ms, plain, bounds))
    timing = {"matricize_p_ms": ms[0], "orthonormalize_q_ms": ms[1],
              "reconstruct_ms": ms[2], "plain_ms": list(plain),
              "bound_ms": [b[0] for b in bounds],
              "bound_by": [b[1] for b in bounds], "bytes": list(nbytes),
              "add_mm_info_ms": list(lib), "deterministic": deterministic}
    return timing, entries


# ---------------------------------------------------------------------------
# Phase 4: the serving slice end to end
# ---------------------------------------------------------------------------


def serve_llama(dev, card: str) -> dict:
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.serving import (LoadSpec, Request, ServingEngine,
                                           generate, prefill_forward)

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=torch.bfloat16,
                               device=dev)
    torch.cuda.synchronize()
    log({"phase": "init", "config": "LLAMA3_8B", "layers": cfg.num_layers,
         "dtype": "bfloat16", "seconds": time.perf_counter() - t0,
         "param_bytes": sum(t.numel() * t.element_size()
                            for t in params.values())})
    eng = ServingEngine(cfg, params, device=dev, slots=8, page_size=16,
                        max_len=4096, dtype=torch.bfloat16)
    # Warm-up: one short request (cuBLAS handles, allocator, kernels).
    warm = Request(rid=-1, prompt=np.arange(16, dtype=np.int32),
                   max_new_tokens=2)
    eng.serve([warm])

    spec = LoadSpec(num_requests=8, prompt_lens=(37, 512, 2048),
                    output_lens=(32, 64), vocab_size=cfg.vocab_size, seed=0)
    reqs = generate(spec)
    registry.reset_launch_counts()
    report = eng.serve(reqs)
    counts = registry.launch_counts()
    rep = report.as_dict()
    log({"phase": "serve", "card": card, **rep, "launches": counts})
    if report.completed != spec.num_requests:
        raise AssertionError(f"completed {report.completed} != 8")
    for r in reqs:
        if not r.tokens or any(not 0 <= t < cfg.vocab_size
                               for t in r.tokens):
            raise AssertionError(f"request {r.rid}: bad tokens")
    if counts["flash"] != cfg.num_layers * report.prefills:
        raise AssertionError(f"flash launches {counts['flash']} != "
                             f"{cfg.num_layers} x {report.prefills}")
    if counts["flash_decode"] != cfg.num_layers * report.decode_steps:
        raise AssertionError(
            f"flash_decode launches {counts['flash_decode']} != "
            f"{cfg.num_layers} x {report.decode_steps}")

    # First request's first-token logits: kernels vs plain attention.
    prompt = torch.tensor(reqs[0].prompt, dtype=torch.long, device=dev)[None]
    got = prefill_forward(params, cfg, prompt, dtype=torch.bfloat16)[0]
    want = prefill_forward(params, cfg, prompt, dtype=torch.bfloat16,
                           force_reference=True)[0]
    got, want = got[0, -1], want[0, -1]
    err = (got - want).abs().max().item()
    tol = BF16_TOL * want.abs().max().item()
    same_token = int(got.argmax()) == int(want.argmax()) == reqs[0].tokens[0]
    log({"phase": "logits", "prompt_len": int(prompt.shape[1]),
         "max_abs_err": err, "tol": tol, "argmax_agrees": same_token})
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError("first-token logits disagree with the plain "
                             "prefill")
    return counts


# ---------------------------------------------------------------------------
# Phases 5-6: the training slice
# ---------------------------------------------------------------------------


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def lora_model(cfg, dev, seed: int, nonzero_b: bool):
    """Llama at ``cfg`` with random bf16 base weights and f32 LoRA rank-8
    adapters from ``seed``; ``nonzero_b`` draws ``lora_b`` too (else zero,
    the standard init).  The base is frozen."""
    from horovod_tpu_torch.models import (LlamaLM, freeze_base,
                                          init_llama_params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_llama_params(cfg, generator=gen, dtype=torch.bfloat16,
                               device=dev, lora_rank=8)
    if nonzero_b:
        for name, t in params.items():
            if name.endswith(".lora_b"):
                t.normal_(0.0, 0.02, generator=gen)
    model = LlamaLM.from_params(cfg, params, dtype=torch.bfloat16,
                                lora_rank=8)
    return model, freeze_base(model)


def batch(cfg, dev, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2048))).to(
        dev)


def check_grad(dev) -> None:
    """One loss and backward at full width, 2 layers, through the kernels
    and through the plain attention."""
    from horovod_tpu_torch.models import LLAMA3_8B
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.training import next_token_loss

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    model, named = lora_model(cfg, dev, seed=4, nonzero_b=True)
    tokens = batch(cfg, dev, seed=1)
    runs = []
    for ref in (False, True):
        model.zero_grad(set_to_none=True)
        registry.reset_launch_counts()
        loss = next_token_loss(model(tokens, force_reference=ref), tokens)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), {n: p.grad.float().clone()
                                   for n, p in named},
                     registry.launch_counts()))
    (loss_k, g_k, c_k), (loss_r, g_r, c_r) = runs
    worst = max(((g_k[n] - g_r[n]).abs().max().item()
                 / max(g_r[n].abs().max().item(), 1e-30), n) for n in g_r)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    ok = (loss_rel <= 1e-2 and worst[0] <= BF16_TOL
          and all(torch.isfinite(g).all() for g in g_k.values())
          and all(c_k[f] == cfg.num_layers for f in
                  ("flash", "flash_bwd_dq", "flash_bwd_dkv"))
          and not any(c_r.values()))
    log({"phase": "grad", "layers": cfg.num_layers, "lora_rank": 8,
         "tensors": len(g_r), "loss": loss_k, "loss_plain": loss_r,
         "loss_rel_err": loss_rel, "worst_grad_rel_err": worst[0],
         "worst_grad": worst[1], "tol": BF16_TOL, "launches": c_k,
         "launches_plain": c_r, "ok": ok})
    if not ok:
        raise AssertionError("LoRA gradients through the kernels disagree "
                             "with the plain attention")
    del model, named, g_k, g_r


def train_llama(dev, card: str) -> dict:
    """Full-depth Llama-3 8B LoRA fine-tune through the port's Horovod
    path; returns the kernels' launch counts over the timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.models import LLAMA3_8B
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    from horovod_tpu_torch.training import causal_lm_loss, make_train_step

    cfg, steps = LLAMA3_8B, 5
    hvd.init()
    t0 = time.perf_counter()
    model, named = lora_model(cfg, dev, seed=0, nonzero_b=False)
    torch.cuda.synchronize()
    base = {n: p for n, p in model.named_parameters() if not p.requires_grad}
    base_host = {n: p.detach().to("cpu") for n, p in base.items()}
    lora_before = {n: p.detach().clone() for n, p in named}
    log({"phase": "train_init", "config": "LLAMA3_8B",
         "layers": cfg.num_layers, "seconds": time.perf_counter() - t0,
         "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "base_bytes": sum(p.numel() * p.element_size()
                           for p in base.values()),
         "trainable_tensors": len(named),
         "trainable_values": sum(p.numel() for _, p in named)})
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3,
                          weight_decay=1e-4),
        named_parameters=named, compression=hvd.Compression.bf16)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_train_step(model, causal_lm_loss, opt)
    tokens = batch(cfg, dev, seed=0)

    losses = [step(tokens).item()]                  # warm-up
    planned = len(plan_buckets([p for _, p in named], 64 * 1024 * 1024,
                               reverse=True).buffers)
    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(tokens).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, lora_before[n]) for n, p in named)
    base_same = sum(torch.equal(p.detach().cpu(), base_host[n])
                    for n, p in base.items())
    log({"phase": "train", "card": card, "steps": steps, "batch": [2, 2048],
         "losses": losses, "step_ms": step_ms,
         "step_ms_each": [1e3 * x for x in times],
         "tokens_per_s": 2 * 2048 / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "plan_buckets": planned, "launches": counts,
         "lora_changed": changed, "lora_tensors": len(named),
         "base_unchanged": base_same, "base_tensors": len(base)})
    want = cfg.num_layers * steps
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named):
        fails.append(f"{len(named) - changed} LoRA tensors unchanged")
    if base_same != len(base):
        fails.append(f"{len(base) - base_same} base tensors changed")
    for f in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        if counts[f] != want:
            fails.append(f"{f} launches {counts[f]} != {want}")
    if per_step["buckets"] != planned or per_step["handles"] != planned:
        fails.append(f"buckets/handles per step {per_step} != planned "
                     f"{planned}")
    if fails:
        raise AssertionError("train: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, opt, step, base, base_host, lora_before
    return counts


# ---------------------------------------------------------------------------
# Phases 7-10: the ResNet-50 (plain and PowerSGD) and LeNet slices
# ---------------------------------------------------------------------------


RESNET50_BN_SITES = 53     # stem + 16 blocks x 3 + 4 projections
RESNET50_PARAM_TENSORS = 161
RESNET_F32_GRAD_TOL = 1e-3  # f32 roundoff through the 53-site backward,
                            # relative to max |plain grad|


def resnet50(dev, seed: int, dtype=torch.bfloat16):
    """ResNet-50 as ``bench.py`` times it (1000 classes, bf16 compute,
    space-to-depth stem) with flax-initialised random weights."""
    from horovod_tpu_torch.models import ResNet50, init_resnet_params
    model = ResNet50(num_classes=1000, dtype=dtype, space_to_depth=True,
                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.load_state_dict(init_resnet_params(model, generator=gen))
    return model, gen


def images(gen, dev, n: int, classes: int, side: int = 224) -> tuple:
    x = torch.randn(n, side, side, 3, generator=gen, device=dev).to(
        torch.bfloat16)
    y = torch.randint(0, classes, (n,), generator=gen, device=dev)
    return x, y


def check_resnet_grad(dev) -> None:
    """One loss and backward of ResNet-50 at full width and depth on 32
    images, through the BN kernels and through their plain versions, in
    bf16 (the training configuration) and in f32 from the same weights.

    Every BN scale is drawn from N(1, 0.1), so no gradient is 0 by
    construction -- and every residual branch is live, which makes the
    backward chaotic: bf16 rounding alone moves most gradients by more
    than their size (bf16 plain against f32 plain).  So the kernels are
    held to f32 roundoff in f32 (``RESNET_F32_GRAD_TOL`` of each
    gradient's max |value|), and in bf16 to bf16's own noise: replacing
    the plain backward by the kernels must move no bf16 gradient by as
    much as bf16 moves it from f32.  The forward never touches a kernel,
    so both losses of a dtype are bitwise equal."""
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.ops.bn import BatchNorm
    from horovod_tpu_torch.training import softmax_xent

    model, gen = resnet50(dev, seed=5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.normal_(1.0, 0.1, generator=gen)
    x, y = images(gen, dev, 32, 1000)
    m32, _ = resnet50(dev, seed=5, dtype=torch.float32)
    m32.load_state_dict(model.state_dict())
    runs = {}
    for dtype, mod in (("bf16", model), ("f32", m32)):
        for ref in (False, True):
            mod.zero_grad(set_to_none=True)
            registry.reset_launch_counts()
            loss = softmax_xent(mod(x, force_reference=ref), y)
            loss.backward()
            torch.cuda.synchronize()
            runs[dtype, ref] = (loss.item(), {
                n: p.grad.float().clone() for n, p in mod.named_parameters()},
                registry.launch_counts())

    def rel(a, b):
        return {n: (a[n] - b[n]).abs().max().item()
                / max(b[n].abs().max().item(), 1e-30) for n in b}

    e_bf16 = rel(runs["bf16", False][1], runs["bf16", True][1])
    e_f32 = rel(runs["f32", False][1], runs["f32", True][1])
    floor = rel(runs["bf16", True][1], runs["f32", True][1])
    want = RESNET50_BN_SITES
    counts_ok = all(
        runs[d, False][2]["bn_bwd_reduce"] == want
        and runs[d, False][2]["bn_bwd_dx"] == want
        and not any(runs[d, True][2].values()) for d in ("bf16", "f32"))
    losses_equal = all(runs[d, False][0] == runs[d, True][0]
                       for d in ("bf16", "f32"))
    worst_f32 = max((v, n) for n, v in e_f32.items())
    worst_bf16 = max((v, n) for n, v in e_bf16.items())
    margin = min((floor[n] / max(v, 1e-30), n) for n, v in e_bf16.items())
    ok = (losses_equal and counts_ok
          and len(e_f32) == RESNET50_PARAM_TENSORS
          and worst_f32[0] <= RESNET_F32_GRAD_TOL and margin[0] >= 1.0
          and all(torch.isfinite(g).all() for d in ("bf16", "f32")
                  for g in runs[d, False][1].values()))
    log({"phase": "resnet_grad", "config": "ResNet50 s2d",
         "batch": list(x.shape), "tensors": len(e_f32),
         "loss_bf16": runs["bf16", False][0],
         "loss_bf16_plain": runs["bf16", True][0],
         "loss_f32": runs["f32", False][0],
         "loss_f32_plain": runs["f32", True][0],
         "losses_bitwise_equal": losses_equal,
         "f32_worst_grad_rel_err": worst_f32[0], "f32_worst_grad":
             worst_f32[1], "f32_tol": RESNET_F32_GRAD_TOL,
         "bf16_worst_grad_rel_err": worst_bf16[0],
         "bf16_worst_grad": worst_bf16[1],
         "bf16_grads_over_2e-2": sum(v > BF16_TOL for v in e_bf16.values()),
         "bf16_vs_f32_median_rel_err": float(np.median(list(
             floor.values()))),
         "bf16_noise_margin": margin[0], "bf16_noise_margin_grad": margin[1],
         "launches": {d: runs[d, False][2] for d in ("bf16", "f32")},
         "launches_plain": {d: runs[d, True][2] for d in ("bf16", "f32")},
         "ok": ok})
    if not ok:
        raise AssertionError("ResNet-50 gradients through the BN kernels "
                             "disagree with the plain backward")
    del model, m32, runs


def train_resnet(dev, card: str) -> dict:
    """``bench.py``'s ResNet-50 configuration through the port's Horovod
    path: 256 images of 224 x 224, one warm-up and five timed steps;
    returns the kernels' launch counts over the timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    from horovod_tpu_torch.training import make_flax_train_step

    batch_size, steps = 256, 5
    hvd.init()
    t0 = time.perf_counter()
    model, _ = resnet50(dev, seed=0)
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=hvd.Compression.none)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_flax_train_step(model, opt)
    batch = images(torch.Generator(device=dev).manual_seed(0), dev,
                   batch_size, 1000)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    before_s = {n: b.clone() for n, b in model.named_buffers()}
    log({"phase": "resnet_init", "config": "ResNet50 s2d bf16",
         "seconds": time.perf_counter() - t0, "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "param_tensors": len(named),
         "param_values": sum(p.numel() for _, p in named),
         "bn_sites": RESNET50_BN_SITES})

    losses = [step(batch).item()]                  # warm-up
    planned = len(plan_buckets([p for _, p in named], 64 * 1024 * 1024,
                               reverse=True).buffers)
    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    stats = dict(model.named_buffers())
    stats_moved = sum(not torch.equal(b, before_s[n])
                      and bool(torch.isfinite(b).all())
                      for n, b in stats.items())
    log({"phase": "resnet_train", "card": card, "steps": steps,
         "batch": list(batch[0].shape), "losses": losses,
         "step_ms": step_ms, "step_ms_each": [1e3 * t for t in times],
         "images_per_s": batch_size / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "plan_buckets": planned, "launches": counts,
         "params_changed": changed, "param_tensors": len(named),
         "stats_changed_finite": stats_moved, "stat_tensors": len(stats)})
    want = RESNET50_BN_SITES * steps
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named):
        fails.append(f"{len(named) - changed} parameters unchanged")
    if stats_moved != len(stats):
        fails.append(f"{len(stats) - stats_moved} running statistics "
                     f"unchanged or not finite")
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        if counts[f] != want:
            fails.append(f"{f} launches {counts[f]} != {want}")
    if per_step["buckets"] != planned or per_step["handles"] != planned:
        fails.append(f"buckets/handles per step {per_step} != planned "
                     f"{planned}")
    if fails:
        raise AssertionError("resnet_train: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, opt, step, batch, before_p, before_s, stats
    return counts


def train_resnet_powersgd(dev, card: str) -> dict:
    """``resnet_train``'s configuration with ``compression="powersgd:4"``:
    the rank-4 PowerSGD exchange with error feedback, each bucket through
    the three fused_update kernels and two factor allreduces.  The first
    (warm-up) step's real buckets are exchanged again through the plain
    versions and compared; returns the kernels' launch counts over the
    five timed steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.compression import wire_payload_bytes
    from horovod_tpu_torch.collectives.ops import powersgd_allreduce
    from horovod_tpu_torch.ops import fused_update as fu
    from horovod_tpu_torch.ops import registry
    from horovod_tpu_torch.timeline.metrics import (exchange_totals,
                                                    registry as metrics)
    from horovod_tpu_torch.training import make_flax_train_step

    batch_size, steps = 256, 5
    hvd.init()
    t0 = time.perf_counter()
    model, _ = resnet50(dev, seed=0)
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=f"powersgd:{POWERSGD_RANK}")
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_flax_train_step(model, opt)
    batch = images(torch.Generator(device=dev).manual_seed(0), dev,
                   batch_size, 1000)
    sizes = [sum(s.size for s in lspecs)
             for _, lspecs in opt.bucket_plan.buffers]
    wire = sum(wire_payload_bytes(opt._compression, n) for n in sizes)
    torch.cuda.synchronize()
    before_p = {n: p.detach().clone() for n, p in named}
    log({"phase": "resnet_powersgd_init", "config": "ResNet50 s2d bf16",
         "compression": opt._compression.__name__,
         "seconds": time.perf_counter() - t0, "world": hvd.size(),
         "backend": torch.distributed.get_backend(),
         "bucket_values": sizes,
         "bucket_leaves": [len(l) for _, l in opt.bucket_plan.buffers],
         "wire_bytes_per_step": wire,
         "compression_ratio": metrics().gauge(
             "horovod_compression_ratio").value})

    # The warm-up step, with every exchange's stage-1 inputs and stage-3
    # outputs recorded (paired through their acc arena).
    seen = []
    real_mp, real_rr = fu.matricize_p, fu.reconstruct_residual

    def matricize_p(x, residual, q0, **kw):
        acc, p = real_mp(x, residual, q0, **kw)
        seen.append({"acc": acc, "x": x, "residual": residual})
        return acc, p

    def reconstruct_residual(acc, *args, **kw):
        out = real_rr(acc, *args, **kw)
        next(e for e in seen if e["acc"] is acc)["got"] = out
        return out

    fu.matricize_p, fu.reconstruct_residual = (matricize_p,
                                               reconstruct_residual)
    try:
        losses = [step(batch).item()]
    finally:
        fu.matricize_p, fu.reconstruct_residual = real_mp, real_rr
    first = []
    for e in seen:
        want = powersgd_allreduce(e["x"], hvd.Average, rank=POWERSGD_RANK,
                                  residual=e["residual"],
                                  force_reference=True)
        errs = [(g - w).abs().max().item() for g, w in zip(e["got"], want)]
        tols = [POWERSGD_STEP_TOL * w.abs().max().item() for w in want]
        first.append({"size": e["x"].numel(), "out_err": errs[0],
                      "out_tol": tols[0], "residual_err": errs[1],
                      "residual_tol": tols[1],
                      "ok": all(a <= b for a, b in zip(errs, tols))})
    del seen

    before = exchange_totals()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(batch).item())
        times.append(time.perf_counter() - t)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: (v - before[k]) / steps
                for k, v in exchange_totals().items()}
    step_ms = 1e3 * sum(times) / steps
    changed = sum(not torch.equal(p, before_p[n]) for n, p in named)
    residuals = [{"values": r.numel(), "finite": bool(torch.isfinite(r).all()),
                  "max_abs": r.abs().max().item()} for r in opt.residuals]
    log({"phase": "resnet_powersgd", "card": card, "steps": steps,
         "batch": list(batch[0].shape), "losses": losses,
         "step_ms": step_ms, "step_ms_each": [1e3 * t for t in times],
         "images_per_s": batch_size / (step_ms / 1e3),
         "peak_mem_bytes": peak, "exchange_per_step": per_step,
         "launches": counts, "params_changed": changed,
         "param_tensors": len(named), "residuals": residuals,
         "first_step_exchange": first})
    fails = []
    if not all(np.isfinite(losses)):
        fails.append("a loss is not finite")
    if not losses[-1] < losses[0]:
        fails.append(f"loss did not fall: {losses}")
    if changed != len(named) or len(named) != RESNET50_PARAM_TENSORS:
        fails.append(f"{changed} of {len(named)} parameters changed")
    if not all(r["finite"] and r["max_abs"] > 0 for r in residuals):
        fails.append(f"a residual is zero or not finite: {residuals}")
    if sizes != list(POWERSGD_BUCKETS) or wire != POWERSGD_WIRE_BYTES:
        fails.append(f"EF plan {sizes}, {wire} wire bytes")
    nb = len(POWERSGD_BUCKETS)
    if per_step != {"buckets": nb, "wire_bytes": POWERSGD_WIRE_BYTES,
                    "handles": 2 * nb}:
        fails.append(f"exchange per step {per_step}")
    for f in ("fused_update_matricize_p", "fused_update_orthonormalize_q",
              "fused_update_reconstruct"):
        if counts[f] != nb * steps:
            fails.append(f"{f} launches {counts[f]} != {nb * steps}")
    for f in ("bn_bwd_reduce", "bn_bwd_dx"):
        if counts[f] != RESNET50_BN_SITES * steps:
            fails.append(f"{f} launches {counts[f]}")
    if len(first) != nb or not all(e["ok"] for e in first):
        fails.append(f"first step's exchange vs plain: {first}")
    if fails:
        raise AssertionError("resnet_powersgd: " + "; ".join(fails))
    hvd.shutdown()
    del model, named, opt, step, batch, before_p
    return counts


def train_lenet(dev) -> None:
    """A few LeNet steps on a synthetic MNIST-like batch (10 gaussian
    centers, as ``examples/mnist_lenet.py``) with that example's
    optimizer, SGD(0.01, momentum 0.9), through the same step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import LeNet, init_params
    from horovod_tpu_torch.training import make_flax_train_step

    hvd.init()
    model = LeNet(device=dev)
    model.load_state_dict(init_params(
        model, generator=torch.Generator(device=dev).manual_seed(0)))
    named = list(model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.01, momentum=0.9),
        named_parameters=named)
    step = make_flax_train_step(model, opt)
    rng = np.random.RandomState(42)
    centers = rng.randn(10, 28 * 28).astype(np.float32)
    y = rng.randint(0, 10, size=256)
    x = centers[y] + 0.5 * rng.randn(256, 28 * 28).astype(np.float32)
    batch = (torch.from_numpy(x.reshape(-1, 28, 28, 1)).to(dev),
             torch.from_numpy(y).to(dev))
    losses = [step(batch).item() for _ in range(10)]
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    log({"phase": "lenet", "batch": [256, 28, 28, 1], "losses": losses,
         "ok": ok})
    if not ok:
        raise AssertionError(f"lenet: the loss did not fall: {losses}")
    hvd.shutdown()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import attention as attn
    from horovod_tpu_torch.ops import bn

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "nvidia_smi": card, "kind": kind,
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda})
    log({"phase": "build", "seconds": _build.build_all(),
         "nvcc": _build.nvcc_path(), "flags": _build.NVCC_FLAGS})

    flash = check_flash(attn, dev)
    decode = check_decode(attn, dev)
    dq, dkv = check_flash_bwd(attn, dev)
    free_device()
    bn_red, bn_dx = check_bn_bwd(bn, dev)
    free_device()
    fused = check_fused_update(dev)
    free_device()
    serve = serve_llama(dev, card)
    free_device()
    check_grad(dev)
    free_device()
    train = train_llama(dev, card)
    free_device()
    check_resnet_grad(dev)
    free_device()
    resnet = train_resnet(dev, card)
    free_device()
    powersgd = train_resnet_powersgd(dev, card)
    free_device()
    train_lenet(dev)
    # The flash forward runs on both paths: its launches are the sum.
    flash["launches"] = serve["flash"] + train["flash"]
    decode["launches"] = serve["flash_decode"]
    dq["launches"] = train["flash_bwd_dq"]
    dkv["launches"] = train["flash_bwd_dkv"]
    bn_red["launches"] = resnet["bn_bwd_reduce"]
    bn_dx["launches"] = resnet["bn_bwd_dx"]
    for e in fused:
        e["launches"] = powersgd[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log({"kernels": [{k: e[k] for k in keys}
                     for e in (flash, decode, dq, dkv, bn_red, bn_dx,
                               *fused)]})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
