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
   the flash backward's dq and dk/dv), with its time, the plain
   version's time, one PyTorch library call's time for the same
   function, and the least time the card could take (``bound_ms``).
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
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (NVIDIA data sheet)
F32_TOL = 1e-5             # f32: absolute, the sums only reorder
F32_GRAD_TOL = 1e-5        # f32 gradients: relative to max |reference grad|
BF16_TOL = 2e-2            # bf16: relative to max |reference output|


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


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops = flops / H100_BF16_FLOPS
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import attention as attn

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
    serve = serve_llama(dev, card)
    free_device()
    check_grad(dev)
    free_device()
    train = train_llama(dev, card)
    # The flash forward runs on both paths: its launches are the sum.
    flash["launches"] = serve["flash"] + train["flash"]
    decode["launches"] = serve["flash_decode"]
    dq["launches"] = train["flash_bwd_dq"]
    dkv["launches"] = train["flash_bwd_dkv"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log({"kernels": [{k: e[k] for k in keys}
                     for e in (flash, decode, dq, dkv)]})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
