"""GPU smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. card -- ``nvidia-smi`` name and power limit, ``torch.cuda`` device
   name; TF32 turned off for matmuls and cuDNN.
2. build -- both CUDA kernels compiled from ``horovod_tpu_torch/ops/csrc``
   with ``nvcc`` for ``sm_90a``.
3. kernels -- each kernel against its plain PyTorch version on the card
   at the serving path's shapes, with its time, the plain version's
   time, one PyTorch library call's time for the same function, and the
   least time the card could take (``bound_ms``).
4. serve -- Llama-3 8B at full width and depth (random bf16 weights from
   a seed) serves 8 requests through ``ServingEngine``; the kernels'
   launch counters must show the main path went through them, and the
   first request's first-token logits must match the same prefill run
   through the plain attention.

Then one JSON line of per-kernel numbers, the card line, and last the
``{"ok": true, "device": ...}`` line.  Without a GPU, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

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


# ---------------------------------------------------------------------------
# Phase 4: the slice end to end
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
    counts = serve_llama(dev, card)
    flash["launches"] = counts["flash"]
    decode["launches"] = counts["flash_decode"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log({"kernels": [{k: e[k] for k in keys} for e in (flash, decode)]})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
