"""Where the time goes in the PyTorch/CUDA serving path, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 profile_torch_serving.py

Builds Llama-3 8B at full width and depth (random bf16 weights from a
seed), serves the same 8-request load as ``chip_smoke.py``
once to warm up, then profiles two windows with ``torch.profiler``:

* one whole-prompt prefill of 2048 tokens;
* 16 decode steps over 8 live slots of ~2048 cached tokens each.

For each window it prints one JSON line: host wall time, device busy
time (sum of GPU kernel time), the device's idle share, and the top GPU
kernels by time with their call counts.  A GPU is required; without one
the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def _window(name: str, fn, top: int = 12) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        # GPU kernel rows only: the CPU operator rows repeat their time.
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        busy_us += dev_us
        rows.append({"kernel": ev.key[:90], "calls": ev.count,
                     "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = busy_us / 1e6
    return {"window": name, "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "top": rows[:top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.models import LLAMA3_8B, init_llama_params
    from horovod_tpu_torch.serving import (LoadSpec, ServingEngine,
                                           generate, greedy_sample,
                                           prefill_forward)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = LLAMA3_8B
    params = init_llama_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev)
    eng = ServingEngine(cfg, params, device=dev, slots=8, page_size=16,
                        max_len=4096, dtype=torch.bfloat16)
    warm = eng.serve(generate(LoadSpec(
        num_requests=8, prompt_lens=(37, 512, 2048), output_lens=(32, 64),
        vocab_size=cfg.vocab_size, seed=0)))
    print(json.dumps({"card": _card(), "layers": cfg.num_layers,
                      "warm_serve": warm.as_dict()}), flush=True)

    rng = np.random.RandomState(1)
    prompt = torch.tensor(rng.randint(0, cfg.vocab_size, (1, 2048)),
                          device=dev)

    def prefill():
        logits, _, _ = prefill_forward(params, cfg, prompt,
                                       dtype=torch.bfloat16)
        greedy_sample(logits[:, -1]).cpu()

    print(json.dumps(_window("prefill_2048", prefill)),
          flush=True)

    # Eight live slots of ~2048 tokens, then plain decode steps.
    cache = eng.cache
    for slot in range(8):
        toks = torch.tensor(rng.randint(0, cfg.vocab_size, (1, 2040 + slot)),
                            device=dev)
        _, kl, vl = prefill_forward(params, cfg, toks, dtype=torch.bfloat16)
        cache.write_prefill(slot, kl[:, 0], vl[:, 0])
    last = torch.zeros(8, dtype=torch.long, device=dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)

    def decode(steps=16):
        nonlocal last
        for _ in range(steps):
            for slot in range(8):
                cache.reserve(slot, int(cache.lengths[slot]) + 1)
            logits, cache.k, cache.v = eng.step(
                params, cache.k, cache.v, last,
                cache.lengths_device().long(), cache.table_device(),
                active)
            last = greedy_sample(logits).long()
            last.cpu()
            cache.lengths[:8] += 1

    decode(2)
    print(json.dumps(_window("decode_16_steps", decode)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
