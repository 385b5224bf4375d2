"""Where the time goes in one LoRA training step of the PyTorch/CUDA port.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 profile_torch_training.py

Builds the trainer of ``chip_smoke.py``'s train phase -- Llama-3 8B at
full width and depth, random bf16 base from seed 0, LoRA rank 8 on all
seven projections, ``DistributedOptimizer(AdamW, compression=bf16)`` in a
world of one over NCCL, a 2 x 2048-token batch -- takes one warm-up step,
then profiles two steps with ``torch.profiler``.  It prints one JSON line
for the window: host wall time, device busy time (sum of GPU kernel
time), the device's idle share, device time per group of kernels
(attention forward, the two backward kernels, GEMMs, NCCL, the rest) and
the top kernels with their call counts, plus the peak device memory.  A
GPU is required; without one the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

GROUPS = {
    "flash_fwd": ("flash_fwd_kernel",),
    "flash_bwd_dq": ("flash_bwd_dq_kernel",),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel",),
    "nccl": ("nccl", "ncclDevKernel"),
    "gemm": ("gemm", "nvjet", "cutlass", "Kernel2", "sm90_xmma",
             "sm80_xmma"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (LLAMA3_8B, LlamaLM, freeze_base,
                                          init_llama_params)
    from horovod_tpu_torch.training import causal_lm_loss, make_train_step
    from profile_torch_serving import _card, _window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = LLAMA3_8B
    hvd.init()
    params = init_llama_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev, lora_rank=8)
    model = LlamaLM.from_params(cfg, params, dtype=torch.bfloat16,
                                lora_rank=8)
    del params
    named = freeze_base(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3,
                          weight_decay=1e-4),
        named_parameters=named, compression=hvd.Compression.bf16)
    step = make_train_step(model, causal_lm_loss, opt)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 2048))).to(dev)
    warm = step(tokens).item()
    torch.cuda.reset_peak_memory_stats()

    def two_steps():
        for _ in range(2):
            step(tokens).item()

    out = _window("train_2_steps", two_steps, top=15, groups=GROUPS)
    out.update(card=_card(), layers=cfg.num_layers, batch=[2, 2048],
               warm_loss=warm,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               bucket_bytes=opt.bucket_plan.bucket_bytes())
    print(json.dumps(out), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
