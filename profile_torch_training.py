"""Where the time goes in one training step of the PyTorch/CUDA port.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 profile_torch_training.py                   # Llama-3 8B LoRA
    python3 profile_torch_training.py --model resnet50  # ResNet-50
    python3 profile_torch_training.py --model resnet50 --compression powersgd:4
    python3 profile_torch_training.py --model bert-large  # BERT-Large Adasum
    python3 profile_torch_training.py --model inception_v3  # or vgg16
    python3 profile_torch_training.py --model torch_resnet50

``llama`` (the default) builds the trainer of ``chip_smoke.py``'s train
phase -- Llama-3 8B at full width and depth, random bf16 base from seed
0, LoRA rank 8 on all seven projections, ``DistributedOptimizer(AdamW,
compression=bf16)`` in a world of one over NCCL, a 2 x 2048-token batch.
``resnet50`` builds that of its ``resnet_train`` phase -- ResNet-50 with
the space-to-depth stem, bf16 compute, 1000 classes, random weights from
seed 0, ``DistributedOptimizer(SGD(0.1, momentum 0.9))`` in a world of
one, 256 images of 224 x 224 from seed 0 -- with
``make_flax_train_step``.  ``bert-large`` builds that of its
``bert_train`` phase -- BERT-Large at full width and depth, bf16
compute, random weights from seed 0, ``DistributedAdasumOptimizer(AdamW,
compression=fp16)`` in a world of one, 64 x 128 tokens with NSP labels
from seed 0, ``make_train_step(bert_pretrain_loss)``.  ``inception_v3``
and ``vgg16`` build the synthetic benchmark's own setup
(``horovod_tpu_torch.synthetic_benchmark.setup``), as ``chip_smoke.py``'s
``inception_train`` and ``vgg_train`` phases do: 32 images of 299 x 299
(224 x 224) from a seed, bf16 compute, 1000 classes, random weights from
seed 0, ``DistributedOptimizer(SGD(0.01, momentum 0.9))``, dropout 0,
``make_flax_train_step``.  ``torch_resnet50`` builds the stock Horovod
script ``horovod_tpu_torch.examples.torch_resnet50``'s setup, as
``chip_smoke.py``'s ``torch_resnet50`` phase does: the torch-idiom
ResNet-50 at full width, 256 images of 224 x 224, channels_last, bf16
autocast, 53 ``hvd.SyncBatchNorm(process_set=ps)`` sites,
``DistributedOptimizer(SGD(0.1, momentum 0.9), compression=fp16,
process_set=ps)``.  ``--compression``
gives the optimizer another
codec spec (``none``, ``fp16``, ``bf16`` or ``powersgd:<r>``; by default
each model's own: bf16 for the LoRA adapters, fp16 for BERT-Large and
the torch-idiom ResNet-50, none for ResNet-50 and the other CNNs);
``powersgd:4`` is the PowerSGD cell of ``chip_smoke.py``'s
``resnet_powersgd`` phase, whose three exchange stages are grouped as
``fused_update``.  Either takes one warm-up step, then profiles
two steps with ``torch.profiler``.  It prints one JSON line for the
window: host wall time, device busy time (sum of GPU kernel time), the
device's idle share, device time per group of kernels and the top
kernels with their call counts, plus the peak device memory.  Groups:
the port's kernels by name, then cuDNN convolutions (``conv``), GEMMs,
NCCL and the rest.  A GPU is required; without one the script exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

NCCL = ("nccl", "ncclDevKernel")
GEMM = ("gemm", "nvjet", "cutlass", "Kernel2", "sm90_xmma", "sm80_xmma")
GROUPS = {
    "llama": {
        "flash_fwd": ("flash_fwd_mma_kernel", "flash_fwd_kernel"),
        "flash_bwd_dq": ("flash_bwd_dq_mma_kernel", "flash_bwd_dq_kernel"),
        "flash_bwd_dkv": ("flash_bwd_dkv_mma_kernel", "flash_bwd_dkv_kernel"),
        "nccl": NCCL,
        "gemm": GEMM,
    },
    # cuDNN's convolution kernels carry fprop/dgrad/wgrad or "conv" in
    # their names (implicit GEMMs among them), so they are matched before
    # the plain GEMMs.
    "resnet50": {
        "bn_bwd_reduce": ("bn_bwd_reduce_kernel", "bn_bwd_finish_kernel"),
        "bn_bwd_dx": ("bn_bwd_dx_kernel",),
        "fused_update": ("matricize_p_kernel", "gram_schmidt",
                         "q_project_kernel", "reconstruct_kernel"),
        "conv": ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                 "implicit_gemm"),
        "nccl": NCCL,
        "gemm": GEMM,
    },
}
GROUPS["bert-large"] = GROUPS["llama"]
GROUPS["inception_v3"] = GROUPS["vgg16"] = GROUPS["resnet50"]
GROUPS["torch_resnet50"] = GROUPS["resnet50"]


def llama_step(dev, hvd, compression):
    from horovod_tpu_torch.models import (LLAMA3_8B, LlamaLM, freeze_base,
                                          init_llama_params)
    from horovod_tpu_torch.training import causal_lm_loss, make_train_step

    cfg = LLAMA3_8B
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
        named_parameters=named, compression=compression or "bf16")
    step = make_train_step(model, causal_lm_loss, opt)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 2048))).to(dev)
    info = {"layers": cfg.num_layers, "batch": [2, 2048]}
    return (lambda: step(tokens)), opt, info


def resnet_step(dev, hvd, compression):
    from horovod_tpu_torch.models import ResNet50, init_resnet_params
    from horovod_tpu_torch.training import make_flax_train_step

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.load_state_dict(init_resnet_params(model, generator=gen))
    named = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=compression or "none")
    step = make_flax_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(256, 224, 224, 3, generator=gen, device=dev).to(
        torch.bfloat16)
    y = torch.randint(0, 1000, (256,), generator=gen, device=dev)
    info = {"config": "ResNet50 s2d bf16", "batch": [256, 224, 224, 3]}
    return (lambda: step((x, y))), opt, info


def bert_step(dev, hvd, compression):
    from horovod_tpu_torch.models import BERT_LARGE, Bert, init_bert_params
    from horovod_tpu_torch.training import bert_pretrain_loss, \
        make_train_step

    cfg = BERT_LARGE
    params = init_bert_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    model = Bert.from_params(cfg, params, dtype=torch.bfloat16)
    del params
    named = list(model.named_parameters())
    opt = hvd.DistributedAdasumOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3, weight_decay=1e-4),
        named_parameters=named, compression=compression or "fp16")
    step = make_train_step(model, bert_pretrain_loss, opt)
    rng = np.random.RandomState(0)
    batch = (torch.from_numpy(rng.randint(0, cfg.vocab_size, (64, 128))
                              ).to(dev),
             torch.from_numpy(rng.randint(0, 2, (64,))).to(dev))
    info = {"layers": cfg.num_layers, "batch": [64, 128]}
    return (lambda: step(batch)), opt, info


def cnn_step(name):
    def build(dev, hvd, compression):
        from horovod_tpu_torch import synthetic_benchmark as sb
        bench = sb.setup(name, batch_size=32,
                         compression=compression or "none")
        info = {"batch": list(bench.batch[0].shape)}
        return (lambda: bench.step(bench.batch)), bench.optimizer, info
    return build


def torch_resnet50_step(dev, hvd, compression):
    from horovod_tpu_torch.examples import torch_resnet50 as ex
    args = ex.parse_args(["--compression", compression or "fp16"])
    bench = ex.setup(args)
    info = {"batch": list(bench.batch[0].shape),
            "process_set": bench.process_set.name}
    return bench.step, bench.optimizer, info


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=sorted(GROUPS), default="llama")
    parser.add_argument("--compression", default=None,
                        help="codec spec for the optimizer (default: the "
                             "model's own)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import horovod_tpu_torch as hvd
    from profile_torch_serving import _card, _window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    hvd.init()
    build = {"llama": llama_step, "resnet50": resnet_step,
             "bert-large": bert_step, "inception_v3": cnn_step(args.model),
             "vgg16": cnn_step(args.model),
             "torch_resnet50": torch_resnet50_step}[args.model]
    step, opt, info = build(dev, hvd, args.compression)
    warm = step().item()
    torch.cuda.reset_peak_memory_stats()

    def two_steps():
        for _ in range(2):
            step().item()

    out = _window("train_2_steps", two_steps, top=25,
                  groups=GROUPS[args.model])
    out.update(card=_card(), model=args.model, **info, warm_loss=warm,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               compression=opt._compression.__name__,
               bucket_bytes=opt.bucket_plan.bucket_bytes())
    print(json.dumps(out), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
