"""Llama LoRA fine-tune, and multi-LoRA serving, on the port
(BASELINE.json config 4, "Llama-3 8B LoRA fine-tune").

The JAX repository's ``examples/llama_lora.py`` with the port's import
and a ``--device`` argument.  Only the rank-``r`` adapters train
(``freeze_base``), and their gradients -- hundreds of small tensors
across every projection -- ride the fused allreduce of
``hvd.DistributedOptimizer(AdamW, compression=bf16)``.  ``--8b`` is the
real Llama-3 8B with the frozen base at int8 (one f32 scale per output
channel) and remat: no base gradients or master weights, about 7.5 GB of
int8 base.  The other sizes keep the base in the compute dtype (bf16 on
the card, f32 on the CPU); ``--remat`` selects remat on its own.

``--serve-adapters N`` serves instead of training: N adapters, stacked
into banks (``stack_adapters``), over ONE base in one continuous decode
batch, each decode slot gathering its own adapter inside the step.
Every stream must equal a dedicated single-adapter engine's, that
adapter's leaves in the tree, and distinct adapters must steer the base
differently.

Sizes: ``--8b``, ``--1b``, else the tiny config (``LLAMA_TINY`` for
training, ``LLAMA_SERVE`` for serving).  The tiny configs' head dim (16)
is not one the attention kernels take (64, 128), so on the card the
default is ``--1b``.

Run::

    python -m horovod_tpu_torch.examples.llama_lora [--steps 30] [--8b]
    python -m horovod_tpu_torch.examples.llama_lora --device cpu --steps 2
    python -m horovod_tpu_torch.examples.llama_lora --serve-adapters 3
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import (LLAMA3_8B, LLAMA_1B, LLAMA_SERVE,
                                      LLAMA_TINY, LlamaLM, freeze_base,
                                      init_llama_params)
from horovod_tpu_torch.training import causal_lm_loss, make_train_step

WARM = 1            # untimed steps before the timed window


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--rank", type=int, default=8, help="LoRA rank")
    p.add_argument("--lr", type=float, default=1e-3)
    size = p.add_mutually_exclusive_group()
    size.add_argument("--1b", dest="mid", action="store_true",
                      help="~0.9B config")
    size.add_argument("--8b", dest="full", action="store_true",
                      help="real Llama-3 8B, int8 frozen base + remat")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--serve-adapters", type=int, default=0, metavar="N",
                   help="serve N LoRA adapters over one shared base in a "
                        "single decode batch (skips training)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _config(args, tiny):
    if args.full:
        return LLAMA3_8B
    if args.mid or args.device == "cuda":
        return LLAMA_1B
    return tiny


def _dtype(device: str):
    return torch.bfloat16 if device == "cuda" else torch.float32


def random_adapters(params: Dict[str, torch.Tensor], n: int, seed: int,
                    std: float = 0.05) -> List[Dict[str, torch.Tensor]]:
    """``n`` stand-ins for independently fine-tuned adapter sets over one
    base: every ``lora_a`` / ``lora_b`` of ``params`` drawn from ``std *
    normal``, adapter ``j`` from seed ``seed + j``."""
    names = [k for k in params if k.endswith(("lora_a", "lora_b"))]
    out = []
    for j in range(n):
        gen = torch.Generator(device=params[names[0]].device)
        gen.manual_seed(seed + j)
        out.append({k: torch.empty_like(params[k]).normal_(
            0.0, std, generator=gen) for k in names})
    return out


def serve_multi_lora(args: argparse.Namespace) -> SimpleNamespace:
    """N adapters, one base model, one continuous decode batch."""
    from horovod_tpu_torch.serving import (Request, ServingEngine,
                                           stack_adapters)

    cfg = _config(args, LLAMA_SERVE)
    dev, dtype = args.device, _dtype(args.device)
    n = args.serve_adapters
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=dtype, device=dev,
                               lora_rank=args.rank)
    adapters = random_adapters(params, n, seed=100)
    banks = stack_adapters(adapters)

    # Identical prompts, so any divergence between streams is the
    # per-slot adapter gather, not the data.
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, (12,))
    new_tokens = 10
    geom = dict(slots=max(4, n), page_size=8, max_len=64, dtype=dtype,
                device=dev)
    reqs = [Request(rid=j, prompt=prompt, max_new_tokens=new_tokens,
                    adapter_id=j) for j in range(n)]
    report = ServingEngine(cfg, params, adapters=banks, **geom).serve(reqs)
    assert report.completed == n, report
    streams = {r.rid: list(r.tokens) for r in reqs}

    # Distinct adapters must steer the shared base differently...
    assert len({tuple(s) for s in streams.values()}) > 1, streams
    # ...and each stream must equal a dedicated engine serving that
    # adapter from the tree (no banks), with as many slots.
    for j, adapter in enumerate(adapters):
        ref = [Request(rid=0, prompt=prompt, max_new_tokens=new_tokens)]
        ServingEngine(cfg, {**params, **adapter}, **geom).serve(ref)
        assert streams[j] == list(ref[0].tokens), (
            f"adapter {j}: banked decode diverged from the single-adapter "
            f"reference: {streams[j]} vs {list(ref[0].tokens)}")
        print(f"adapter {j}: {len(streams[j])} tokens match "
              f"single-adapter reference")
    print(f"multi-LoRA serve OK: {n} adapters shared one base "
          f"({report.new_tokens} tokens, {report.decode_steps} decode "
          f"steps, {report.tokens_per_s:.1f} tokens/s)")
    return SimpleNamespace(streams=streams, report=report)


def train(args: argparse.Namespace) -> SimpleNamespace:
    """The LoRA fine-tune: ``WARM`` untimed steps, then ``args.steps``
    timed ones (host clock; reading the loss waits for the device)."""
    hvd.init(device=args.device)
    dev = torch.device(args.device) if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    cfg = _config(args, LLAMA_TINY)
    dtype = _dtype(args.device)
    base_dtype = "int8" if args.full else None
    remat = args.remat or args.full
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_llama_params(cfg, generator=gen, dtype=dtype, device=dev,
                               lora_rank=args.rank, base_dtype=base_dtype)
    model = LlamaLM.from_params(cfg, params, dtype, lora_rank=args.rank,
                                remat=remat, base_dtype=base_dtype)
    named = freeze_base(model)
    batch = args.batch_size or 2 * hvd.size()
    seq = min(args.seq_len, cfg.max_seq_len)
    if hvd.rank() == 0:
        n_all = sum(p.numel() for p in model.parameters())
        n_lora = sum(p.numel() for _, p in named)
        print(f"devices={hvd.size()} params={n_all / 1e6:.1f}M "
              f"trainable(LoRA)={n_lora / 1e3:.1f}K batch={batch} "
              f"seq={seq} base={base_dtype or str(dtype)[6:]}")

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=args.lr),
        named_parameters=named, compression=hvd.Compression.bf16)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    step = make_train_step(model, causal_lm_loss, opt)

    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (batch, seq))
    per = batch // hvd.size()
    local = torch.from_numpy(
        tokens[hvd.rank() * per:(hvd.rank() + 1) * per]).to(dev)

    for _ in range(WARM):
        step(local).item()
    t0 = time.perf_counter()
    losses = [step(local) for _ in range(args.steps)]
    losses = [x.item() for x in losses]
    dt = time.perf_counter() - t0
    if hvd.rank() == 0:
        for i in range(0, args.steps, 10):
            print(f"step {i + 1 + WARM:4d} loss {losses[i]:.4f}")
        rate = args.steps * batch / dt
        print(f"{rate:.1f} sequences/s ({rate / hvd.size():.1f}/chip), "
              f"final loss {losses[-1]:.4f}")
    return SimpleNamespace(losses=losses, model=model, named=named,
                           seconds=dt)


def main(argv: Optional[Sequence[str]] = None) -> SimpleNamespace:
    args = parse_args(argv)
    if args.serve_adapters:
        return serve_multi_lora(args)
    try:
        return train(args)
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
