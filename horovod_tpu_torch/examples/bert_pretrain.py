"""BERT pretraining (MLM + NSP) on the port: Adasum + fp16, or DP x TP.

The JAX repository's ``examples/bert_pretrain.py`` with the port's
import: synthetic token batches (the MLM target is the token itself, as
there), the full forward, backward and update through the framework.

* Without ``--tp``: ``Bert`` (every tensor replicated) through
  ``DistributedAdasumOptimizer(AdamW, compression=<codec>)`` and
  ``make_train_step``.
* ``--tp T``: the 3-D step over ``build_3d_mesh(data=world / T,
  model=T)`` (``dcn_size=2`` when the data extent is 4 or more and
  even): ``models.BertTP`` -- this rank's Megatron shard of every
  attention and FFN kernel, the ``heads / T`` local heads through the
  flash kernels -- ``DistributedOptimizer(AdamW, compression=<codec>,
  process_set=<the data axes' set>)`` and ``make_train_step(tp=T,
  param_specs=tp_param_specs(...))``.  The HBM report prints the
  parameters and AdamW moments a rank holds both ways;
  ``--save-checkpoint`` saves the FULL tree, gathered over the model
  set (``parallel.gather_tp_params``), which the serving plane loads.

Run::

    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.bert_pretrain --tp 2 --steps 5
    python -m horovod_tpu_torch.examples.bert_pretrain --large
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=0,
                   help="global batch (default: 4 per data shard)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--large", action="store_true",
                   help="BERT-Large (BERT_TINY otherwise)")
    p.add_argument("--compression", default="fp16",
                   help="gradient wire codec: none, fp16 or bf16")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel extent: the DP x TP 3-D step")
    p.add_argument("--save-checkpoint", default="",
                   help="save the final (full) parameters to this npz path")
    p.add_argument("--device", default=None,
                   help="cpu or cuda (default: cuda, or cpu under the "
                        "launcher's --cpu)")
    return p.parse_args(argv)


def _data(cfg, batch: int, seq: int, dev):
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq)))
    nsp = torch.from_numpy(rng.randint(0, 2, (batch,)))
    return tokens.to(dev), nsp.to(dev)


def _loss(model, batch):
    from horovod_tpu_torch.training import mlm_nsp_loss
    return mlm_nsp_loss(*model(batch[0]), *batch)


def _train(step, batch, steps: int, items: int) -> dict:
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        times.append(time.perf_counter() - t0)
        if hvd.rank() == 0 and i % 10 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}", flush=True)
    if hvd.rank() == 0 and len(times) > 1:
        ms = 1e3 * sum(times[1:]) / (len(times) - 1)
        print(f"final loss {losses[-1]:.4f}  {ms:.1f} ms/step  "
              f"{items / (ms / 1e3):.1f} seq/s", flush=True)
    return {"losses": losses, "times": times}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    if args.tp > 0:
        return main_3d(args)
    from horovod_tpu_torch.models import (BERT_LARGE, BERT_TINY, Bert,
                                          init_bert_params)
    dev = global_state().device
    cfg = BERT_LARGE if args.large else BERT_TINY
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Bert.from_params(cfg, init_bert_params(cfg, generator=gen,
                                                   device=dev), dtype=dtype)
    batch = args.batch_size or 4 * hvd.size()
    seq = min(args.seq_len, cfg.max_seq_len)
    if hvd.rank() == 0:
        n = sum(p.numel() for p in model.parameters())
        print(f"devices={hvd.size()} params={n / 1e6:.1f}M batch={batch} "
              f"seq={seq}", flush=True)
    named = list(model.named_parameters())
    opt = hvd.DistributedAdasumOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=args.lr),
        named_parameters=named,
        compression=getattr(hvd.Compression, args.compression))
    from horovod_tpu_torch.training import make_train_step, shard_batch
    step = make_train_step(model, _loss, opt)
    data = shard_batch(_data(cfg, batch, seq, dev))
    run = _train(step, data, args.steps, batch)
    if args.save_checkpoint:
        from horovod_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(args.save_checkpoint, dict(model.named_parameters()))
    return dict(run, model=model)


def main_3d(args) -> dict:
    """DP x TP over one ``build_3d_mesh`` (module docstring)."""
    from horovod_tpu_torch.models import (BERT_LARGE, BERT_TINY, BertTP,
                                          init_bert_params)
    from horovod_tpu_torch.parallel import (build_3d_mesh, data_axes,
                                            gather_tp_params, shard_params,
                                            tp_param_specs)
    from horovod_tpu_torch.parallel.tp import split_bytes
    from horovod_tpu_torch.training import make_train_step, shard_batch

    world, tp = hvd.size(), args.tp
    if world % tp:
        raise SystemExit(f"--tp {tp} does not divide {world} ranks")
    data = world // tp
    dcn = 2 if data % 2 == 0 and data >= 4 else 1
    mesh = build_3d_mesh(data=data // dcn, model=tp, dcn_size=dcn)
    dev = global_state().device
    cfg = BERT_LARGE if args.large else BERT_TINY
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    batch = args.batch_size or 4 * data
    seq = min(args.seq_len, cfg.max_seq_len)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_bert_params(cfg, generator=gen, device=dev)
    specs = tp_param_specs(params, axis="model")
    local = shard_params(params, specs, mesh.axis_index("model"), tp)
    full = sum(t.numel() * t.element_size() for t in params.values())
    split = split_bytes(params, specs)
    mine = full - split + split // tp
    del params
    model = BertTP(cfg, local, dtype, axis="model")
    if hvd.rank() == 0:
        print(f"devices={world} mesh=dcn{dcn} x (data{data // dcn}, "
              f"model{tp}) params={full / 4e6:.1f}M batch={batch} "
              f"seq={seq}", flush=True)
        print(f"HBM/device (params + 2 AdamW moments): pure-DP "
              f"{3 * full / 2**20:.1f} MiB vs 3D {3 * mine / 2**20:.1f} "
              f"MiB ({full / mine:.2f}x)", flush=True)
    named = list(model.named_parameters())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=args.lr),
        named_parameters=named,
        compression=getattr(hvd.Compression, args.compression),
        process_set=mesh.group(data_axes(mesh)))
    step = make_train_step(model, _loss, opt, tp=tp, param_specs=specs)
    run = _train(step, shard_batch(_data(cfg, batch, seq, dev)),
                 args.steps, batch)
    if args.save_checkpoint:
        from horovod_tpu_torch.utils.checkpoint import save_checkpoint
        tree = gather_tp_params(dict(model.named_parameters()), specs,
                                axis="model")
        save_checkpoint(args.save_checkpoint, tree)
        if hvd.rank() == 0:
            print(f"saved {args.save_checkpoint} (full kernels, "
                  f"serving-loadable)", flush=True)
    return dict(run, model=model, mesh=mesh, specs=specs)


if __name__ == "__main__":
    main()
    hvd.shutdown()
