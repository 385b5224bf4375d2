"""Error-feedback gradient compression on the wire -- powersgd / topk (the
port of ``examples/grad_compression.py``).

Trains the same small model three ways -- uncompressed, ``powersgd:4``
(rank-4 factorization of each fusion bucket) and ``topk:0.05`` (top-k
magnitude selection exchanged by allgather) -- and prints the wire bytes
a step beside the first and last loss, so the bandwidth/convergence
trade is visible in one run.  Both codecs carry an error-feedback
residual in the optimizer: what a step's compression dropped is
re-injected into the next step's exchange.  ``powersgd:4`` runs the
three ``fused_update`` kernels on the card (one launch of each a step:
the MLP's 9,610 f32 values are one bucket).

The data is the JAX script's (numpy ``RandomState(42)`` class centres,
``RandomState(step)`` batches of the global batch, split over the
ranks); the MLP's parameters keep the JAX tree's names and layout
(``w1 [64, 128]``, ``b1``, ``w2 [128, 10]``, ``b2``; ``x @ w1``), so its
error-feedback bucket is the JAX one.  :func:`init_params` draws the
He-normal initial values from numpy; :func:`main` takes other initial
values as numpy arrays (``params=``).

Run::

    python -m horovod_tpu_torch.examples.grad_compression --device cpu
    python -m horovod_tpu_torch.examples.grad_compression --compression \\
        powersgd:8 --zero
    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.grad_compression

Without ``--device cpu`` (or the launcher's ``--cpu``) it runs on
``cuda``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

IN, HIDDEN, CLASSES = 64, 128, 10
CODECS = (None, "powersgd:4", "topk:0.05")


def class_centers() -> np.ndarray:
    return np.random.RandomState(42).randn(CLASSES, IN).astype(np.float32)


def make_batch(centers: np.ndarray, step: int, batch_size: int):
    """The global batch of step ``step``: ``(x [b, 64] f32, y [b] int)``
    as numpy, the JAX script's draws."""
    r = np.random.RandomState(step)
    y = r.randint(0, CLASSES, size=batch_size)
    x = centers[y] + 0.5 * r.randn(batch_size, IN)
    return x.astype(np.float32), y.astype(np.int64)


def _he_normal(rng: np.random.RandomState, shape) -> np.ndarray:
    """He-normal (a truncated normal of variance ``2 / fan_in``, as
    ``jax.nn.initializers.he_normal``) from numpy."""
    std = np.sqrt(2.0 / shape[0]) / 0.87962566103423978
    out = rng.randn(*shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.randn(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return (out * std).astype(np.float32)


def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {"w1": _he_normal(rng, (IN, HIDDEN)),
            "b1": np.zeros((HIDDEN,), np.float32),
            "w2": _he_normal(rng, (HIDDEN, CLASSES)),
            "b2": np.zeros((CLASSES,), np.float32)}


class MLP(nn.Module):
    """``relu(x @ w1 + b1) @ w2 + b2`` with the JAX tree's names,
    registered in its leaf order (sorted keys)."""

    def __init__(self, params: Dict[str, np.ndarray], device):
        super().__init__()
        for name in sorted(params):
            self.register_parameter(name, nn.Parameter(
                torch.tensor(params[name], device=device)))

    def forward(self, x):
        return F.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


def loss_fn(model: nn.Module, batch) -> torch.Tensor:
    x, y = batch
    return F.cross_entropy(model(x), y)


def wire_per_step(spec: Optional[str], params: Dict[str, np.ndarray],
                  world: int) -> int:
    """A rank's wire bytes a step: the f32 gradient for no codec, else
    ``wire_payload_bytes`` over the codec's error-feedback buckets (the
    JAX script's accounting)."""
    from horovod_tpu_torch.collectives.compression import (
        parse_compression, wire_payload_bytes)
    from horovod_tpu_torch.optim.distributed import ef_bucket_plan
    leaves = [torch.empty(params[k].shape, device="meta")
              for k in sorted(params)]
    if not spec:
        return sum(t.numel() * 4 for t in leaves)
    comp = parse_compression(spec)
    plan = ef_bucket_plan(leaves, None, comp)
    return sum(wire_payload_bytes(comp, sum(s.size for s in lspecs),
                                  dt.itemsize, world)
               for dt, lspecs in plan.buffers)


def train(spec: Optional[str], args: argparse.Namespace,
          params: Dict[str, np.ndarray]) -> list:
    """``args.steps`` steps of SGD (momentum 0.9) under ``spec``: the
    losses averaged over the ranks, as floats."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.training import make_train_step, shard_batch
    dev = global_state().device
    model = MLP(params, dev)
    sgd = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    if args.zero:
        step = make_train_step(model, loss_fn, sgd, zero_stage=1,
                               zero_compression=spec)
    else:
        opt = hvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(),
            compression=spec)
        step = make_train_step(model, loss_fn, opt,
                               microbatches=args.microbatches)
    centers = class_centers()
    losses = []
    for i in range(args.steps):
        x, y = shard_batch(make_batch(centers, i, args.batch_size))
        loss = step((torch.from_numpy(x).to(dev),
                     torch.from_numpy(y).to(dev)))
        losses.append(float(loss))
    return losses


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=256,
                   help="global batch size (split across ranks)")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--compression", default=None,
                   help="run ONLY this codec (e.g. powersgd:8, topk:0.1) "
                        "instead of the three-way comparison")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 path: compress the param-delta allgather "
                        "leg, residuals on the shard owner")
    p.add_argument("--microbatches", type=int, default=1,
                   help="k>1: accumulate k microbatch gradients locally, "
                        "ONE compressed exchange per step")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         params: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """Train under each codec; returns ``{codec name: {"losses",
    "wire"}}`` (``"uncompressed"`` for no codec).  ``params`` replaces
    :func:`init_params`'s initial values."""
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    hvd.init(device=args.device)
    n = hvd.size()
    if hvd.rank() == 0:
        print(f"ranks: {n} ({global_state().device})", flush=True)
    params = init_params() if params is None else params
    specs = [args.compression] if args.compression else list(CODECS)
    results = {}
    for spec in specs:
        results[spec or "uncompressed"] = {
            "losses": train(spec, args, params),
            "wire": wire_per_step(spec, params, n)}
    if hvd.rank() == 0:
        base_wire = wire_per_step(None, params, n)
        print(f"\n{'codec':<14} {'wire/step':>12} {'ratio':>7} "
              f"{'loss@0':>8} {'loss@end':>9}")
        for name, r in results.items():
            losses, wire = r["losses"], r["wire"]
            print(f"{name:<14} {wire:>10} B {base_wire / wire:>6.1f}x "
                  f"{losses[0]:>8.4f} {losses[-1]:>9.4f}")
        print("\n(error feedback keeps the compressed trajectories "
              "tracking the exact one; try --microbatches 2 or --zero "
              "to see the composed paths)", flush=True)
    return results


if __name__ == "__main__":
    main()
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    sys.exit(0)
