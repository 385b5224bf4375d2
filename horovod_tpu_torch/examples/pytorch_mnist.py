"""Horovod's PyTorch MNIST example on the port (BASELINE.json config 1).

The JAX repository's ``examples/pytorch_mnist.py`` with the port's import
(``import horovod_tpu_torch as hvd``) and a ``--device`` argument: the
same LeNet ``Net``, ``SGD(0.05, momentum 0.9)`` wrapped in
``hvd.DistributedOptimizer`` with fp16 compression, rank 0's weights and
optimizer state broadcast to every rank, rank-seeded synthetic batches of
64 (gaussian class centers, no dataset download), the loss averaged over
the ranks with ``hvd.allreduce(loss.detach(), name="loss")``, and the
final-loss check (the last loss below 0.7 of the first).

Run::

    python -m horovod_tpu_torch.examples.pytorch_mnist --device cpu
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.examples.pytorch_mnist
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(256, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, 10)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.flatten(1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


def class_centers() -> np.ndarray:
    return np.random.RandomState(1).randn(10, 28 * 28).astype(np.float32)


def synthetic_batch(centers: np.ndarray, step: int, rank: int,
                    batch_size: int):
    """Rank ``rank``'s batch of step ``step`` (each rank sees its own
    shard): ``(images [b, 1, 28, 28] f32, labels [b] int64)`` as numpy."""
    r = np.random.RandomState(1000 * step + rank)
    y = r.randint(0, 10, size=batch_size)
    x = centers[y] + 0.5 * r.randn(batch_size, 28 * 28)
    return (x.astype(np.float32).reshape(-1, 1, 28, 28),
            y.astype(np.int64))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--backward-passes-per-step", type=int, default=1)
    p.add_argument("--compression", choices=("fp16", "none"),
                   default="fp16")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> SimpleNamespace:
    """The training loop: returns the per-step losses averaged over the
    ranks (``losses``), the model and each step's seconds (``step_s``,
    host clock; the loss's ``float()`` waits for the device)."""
    hvd.init(device=args.device)
    dev = torch.device(args.device) if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    torch.manual_seed(42)
    rank = hvd.rank()

    model = Net().to(dev)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    compression = {"fp16": hvd.Compression.fp16,
                   "none": hvd.Compression.none}[args.compression]
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression,
        backward_passes_per_step=args.backward_passes_per_step)

    # Rank 0's initial weights everywhere (reference idiom).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    centers = class_centers()

    def make_batch(step):
        x, y = synthetic_batch(centers, step, rank, args.batch_size)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    losses, times = [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        optimizer.zero_grad()
        # With backward_passes_per_step > 1, the first N-1 backwards
        # accumulate locally; only the Nth triggers the fused allreduce.
        for i in range(args.backward_passes_per_step):
            x, y = make_batch(args.backward_passes_per_step * step + i)
            loss = F.cross_entropy(model(x), y)
            loss.backward()
        optimizer.step()
        # Average the reported loss across ranks (metric allreduce).
        avg = hvd.allreduce(loss.detach(), name="loss")
        losses.append(float(avg))
        times.append(time.perf_counter() - t0)
        if rank == 0 and step % 10 == 0:
            print(f"step {step:3d} loss {losses[-1]:.4f}", flush=True)

    if rank == 0:
        print(f"final loss {losses[-1]:.4f}", flush=True)
    return SimpleNamespace(losses=losses, model=model, step_s=times)


def main(argv: Optional[Sequence[str]] = None) -> SimpleNamespace:
    """Train, then check that the last loss fell below 0.7 of the first;
    returns what :func:`train` does."""
    run = train(parse_args(argv))
    if not run.losses[-1] < run.losses[0] * 0.7:
        raise AssertionError(f"loss did not fall: {run.losses[0]} -> "
                             f"{run.losses[-1]}")
    return run


if __name__ == "__main__":
    main()
    hvd.shutdown()
