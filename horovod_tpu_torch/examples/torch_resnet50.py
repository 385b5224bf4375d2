"""ResNet-50 in the ``horovod.torch`` idiom on the port (BASELINE.json
config 2, the torch half).

The JAX repository's ``examples/torch_resnet50.py`` at full width, with
the port's import and ``--device``: a standard bottleneck ResNet-50
(7 x 7 stem, 1000 classes; 25,557,032 parameters in 161 tensors) as NCHW
module code run ``channels_last``, its 53 BatchNorm sites
``hvd.SyncBatchNorm(process_set=ps)`` (``--no-sync-bn``:
``nn.BatchNorm2d``), bf16 autocast over f32 parameters, 224 x 224
images in batches of 256 from a rank-seeded generator, rank 0's weights
broadcast, and ``hvd.DistributedOptimizer(SGD(0.1, momentum 0.9),
named_parameters, compression=fp16, process_set=ps)``.

``ps`` is a process set of every rank, registered by every rank as
process sets require.  On the card the sync layers' backward runs the BN
backward kernels on the channels-last ``[rows, C]`` view.

Run::

    python -m horovod_tpu_torch.examples.torch_resnet50
    python -m horovod_tpu_torch.examples.torch_resnet50 --device cpu \\
        --image-size 64 --batch-size 4 --steps 2
"""

from __future__ import annotations

import argparse
import math
import time
from types import SimpleNamespace
from typing import Callable, Optional, Sequence

import torch
from torch import nn

import horovod_tpu_torch as hvd

RESNET50_BN_SITES = 53


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int,
                 norm: Callable[[int], nn.Module]):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = norm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = norm(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = norm(cout)
        self.relu = nn.ReLU(inplace=True)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), norm(cout))

    def forward(self, x):
        r = x if self.down is None else self.down(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + r)


class ResNet50(nn.Module):
    """Standard ImageNet ResNet-50 (He et al. 2015); ``norm(c)`` makes
    each of the 53 BatchNorm layers."""

    def __init__(self, num_classes: int = 1000,
                 norm: Callable[[int], nn.Module] = nn.BatchNorm2d):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), norm(64),
            nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1))
        layers, cin = [], 64
        for width, blocks, stride in ((64, 3, 1), (128, 4, 2),
                                      (256, 6, 2), (512, 3, 2)):
            for b in range(blocks):
                layers.append(Bottleneck(cin, width, stride if b == 0 else 1,
                                         norm))
                cin = width * Bottleneck.expansion
        self.body = nn.Sequential(*layers)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x):
        y = self.body(self.stem(x))
        y = torch.flatten(nn.functional.adaptive_avg_pool2d(y, 1), 1)
        return self.head(y)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256,
                   help="per-rank batch size")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--compression", choices=("fp16", "bf16", "none"),
                   default="fp16")
    p.add_argument("--no-sync-bn", action="store_true",
                   help="nn.BatchNorm2d instead of hvd.SyncBatchNorm")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def setup(args: argparse.Namespace) -> SimpleNamespace:
    """``init`` -> the model -> ``broadcast_parameters`` ->
    ``DistributedOptimizer``; the step and this rank's batch."""
    hvd.init(device=args.device)
    dev = torch.device(args.device) if args.device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    ps = hvd.add_process_set(range(hvd.size()))
    if args.no_sync_bn:
        def norm(c):
            return nn.BatchNorm2d(c, device=dev)
    else:
        def norm(c):
            return hvd.SyncBatchNorm(c, process_set=ps, device=dev)
    torch.manual_seed(1234)  # identical init everywhere; broadcast verifies
    model = ResNet50(args.classes, norm).to(
        dev, memory_format=torch.channels_last)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    compression = {"none": hvd.Compression.none,
                   "fp16": hvd.Compression.fp16,
                   "bf16": hvd.Compression.bf16}[args.compression]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=compression, process_set=ps)
    hvd.broadcast_optimizer_state(opt, root_rank=0, process_set=ps)
    loss_fn = nn.CrossEntropyLoss()

    g = torch.Generator(device=dev).manual_seed(hvd.rank())
    x = torch.randn(args.batch_size, 3, args.image_size, args.image_size,
                    generator=g, device=dev).contiguous(
                        memory_format=torch.channels_last)
    y = torch.randint(0, args.classes, (args.batch_size,), generator=g,
                      device=dev)

    def step() -> torch.Tensor:
        opt.zero_grad()
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    return SimpleNamespace(model=model, optimizer=opt, step=step,
                           batch=(x, y), process_set=ps, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train ``--steps`` steps; the losses and the step times."""
    args = parse_args(argv)
    bench = setup(args)
    losses, times = [], []
    for _ in range(args.steps):
        t = time.perf_counter()
        losses.append(float(bench.step()))   # float() waits for the device
        times.append(time.perf_counter() - t)
    imgs = args.batch_size * hvd.size()
    if hvd.rank() == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if len(times) > 1:
            mean = sum(times[1:]) / (len(times) - 1)
            print(f"{imgs / mean:.1f} images/s total after the first step "
                  f"(size {hvd.size()}, {bench.device})")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    return {"losses": losses, "step_s": times}


if __name__ == "__main__":
    main()
    hvd.shutdown()
