"""Synthetic-data throughput benchmark (Horovod's
``pytorch_synthetic_benchmark.py``; counterpart of
``examples/synthetic_benchmark.py``).

Images/s for a model of the zoo on random images and labels made on the
device from a seed, through the port's full data-parallel path:
``init`` -> ``broadcast_parameters`` -> ``DistributedOptimizer(SGD(0.01,
momentum 0.9))`` (fused, optionally compressed allreduce buckets) ->
``make_flax_train_step`` (bf16 compute, BN running statistics averaged
over the ranks)::

    python3 -m horovod_tpu_torch.synthetic_benchmark --model inception_v3
    python3 -m horovod_tpu_torch.synthetic_benchmark --model vgg16 \\
        --device cpu --image-size 32 --batch-size 8 --num-iters 3

The defaults are the JAX script's: a per-chip batch of 32, 3 warm-up and
10 timed iterations, bf16, 1000 classes, dropout 0.  ``--device cpu``
runs on the CPU (a gloo world); the default is the GPU, and with no GPU
it raises.  Differences from the JAX script: ``--cpu-devices`` (a virtual
XLA mesh) is ``--device cpu``; LeNet's labels are drawn from its own 10
classes (the JAX script draws them from ``--num-classes``, which
``optax`` takes as all-zero targets past the logits and torch refuses).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

MODELS = ("lenet", "resnet50", "resnet101", "vgg16", "vgg19",
          "inception_v3")


def default_image_size(name: str) -> int:
    return {"lenet": 28, "inception_v3": 299}.get(name, 224)


def build_model(name: str, num_classes: int, dtype: torch.dtype,
                image_size: int, device) -> torch.nn.Module:
    """The zoo's ``name`` at ``num_classes`` and ``dtype`` (LeNet: f32,
    10 classes), dropout 0, for ``image_size`` x ``image_size`` input."""
    from . import models as zoo
    kw = dict(num_classes=num_classes, dtype=dtype, device=device)
    if name == "lenet":
        return zoo.LeNet(device=device)
    if name == "resnet50":
        return zoo.ResNet50(**kw)
    if name == "resnet101":
        return zoo.ResNet101(**kw)
    if name in ("vgg16", "vgg19"):
        cls = zoo.VGG16 if name == "vgg16" else zoo.VGG19
        return cls(dropout_rate=0.0, image_size=image_size, **kw)
    if name == "inception_v3":
        return zoo.InceptionV3(dropout_rate=0.0, image_size=image_size,
                               **kw)
    raise ValueError(f"unknown model {name!r}; choose from {MODELS}")


@dataclasses.dataclass
class Bench:
    """What :func:`setup` built: ``step(batch) -> loss`` and its batch."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: Callable
    batch: tuple
    image_size: int


def setup(model_name: str, *, batch_size: int = 32,
          image_size: Optional[int] = None, num_classes: int = 1000,
          fp32: bool = False, compression: str = "none",
          seed: int = 0) -> Bench:
    """The benchmark's model, optimizer, step and this rank's batch, on
    the device :func:`~horovod_tpu_torch.init` chose (call it first)."""
    from . import (DistributedOptimizer, broadcast_optimizer_state,
                   broadcast_parameters, rank)
    from .core.state import global_state
    from .models import init_params
    from .training import make_flax_train_step

    dev = global_state().device
    dtype = torch.float32 if fp32 else torch.bfloat16
    size = image_size or default_image_size(model_name)
    model = build_model(model_name, num_classes, dtype, size, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.load_state_dict(init_params(model, generator=gen))
    named = list(model.named_parameters())
    broadcast_parameters(model.state_dict(), root_rank=0)
    opt = DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.01, momentum=0.9),
        named_parameters=named, compression=compression)
    broadcast_optimizer_state(opt, root_rank=0)
    chans = 1 if model_name == "lenet" else 3
    classes = 10 if model_name == "lenet" else num_classes
    gen.manual_seed(seed + 1 + rank())
    x = torch.randn(batch_size, size, size, chans, generator=gen,
                    device=dev).to(dtype)
    y = torch.randint(0, classes, (batch_size,), generator=gen, device=dev)
    return Bench(model, opt, make_flax_train_step(model, opt), (x, y), size)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="resnet50", choices=MODELS)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-chip batch size")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--num-iters", type=int, default=10,
                    help="timed batches per measurement")
    ap.add_argument("--num-warmup", type=int, default=3)
    ap.add_argument("--fp32", action="store_true",
                    help="float32 compute instead of bfloat16")
    ap.add_argument("--compression", default="none",
                    choices=["none", "fp16", "bf16", "fp8"],
                    help="gradient wire codec for the fused allreduce")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.num_iters < 1:
        ap.error("--num-iters must be at least 1")

    from . import init, rank, size
    init(device=args.device)
    n = size()
    bench = setup(args.model, batch_size=args.batch_size,
                  image_size=args.image_size, num_classes=args.num_classes,
                  fp32=args.fp32, compression=args.compression)
    global_batch = args.batch_size * n
    if rank() == 0:
        print(f"model: {args.model}  devices: {n}  global batch: "
              f"{global_batch}  image: {bench.image_size}", flush=True)
    loss = None
    for _ in range(args.num_warmup):
        loss = bench.step(bench.batch)
    if loss is not None:
        loss.item()             # the host waits for the device
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        loss = bench.step(bench.batch)
    last = loss.item()
    dt = time.perf_counter() - t0
    ips = args.num_iters * global_batch / dt
    if rank() == 0:
        print(f"{args.num_iters} iters in {dt:.2f}s -> {ips:.1f} images/s "
              f"total, {ips / n:.1f} images/s/chip", flush=True)
    return {"model": args.model, "devices": n, "global_batch": global_batch,
            "seconds": dt, "images_per_s": ips, "loss": last}


if __name__ == "__main__":
    main()
