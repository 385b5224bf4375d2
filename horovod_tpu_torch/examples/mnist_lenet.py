"""Data-parallel LeNet on (synthetic) MNIST -- the minimum end-to-end slice
(the port of ``examples/mnist_lenet.py``).

The port's :class:`~horovod_tpu_torch.models.LeNet` (NHWC, flax's layout)
through :func:`~horovod_tpu_torch.training.make_flax_train_step` with a
``DistributedOptimizer(SGD(lr, momentum 0.9))``: each rank takes its
share of the global batch, the optimizer allreduces the gradients in
fused buckets.  The data is the JAX script's (numpy ``RandomState(42)``
class centres, ``RandomState(step)`` batches); :func:`main` takes the
JAX script's parameter tree (``{"c1": {"w", "b"}, ..., "f3": ...}``, HWIO
convolution kernels, as numpy) in place of the port's own initializer.
``--compare-single-device`` trains the same model again with a bare
``SGD`` and no framework and compares the loss curves.

Run::

    python -m horovod_tpu_torch.examples.mnist_lenet --device cpu \\
        [--steps 60] [--compare-single-device]
    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.mnist_lenet

Without ``--device cpu`` (or the launcher's ``--cpu``) it runs on
``cuda``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# The JAX script's parameter names -> the flax LeNet's modules.
_JAX_NAMES = {"c1": "Conv_0", "c2": "Conv_1", "f1": "Dense_0",
              "f2": "Dense_1", "f3": "Dense_2"}


def class_centers() -> np.ndarray:
    return np.random.RandomState(42).randn(10, 28 * 28).astype(np.float32)


def make_batch(centers: np.ndarray, step: int, batch_size: int):
    """Global batch ``step``: NHWC images ``[b, 28, 28, 1]`` f32 and int
    labels, as numpy."""
    r = np.random.RandomState(step)
    y = r.randint(0, 10, size=batch_size)
    x = centers[y] + 0.5 * r.randn(batch_size, 28 * 28)
    return x.astype(np.float32).reshape(-1, 28, 28, 1), y.astype(np.int64)


def state_from_script_params(params: Dict[str, dict], device
                             ) -> Dict[str, torch.Tensor]:
    """The JAX script's ``{"c1": {"w", "b"}, ...}`` tree (numpy) -> the
    port LeNet's ``state_dict``."""
    from horovod_tpu_torch.models import flax_state_from_jax
    tree = {_JAX_NAMES[k]: {"kernel": np.asarray(v["w"]),
                            "bias": np.asarray(v["b"])}
            for k, v in params.items()}
    return flax_state_from_jax({"params": tree}, device=device)


def build_model(device, params: Optional[Dict[str, dict]] = None):
    """LeNet on ``device`` with the script's ``params`` or, without them,
    the port's initializer from seed 0."""
    from horovod_tpu_torch.models import LeNet
    from horovod_tpu_torch.models.layers import init_params
    model = LeNet(device=device)
    if params is not None:
        model.load_state_dict(state_from_script_params(params, device))
    else:
        model.load_state_dict(init_params(
            model, generator=torch.Generator(device=device).manual_seed(0)))
    return model


def train(args: argparse.Namespace, params, world: bool):
    """``(losses, seconds)``: through the framework's step when ``world``,
    else a bare SGD step on this process alone (the whole batch)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.training import (make_flax_train_step,
                                            shard_batch, softmax_xent)
    dev = global_state().device
    model = build_model(dev, params)
    sgd = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    if world:
        opt = hvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        step = make_flax_train_step(model, opt)
    else:
        def step(batch):
            x, y = batch
            sgd.zero_grad()
            loss = softmax_xent(model(x), y)
            loss.backward()
            sgd.step()
            return loss.detach()

    centers = class_centers()
    losses = []
    t0 = time.perf_counter()
    for s in range(args.steps):
        batch = make_batch(centers, s, args.batch_size)
        if world:
            batch = shard_batch(batch)
        x, y = (torch.from_numpy(a).to(dev) for a in batch)
        losses.append(float(step((x, y))))
        if world and hvd.rank() == 0 and s % 10 == 0:
            print(f"step {s:4d}  loss {losses[-1]:.4f}", flush=True)
    return losses, time.perf_counter() - t0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=256,
                   help="global batch size (split across ranks)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--compare-single-device", action="store_true",
                   help="also train single-device and compare losses")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         params: Optional[Dict[str, dict]] = None) -> dict:
    """Train (and compare); returns ``losses`` and, with
    ``--compare-single-device``, ``ref_losses`` and ``diff``."""
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    hvd.init(device=args.device)
    if hvd.rank() == 0:
        print(f"ranks: {hvd.size()} ({global_state().device})", flush=True)
    losses, dt = train(args, params, world=True)
    out = {"losses": losses}
    if hvd.rank() == 0:
        ips = args.steps * args.batch_size / dt
        print(f"final loss {losses[-1]:.4f}  ({ips:,.0f} images/s incl. "
              f"host data gen)", flush=True)
        assert losses[-1] < losses[0] * 0.5, "did not converge"
    if args.compare_single_device:
        ref, _ = train(args, params, world=False)
        diff = max(abs(a - b) for a, b in zip(losses, ref))
        print(f"max |distributed - single-device| loss diff over "
              f"{args.steps} steps: {diff:.3e}", flush=True)
        assert diff < 5e-2, "distributed training diverged from reference"
        print("PARITY OK", flush=True)
        out.update(ref_losses=ref, diff=diff)
    return out


if __name__ == "__main__":
    main()
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    sys.exit(0)
