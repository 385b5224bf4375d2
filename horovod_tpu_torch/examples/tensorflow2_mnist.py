"""TensorFlow-2 MNIST through the port's ``horovod.tensorflow`` shim (the
port of ``examples/tensorflow2_mnist.py``).

The reference's TF2 user experience -- ``import
horovod_tpu_torch.tensorflow as hvd``, a ``DistributedGradientTape``
training loop, ``broadcast_variables`` after the first step, the LR
scaled by the world size -- with the gradient allreduce on the port's op
layer (gloo on the CPU).  Synthetic MNIST (numpy-seeded gaussian class
centres, rank-seeded batches) keeps it dataset-free; ``--seed`` seeds
Keras's initializers.  TensorFlow runs on the host: the script needs the
``tensorflow`` and ``keras`` packages.  Run::

    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.tensorflow2_mnist

Each rank prints ``avg final loss ... OK``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=None,
                   help="seed Keras's initializers (keras.utils."
                        "set_random_seed)")
    p.add_argument("--device", default=None,
                   help="where the collectives run: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Train; returns the per-step losses of this rank."""
    args = parse_args(argv)
    import keras
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init(device=args.device)
    rank = hvd.rank()
    if args.seed is not None:
        keras.utils.set_random_seed(args.seed)

    model = keras.Sequential([
        keras.Input((28, 28, 1)),
        keras.layers.Conv2D(6, 5, activation="relu"),
        keras.layers.MaxPooling2D(),
        keras.layers.Conv2D(16, 5, activation="relu"),
        keras.layers.MaxPooling2D(),
        keras.layers.Flatten(),
        keras.layers.Dense(120, activation="relu"),
        keras.layers.Dense(84, activation="relu"),
        keras.layers.Dense(10),
    ])
    # Reference recipe: scale the LR by the world size for the larger
    # effective batch.
    opt = keras.optimizers.SGD(args.lr * hvd.size(), momentum=0.9)
    loss_fn = keras.losses.SparseCategoricalCrossentropy(from_logits=True)

    rng = np.random.RandomState(1)
    centers = rng.randn(10, 28 * 28).astype(np.float32)

    def make_batch(step):
        r = np.random.RandomState(1000 * step + rank)
        y = r.randint(0, 10, size=args.batch_size)
        x = centers[y] + 0.5 * r.randn(args.batch_size, 28 * 28)
        return (tf.constant(x.astype(np.float32).reshape(-1, 28, 28, 1)),
                tf.constant(y.astype(np.int64)))

    losses = []
    for step in range(args.steps):
        x, y = make_batch(step)
        with tf.GradientTape() as tape:
            loss = loss_fn(y, model(x, training=True))
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if step == 0:
            # After the first apply, so the optimizer's slots exist
            # everywhere.
            hvd.broadcast_variables(model.variables, root_rank=0)
            hvd.broadcast_variables(opt.variables, root_rank=0)
        losses.append(float(loss))
        if step % 10 == 0 and rank == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}", flush=True)

    if rank == 0:
        print(f"final loss {losses[-1]:.4f}", flush=True)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    # Global metric averaging across the ranks (the reference's eval
    # idiom).
    avg = float(hvd.allreduce(tf.constant(losses[-1]), name="final_loss"))
    print(f"rank {rank}: avg final loss {avg:.4f} OK", flush=True)
    hvd.shutdown()
    return losses


if __name__ == "__main__":
    main()
    sys.exit(0)
