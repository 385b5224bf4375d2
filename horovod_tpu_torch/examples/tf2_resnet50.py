"""ResNet-50 through the port's TensorFlow-2 shim (the port of
``examples/tf2_resnet50.py``; BASELINE.json's "ResNet-50 ImageNet
(horovod.torch and horovod.tensorflow2)", its TF2 half).

The model is ``keras.applications.ResNet50`` (``weights=None``) on
synthetic data, trained in the reference's TF2 idiom:
``DistributedGradientTape`` -> ``apply_gradients`` with
``broadcast_variables`` after the first step; ``--fit`` trains through
``model.fit`` with the port's Keras ``DistributedOptimizer`` and
``BroadcastGlobalVariablesCallback`` instead.  TensorFlow is the
autograd engine on the host; each gradient allreduce goes through numpy
to the port's op layer.  The port's own ResNet-50 path is
``torch_resnet50`` / ``synthetic_benchmark``; this script shows the
unchanged reference API on a real model.  Run::

    python -m horovod_tpu_torch.examples.tf2_resnet50 --device cpu \\
        --image-size 64 --batch-size 2 --steps 2

It prints ``tf2 resnet50 OK`` last.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--fit", action="store_true",
                   help="train via model.fit + DistributedOptimizer "
                        "instead of the DistributedGradientTape loop")
    p.add_argument("--device", default=None,
                   help="where the collectives run: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Train; returns the losses (a step's, or an epoch's with
    ``--fit``)."""
    args = parse_args(argv)
    import keras
    import numpy as np
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init(device=args.device)
    s = args.image_size
    model = keras.applications.ResNet50(
        weights=None, input_shape=(s, s, 3), classes=args.classes)
    rng = np.random.RandomState(hvd.rank())
    x = rng.randn(args.batch_size, s, s, 3).astype(np.float32)
    y = rng.randint(0, args.classes, args.batch_size).astype(np.int64)

    if args.fit:
        import horovod_tpu_torch.keras as khvd
        opt = khvd.DistributedOptimizer(keras.optimizers.SGD(args.lr))
        model.compile(optimizer=opt,
                      loss="sparse_categorical_crossentropy")
        t0 = time.perf_counter()
        hist = model.fit(
            x, y, batch_size=args.batch_size, epochs=args.steps, verbose=0,
            callbacks=[khvd.BroadcastGlobalVariablesCallback(0)])
        dt = time.perf_counter() - t0
        losses = [float(v) for v in hist.history["loss"]]
    else:
        opt = keras.optimizers.SGD(args.lr)
        loss_fn = keras.losses.SparseCategoricalCrossentropy(
            from_logits=False)
        losses = []
        t0 = time.perf_counter()
        for i in range(args.steps):
            with tf.GradientTape() as tape:
                loss = loss_fn(y, model(x, training=True))
            tape = hvd.DistributedGradientTape(tape)
            grads = tape.gradient(loss, model.trainable_variables)
            opt.apply_gradients(zip(grads, model.trainable_variables))
            if i == 0:
                # The reference idiom: broadcast AFTER the first apply so
                # the optimizer's slot variables exist everywhere.
                hvd.broadcast_variables(model.variables, root_rank=0)
                hvd.broadcast_variables(opt.variables, root_rank=0)
            losses.append(float(loss))
        dt = time.perf_counter() - t0

    imgs = args.steps * args.batch_size * hvd.size()
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"{imgs / dt:.1f} images/s total "
          f"({args.steps} steps, size {hvd.size()}, tf2 shim)")
    assert np.isfinite(losses[-1])
    print("tf2 resnet50 OK", flush=True)
    hvd.shutdown()
    return losses


if __name__ == "__main__":
    main()
    sys.exit(0)
