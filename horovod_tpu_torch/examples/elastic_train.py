"""Elastic training demo and integration workload (the port of
``examples/elastic_train.py``).

Counts "batches" with a tiny matmul train step (or, with
``ELASTIC_MODEL=resnet50``, BASELINE's "Elastic ResNet-50" workload: the
port's flax-layout ResNet-50 behind the same protocol), committing every
batch; survives a rescale (``HostsUpdatedInterrupt``) and a peer failure
(rollback).  Run under the elastic launcher::

    python -m horovod_tpu_torch.run --host-discovery-script d.sh \\
        --min-np 1 python -m horovod_tpu_torch.examples.elastic_train

Knobs (the JAX example's): ``ELASTIC_TARGET_BATCHES`` (20),
``ELASTIC_BATCH_DELAY_S`` (0.2), ``ELASTIC_MODEL=matmul|resnet50``,
``ELASTIC_IMAGE_SIZE`` (64), and the preemption drill's
``ELASTIC_SELF_SIGTERM_AT`` / ``ELASTIC_SIGTERM_HOST`` (the worker on that
host SIGTERMs itself after that batch).  ``ELASTIC_BATCH`` (2) is each
rank's batch.  The worker runs on ``cuda`` (ResNet-50 in bf16) unless
``HVD_TPU_FORCE_CPU`` is set (the launcher's ``--cpu``; f32).

Each batch prints ``rank r/n batch b loss L step_ms t``; the end prints
``rank r: finished at batch b (final size n)`` and then ``rank r: elastic
metrics {...}`` (the KV retries, resets and steps rolled back in this
worker, as JSON).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import torch


def main() -> int:
    target = int(os.environ.get("ELASTIC_TARGET_BATCHES", "20"))
    delay = float(os.environ.get("ELASTIC_BATCH_DELAY_S", "0.2"))
    model_name = os.environ.get("ELASTIC_MODEL", "matmul")
    image_size = int(os.environ.get("ELASTIC_IMAGE_SIZE", "64"))
    per_rank = int(os.environ.get("ELASTIC_BATCH", "2"))

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.training import (make_flax_train_step,
                                            make_train_step)

    hvd.init()
    dev = global_state().device

    # The model, optimizer and data are world-size independent and built
    # once; the STEP is rebuilt at every train() entry, because the
    # exchange it runs binds the process group a re-init replaces.
    if model_name == "resnet50":
        from horovod_tpu_torch.models import ResNet50, init_resnet_params
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = ResNet50(num_classes=100, dtype=dtype, device=dev)
        model.load_state_dict(init_resnet_params(
            model, generator=torch.Generator(device=dev).manual_seed(0)))
        named = list(model.named_parameters())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.01, momentum=0.9),
            named_parameters=named, compression=hvd.Compression.none)

        def make_step():
            return make_flax_train_step(model, opt)

        batch = (torch.ones(per_rank, image_size, image_size, 3,
                            device=dev, dtype=dtype),
                 torch.zeros(per_rank, dtype=torch.long, device=dev))
    else:
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.zeros(4, 4, device=dev))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([model.w], lr=0.01),
            named_parameters=[("w", model.w)],
            compression=hvd.Compression.none)

        def loss_fn(m, b):
            return torch.mean((b[0] @ m.w - b[1]) ** 2)

        def make_step():
            return make_train_step(model, loss_fn, opt)

        batch = (torch.ones(per_rank, 4, device=dev),
                 torch.zeros(per_rank, 4, device=dev))

    sig_at = int(os.environ.get("ELASTIC_SELF_SIGTERM_AT", "0"))
    sig_host = os.environ.get("ELASTIC_SIGTERM_HOST", "")
    wid = os.environ.get("HVD_TPU_ELASTIC_WORKER_ID", "")

    @elastic.run
    def train(state):
        step = make_step()             # binds the current process group
        while state.batch < target:
            n = hvd.size()
            t0 = time.perf_counter()
            loss = float(step(batch))  # reading the loss synchronizes
            ms = 1e3 * (time.perf_counter() - t0)
            state.batch += 1
            print(f"rank {hvd.rank()}/{n} batch {state.batch} "
                  f"loss {loss:.4f} step_ms {ms:.3f}", flush=True)
            # Preemption drill: a real SIGTERM to this worker at the given
            # batch (what a cloud preemption notice does).
            if sig_at and state.batch == sig_at and sig_host and \
                    wid.split(":")[0] == sig_host:
                os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(delay)
            state.commit()
        return state.batch

    state = elastic.TorchState(model=model, optimizer=opt, batch=0)
    done = train(state)
    print(f"rank {hvd.rank()}: finished at batch {done} "
          f"(final size {hvd.size()})", flush=True)
    from horovod_tpu_torch.timeline import metrics
    reg = metrics.registry()
    print(f"rank {hvd.rank()}: elastic metrics " + json.dumps({
        "kv_retries": reg.counter("horovod_kv_retries_total").value,
        "resets": reg.counter("horovod_elastic_reset_total").value,
        "steps_to_recover": reg.gauge(
            "horovod_elastic_steps_to_recover").value}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
