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

The matmul model learns a seeded linear map (the same batch on every
rank, so the trajectory does not depend on the world size).

The silent-data-corruption drill runs under ``HOROVOD_CHAOS``'s
corruption kinds: a ``nan`` fault wedges the victim rank's input (every
batch NaN-poisoned from then on, until the elastic loop rolls back: the
replay reads healed data), so under ``HOROVOD_GUARD`` the steps are
skipped until ``HOROVOD_GUARD_STREAK`` raises ``SustainedAnomalyError``
and the snapshot ledger rolls back; a ``bitflip`` fault flips one bit of
the victim's parameter replica right after the commit it fires at
(``core.desync.corrupt_replica``), which the tripwire
(``HOROVOD_DESYNC_CHECK_STEPS``) attributes, so the victim leaves and the
others continue without it.

Each batch prints ``rank r/n batch b loss L step_ms t``; the end prints
``rank r: finished at batch b (final size n)``, ``rank r: elastic
metrics {...}`` (the KV retries, resets, steps rolled back, guard skips,
rollbacks and tripwire trips in this worker, as JSON) and ``rank r:
final loss L checksum c`` (``c`` the tripwire checksum of the model, the
same on every rank whose replica is intact).
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
    from horovod_tpu_torch.core import desync
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.elastic import chaos
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
            torch.optim.SGD([model.w], lr=0.05),
            named_parameters=[("w", model.w)],
            compression=hvd.Compression.none)

        def loss_fn(m, b):
            return torch.mean((b[0] @ m.w - b[1]) ** 2)

        def make_step():
            return make_train_step(model, loss_fn, opt)

        batch = matmul_batch(per_rank, dev)

    sig_at = int(os.environ.get("ELASTIC_SELF_SIGTERM_AT", "0"))
    sig_host = os.environ.get("ELASTIC_SIGTERM_HOST", "")
    wid = os.environ.get("HVD_TPU_ELASTIC_WORKER_ID", "")

    wedged = [False]

    @elastic.run
    def train(state):
        step = make_step()             # binds the current process group
        wedged[0] = False              # a rolled-back replay reads healed data
        while state.batch < target:
            n = hvd.size()
            victim = chaos.consume_nan_poison()
            if victim is not None and victim == hvd.rank():
                wedged[0] = True
            use = chaos.poison_batch(batch) if wedged[0] else batch
            t0 = time.perf_counter()
            loss = float(step(use))    # reading the loss synchronizes
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
            victim = chaos.consume_bitflip()
            if victim is not None and victim < n:
                desync.corrupt_replica(desync.module_tree(model)["params"],
                                       victim)
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
            "horovod_elastic_steps_to_recover").value,
        "guard_skipped": reg.counter("horovod_guard_skipped_total").value,
        "guard_rollbacks": reg.counter(
            "horovod_guard_rollbacks_total").value,
        "tripwire_trips": reg.counter(
            "horovod_guard_tripwire_trips_total").value}), flush=True)
    if model_name != "resnet50":
        with torch.no_grad():
            final = float(loss_fn(model, batch))
        print(f"rank {hvd.rank()}: final loss {final!r} checksum "
              f"{desync.local_checksum(desync.module_tree(model))}",
              flush=True)
    return 0


def matmul_batch(per_rank: int, device) -> tuple:
    """The matmul model's batch: ``x`` from a fixed seed and ``y = x @
    w_true``, the same on every rank."""
    gen = torch.Generator().manual_seed(0)
    w_true = torch.randn(4, 4, generator=gen)
    x = torch.randn(per_rank, 4, generator=gen)
    return x.to(device), (x @ w_true).to(device)


if __name__ == "__main__":
    sys.exit(main())
