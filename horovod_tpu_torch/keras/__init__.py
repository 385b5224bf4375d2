"""``horovod_tpu_torch.keras``: Keras-facing API + callbacks.

The port's counterpart of ``horovod_tpu/keras`` (the collectives are the
:mod:`horovod_tpu_torch.tensorflow` shim's).  Reference: ``horovod/keras/`` + ``horovod/_keras/callbacks.py`` --
``DistributedOptimizer`` plus the training callbacks
(``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback``, ``LearningRateScheduleCallback``).
"""

from __future__ import annotations

import keras
import numpy as np

from ..core.basics import (  # noqa: F401
    init, shutdown, is_initialized, size, rank, local_size, local_rank,
    cross_size, cross_rank, nccl_built, mpi_built, gloo_built, tpu_built,
    cuda_built, rocm_built, start_timeline, stop_timeline,
)
from ..collectives.reduce_op import Average, Sum  # noqa: F401
from ..collectives.compression import Compression  # noqa: F401
from ..tensorflow import (  # noqa: F401
    DistributedOptimizer, allreduce, barrier, broadcast, broadcast_variables,
)
from ..training import steps_per_execution  # noqa: F401


def compile_args(**overrides) -> dict:
    """Keras ``model.compile`` kwargs honoring ``HOROVOD_STEPS_PER_EXEC``.

    Keras already owns a steps-per-execution loop
    (``model.compile(steps_per_execution=k)`` drives k steps per
    ``train_function`` call); this helper routes the framework-wide env
    knob into it so keras and the port's
    :func:`horovod_tpu_torch.training.make_train_loop` runner pick up the
    SAME configuration::

        model.compile(optimizer=opt, loss=loss,
                      **hvd.keras.compile_args())

    Explicit ``overrides`` win over the env.
    """
    args = {"steps_per_execution": steps_per_execution()}
    args.update(overrides)
    return args


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast initial model/optimizer state from ``root_rank`` at the
    start of training so all workers begin identical."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, logs=None):
        if self._done:
            return
        broadcast_variables(self.model.weights, self.root_rank)
        if getattr(self.model, "optimizer", None) is not None and \
                getattr(self.model.optimizer, "variables", None):
            broadcast_variables(self.model.optimizer.variables,
                                self.root_rank)
        self._done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average epoch metrics over all workers (rank-0 logs are global)."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        for k, v in list(logs.items()):
            if isinstance(v, (int, float, np.floating)):
                logs[k] = float(np.asarray(
                    allreduce(np.asarray(v, np.float32), name=f"metric.{k}")))


class LearningRateWarmupCallback(keras.callbacks.Callback):
    """Linearly ramp the LR from lr/size to lr over ``warmup_epochs``
    (the reference's large-batch warmup recipe)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: int = 100, verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._step = 0

    def _set_lr(self, lr: float) -> None:
        self.model.optimizer.learning_rate.assign(lr)

    def on_train_batch_begin(self, batch, logs=None):
        total = self.warmup_epochs * self.steps_per_epoch
        if self._step >= total:
            return
        frac = self._step / max(1, total)
        lr = self.initial_lr * (1.0 / size() + frac * (1 - 1.0 / size()))
        self._set_lr(lr)
        self._step += 1


class LearningRateScheduleCallback(keras.callbacks.Callback):
    """Multiply the LR by ``multiplier`` within [start_epoch, end_epoch)."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch=None):
        super().__init__()
        self.initial_lr = initial_lr
        self.multiplier = multiplier if callable(multiplier) else \
            (lambda epoch: multiplier)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_epoch_begin(self, epoch, logs=None):
        if epoch < self.start_epoch or \
                (self.end_epoch is not None and epoch >= self.end_epoch):
            return
        self.model.optimizer.learning_rate.assign(
            self.initial_lr * self.multiplier(epoch))


__all__ = [
    "init", "shutdown", "is_initialized", "size", "rank", "local_size",
    "local_rank", "cross_size", "cross_rank", "nccl_built", "mpi_built",
    "gloo_built", "tpu_built", "cuda_built", "rocm_built",
    "start_timeline", "stop_timeline", "allreduce", "barrier",
    "broadcast", "broadcast_variables", "Average", "Sum", "Compression",
    "DistributedOptimizer", "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback", "LearningRateWarmupCallback",
    "LearningRateScheduleCallback", "callbacks",
    "steps_per_execution", "compile_args",
]

from . import callbacks  # noqa: E402,F401  (hvd.callbacks.* namespace)
