"""``horovod_tpu_torch.keras.callbacks``: the reference's callbacks namespace
(``horovod/_keras/callbacks.py`` surface; upstream examples use
``hvd.callbacks.BroadcastGlobalVariablesCallback``)."""

from . import (  # noqa: F401
    BroadcastGlobalVariablesCallback, MetricAverageCallback,
    LearningRateWarmupCallback, LearningRateScheduleCallback,
)
