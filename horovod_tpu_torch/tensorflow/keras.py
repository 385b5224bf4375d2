"""``horovod_tpu_torch.tensorflow.keras``: the reference's canonical
``import horovod.tensorflow.keras as hvd`` path, aliasing
:mod:`horovod_tpu_torch.keras` (same DistributedOptimizer + callbacks)."""

from ..keras import *  # noqa: F401,F403
