"""Cross-replica batch normalization for the TF/Keras shim.

The port's counterpart of ``horovod_tpu/tensorflow/sync_batch_norm.py``.
Parity with ``horovod/tensorflow/sync_batch_norm.py::SyncBatchNormalization``:
a drop-in ``keras.layers.BatchNormalization`` whose training-time batch
statistics are averaged across every rank (of the optional process set),
so normalization behaves as if the global batch were on one device.

Math: allreduce-average E[x] and E[x^2] over the replicas and derive
``var = E[x^2] - E[x]^2`` (equal per-rank batch sizes, the same
assumption the reference makes for its group mean/variance).
"""

from __future__ import annotations

import tensorflow as tf
import keras


class SyncBatchNormalization(keras.layers.BatchNormalization):
    """``keras.layers.BatchNormalization`` with cross-rank statistics."""

    def __init__(self, *args, process_set=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._hvd_process_set = process_set

    def get_config(self):
        # Serialize the process set by NAME (registered sets are looked up
        # again at from_config time), so clone_model / to_json round-trips
        # keep reducing over the right group instead of silently falling
        # back to the global set.
        config = super().get_config()
        ps = self._hvd_process_set
        if ps is not None:
            config["process_set"] = ps if isinstance(ps, str) else ps.name
        return config

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        ps_name = config.pop("process_set", None)
        if ps_name is not None:
            from ..core.process_sets import get_process_set
            config["process_set"] = get_process_set(ps_name)
        return cls(**config)

    def _moments(self, inputs, mask):
        from . import grouped_allreduce, Average, size

        mean, variance = super()._moments(inputs, mask)
        if size() == 1:
            return mean, variance
        process_set = self._hvd_process_set

        @tf.custom_gradient
        def _cross_replica_avg(m, msq):
            gm, gmsq = grouped_allreduce(
                [m, msq], op=Average, name="sync_bn",
                process_set=process_set)

            def grad(dm, dmsq):
                # Every rank's output depends on every rank's local stats
                # through the average; under SPMD the adjoint is the same
                # average applied to the upstream gradients.
                return grouped_allreduce([dm, dmsq], op=Average,
                                         name="sync_bn_bwd",
                                         process_set=process_set)

            return (gm, gmsq), grad

        mean_sq = variance + tf.square(mean)
        g_mean, g_mean_sq = _cross_replica_avg(mean, mean_sq)
        return g_mean, g_mean_sq - tf.square(g_mean)


SyncBatchNorm = SyncBatchNormalization
