"""``horovod_tpu_torch.spark``: Spark cluster integration (reference
``horovod/spark/`` parity surface).

The port's counterpart of ``horovod_tpu/spark``.  ``run(fn)`` executes
``fn`` once per worker inside a Spark barrier-mode stage, with the
``HOROVOD_*`` identity env and the rendezvous address injected exactly
like ``horovod_tpu_torch.run`` does for local workers (the reference's
``horovod.spark.run`` + ``gloo_run`` path).  PySpark is an optional
dependency: importing this package works without it; calling :func:`run`
raises with guidance.

The :class:`~horovod_tpu_torch.spark.store.LocalStore` / ``Store``
abstraction (checkpoint + intermediate-data layout used by the
estimators) is dependency-free and fully functional, and so are the
estimators (:mod:`.estimator`): they run their workers through the
local executor unless ``backend="spark"``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

from ..run.launch import free_port, worker_env
from .store import LocalStore, Store  # noqa: F401
from .estimator import (  # noqa: F401
    EstimatorParams, JaxEstimator, JaxModel, KerasEstimator, KerasModel,
    LightningEstimator, TorchEstimator, TorchModel,
)


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark.run() requires pyspark, which is not "
            "installed in this environment. Install pyspark (or launch "
            "workers directly with `python -m horovod_tpu_torch.run -np N "
            "...`).") from e


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        num_proc: Optional[int] = None, verbose: int = 1) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``num_proc`` Spark barrier tasks.

    Each task exports the env of its barrier partition id as rank; rank
    0's host is the rendezvous address.  Returns the per-rank results,
    rank-ordered.
    """
    pyspark = _require_pyspark()
    kwargs = kwargs or {}
    spark = pyspark.sql.SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    n = num_proc or int(sc.defaultParallelism)

    coordinator_port = free_port()

    def task_fn(iterator):
        from pyspark import BarrierTaskContext
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        infos = ctx.getTaskInfos()
        coordinator = infos[0].address.split(":")[0]
        os.environ.update(task_env(rank, n, coordinator, coordinator_port))
        ctx.barrier()
        yield rank, fn(*args, **kwargs)

    results = (sc.parallelize(range(n), n)
               .barrier()
               .mapPartitions(task_fn)
               .collect())
    return [r for _, r in sorted(results)]


def task_env(rank: int, size: int, coordinator: str, port: int) -> dict:
    """The env a Spark barrier task exports before user code runs
    (:func:`~horovod_tpu_torch.run.launch.worker_env` on the GPU;
    dependency-free so the layout is unit-testable without a cluster)."""
    return worker_env(rank=rank, size=size, coordinator=coordinator,
                      port=port, cpu=False)
