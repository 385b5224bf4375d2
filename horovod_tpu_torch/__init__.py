"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

A second package beside the JAX one, for an NVIDIA H100.  Slices
ported so far:

* serving: requests in, tokens out, through
  :class:`~horovod_tpu_torch.serving.ServingEngine`;
* data-parallel LoRA fine-tuning through Horovod's own hot path:
  :func:`init` -> :func:`DistributedOptimizer` over fused,
  optionally compressed allreduce buckets -> the wrapped optimizer, with
  :func:`~horovod_tpu_torch.training.make_train_step`;
* data-parallel ResNet-50 (and LeNet) training on the same path, with
  :func:`~horovod_tpu_torch.training.make_flax_train_step`, which also
  averages the BatchNorm running statistics over the ranks;
* the compressed exchange ``compression="powersgd:<r>"``
  (``Compression.powersgd(r)``): rank-``r`` PowerSGD factor allreduces
  with the error-feedback residual carried by the optimizer;
* BERT pretraining (MLM + NSP, :func:`~horovod_tpu_torch.training.
  bert_pretrain_loss`) through :func:`DistributedAdasumOptimizer`: each
  fusion bucket, optionally fp16-compressed, combined by Adasum's
  vector-halving, distance-doubling exchange (``op=Adasum``).
* the CNN half of Horovod's headline workloads through the synthetic
  benchmark (``python -m horovod_tpu_torch.synthetic_benchmark``):
  VGG-16/19 and Inception-v3 beside ResNet and LeNet, and synchronized
  BatchNorm -- :func:`~horovod_tpu_torch.training.sync_batch_norm`
  (flax-style, for the port's NHWC models) and :class:`SyncBatchNorm`
  (torch-style) -- whose backward
  sums the BN kernels' first pass over the ranks before the second;
* the ``horovod.torch`` API surface, so a stock Horovod PyTorch script
  runs with ``import horovod_tpu_torch as hvd``: process sets
  (:func:`add_process_set`; every op, the optimizer and
  :class:`SyncBatchNorm` take ``process_set=``), ``reducescatter``,
  ``alltoall`` (with ``splits``), the grouped ops, sparse and object
  collectives, Horovod's keywords (``average=``, ``name=``, ...) and its
  integer handles (``*_async`` -> :func:`synchronize` / :func:`poll`),
  with the ``pytorch_mnist`` and torch-idiom ResNet-50 examples
  (``python -m horovod_tpu_torch.examples.pytorch_mnist``);
* the compressed and sharded exchanges: ``Compression.fp8`` (e4m3 wire,
  f32 accumulation), ``topk:<f>`` error feedback, the two-level
  ``hierarchical_allreduce`` with per-leg ``ici:<c>,dcn:<c>`` codecs
  (``HOROVOD_HIERARCHICAL``), ``chunked_allreduce``
  (``HOROVOD_EXCHANGE_CHUNK_MB``), all in :data:`collective_ops`, and
  ZeRO-1 (``make_flax_train_step(..., zero_stage=1)``,
  :func:`zero_init`, :func:`zero_report`);
* the microbatched backward-overlap exchange
  (``make_flax_train_step(..., microbatches=k)``), the
  steps-per-execution loop (:func:`make_flax_train_loop`, one CUDA graph
  a window on the GPU), the device prefetcher (:class:`DevicePrefetcher`,
  ``stack_steps=k``) and the exchange-plan IR every exchange notes its
  rows from (``controller.fusion.plan_exchange``);
* elastic training (``hvd.elastic``): :class:`~horovod_tpu_torch.elastic.
  TorchState` commit / restore / sync / resize, the ``@hvd.elastic.run``
  rollback loop with an in-process re-init (a new NCCL communicator),
  the launcher and its elastic driver (``python -m horovod_tpu_torch.run``,
  host discovery, heartbeats, the HMAC-signed KV rendezvous), seeded
  chaos injection (``HOROVOD_CHAOS``), the stall inspector, and rank-0
  npz checkpoints (:func:`save_checkpoint`) in the JAX package's format;
* the silent-data-corruption plane: the in-step guard
  (``HOROVOD_GUARD``: a poisoned step is skipped bit for bit, a streak
  rolls the snapshot ledger back), the commit-boundary desync checksums
  (``HOROVOD_CHECK_DESYNC``) and the cross-rank corruption tripwire
  (``HOROVOD_DESYNC_CHECK_STEPS``), which names a corrupt rank for
  quarantine;
* the observability plane: the Chrome-trace timeline
  (``HOROVOD_TIMELINE``, :func:`start_timeline`, ``--timeline-filename``)
  and its merge CLI (``python -m horovod_tpu_torch.timeline --merge
  DIR``), a ``StepReport`` and span summary a step, the straggler
  monitor, the dispatch-gap and overlap monitors, the cross-rank trace
  plane (``HOROVOD_TRACE_SYNC``) and Prometheus ``/metrics``
  (``HOROVOD_METRICS_PORT``);
* the autotuner (``HOROVOD_AUTOTUNE``, ``--autotune``): GP Bayesian
  search over the fusion threshold and the opt-in chunk, codec, ZeRO,
  steps-per-execution and microbatch axes, rank 0 deciding, with a CSV
  log that warm-starts the next run; the launcher's pre-launch probe
  (``--probe``) and ``-np`` from an LSF allocation; and sharded
  checkpoints (:func:`save_checkpoint_sharded`), one npz a rank;
* the eager control plane: :func:`join` (a rank out of data drains --
  it takes part in the others' collectives with identity payloads until
  every rank has joined, then every rank gets the last rank to join; -1
  at world 1), the fused deferred flush of ``allreduce_async`` while the
  join protocol applies, :func:`allgatherv` / :func:`alltoallv` /
  :func:`local_result` / :func:`local_rank_count`, and the native cycle
  batcher (``HVD_TPU_NATIVE_CORE=1``: the ``DistributedOptimizer``'s
  hooks hand each gradient to a C++ scheduler that cuts fused batches,
  one ``grouped_allreduce`` each; ``HOROVOD_CYCLE_TIME``, tuned by the
  autotuner's cycle axis);
* model parallelism (:mod:`horovod_tpu_torch.parallel`): the rank mesh
  (``build_3d_mesh``, ``build_parallel_mesh``: one process set a line
  of each named axis), Megatron tensor parallelism and BERT's tp
  forward (``models.BertTP``), ring and Ulysses sequence parallelism,
  the GPipe pipeline and the Switch MoE layer, and the 3-D step
  (``make_train_step(..., tp=, pipeline_stages=, param_specs=)``), whose
  own collectives run over the mesh's data axes only.

Kernels hand-written in CUDA C++ for ``sm_90a`` (``ops/csrc``) carry
attention -- the flash forward and decode kernels, the flash backward's
dq and dk/dv kernels -- the train-mode BatchNorm backward's two
passes, and the three stages of the PowerSGD exchange.  The layout
mirrors ``horovod_tpu`` (``core/``, ``adasum/``, ``collectives/``,
``autotune/``, ``controller/``, ``data/``, ``elastic/``, ``optim/``,
``parallel/``, ``run/``, ``timeline/``, ``models/``, ``ops/``, ``serving/``,
``utils/``, ``training.py``) so each module's counterpart is easy to find.

The package imports ``torch`` and ``numpy`` only -- nothing of JAX and
nothing of ``horovod_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU they raise rather than fall
back.  Kernels build with ``nvcc`` on first use, never at import.
"""

from .collectives import Compression  # noqa: F401
from .collectives import ops as collective_ops  # noqa: F401
from .collectives.handles import (allgather_async,  # noqa: F401
                                  allreduce_async, allreduce_async_,
                                  alltoall_async, broadcast_async,
                                  broadcast_async_, grouped_allgather_async,
                                  grouped_allreduce_async,
                                  grouped_allreduce_async_, poll,
                                  grouped_reducescatter_async,
                                  reducescatter_async,
                                  sparse_allreduce_async, synchronize)
from .collectives.ops import (allgather, allreduce,  # noqa: F401
                              allreduce_, alltoall, barrier, broadcast,
                              broadcast_, grouped_allgather,
                              grouped_allreduce, grouped_allreduce_,
                              grouped_reducescatter, reducescatter)
from .collectives.eager import (allgatherv, alltoallv,  # noqa: F401
                                alltoallv_row, deferred_fuse_stats,
                                local_rank_count, local_result, one_row,
                                replicated_stack)
from .collectives.reduce_op import (Adasum, Average, Max,  # noqa: F401
                                    Min, Product, ReduceOp, Sum)
from .data import DevicePrefetcher, prefetch_to_device  # noqa: F401
from . import elastic  # noqa: F401
from .core import (HorovodInternalError,  # noqa: F401
                   HostsUpdatedInterrupt, ProcessSet, ProcessSetError,
                   add_process_set, cross_rank, cross_size, cuda_built,
                   get_process_set, gloo_built, init, is_homogeneous,
                   is_initialized, join, local_rank, local_size, mpi_built,
                   mpi_threads_supported, nccl_built, process_set_names,
                   rank, remove_process_set, rocm_built, shutdown, size,
                   start_timeline, steps_per_execution, stop_timeline,
                   tpu_built)
from .models import (BERT_BASE, BERT_LARGE, BERT_TINY, Bert,  # noqa: F401
                     BertConfig)
from .optim import (DistributedAdasumOptimizer,  # noqa: F401
                    DistributedOptimizer, allgather_object,
                    broadcast_object, broadcast_optimizer_state,
                    broadcast_parameters)
from .optim.zero import zero_init, zero_report  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from .utils.checkpoint import (checkpoint_path,  # noqa: F401
                               latest_checkpoint, restore_checkpoint,
                               restore_checkpoint_sharded, save_checkpoint,
                               save_checkpoint_sharded)
from .training import (bert_pretrain_loss,  # noqa: F401
                       make_flax_train_loop, make_flax_train_step,
                       make_train_loop, make_train_step, microbatches,
                       stack_steps)

__version__ = "0.3.0"
