"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

A second package beside the JAX one, for an NVIDIA H100.  Four slices
are ported so far:

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
  with the error-feedback residual carried by the optimizer.

Kernels hand-written in CUDA C++ for ``sm_90a`` (``ops/csrc``) carry
attention -- the flash forward and decode kernels, the flash backward's
dq and dk/dv kernels -- the train-mode BatchNorm backward's two
passes, and the three stages of the PowerSGD exchange.  The layout
mirrors ``horovod_tpu`` (``core/``, ``collectives/``, ``controller/``, ``optim/``, ``timeline/``,
``models/``, ``ops/``, ``serving/``, ``training.py``) so each module's
counterpart is easy to find.

The package imports ``torch`` and ``numpy`` only -- nothing of JAX and
nothing of ``horovod_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU they raise rather than fall
back.  Kernels build with ``nvcc`` on first use, never at import.
"""

from .collectives import (Average, Compression, Max, Min,  # noqa: F401
                          Product, Sum, allgather, allreduce,
                          allreduce_async, barrier, broadcast,
                          grouped_allreduce)
from .core import (cross_rank, cross_size, cuda_built, init,  # noqa: F401
                   is_initialized, local_rank, local_size, nccl_built, rank,
                   shutdown, size)
from .optim import (DistributedOptimizer, broadcast_object,  # noqa: F401
                    broadcast_optimizer_state, broadcast_parameters)

__version__ = "0.2.0"
