"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

A second package beside the JAX one, for an NVIDIA H100.  Two slices are
ported so far:

* serving: requests in, tokens out, through
  :class:`~horovod_tpu_torch.serving.ServingEngine`;
* data-parallel LoRA fine-tuning through Horovod's own hot path:
  :func:`init` -> :func:`DistributedOptimizer` over fused,
  optionally compressed allreduce buckets -> the wrapped optimizer, with
  :func:`~horovod_tpu_torch.training.make_train_step`.

Attention runs through kernels hand-written in CUDA C++ for ``sm_90a``
(``ops/csrc``): the flash forward and decode kernels, and the flash
backward's dq and dk/dv kernels.  The layout mirrors ``horovod_tpu``
(``core/``, ``collectives/``, ``controller/``, ``optim/``, ``timeline/``,
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
