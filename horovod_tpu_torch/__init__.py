"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

A second package beside the JAX one, for an NVIDIA H100.  This first
slice is the single-GPU serving path: requests in, tokens out, through
:class:`~horovod_tpu_torch.serving.ServingEngine`, with its two attention
kernels hand-written in CUDA C++ for ``sm_90a`` (``ops/csrc``).  The
layout mirrors ``horovod_tpu`` (``core/``, ``timeline/``, ``models/``,
``ops/``, ``serving/``) so each module's counterpart is easy to find.

The package imports ``torch`` and ``numpy`` only -- nothing of JAX and
nothing of ``horovod_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU they raise rather than fall
back.  Kernels build with ``nvcc`` on first use, never at import.
"""

__version__ = "0.1.0"
