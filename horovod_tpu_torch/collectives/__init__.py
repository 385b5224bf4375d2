"""Collectives over ``torch.distributed``, reduce ops, and the codecs
(casts and PowerSGD).  The ``*_async`` names here return the op layer's
:class:`Handle`; the package's top level returns Horovod's integer
handles (:mod:`.handles`)."""

from .compression import Compression  # noqa: F401
from .ops import (Handle, allgather, allgather_async,  # noqa: F401
                  allreduce, allreduce_async, allreduce_async_, barrier,
                  broadcast, broadcast_, broadcast_async, broadcast_async_,
                  grouped_allreduce, grouped_allreduce_async,
                  powersgd_allreduce, powersgd_allreduce_async)
from .reduce_op import (Adasum, Average, Max, Min, Product,  # noqa: F401
                        ReduceOp, Sum)
