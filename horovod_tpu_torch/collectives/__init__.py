"""Collectives over ``torch.distributed``, reduce ops, and the cast
codecs."""

from .compression import Compression  # noqa: F401
from .ops import (Handle, allgather, allgather_async,  # noqa: F401
                  allreduce, allreduce_async, allreduce_async_, barrier,
                  broadcast, broadcast_, broadcast_async, broadcast_async_,
                  grouped_allreduce, grouped_allreduce_async)
from .reduce_op import Average, Max, Min, Product, ReduceOp, Sum  # noqa: F401
