"""DistributedOptimizer, the fused gradient exchange, and state sync."""

from .distributed import (DistributedAdasumOptimizer,  # noqa: F401
                          DistributedOptimizer, allreduce_gradients)
from .functions import (allgather_object, broadcast_object,  # noqa: F401
                        broadcast_optimizer_state, broadcast_parameters)
