"""DistributedOptimizer, the fused gradient exchange, and state sync."""

from .distributed import (DistributedOptimizer,  # noqa: F401
                          allreduce_gradients)
from .functions import (broadcast_object,  # noqa: F401
                        broadcast_optimizer_state, broadcast_parameters)
