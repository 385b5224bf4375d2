"""Runtime configuration, device resolution, and the init/rank/size
lifecycle."""

from .basics import (cross_rank, cross_size, cuda_built,  # noqa: F401
                     init, is_initialized, local_rank, local_size,
                     nccl_built, rank, shutdown, size)
from .config import Config, _env, _env_bool, _env_int, load_config  # noqa: F401
from .device import resolve_device  # noqa: F401
from .exceptions import (HorovodInternalError,  # noqa: F401
                         NotInitializedError)
