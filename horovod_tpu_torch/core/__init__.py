"""Runtime configuration, device resolution, and the init/rank/size
lifecycle."""

from .basics import (cross_rank, cross_size, cuda_built,  # noqa: F401
                     gloo_built, init, is_homogeneous, is_initialized,
                     join, local_rank, local_size, mpi_built,
                     mpi_threads_supported, nccl_built, rank, rocm_built,
                     shutdown, size, start_timeline, steps_per_execution,
                     stop_timeline, tpu_built)
from .config import Config, _env, _env_bool, _env_int, load_config  # noqa: F401
from .device import resolve_device  # noqa: F401
from .exceptions import (HorovodInternalError,  # noqa: F401
                         HostsUpdatedInterrupt, NotInitializedError,
                         ProcessSetError)
from .process_sets import (ProcessSet, add_process_set,  # noqa: F401
                           get_process_set, process_set_names,
                           remove_process_set)
