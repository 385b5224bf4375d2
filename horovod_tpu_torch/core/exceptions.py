"""Exception types.

Counterpart of ``horovod_tpu/core/exceptions.py``, cut to what the
training path raises: a failed collective is a
:class:`HorovodInternalError`; an API called before ``init()`` raises
:class:`NotInitializedError`; a bad process-set registration raises
:class:`ProcessSetError`.
"""

from __future__ import annotations


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective or runtime operation failed (e.g. a peer vanished)."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The set of hosts changed; re-rendezvous at the next commit
    (``horovod/common/exceptions.py``).  Nothing in the port raises it
    yet: elastic training is ROADMAP item 1.11."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class NotInitializedError(HorovodTpuError):
    """An API was called before ``init()``."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            f"horovod_tpu_torch.init() first.")


class ProcessSetError(HorovodTpuError):
    """A process set was registered, looked up or removed against the
    rules of :mod:`horovod_tpu_torch.core.process_sets`."""
