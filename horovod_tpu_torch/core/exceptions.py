"""Exception types.

Counterpart of ``horovod_tpu/core/exceptions.py``, cut to what the
training path raises: a failed collective is a
:class:`HorovodInternalError`; an API called before ``init()`` raises
:class:`NotInitializedError`.
"""

from __future__ import annotations


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective or runtime operation failed (e.g. a peer vanished)."""


class NotInitializedError(HorovodTpuError):
    """An API was called before ``init()``."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            f"horovod_tpu_torch.init() first.")
