"""Exception types.

Counterpart of ``horovod_tpu/core/exceptions.py``: a failed collective
is a :class:`HorovodInternalError` (elastic training rolls back to the
last commit); a membership change pushed by the elastic driver is a
:class:`HostsUpdatedInterrupt` (re-rendezvous at the next commit); an API
called before ``init()`` raises :class:`NotInitializedError`; a bad
process-set registration raises :class:`ProcessSetError`.
:class:`DesyncError`, :class:`SustainedAnomalyError` and
:class:`CorruptRankError` are the silent-data-corruption plane's signals:
nothing in the port raises them yet (ROADMAP item 1.11), but the elastic
loop's ``except`` clauses are the JAX loop's, so they are here.
"""

from __future__ import annotations


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective or runtime operation failed (e.g. a peer vanished)."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """The set of hosts changed; re-rendezvous at the next commit
    (``horovod/common/exceptions.py``).  ``State.commit()`` raises it
    when the elastic driver has published a new membership epoch."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class DesyncError(HorovodInternalError):
    """Replica state diverged across ranks (the commit-boundary
    checksums).  The elastic loop restores the last commit and re-syncs
    from rank 0 without a re-rendezvous."""

    def __init__(self, message: str, leaves=None):
        super().__init__(message)
        self.leaves = list(leaves or [])


class SustainedAnomalyError(HorovodInternalError):
    """The SDC guard skipped ``streak`` consecutive steps: the elastic
    loop rolls back (ledger first) and replays."""

    def __init__(self, streak: int):
        super().__init__(
            f"SDC guard skipped {streak} consecutive steps; "
            "rolling back to last good snapshot")
        self.streak = int(streak)


class CorruptRankError(DesyncError):
    """The cross-rank tripwire attributed divergent state to ``ranks``:
    they leave for quarantine, the others roll back and re-rendezvous."""

    def __init__(self, message: str, ranks=None, leaves=None):
        super().__init__(message, leaves=leaves)
        self.ranks = sorted(set(int(r) for r in (ranks or [])))


class NotInitializedError(HorovodTpuError):
    """An API was called before ``init()``."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            f"horovod_tpu_torch.init() first.")


class ProcessSetError(HorovodTpuError):
    """A process set was registered, looked up or removed against the
    rules of :mod:`horovod_tpu_torch.core.process_sets`."""
