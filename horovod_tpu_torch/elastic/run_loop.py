"""The elastic run decorator: rollback + re-rendezvous control flow.

The port's counterpart of ``horovod_tpu/elastic/run_loop.py`` (the
reference's worker loop, ``hvd.elastic.run``)::

    loop:
      state.sync()            # broadcast from rank 0 after any reset
      try: func(state, ...)   # user training, commits at batch boundaries
      except HorovodInternalError:   -> state.restore()  (peer died)
      except HostsUpdatedInterrupt:  -> pass             (topology changed)
      shutdown; re-rendezvous; init  # full comm-plane rebuild

The comm-plane rebuild is ``hvd.shutdown()`` -- which destroys the process
group and every process set's group -- then ``hvd.init()`` against the
rendezvous the driver published for epoch N+1 (its ``FileStore``, else
``MASTER_PORT``): on CUDA a new NCCL communicator in the same process.
Without a driver (no assignment to read) a world of one is built again
on the same device; a larger one raises.  A failed collective surfaces as
a torch ``DistError`` (``DistBackendError``, ``DistNetworkError``,
``DistStoreError``), a ``RuntimeError`` with gloo's or NCCL's message, or
the port's ``HorovodInternalError`` -- the loop converts any error
carrying a transport signature into the rollback path.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Any, Callable

from ..core import basics as _basics
from ..core.exceptions import (CorruptRankError, DesyncError,
                               HorovodInternalError, HostsUpdatedInterrupt,
                               SustainedAnomalyError)
from ..core.stall import heartbeat_path  # noqa: F401  (re-export)
from .notify import Notifier
from .state import State

logger = logging.getLogger("horovod_tpu_torch.elastic")


def _comm_error_types() -> tuple:
    """Exception types torch.distributed raises for transport and
    coordination failures: ``DistError`` and its subclasses
    (``DistBackendError`` for a failed gloo/NCCL collective,
    ``DistNetworkError``, ``DistStoreError`` for the rendezvous store),
    which subclass ``RuntimeError``; and the builtin transport types."""
    import torch.distributed as dist
    types = [RuntimeError, OSError, TimeoutError, ConnectionError]
    for name in ("DistError", "DistBackendError", "DistNetworkError",
                 "DistStoreError"):
        t = getattr(dist, name, None)
        if t is not None:
            types.append(t)
    return tuple(types)


# Status prefixes a runtime stamps on its messages (the JAX package's
# table, kept: a message of that form from any layer is classified the
# same way in both packages).
_STATUS_PREFIXES = ("UNKNOWN:", "INTERNAL:", "UNAVAILABLE:",
                    "DEADLINE_EXCEEDED:", "ABORTED:", "CANCELLED:",
                    "FAILED_PRECONDITION:")


def _looks_like_comm_failure(err: BaseException) -> bool:
    """Classify an exception as a recoverable comm-plane failure.

    Two gates, both required (a user ``ValueError`` whose message merely
    mentions "connection" must not be silently converted into a
    rollback):

    1. the exception must look like it came from the runtime layer --
       either by TYPE (torch's ``DistError`` family / RuntimeError /
       OSError / TimeoutError) or by the status-code PREFIX a runtime
       stamps on its messages;
    2. the message must carry a transport/coordination signature.

    The needles cover torch's transports: gloo's "Connection closed by
    peer" / "Connection reset by peer", NCCL's "NCCL error" and its
    watchdog's timeouts, the store's "Socket Timeout"; the port's tests
    classify the error a live gloo world raises when a peer dies.
    """
    if isinstance(err, HorovodInternalError):
        return True
    from . import chaos
    if isinstance(err, chaos.ChaosCommError):
        return True  # injected faults are comm failures by construction
    # A rejected signature is a configuration bug (wrong per-job secret /
    # clock skew), not a transport failure: it subclasses RuntimeError and
    # its message mentions "rendezvous", so both gates would pass -- rule
    # it out explicitly before they run.
    try:
        from ..run.http_kv import RendezvousAuthError
        if isinstance(err, RendezvousAuthError):
            return False
    except ImportError:  # pragma: no cover - partial install
        pass
    text = f"{type(err).__name__}: {err}"
    # "rendezvous"/"urlopen error"/"timed out" cover KV-plane failures:
    # http_kv normalizes urllib's URLError (an OSError subclass, so gate
    # 1 already passes) into ConnectionError("rendezvous GET /kv/...:
    # <urlopen error ...>"), and socket timeouts surface as plain
    # "timed out" with no other signature.
    # Not "gloo": every error of torch's gloo backend, a tensor of the
    # wrong size included, names "ProcessGroupGloo"; its transport
    # failures say "Connection".
    needles = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "connection",
               "Connection", "NCCL", "nccl", "Watchdog",
               "watchdog", "distributed", "heartbeat", "coordinator",
               "barrier timed out", "preempt", "Socket closed",
               "Socket Timeout", "recv", "peer", "rendezvous",
               "urlopen error", "timed out", "Timed out", "chaos")
    if isinstance(err, _comm_error_types()):
        return any(n in text for n in needles)
    if str(err).startswith(_STATUS_PREFIXES):
        return any(n in text for n in needles)
    return False


def check_for_host_updates(state: State) -> None:
    """Raise ``HostsUpdatedInterrupt`` when the driver advanced the epoch.

    Call at commit boundaries (``State.commit`` does; explicit calls are
    allowed anywhere in user code).
    """
    from . import preemption
    notifier: Notifier = getattr(state, "_hvd_notifier", None)
    if preemption.notice_received():
        if notifier is not None and notifier.enabled:
            if notifier.excluded_from_current():
                # The latest epoch already excludes this worker: the
                # SIGTERM was the DRIVER's eviction (scale-down,
                # heartbeat), not a cloud preemption -- don't mark, just
                # take the interrupt and leave via the loop top.
                state.on_hosts_updated()
                raise HostsUpdatedInterrupt()
            # Announce ONCE and keep participating: exiting now would
            # strand peers already inside the next step's collective
            # (Gloo blocks forever on a vanished member -- measured).
            # The driver answers the marker with a new epoch excluding
            # this worker, which interrupts EVERYONE at a commit
            # boundary -- the same coordinated teardown the scale-down
            # path uses (SURVEY.md 5.3 graceful preemption).
            if not preemption.announced():
                if notifier.mark_preempted():  # else: retry next commit
                    preemption.set_announced()
        else:
            # No driver to coordinate: best effort, leave at this
            # boundary with the snapshot saved.
            state.on_hosts_updated()
            raise HostsUpdatedInterrupt()
    if notifier is None or not notifier.enabled:
        return
    doc = notifier.updated()
    if doc:
        state.on_hosts_updated()
        raise HostsUpdatedInterrupt()


def _reinitialize(notifier: Notifier) -> None:
    """Full comm-plane rebuild against the latest assignment: shutdown,
    then init at the new epoch's rank, size and rendezvous, on the kind
    of device the world ran on.  Without a driver only a world of one can
    be rebuilt (there is no one to publish a new membership)."""
    from ..core.state import global_state
    st = global_state()
    device = st.device if st.initialized else None
    if not notifier.enabled and st.initialized and st.size > 1:
        raise HorovodInternalError(
            f"a world of {st.size} lost a collective, and no elastic "
            f"driver publishes a new membership (launch with "
            f"--host-discovery-script)")
    _basics.shutdown()
    if not notifier.enabled:
        _basics.init(device=device)
        return
    doc = None
    found = False
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        doc = notifier.read()
        if doc and doc["epoch"] > notifier.current_epoch and \
                notifier.worker_id in doc["ranks"]:
            found = True
            break
        time.sleep(0.5)
    if not found:
        raise HorovodInternalError(
            "no new elastic assignment including this worker was published "
            "before the deadline (driver gone, or this worker scaled out)")
    notifier.accept(doc)
    rank, size = doc["ranks"][notifier.worker_id], doc["size"]
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    # Single-host driver: local == global (matches run.launch.worker_env).
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank)
    os.environ["HOROVOD_LOCAL_SIZE"] = str(size)
    os.environ["HVD_TPU_COORDINATOR_PORT"] = str(doc["port"])
    os.environ["MASTER_PORT"] = str(doc["port"])
    if doc.get("store"):
        os.environ["HVD_TPU_RENDEZVOUS_FILE"] = doc["store"]
    else:
        os.environ.pop("HVD_TPU_RENDEZVOUS_FILE", None)
        os.environ.pop("HOROVOD_RENDEZVOUS_FILE", None)
    if device is not None and device.type == "cuda":
        device = None  # cuda:<new local rank>
    _basics.init(device=device)


def run(func: Callable[..., Any]) -> Callable[..., Any]:
    """``@hvd.elastic.run`` decorator: ``run(train)(state, *args)``."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        from ..core.config import _env_bool
        from . import preemption
        if not _env_bool("ELASTIC_NO_SIGTERM"):
            preemption.install_sigterm()
        if _env_bool("ELASTIC_PREEMPT_POLL"):
            preemption.start_gce_poll()
        notifier = Notifier()
        state._hvd_notifier = notifier
        heartbeat = None
        if notifier.enabled and notifier.worker_id:
            # Liveness signal for the driver's stall plane (StallInspector
            # analogue at the process level).  Beats are gated on the stall
            # inspector: a worker wedged in a blocking collective stops
            # beating, so the driver's heartbeat timeout can evict it.
            from ..core.stall import (HeartbeatWriter, KVHeartbeatWriter,
                                      progress_gate)
            if notifier.path.startswith("http://"):
                from ..run.secret import SECRET_ENV
                heartbeat = KVHeartbeatWriter(
                    notifier.path, notifier.worker_id,
                    os.environ.get(SECRET_ENV, ""), gate=progress_gate)
            else:
                heartbeat = HeartbeatWriter(
                    heartbeat_path(notifier.path, notifier.worker_id),
                    gate=progress_gate)
        try:
            return _elastic_loop(func, state, notifier, args, kwargs)
        finally:
            if heartbeat is not None:
                heartbeat.stop()

    return wrapper


def _desync_max_retries() -> int:
    """Config-time knob (HOROVOD_DESYNC_MAX_RETRIES), read at use time like
    every other HOROVOD_* flag."""
    from ..core.state import global_state
    st = global_state()
    if st.initialized and st.config is not None:
        return st.config.desync_max_retries
    from ..core.config import load_config
    return load_config().desync_max_retries


def apply_resize(state, old_size, new_size) -> None:
    """World-size transition sequence, shared by the training loop and
    the serving control plane.

    Exactly the reset/resize steps ``_elastic_loop`` runs after a
    re-rendezvous, with no training assumptions: account lost ranks in
    ``horovod_elastic_ranks_lost``, hand the transition to
    ``state.resize`` when the carrier implements it (checkpointless
    repartition for a training carry, drain/re-prefill for a serving
    mesh), fall back to plain sync semantics when resize fails, and
    finish with ``state.on_reset()``.  ``old_size`` may be ``None``
    (first rendezvous -- nothing to resize).
    """
    if old_size is not None and new_size != old_size:
        from ..timeline import metrics as _metrics
        if new_size < old_size:
            _metrics.registry().counter(
                "horovod_elastic_ranks_lost",
                "Ranks lost across elastic recoveries").inc(
                    old_size - new_size)
        if hasattr(state, "resize"):
            try:
                report = state.resize(old_size, new_size)
                logger.info(
                    "checkpointless resize %d -> %d: %s",
                    old_size, new_size, report)
            except Exception:
                # sync() still rebroadcasts whatever rank 0
                # holds; worst case the optimizer state is
                # re-derived instead of carried.
                logger.exception(
                    "checkpointless resize %d -> %d failed; "
                    "falling back to plain sync", old_size,
                    new_size)
    state.on_reset()


def _rollback_or_restore(state) -> None:
    """Recover committed state, preferring the snapshot ledger.

    ``rollback()`` (TorchState, HOROVOD_SNAPSHOT_STEPS > 0) steps back to a
    pre-anomaly ledger entry -- the last *commit* may already hold
    poisoned state.  When the ledger is off/empty (or the carrier has no
    ledger) this degrades to plain ``restore()``.
    """
    rollback = getattr(state, "rollback", None)
    if rollback is not None:
        try:
            report = rollback()
            if report is not None:
                logger.warning("rolled back to ledger snapshot %s", report)
                return
        except Exception:
            logger.exception("snapshot-ledger rollback failed; falling "
                             "back to plain restore")
    state.restore()


def _elastic_loop(func, state, notifier, args, kwargs):
    from . import preemption

    reset_required = False
    desync_retries = 0
    commit_baseline = None  # commit count right after the last sync()
    while True:
        if preemption.notice_received():
            # Reached after the coordinated interrupt (or a comm
            # failure): state is committed, the driver already has the
            # marker, peers are rolling to the new epoch.  Leave without
            # an explicit comm-plane teardown -- the process exit closes
            # the transports (same as a scale-down removal).
            logger.warning("preemption notice honored (%s); exiting "
                           "after commit", preemption.reason())
            print("preempted: exiting gracefully after commit", flush=True)
            return None
        if reset_required:
            from ..core.config import _env_bool
            old_size = _basics.size() if _basics.is_initialized() else None
            _reinitialize(notifier)
            if _env_bool("ELASTIC_PREEMPT_POLL"):
                # GlobalState.reset (inside _reinitialize's shutdown)
                # stopped the metadata poll; re-arm it for the new life.
                preemption.start_gce_poll()
            new_size = _basics.size()
            apply_resize(state, old_size, new_size)
            reset_required = False
        try:
            # sync() ends in commit(), which may itself raise
            # HostsUpdatedInterrupt -- keep it inside the catch.
            state.sync()
            commit_baseline = getattr(state, "_commit_count", 0)
            return func(state, *args, **kwargs)
        except HostsUpdatedInterrupt:
            logger.info("hosts updated; re-rendezvousing")
            reset_required = True
        except CorruptRankError as e:
            # The in-band tripwire attributed divergent replicas to
            # specific rank(s) by majority vote -- bitflip-class SDC, not
            # a membership change.  The attributed rank must not carry
            # its replica forward: it leaves at this boundary (the
            # driver's next epoch excludes it, the same teardown the
            # heartbeat-eviction path uses), while survivors roll back
            # past the corruption window and re-rendezvous into the
            # shrunk world.
            my_rank = _basics.rank() if _basics.is_initialized() else None
            if my_rank is not None and my_rank in e.ranks:
                logger.error("tripwire attributed THIS rank (%d) as "
                             "corrupt; exiting for quarantine", my_rank)
                raise
            logger.warning("tripwire attributed corrupt rank(s) %s; "
                           "rolling back and re-rendezvousing without "
                           "them", e.ranks)
            _rollback_or_restore(state)
            reset_required = True
        except SustainedAnomalyError as e:
            # The in-step guard skipped HOROVOD_GUARD_STREAK consecutive
            # updates: skipping forward cannot recover, but no membership
            # change happened either -- roll back (ledger-first) and let
            # the loop-top sync() replay from the snapshot.  Shares the
            # desync consecutive-failure cap: an anomaly that survives
            # rollback+replay (deterministically poisoned input) must not
            # spin this loop forever.
            commits = getattr(state, "_commit_count", 0)
            if commit_baseline is not None and commits > commit_baseline:
                desync_retries = 0
            commit_baseline = commits
            desync_retries += 1
            cap = _desync_max_retries()
            if desync_retries > cap:
                logger.error("sustained anomaly persisted through %d "
                             "rollback+replay attempts; giving up", cap)
                raise
            logger.warning("%s (attempt %d/%d)", e, desync_retries, cap)
            _rollback_or_restore(state)
        except DesyncError as e:
            # Raised symmetrically on every rank by the commit-boundary
            # checksum (the check runs BEFORE the snapshot is overwritten,
            # so the last commit is still converged).  No membership
            # change happened, so no re-rendezvous: restore and let the
            # loop-top sync() rebroadcast rank 0's copy.  A cause that
            # survives restore+sync (non-deterministic pipeline, an
            # unchecksummable leaf) would otherwise spin this loop
            # forever, so cap CONSECUTIVE failures: a successful in-func
            # commit since the last sync() (commit counter moved past the
            # post-sync baseline) means the last recovery worked, and the
            # count starts over.  sync()'s own commit is excluded -- it
            # always succeeds after a broadcast and would otherwise make a
            # persistent desync look like progress.
            commits = getattr(state, "_commit_count", 0)
            if commit_baseline is not None and commits > commit_baseline:
                desync_retries = 0
            commit_baseline = commits
            desync_retries += 1
            cap = _desync_max_retries()
            if desync_retries > cap:
                logger.error("replica desync persisted through %d "
                             "restore+sync attempts; giving up", cap)
                raise
            logger.warning("replica desync (%s); restoring last commit and "
                           "re-syncing from rank 0 (attempt %d/%d)", e,
                           desync_retries, cap)
            state.restore()
        except HorovodInternalError as e:
            logger.warning("collective failed (%s); rolling back to last "
                           "commit", e)
            state.restore()
            reset_required = True
        except Exception as e:  # noqa: BLE001
            if _looks_like_comm_failure(e):
                logger.warning("comm-plane failure (%s: %s); rolling back",
                               type(e).__name__, e)
                state.restore()
                reset_required = True
            else:
                raise
