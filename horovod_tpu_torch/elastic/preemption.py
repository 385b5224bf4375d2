"""Preemption notice: SIGTERM handler + optional GCE metadata poll
(the port's copy of ``horovod_tpu/elastic/preemption.py``).

SURVEY.md 5.3 ("detect preemption -- coordinator heartbeat loss / GCE
preemption notice"): an imminent preemption should become a graceful
``HostsUpdatedInterrupt`` at the NEXT COMMIT BOUNDARY, before the host
dies -- the worker leaves with its state committed instead of dying
mid-collective and forcing the survivors through the crash-rollback
path.

Two sources feed one latched notice:

* **SIGTERM** (cloud preemptions deliver one before the kill): installed
  by ``hvd.elastic.run`` (main thread only; ``HOROVOD_ELASTIC_NO_SIGTERM=1``
  opts out, e.g. when the application owns the handler).
* **GCE metadata poll** (``HOROVOD_ELASTIC_PREEMPT_POLL=1``): a daemon
  thread polls the metadata server's ``instance/preempted`` flag; off
  GCE the poll fails a few times and stops itself.

The elastic run loop checks :func:`notice_received` at every commit
(via ``check_for_host_updates``) and once more at the loop top: a
noticed worker logs, leaves the re-rendezvous to the survivors, and
exits cleanly.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger("horovod_tpu_torch.elastic")

GCE_PREEMPTED_URL = ("http://metadata.google.internal/computeMetadata/"
                     "v1/instance/preempted")

_notice = threading.Event()
_announced = threading.Event()
_reason: str = ""
_installed = False
_poller: threading.Thread = None
_poll_stop = threading.Event()


def notice_received() -> bool:
    return _notice.is_set()


def announced() -> bool:
    """The driver has been told (via the preempted marker) -- announce
    exactly once."""
    return _announced.is_set()


def set_announced() -> None:
    _announced.set()


def reason() -> str:
    return _reason


def trigger(why: str) -> None:
    """Latch the preemption notice (idempotent)."""
    global _reason
    if not _notice.is_set():
        _reason = why
        logger.warning("preemption notice (%s): will interrupt at the "
                       "next commit boundary", why)
        _notice.set()


def reset() -> None:
    """Test hook / fresh life: clear the latch."""
    global _reason
    _notice.clear()
    _announced.clear()
    _reason = ""


def stop_gce_poll(timeout: float = 6.0) -> None:
    """Stop a running metadata poll thread (idempotent)."""
    global _poller
    p = _poller
    if p is None:
        return
    _poll_stop.set()
    if p.is_alive():
        p.join(timeout=timeout)
    _poller = None
    _poll_stop.clear()


def on_runtime_reset() -> None:
    """Hook for ``core.state.GlobalState.reset`` (shutdown / re-init).

    Stops the metadata poll thread so repeated init/reset cycles don't
    leak pollers, and forgets the installed-handler latch so the next
    ``elastic.run`` re-installs cleanly.  The OS-level SIGTERM handler
    and a pending preemption NOTICE are deliberately left alone:
    ``_reinitialize`` resets the runtime mid-recovery, and clearing the
    latch there would drop a real preemption warning.
    """
    global _installed
    stop_gce_poll()
    _installed = False


def _handler(signum, frame):  # pragma: no cover - exercised in live test
    trigger(f"signal {signum}")
    # Re-arm the default action: the first SIGTERM is a notice, a second
    # one (the platform's or the driver's escalation) must still kill a
    # worker that is wedged in a blocking collective and will never reach
    # a commit boundary.
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def install_sigterm() -> bool:
    """Install the SIGTERM handler (idempotent; main thread only --
    signal.signal raises ValueError elsewhere, and a worker thread must
    not steal the application's handler)."""
    global _installed
    if _installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        logger.warning("not on the main thread; SIGTERM preemption "
                       "notice not installed")
        return False
    _installed = True
    return True


def start_gce_poll(interval_s: float = 5.0,
                   max_failures: int = 3) -> threading.Thread:
    """Poll the GCE metadata server's preempted flag in a daemon thread.

    Off GCE (no metadata server) the poll errors ``max_failures`` times
    and stops itself -- enabling the flag on non-GCE hosts is harmless.
    """
    global _poller
    if _poller is not None and _poller.is_alive():
        return _poller
    _poll_stop.clear()

    def poll():
        import urllib.request

        failures = 0
        while not (_notice.is_set() or _poll_stop.is_set()):
            try:
                req = urllib.request.Request(
                    GCE_PREEMPTED_URL,
                    headers={"Metadata-Flavor": "Google"})
                with urllib.request.urlopen(req, timeout=2) as resp:
                    if b"TRUE" in resp.read().upper():
                        trigger("GCE metadata: instance preempted")
                        return
                failures = 0
            except Exception:
                failures += 1
                if failures >= max_failures:
                    logger.info("GCE metadata server unreachable %d times;"
                                " stopping the preemption poll", failures)
                    return
            _poll_stop.wait(interval_s)

    _poller = threading.Thread(target=poll, name="hvd-preempt-poll",
                               daemon=True)
    _poller.start()
    return _poller
