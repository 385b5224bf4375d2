"""Stall inspection + worker heartbeats.

Counterpart of ``horovod_tpu/core/stall.py`` (the reference's
``horovod/common/stall_inspector.cc``: warn when a collective has been
outstanding longer than ``HOROVOD_STALL_CHECK_TIME``, optionally shut the
job down after ``HOROVOD_STALL_SHUTDOWN_TIME``), at the two places the
port can stall:

* **Blocking waits**: a collective's ``Handle.wait``, ``barrier()``,
  ``DistributedOptimizer.synchronize()``.  A dead peer makes gloo raise,
  but an NCCL wait can hang until the process group's timeout.
  :class:`StallInspector` tracks every watched wait and a daemon checker
  thread logs which named ops are stuck and for how long; past
  ``HOROVOD_STALL_RESET_TIME`` it latches the elastic preemption notice.
* **The launcher/elastic plane**: worker liveness via heartbeat files
  (:class:`HeartbeatWriter` / :func:`heartbeat_age`) or the KV store
  (:class:`KVHeartbeatWriter`); the elastic driver treats a stale
  heartbeat like a failed worker (terminate -> blacklist -> rescale).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("horovod_tpu_torch.stall")


class StallInspector:
    """Watches named blocking operations and complains about stuck ones."""

    def __init__(self, warn_time_s: float = 60.0,
                 shutdown_time_s: float = 0.0,
                 check_interval_s: Optional[float] = None,
                 on_shutdown: Optional[Callable[[List[str]], None]] = None,
                 reset_time_s: float = 0.0,
                 on_reset: Optional[Callable[[List[str]], None]] = None):
        self.warn_time_s = warn_time_s
        self.shutdown_time_s = shutdown_time_s
        # HOROVOD_STALL_RESET_TIME: waits older than this latch the
        # elastic preemption notice, turning a wedged collective into a
        # graceful elastic reset instead of a hang (or the harder
        # os._exit of the shutdown threshold).
        self.reset_time_s = reset_time_s
        self._on_reset = on_reset or self._default_reset
        self._reset_fired = False
        self.check_interval_s = check_interval_s or max(
            min(warn_time_s / 4.0, 10.0), 0.01)
        self._on_shutdown = on_shutdown or self._default_shutdown
        self._lock = threading.Lock()
        self._inflight: Dict[int, Tuple[str, float]] = {}
        self._next_token = 0
        self._last_warn: Dict[int, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- watching ---------------------------------------------------------
    def begin(self, name: str) -> int:
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._inflight[token] = (name, time.monotonic())
        self._ensure_thread()
        return token

    def end(self, token: int) -> None:
        with self._lock:
            self._inflight.pop(token, None)
            self._last_warn.pop(token, None)

    class _Watch:
        def __init__(self, inspector: "StallInspector", name: str):
            self._i, self._name = inspector, name
            self._token: Optional[int] = None

        def __enter__(self):
            self._token = self._i.begin(self._name)
            return self

        def __exit__(self, *exc):
            self._i.end(self._token)
            return False

    def watch(self, name: str) -> "StallInspector._Watch":
        """Context manager marking a blocking wait as in flight."""
        return self._Watch(self, name)

    def stalled(self) -> List[str]:
        """Names of ops currently past the warn threshold (no logging)."""
        now = time.monotonic()
        with self._lock:
            return [name for name, start in self._inflight.values()
                    if now - start > self.warn_time_s]

    # -- checking ---------------------------------------------------------
    def check_now(self) -> List[str]:
        """One inspection pass; returns the names of currently stalled ops."""
        now = time.monotonic()
        stalled: List[str] = []
        doomed: List[str] = []
        resettable: List[str] = []
        with self._lock:
            for token, (name, start) in self._inflight.items():
                age = now - start
                if age <= self.warn_time_s:
                    continue
                stalled.append(name)
                if now - self._last_warn.get(token, 0.0) > self.warn_time_s:
                    self._last_warn[token] = now
                    logger.warning(
                        "stall inspector: operation %r has been waiting for "
                        "%.1fs (> %.1fs). One or more peer processes may "
                        "have died or a device grant may be wedged.",
                        name, age, self.warn_time_s)
                if self.reset_time_s > 0 and age > self.reset_time_s:
                    resettable.append(name)
                if self.shutdown_time_s > 0 and age > self.shutdown_time_s:
                    doomed.append(name)
        if resettable and not self._reset_fired:
            self._reset_fired = True
            self._on_reset(resettable)
        if doomed:
            self._on_shutdown(doomed)
        return stalled

    @staticmethod
    def _default_shutdown(names: List[str]) -> None:
        logger.critical(
            "stall inspector: operations %s exceeded the shutdown "
            "threshold; aborting the process (HOROVOD_STALL_SHUTDOWN_TIME "
            "semantics).", names)
        os._exit(17)

    @staticmethod
    def _default_reset(names: List[str]) -> None:
        logger.warning(
            "stall inspector: operations %s exceeded "
            "HOROVOD_STALL_RESET_TIME; latching the elastic preemption "
            "notice so the run loop resets instead of hanging.", names)
        try:
            from ..elastic import preemption
            preemption.trigger(f"stall: {', '.join(names)}")
        except ImportError:  # pragma: no cover - partial install
            pass

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-stall-inspector")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            with self._lock:
                empty = not self._inflight
            if empty:
                continue
            try:
                self.check_now()
            except Exception:  # pragma: no cover - never kill the checker
                logger.exception("stall inspector check failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.check_interval_s + 1)
            self._thread = None


# ---------------------------------------------------------------------------
# Module singleton, configured by hvd.init().
# ---------------------------------------------------------------------------

_inspector: Optional[StallInspector] = None
_inspector_lock = threading.Lock()


def configure(config) -> Optional[StallInspector]:
    """(Re)build the process-wide inspector from a parsed Config."""
    global _inspector
    with _inspector_lock:
        if _inspector is not None:
            _inspector.stop()
            _inspector = None
        if not config.stall_check_disable and config.stall_check_time > 0:
            _inspector = StallInspector(
                warn_time_s=config.stall_check_time,
                shutdown_time_s=config.stall_shutdown_time,
                reset_time_s=getattr(config, "stall_reset_time", 0.0))
        return _inspector


def inspector() -> Optional[StallInspector]:
    return _inspector


def teardown() -> None:
    """Stop and drop the process-wide inspector (shutdown path)."""
    global _inspector
    with _inspector_lock:
        if _inspector is not None:
            _inspector.stop()
            _inspector = None


class _NullWatch:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_WATCH = _NullWatch()


def watched(name: str):
    """``with watched("allreduce.x"):`` around a blocking wait; no-op when
    no inspector is configured."""
    ins = _inspector
    return ins.watch(name) if ins is not None else _NULL_WATCH


# ---------------------------------------------------------------------------
# Heartbeat plane (elastic driver <- worker liveness).
# ---------------------------------------------------------------------------

def heartbeat_path(assignment_path: str, worker_id: str) -> str:
    """Heartbeat file for a worker, next to the elastic assignment file.

    Lives here (not in the elastic modules) so the launcher/driver process
    can compute it without importing the training stack.
    """
    safe = worker_id.replace("/", "_")
    return os.path.join(os.path.dirname(assignment_path), f"hb_{safe}")


class HeartbeatWriter:
    """Worker-side: touch ``path`` every ``interval_s`` from a daemon thread.

    ``gate`` (when given) is consulted before each beat; returning False
    skips it.  The elastic run loop gates on the stall inspector, so a
    worker wedged inside a blocking collective stops beating and the
    driver's heartbeat timeout can actually evict it -- a live daemon
    thread alone would keep beating through the hang.
    """

    def __init__(self, path: str, interval_s: float = 1.0,
                 gate: Optional[Callable[[], bool]] = None):
        self.path = path
        self.interval_s = interval_s
        self._gate = gate
        self._stop = threading.Event()
        self.beat(force=True)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-heartbeat")
        self._thread.start()

    def beat(self, force: bool = False) -> None:
        if not force:
            try:
                from ..elastic import chaos as _chaos
                if _chaos.heartbeat_drop_active():
                    return  # injected heartbeat loss (fault testing)
            except ImportError:  # pragma: no cover - partial install
                pass
        if not force and self._gate is not None:
            try:
                if not self._gate():
                    return
            except Exception:  # pragma: no cover - gate must never kill us
                logger.exception("heartbeat gate failed")
        try:
            self._do_beat()
        except OSError:  # pragma: no cover - dir vanished mid-teardown
            pass

    def _do_beat(self) -> None:
        with open(self.path, "a"):
            os.utime(self.path, None)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.interval_s + 1)
        self._cleanup()

    def _cleanup(self) -> None:
        # Remove the file so the driver sees "no heartbeat yet" (which it
        # grants grace) rather than a stale mtime it would treat as a dead
        # worker -- a worker doing post-training work (checkpoint save,
        # eval) after the elastic loop returns must not get evicted.
        try:
            os.unlink(self.path)
        except OSError:
            pass


class KVHeartbeatWriter(HeartbeatWriter):
    """Heartbeats over the HTTP KV rendezvous (multi-host: no shared FS).

    Publishes a wall-clock timestamp under ``hb/<worker_id>``; the driver
    compares against its own clock (same-pod VMs are NTP-synced; the
    heartbeat timeout is seconds, not milliseconds).
    """

    def __init__(self, url: str, worker_id: str, secret_key: str,
                 interval_s: float = 1.0,
                 gate: Optional[Callable[[], bool]] = None):
        from ..run.http_kv import KVClient
        self._kv = KVClient.from_url(url, secret_key, timeout_s=5.0)
        self.worker_id = worker_id
        super().__init__(path=url, interval_s=interval_s, gate=gate)

    def _do_beat(self) -> None:
        try:
            self._kv.put("hb", self.worker_id, repr(time.time()).encode())
        except ConnectionError:  # driver gone/restarting: keep trying
            pass
        except Exception as e:  # RendezvousAuthError etc: NOT transient
            # Surface the misconfiguration loudly ONCE and stop the beat
            # thread cleanly -- a dead daemon thread would hide the cause
            # and the worker would just get evicted as "stale".
            logger.error(
                "heartbeat publication failed permanently (%s); stopping "
                "heartbeats -- the driver will evict this worker after "
                "its heartbeat timeout", e)
            self._stop.set()

    def _cleanup(self) -> None:
        try:
            self._kv.delete("hb", self.worker_id)
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass


def progress_gate() -> bool:
    """Default heartbeat gate: healthy unless the stall inspector sees a
    wait past its warn threshold."""
    ins = _inspector
    return ins is None or not ins.stalled()


def heartbeat_age(path: str) -> Optional[float]:
    """Seconds since the last beat, or None if no heartbeat exists yet."""
    try:
        return max(0.0, time.time() - os.stat(path).st_mtime)
    except OSError:
        return None
