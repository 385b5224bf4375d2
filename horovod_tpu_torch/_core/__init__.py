"""ctypes bindings for the native coordination core (``src/core.cc``).

The port's own copy of ``horovod_tpu/_core``: a handle table
(:class:`NativeHandles`), the cycle scheduler that cuts fused gradient
batches (:class:`NativeScheduler`), an LRU of request signatures
(:class:`NativeCache`) and a background Chrome-trace writer
(:class:`NativeTimeline`), over a C ABI (upstream's ``HorovodBasics``
loading pattern, ``horovod/common/basics.py``).  This is host code, not a
kernel.

The library is built with the system ``g++`` from the package's source
at first use, never at import, into ``_core/build/`` (git-ignored).  The
file name carries a hash of the source, so an edited ``core.cc``
rebuilds, and the build renames atomically, so concurrent builds are
safe.  ``HVD_TPU_NATIVE_CORE=0`` turns the library off
(:func:`available` is then False).  :func:`get_lib` returns None when
the library cannot be had; :func:`require_lib` raises with the reason
instead, which is what the batched ``DistributedOptimizer`` asks for: a
failed build under ``HVD_TPU_NATIVE_CORE=1`` is an error, never a quiet
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Callable, Dict, List, Optional

log = logging.getLogger("horovod_tpu_torch.core.native")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "core.cc")
BUILD_DIR = os.path.join(_HERE, "build")

_lib = None
_lib_err: Optional[str] = None
_lib_lock = threading.Lock()

BatchCB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_int)


def _build() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libhvdcore-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so_path + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, so_path)  # atomic under concurrent builds
    return so_path


def _bind(lib) -> None:
    lib.hvd_core_version.argtypes = []
    lib.hvd_core_version.restype = ctypes.c_char_p
    for name in ("hvd_handle_create", "hvd_handle_pending",
                 "hvd_sched_pending", "hvd_cache_size"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    for name in ("hvd_sched_stop", "hvd_sched_flush", "hvd_timeline_close"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = None
    for name in ("hvd_handle_poll", "hvd_handle_release"):
        getattr(lib, name).argtypes = [ctypes.c_int]
    lib.hvd_handle_poll.restype = ctypes.c_int
    lib.hvd_handle_release.restype = None
    lib.hvd_cache_configure.argtypes = [ctypes.c_int]
    lib.hvd_cache_configure.restype = None
    lib.hvd_set_log_level.argtypes = [ctypes.c_int]
    lib.hvd_set_log_level.restype = None
    lib.hvd_handle_wait.argtypes = [ctypes.c_int, ctypes.c_double]
    lib.hvd_handle_wait.restype = ctypes.c_int
    lib.hvd_handle_error.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.hvd_handle_error.restype = ctypes.c_int
    lib.hvd_handle_done.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p]
    lib.hvd_handle_done.restype = ctypes.c_int
    lib.hvd_sched_start.argtypes = [ctypes.c_double, ctypes.c_longlong,
                                    BatchCB, ctypes.c_double, ctypes.c_int]
    lib.hvd_sched_start.restype = ctypes.c_int
    lib.hvd_sched_enqueue.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int]
    lib.hvd_sched_enqueue.restype = ctypes.c_longlong
    lib.hvd_sched_update_tuning.argtypes = [ctypes.c_double,
                                            ctypes.c_longlong]
    lib.hvd_sched_update_tuning.restype = None
    lib.hvd_cache_lookup.argtypes = [ctypes.c_char_p]
    lib.hvd_cache_lookup.restype = ctypes.c_int
    lib.hvd_cache_insert.argtypes = [ctypes.c_char_p]
    lib.hvd_cache_insert.restype = None
    lib.hvd_cache_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.POINTER(ctypes.c_longlong)]
    lib.hvd_cache_stats.restype = None
    lib.hvd_timeline_open.argtypes = [ctypes.c_char_p]
    lib.hvd_timeline_open.restype = ctypes.c_int
    lib.hvd_timeline_event.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_char, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_longlong]
    lib.hvd_timeline_event.restype = None


def get_lib():
    """Load (building if needed) the native core; None when unavailable."""
    global _lib, _lib_err
    with _lib_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        if os.environ.get("HVD_TPU_NATIVE_CORE", "") in ("0", "false"):
            _lib_err = "disabled via HVD_TPU_NATIVE_CORE=0"
            return None
        try:
            path = _build()
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _lib_err = f"native core build failed: {detail[:500]}"
            log.warning("%s", _lib_err)
        return _lib


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    get_lib()
    return _lib_err


def require_lib():
    """The native core, or ``RuntimeError`` saying why it is missing."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(unavailable_reason() or "native core missing")
    return lib


# ---------------------------------------------------------------------------
# Pythonic wrappers
# ---------------------------------------------------------------------------


class NativeHandles:
    """Thread-safe async-op handle table (HandleManager parity)."""

    def __init__(self, lib=None):
        self._lib = lib or require_lib()

    def create(self) -> int:
        return self._lib.hvd_handle_create()

    def done(self, h: int, status: int = 0, error: str = "") -> None:
        self._lib.hvd_handle_done(h, status, error.encode())

    def poll(self, h: int) -> int:
        return self._lib.hvd_handle_poll(h)

    def wait(self, h: int, timeout_s: float = -1.0) -> int:
        return self._lib.hvd_handle_wait(h, timeout_s)

    def error(self, h: int) -> str:
        buf = ctypes.create_string_buffer(1024)
        self._lib.hvd_handle_error(h, buf, len(buf))
        return buf.value.decode()

    def release(self, h: int) -> None:
        self._lib.hvd_handle_release(h)

    def pending(self) -> int:
        return self._lib.hvd_handle_pending()


class NativeScheduler:
    """Cycle-time micro-batching scheduler (TensorQueue + RunLoopOnce).

    Python registers payloads keyed by request id; the native background
    thread groups requests (per dtype code, up to the fusion threshold)
    every cycle -- or, deterministic, at each :meth:`flush` only, in name
    order -- and invokes ``on_batch(payloads)`` from its own thread.
    """

    def __init__(self, on_batch: Callable[[List], None],
                 cycle_ms: float = 1.0,
                 fusion_bytes: int = 64 << 20,
                 stall_warn_s: float = 60.0,
                 deterministic: bool = False, lib=None):
        self._lib = lib or require_lib()
        self._payloads: Dict[int, object] = {}
        self._plock = threading.Lock()
        self._on_batch = on_batch

        def _cb(ids_ptr, n):
            ids = [ids_ptr[i] for i in range(n)]
            with self._plock:
                payloads = [self._payloads.pop(i) for i in ids
                            if i in self._payloads]
            if payloads:
                try:
                    self._on_batch(payloads)
                except Exception:  # noqa: BLE001 - background thread
                    log.exception("native scheduler batch callback failed")

        self._cb = BatchCB(_cb)  # keep a ref; C holds the raw pointer
        rc = self._lib.hvd_sched_start(cycle_ms, fusion_bytes, self._cb,
                                       stall_warn_s, int(deterministic))
        if rc != 0:
            raise RuntimeError("scheduler already running (singleton)")

    def enqueue(self, payload, name: str, dtype_code: int, nbytes: int,
                handle: int = 0) -> int:
        # The payload is registered under the lock the dispatch callback
        # takes, so a cycle firing between the native enqueue and the
        # registration waits until the payload is in place.
        with self._plock:
            rid = self._lib.hvd_sched_enqueue(name.encode(), dtype_code,
                                              nbytes, handle)
            if rid < 0:
                raise RuntimeError("scheduler not running")
            self._payloads[rid] = payload
        return rid

    def flush(self) -> None:
        self._lib.hvd_sched_flush()

    def pending(self) -> int:
        return self._lib.hvd_sched_pending()

    def update_tuning(self, cycle_ms: float = -1.0,
                      fusion_bytes: int = -1) -> None:
        self._lib.hvd_sched_update_tuning(cycle_ms, fusion_bytes)

    def stop(self) -> None:
        self._lib.hvd_sched_stop()


class NativeCache:
    """LRU response-signature cache (ResponseCache parity)."""

    def __init__(self, capacity: int = 1024, lib=None):
        self._lib = lib or require_lib()
        self._lib.hvd_cache_configure(capacity)

    def lookup(self, sig: str) -> bool:
        return bool(self._lib.hvd_cache_lookup(sig.encode()))

    def insert(self, sig: str) -> None:
        self._lib.hvd_cache_insert(sig.encode())

    def __len__(self) -> int:
        return self._lib.hvd_cache_size()

    def stats(self):
        hits = ctypes.c_longlong()
        misses = ctypes.c_longlong()
        self._lib.hvd_cache_stats(ctypes.byref(hits), ctypes.byref(misses))
        return hits.value, misses.value


class NativeTimeline:
    """Background-thread chrome-trace writer (timeline.cc parity)."""

    def __init__(self, path: str, lib=None):
        self._lib = lib or require_lib()
        rc = self._lib.hvd_timeline_open(path.encode())
        if rc != 0:
            raise RuntimeError(f"timeline open failed ({rc}): {path}")

    def event(self, name: str, cat: str, ph: str, ts_us: float,
              dur_us: float = 0.0, tid: int = 0) -> None:
        self._lib.hvd_timeline_event(name.encode(), cat.encode(),
                                     ph.encode(), ts_us, dur_us, tid)

    def close(self) -> None:
        self._lib.hvd_timeline_close()
