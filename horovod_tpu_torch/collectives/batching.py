"""Native cycle-time gradient batching (the batched ``DistributedOptimizer``).

Counterpart of ``horovod_tpu/torch_api/batching.py``, upstream's hot path
(``horovod/common/operations.cc::RunLoopOnce``): gradient hooks enqueue
each gradient to the native C++ queue (:mod:`horovod_tpu_torch._core`);
its background thread cuts fused batches -- every ``HOROVOD_CYCLE_TIME``
ms, or, deterministic, at each :meth:`GradBatcher.flush` only, in name
order -- up to ``HOROVOD_FUSION_THRESHOLD`` bytes, grouped by (dtype,
op, codec, process set, pre/postscale); its callback runs ONE
:func:`~horovod_tpu_torch.collectives.ops.grouped_allreduce` per batch,
copies the results into the gradients in place and completes the native
handles.  :meth:`GradBatcher.wait` is flush + wait.

Deterministic mode (batches cut at flush only) is a correctness
requirement at world > 1 -- NCCL and gloo match collectives by issue
order, so every rank must cut identical batches -- and the default on
the GPU at world 1; on the CPU at world 1 batches follow the clock
unless ``HOROVOD_DETERMINISTIC`` says otherwise.

On CUDA the callback runs on the native thread, whose current stream is
not the one that produced the gradient: the hook records an event on the
producer's stream that the callback's stream waits on, and the callback
records one that :meth:`GradBatcher.wait` makes the caller's stream wait
on.
"""

from __future__ import annotations

import atexit
import threading
from typing import Dict, List, Optional, Tuple

import torch

from .. import _core
from ..core.exceptions import HorovodInternalError
from ..core.state import global_state

_lock = threading.Lock()
_batcher: Optional["GradBatcher"] = None
_tls = threading.local()             # .on_batcher: the callback's thread


def on_batcher_thread() -> bool:
    """True inside the batcher's callback (on the native thread)."""
    return getattr(_tls, "on_batcher", False)


class GradBatcher:
    """Hooks :meth:`enqueue` gradients; the native thread fuses and
    reduces them; :meth:`wait` returns once a gradient holds its reduced
    value."""

    def __init__(self, cycle_ms: float, fusion_bytes: int,
                 stall_warn_s: float, deterministic: bool = False):
        self.handles = _core.NativeHandles()
        self.deterministic = deterministic
        self.cycle_ms = float(cycle_ms)
        self.fusion_bytes = int(fusion_bytes)
        self._group_codes: Dict[Tuple, int] = {}
        self._done_events: Dict[int, object] = {}
        self._batches = 0
        self._sched = _core.NativeScheduler(
            self._on_batch, cycle_ms=cycle_ms, fusion_bytes=fusion_bytes,
            stall_warn_s=stall_warn_s, deterministic=deterministic)

    def _code(self, key: Tuple) -> int:
        # The native scheduler groups by an int "dtype" code; every field
        # that must be uniform within one fused dispatch folds into it.
        with _lock:
            return self._group_codes.setdefault(key, len(self._group_codes))

    def enqueue(self, tensor: torch.Tensor, name: str, op, compression,
                process_set, prescale_factor: float = 1.0,
                postscale_factor: float = 1.0) -> int:
        """Queue ``tensor`` (reduced in place); its native handle."""
        h = self.handles.create()
        ps_name = getattr(process_set, "name", process_set)
        code = self._code((str(tensor.dtype), str(op),
                           compression.__name__, ps_name,
                           float(prescale_factor), float(postscale_factor)))
        ready = None
        if tensor.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(tensor.device))
        payload = (h, tensor, op, compression, process_set,
                   prescale_factor, postscale_factor, ready)
        self._sched.enqueue(payload, name=name, dtype_code=code,
                            nbytes=tensor.numel() * tensor.element_size(),
                            handle=h)
        return h

    def _on_batch(self, payloads: List) -> None:
        # Runs on the native cycle thread (ctypes holds the GIL here).
        _tls.on_batcher = True
        try:
            from . import ops
            tensors = [p[1] for p in payloads]
            _, t0, op, compression, process_set, pre, post, _ = payloads[0]
            if t0.is_cuda:
                stream = torch.cuda.current_stream(t0.device)
                for p in payloads:
                    stream.wait_event(p[7])
            outs = ops.grouped_allreduce(
                tensors, op=op, compression=compression,
                process_set=process_set, prescale_factor=pre,
                postscale_factor=post, name="cycle_fused")
            for t, o in zip(tensors, outs):
                t.copy_(o)
            done = None
            if t0.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(t0.device))
            with _lock:
                self._batches += 1
                for p in payloads:
                    self._done_events[p[0]] = done
            for p in payloads:
                self.handles.done(p[0], 0)
        except Exception as e:  # noqa: BLE001 - delivered through handles
            for p in payloads:
                self.handles.done(p[0], 1, f"{type(e).__name__}: {e}")
        finally:
            _tls.on_batcher = False

    def flush(self) -> None:
        """Cut and dispatch every batch enqueued so far; returns once
        their callbacks ran."""
        self._sched.flush()

    def wait(self, h: int, timeout_s: float = 300.0) -> None:
        """Flush, then wait for handle ``h``; the gradient then holds its
        reduced value (ordered before the caller's stream's later work).
        The handle is released either way."""
        self._sched.flush()
        status = self.handles.wait(h, timeout_s)
        err = self.handles.error(h) if status not in (0, -2, -3) else ""
        self.handles.release(h)   # a leaked entry would trip the stall
        with _lock:                # inspector forever
            done = self._done_events.pop(h, None)
        if status == -2:
            raise HorovodInternalError(
                f"allreduce handle {h} timed out after {timeout_s}s")
        if status not in (0, -3):
            raise HorovodInternalError(
                f"fused allreduce failed: {err or status}")
        if done is not None:
            torch.cuda.current_stream().wait_event(done)

    def poll(self, h: int) -> bool:
        return self.handles.poll(h) != 0

    def batches(self) -> int:
        """Batches dispatched since the batcher started."""
        with _lock:
            return self._batches

    def update_tuning(self, cycle_ms: float = -1.0,
                      fusion_bytes: int = -1) -> None:
        """Push the autotuner's cycle time (ms) and fusion threshold
        (bytes) into the native scheduler (-1 keeps a value)."""
        if cycle_ms > 0:
            self.cycle_ms = float(cycle_ms)
        if fusion_bytes > 0:
            self.fusion_bytes = int(fusion_bytes)
        self._sched.update_tuning(cycle_ms, fusion_bytes)

    def stop(self) -> None:
        self._sched.stop()


def resolve_deterministic(cfg, size: int, device) -> bool:
    """The batcher's mode: always deterministic at world > 1 (NCCL and
    gloo match collectives by issue order, so every rank must cut
    identical batches); at world 1 ``HOROVOD_DETERMINISTIC`` when set,
    else deterministic on the GPU and not on the CPU."""
    if size > 1:
        return True
    if cfg is not None and cfg.deterministic is not None:
        return bool(cfg.deterministic)
    return getattr(device, "type", "cpu") == "cuda"


def current() -> Optional[GradBatcher]:
    """The running batcher, or None."""
    return _batcher


def batcher() -> GradBatcher:
    """The process-wide batcher, started at first use over the native
    core (which raises ``RuntimeError`` if it cannot be built: the
    batched path never falls back quietly)."""
    global _batcher
    with _lock:
        if _batcher is None:
            st = global_state()
            cfg = st.config
            if cfg is None:
                raise RuntimeError(
                    "the native gradient batcher needs hvd.init()")
            from ..controller.fusion import fusion_threshold
            stall = 0.0 if cfg.stall_check_disable else cfg.stall_check_time
            cycle = cfg.cycle_time
            if st.autotuner is not None and st.autotuner.tunes_cycle:
                cycle = st.autotuner.cycle_time_ms()
            _batcher = GradBatcher(
                cycle, fusion_threshold(), stall,
                deterministic=resolve_deterministic(cfg, st.size,
                                                    st.device))
            atexit.register(shutdown_batcher)
        return _batcher


def shutdown_batcher() -> None:
    """Stop the native thread (``hvd.shutdown()``); the next
    :func:`batcher` starts a new one."""
    global _batcher
    with _lock:
        b, _batcher = _batcher, None
    if b is not None:
        b.stop()
