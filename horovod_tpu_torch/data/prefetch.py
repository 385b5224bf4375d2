"""Double-buffered host-to-device batch prefetcher.

Counterpart of ``horovod_tpu/data/prefetch.py``: a producer thread stays
``depth`` batches ahead of the consumer, so a batch's copy to the card
overlaps the steps on earlier ones.  On the GPU the producer pins each
host tensor, copies it on its own CUDA stream and records an event;
``__next__`` makes the consumer's current stream wait on that event and
``record_stream``\\ s each tensor on it, so the copy is ordered before
the step that reads it and its memory is not reused under it.
``stack_steps=k`` groups k host batches, stacks each tensor on a new
leading axis -- the ``[k, batch, ...]`` layout of
``training.make_train_loop`` -- and drops a trailing partial group
(``dropped_remainder``).  ``device="cpu"`` moves nothing (the tests).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import torch

from ..core.device import resolve_device
from ..core.state import global_state
from .tree import stack_steps, tree_leaves, tree_map


class _Stop:
    """Sentinel carrying the producer's exit: clean end or an exception."""

    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


class DevicePrefetcher:
    """Iterate host batches already on ``device``, ``depth`` ahead.

    ``iterator``: any iterable of batches (tensors or numpy arrays,
    nested in tuples, lists or dicts).  ``depth`` (default 2: double
    buffering) bounds the queue, so at most ``depth`` staged batches
    wait on the card.  ``device``: where to put the batches (default the
    device ``init()`` chose, else ``cuda``).  ``stack_steps > 1``: group
    that many host batches an item, stacked on a new leading axis; a
    trailing partial group is dropped and counted in
    ``dropped_remainder``."""

    def __init__(self, iterator: Iterable, depth: int = 2, device=None,
                 stack_steps: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if stack_steps < 1:
            raise ValueError(
                f"stack_steps must be >= 1, got {stack_steps}")
        if device is None:
            device = global_state().device
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        self._stack = stack_steps
        self.dropped_remainder = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterator),),
            name="hvd-prefetch", daemon=True)
        self._thread.start()

    # -- producer ---------------------------------------------------------
    def _put(self, item) -> bool:
        """Enqueue, giving up promptly if the consumer closed us."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, host):
        """``(batch on the device, event after its copy or None)``."""
        host = tree_map(torch.as_tensor, host)
        if not self._cuda:
            return tree_map(lambda x: x.to(self._device), host), None
        with torch.cuda.stream(self._copy_stream):
            dev = tree_map(lambda x: x.pin_memory().to(
                self._device, non_blocking=True), host)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _produce(self, it: Iterator) -> None:
        try:
            while not self._stop.is_set():
                if self._stack > 1:
                    group = []
                    for _ in range(self._stack):
                        try:
                            group.append(next(it))
                        except StopIteration:
                            break
                    if len(group) < self._stack:
                        self.dropped_remainder += len(group)
                        break
                    host = stack_steps(tree_map(torch.as_tensor, g)
                                       for g in group)
                else:
                    try:
                        host = next(it)
                    except StopIteration:
                        break
                if not self._put(self._to_device(host)):
                    return
            self._put(_Stop())
        except BaseException as e:  # surface in the consumer thread
            # Recorded before the sentinel: if the sentinel is lost, the
            # consumer's starved-queue path still raises the error.
            self._error = e
            self._put(_Stop(e))

    # -- consumer ---------------------------------------------------------
    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                # Queued batches (and an enqueued error) drain first; a
                # starved queue consults the producer: its recorded error
                # re-raises, a dead producer without one ends the input.
                if self._error is not None:
                    self._stop.set()
                    raise self._error
                if not self._thread.is_alive():
                    self._stop.set()
                    raise StopIteration
        if isinstance(item, _Stop):
            self._stop.set()
            if item.error is not None:
                raise item.error
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for x in tree_leaves(batch):
                x.record_stream(current)
        return batch

    def close(self) -> None:
        """Stop the producer and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(iterator: Iterable, depth: int = 2, device=None,
                       stack_steps: int = 1) -> DevicePrefetcher:
    """Functional spelling of :class:`DevicePrefetcher`."""
    return DevicePrefetcher(iterator, depth=depth, device=device,
                            stack_steps=stack_steps)
