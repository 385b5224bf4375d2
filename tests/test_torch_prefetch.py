"""PyTorch/CUDA port: the device prefetcher (``horovod_tpu_torch.data``),
the eight cases of ``tests/test_prefetch.py`` on CPU tensors
(``device="cpu"``; the CUDA stream and event handoff is
``tests/test_torch_cuda.py``'s).

The producer thread stages host batches ``depth`` ahead of the consumer;
with ``stack_steps=k`` it groups k batches into the ``make_train_loop``
stacked layout and drops a trailing partial group.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.data import DevicePrefetcher, prefetch_to_device


def _host_batches(n, shape=(16, 3)):
    return [{"x": np.full(shape, i, np.float32),
             "y": np.full((shape[0],), i, np.int32)} for i in range(n)]


def test_prefetcher_yields_all_batches_on_device():
    batches = _host_batches(5)
    with DevicePrefetcher(batches, depth=2, device="cpu") as pf:
        out = list(pf)
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == \
            "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), batches[i]["y"])
    assert pf.dropped_remainder == 0


def test_prefetcher_stacks_steps_and_drops_remainder():
    batches = _host_batches(5)
    with DevicePrefetcher(batches, stack_steps=2, device="cpu") as pf:
        out = list(pf)
    # 5 host batches / 2 a group -> 2 whole groups, 1 dropped.
    assert len(out) == 2
    assert pf.dropped_remainder == 1
    for g, b in enumerate(out):
        assert tuple(b["x"].shape) == (2, 16, 3)
        np.testing.assert_array_equal(b["x"][1].numpy(),
                                      batches[2 * g + 1]["x"])


def test_prefetcher_feeds_train_loop(monkeypatch):
    """Prefetched stacked windows drive ``make_train_loop``."""
    from horovod_tpu_torch.training import make_train_loop
    for k in ("RANK", "WORLD_SIZE", "HOROVOD_RANK", "HOROVOD_SIZE",
              "HOROVOD_STEPS_PER_EXEC", "HOROVOD_MICROBATCHES"):
        monkeypatch.delenv(k, raising=False)
    k = 2
    thvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.zeros(3, 2))
        model = torch.nn.Module()
        model.register_parameter("w", w)
        opt = thvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
        loop = make_train_loop(
            model, lambda m, b: ((b["x"] @ m.w) ** 2).mean()
            + 0.0 * b["y"].float().sum(), opt, steps_per_execution=k)
        seen = 0
        with prefetch_to_device(_host_batches(4), stack_steps=k,
                                device="cpu") as pf:
            for window in pf:
                losses = loop(window)
                assert losses.shape == (k,)
                seen += 1
        assert seen == 2
        assert torch.isfinite(w).all()
    finally:
        thvd.shutdown()


def test_prefetcher_propagates_producer_errors():
    def gen():
        yield {"x": np.zeros((16, 3), np.float32)}
        raise RuntimeError("input pipeline boom")

    pf = DevicePrefetcher(gen(), depth=2, device="cpu")
    next(pf)  # the good batch
    with pytest.raises(RuntimeError, match="input pipeline boom"):
        next(pf)
    pf.close()


def test_prefetcher_close_stops_producer_promptly():
    produced = [0]

    def endless():
        while True:
            produced[0] += 1
            yield {"x": np.zeros((16, 3), np.float32)}

    pf = DevicePrefetcher(endless(), depth=2, device="cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    # Bounded queue: the producer never ran far ahead of depth.
    assert produced[0] <= 2 + 2 + 1


def test_prefetcher_rejects_bad_args():
    with pytest.raises(ValueError):
        DevicePrefetcher([], depth=0, device="cpu")
    with pytest.raises(ValueError):
        DevicePrefetcher([], stack_steps=0, device="cpu")


def test_prefetcher_empty_iterator():
    with DevicePrefetcher([], depth=2, device="cpu") as pf:
        assert list(pf) == []


def test_prefetcher_surfaces_error_even_when_sentinel_is_lost(monkeypatch):
    """A poisoned iterator raises on the consumer's next ``__next__`` even
    if the producer's error sentinel never lands in the queue."""
    from horovod_tpu_torch.data.prefetch import _Stop

    orig_put = DevicePrefetcher._put

    def lossy_put(self, item):
        if isinstance(item, _Stop) and item.error is not None:
            return False  # drop the error sentinel on the floor
        return orig_put(self, item)

    monkeypatch.setattr(DevicePrefetcher, "_put", lossy_put)

    def gen():
        yield {"x": np.zeros((16, 3), np.float32)}
        raise RuntimeError("poisoned iterator")

    pf = DevicePrefetcher(gen(), depth=2, device="cpu")
    next(pf)  # the good batch still arrives first (FIFO preserved)
    with pytest.raises(RuntimeError, match="poisoned iterator"):
        next(pf)
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
