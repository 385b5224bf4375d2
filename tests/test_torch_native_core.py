"""PyTorch/CUDA port: the native C++ coordination core
(``horovod_tpu_torch/_core``, the port's own copy of ``core.cc``) --
handles, the cycle scheduler, the LRU cache and the timeline writer --
held to the expectations of ``tests/test_native_core.py``, case for case.

The library builds here with ``g++`` from the port's source into
``horovod_tpu_torch/_core/build/`` (git-ignored) at first use.  The
JAX package's library is a separate shared object with its own globals,
so both files can run in one process.
"""

import json
import threading
import time

import pytest

from horovod_tpu_torch import _core

pytestmark = pytest.mark.skipif(
    not _core.available(),
    reason=f"native core unavailable: {_core.unavailable_reason()}")


def test_version_string():
    assert b"hvdcore" in _core.get_lib().hvd_core_version()
    assert _core.get_lib()._name.startswith(_core.BUILD_DIR)


# ---------------------------------------------------------------------------
# HandleManager
# ---------------------------------------------------------------------------


def test_handle_lifecycle():
    hm = _core.NativeHandles()
    h = hm.create()
    assert hm.poll(h) == 0
    hm.done(h, 0)
    assert hm.poll(h) == 1
    assert hm.wait(h) == 0
    hm.release(h)
    assert hm.poll(h) == -1


def test_handle_error_propagation():
    hm = _core.NativeHandles()
    h = hm.create()
    hm.done(h, 7, "peer vanished")
    assert hm.wait(h) == 7
    assert hm.error(h) == "peer vanished"
    hm.release(h)


def test_handle_wait_blocks_across_threads():
    hm = _core.NativeHandles()
    h = hm.create()
    results = {}

    def waiter():
        results["status"] = hm.wait(h, timeout_s=10.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # still blocked
    hm.done(h, 0)
    t.join(timeout=5.0)
    assert results["status"] == 0
    hm.release(h)


def test_handle_wait_timeout():
    hm = _core.NativeHandles()
    h = hm.create()
    assert hm.wait(h, timeout_s=0.05) == -2  # timeout
    hm.release(h)


# ---------------------------------------------------------------------------
# Cycle scheduler
# ---------------------------------------------------------------------------


def test_scheduler_batches_within_cycle():
    batches = []
    done = threading.Event()

    def on_batch(payloads):
        batches.append(payloads)
        done.set()

    sched = _core.NativeScheduler(on_batch, cycle_ms=20.0)
    try:
        for i in range(5):
            sched.enqueue(("grad", i), name=f"g{i}", dtype_code=1,
                          nbytes=1000)
        assert done.wait(5.0)
        time.sleep(0.05)  # allow the cycle to finish draining
        got = [p for b in batches for p in b]
        assert sorted(got) == [("grad", i) for i in range(5)]
        # All five fit one fusion bucket -> exactly one batch.
        assert len(batches) == 1
    finally:
        sched.stop()


def test_scheduler_fusion_threshold_splits_batches():
    batches = []

    def on_batch(payloads):
        batches.append(payloads)

    # Threshold 3 KB, tensors of 1 KB -> groups of <= 3.
    sched = _core.NativeScheduler(on_batch, cycle_ms=1000.0,
                                  fusion_bytes=3000)
    try:
        for i in range(7):
            sched.enqueue(i, name=f"g{i}", dtype_code=1, nbytes=1000)
        sched.flush()
        time.sleep(0.1)
        assert sorted(p for b in batches for p in b) == list(range(7))
        assert all(len(b) <= 3 for b in batches)
        assert len(batches) >= 3
    finally:
        sched.stop()


def test_scheduler_groups_by_dtype():
    batches = []

    def on_batch(payloads):
        batches.append(payloads)

    sched = _core.NativeScheduler(on_batch, cycle_ms=1000.0)
    try:
        sched.enqueue("f32_a", name="a", dtype_code=1, nbytes=10)
        sched.enqueue("f16_a", name="b", dtype_code=2, nbytes=10)
        sched.enqueue("f32_b", name="c", dtype_code=1, nbytes=10)
        sched.flush()
        time.sleep(0.1)
        assert len(batches) == 2
        by_first = {b[0][:3]: b for b in batches}
        assert sorted(by_first["f32"]) == ["f32_a", "f32_b"]
        assert by_first["f16"] == ["f16_a"]
    finally:
        sched.stop()


def test_scheduler_full_buffer_dispatches_early():
    """Hitting the fusion threshold cuts the cycle short."""
    done = threading.Event()

    def on_batch(payloads):
        done.set()

    # Cycle of 10 s -- only the full-buffer path can dispatch quickly.
    sched = _core.NativeScheduler(on_batch, cycle_ms=10_000.0,
                                  fusion_bytes=1000)
    try:
        t0 = time.perf_counter()
        sched.enqueue("big", name="big", dtype_code=1, nbytes=2000)
        assert done.wait(5.0)
        assert time.perf_counter() - t0 < 5.0
    finally:
        sched.stop()


def test_scheduler_handle_integration():
    """End-to-end: enqueue -> batch callback completes handles."""
    hm = _core.NativeHandles()

    def on_batch(payloads):
        for h in payloads:
            hm.done(h, 0)

    sched = _core.NativeScheduler(on_batch, cycle_ms=5.0)
    try:
        handles = []
        for i in range(4):
            h = hm.create()
            sched.enqueue(h, name=f"t{i}", dtype_code=1, nbytes=100,
                          handle=h)
            handles.append(h)
        for h in handles:
            assert hm.wait(h, timeout_s=5.0) == 0
            hm.release(h)
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# ResponseCache
# ---------------------------------------------------------------------------


def test_cache_lru_eviction():
    cache = _core.NativeCache(capacity=3)
    for sig in ("a", "b", "c"):
        cache.insert(sig)
    assert cache.lookup("a")  # refresh a
    cache.insert("d")         # evicts b (LRU)
    assert cache.lookup("a")
    assert not cache.lookup("b")
    assert cache.lookup("c") and cache.lookup("d")
    assert len(cache) == 3
    hits, misses = cache.stats()
    assert hits >= 4 and misses >= 1


# ---------------------------------------------------------------------------
# Timeline
# ---------------------------------------------------------------------------


def test_timeline_writes_valid_chrome_trace(tmp_path):
    path = str(tmp_path / "timeline.json")
    tl = _core.NativeTimeline(path)
    tl.event("allreduce.grad0", "NEGOTIATE_ALLREDUCE", "B", 10.0)
    tl.event("allreduce.grad0", "NEGOTIATE_ALLREDUCE", "E", 60.0)
    tl.event("allreduce.grad0", "ALLREDUCE", "X", 70.0, dur_us=230.0)
    tl.close()
    events = json.load(open(path))
    assert len(events) == 3
    assert events[2]["ph"] == "X" and events[2]["dur"] == 230.0
    assert events[0]["name"] == "allreduce.grad0"


def test_deterministic_flush_watermark_excludes_late_enqueues():
    """A stale flush flag must not sweep up requests enqueued after the
    flush call (bucket divergence regression: rank A's late flush
    wakeup grabbed 3 of the next step's 4 gradients and cut a different
    fused bucket than rank B)."""
    import time
    batches = []

    def on_batch(payloads):
        batches.append(list(payloads))

    sched = _core.NativeScheduler(on_batch, cycle_ms=1.0,
                                  deterministic=True)
    try:
        sched.enqueue("a", name="g.a", dtype_code=0, nbytes=8)
        sched.enqueue("b", name="g.b", dtype_code=0, nbytes=8)
        sched.flush()
        assert [sorted(b) for b in batches] == [["a", "b"]]
        # Enqueue after the flush: cycle ticks alone must NOT dispatch it
        # in deterministic mode, even though flush flags were just set.
        sched.enqueue("c", name="g.c", dtype_code=0, nbytes=8)
        time.sleep(0.05)  # many cycle ticks
        assert len(batches) == 1
        assert sched.pending() == 1
        sched.flush()
        assert [sorted(b) for b in batches] == [["a", "b"], ["c"]]
    finally:
        sched.stop()


def test_deterministic_rapid_flush_then_enqueue_race():
    """Tight loop of (enqueue x4, flush) must always cut 4-element batches
    -- the exact pattern of per-step gradient sync."""
    batches = []

    def on_batch(payloads):
        batches.append(list(payloads))

    sched = _core.NativeScheduler(on_batch, cycle_ms=0.1,
                                  deterministic=True)
    try:
        for step in range(200):
            for j in range(4):
                sched.enqueue(f"{step}/{j}", name=f"g.{j}", dtype_code=0,
                              nbytes=8)
            sched.flush()
    finally:
        sched.stop()
    assert len(batches) == 200
    assert all(len(b) == 4 for b in batches)


def test_thread_affinity_env(monkeypatch):
    """HOROVOD_THREAD_AFFINITY pins the native cycle thread: the
    scheduler must start (PinThread runs in Start), batch, and stop with
    the env set -- including the reference's comma-separated form and a
    malformed value, both of which must be non-fatal."""
    import threading
    import time

    for value in ("0", "0,1", "not-a-cpu"):
        batches, done = [], threading.Event()

        def on_batch(payloads, batches=batches, done=done):
            batches.append(payloads)
            done.set()

        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", value)
        sched = _core.NativeScheduler(on_batch, cycle_ms=20.0)
        try:
            sched.enqueue(("g", 0), name="g0", dtype_code=1, nbytes=8)
            assert done.wait(5.0), f"no batch under affinity={value!r}"
            time.sleep(0.05)
        finally:
            sched.stop()
        assert [p for b in batches for p in b] == [("g", 0)]
