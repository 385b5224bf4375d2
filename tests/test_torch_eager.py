"""PyTorch/CUDA port: the eager control plane's flush, ragged ops and
join pieces, against the JAX package (``horovod_tpu/collectives/
eager.py``, ``joinop.py``, ``controller/fusion.py``).

* ``controller.fusion.plan_eager_flush`` equals the JAX planner's bucket
  plans on the same leaves and thresholds; ``eager._plan_flush_units``
  cuts the same units in the same order as the JAX function on the same
  pending set, under ``HOROVOD_EXCHANGE_SCHEDULE=program`` and
  ``bandwidth`` (the port's bandwidth order holds no link rate: fused
  units by wire bytes, then issue position);
* ``joinop.identity_value`` equals JAX's for each op and dtype;
* ``allgatherv``, ``alltoallv``, ``alltoallv_row`` and ``local_result``
  at gloo worlds of 2, 3 and 4 (this file as each rank, over a
  ``FileStore`` under pytest's tmp dir) equal the JAX ops on a
  one-process mesh of as many CPU devices, on the same numpy inputs from
  a seed; the deferred fused flush at those worlds (where it applies)
  gives every handle its sum;
* the counterparts of ``tests/test_joinop_units.py`` and
  ``tests/test_deferred_fuse.py`` that are not about JAX mesh fences, at
  world 1 with deferral forced through the ``eager._defer_applies``
  seam: error stamping, a ``KeyError`` after a failed flush, mixed keys
  that do not fuse, threshold splits, a lone op without fusion overhead,
  ``HOROVOD_DEFERRED_FUSE=0``, deferred ops dropped at shutdown, the
  timeline counters and metric families, the header's round trip and
  the replay of every codec.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.collectives import eager as teager
from horovod_tpu_torch.collectives import joinop as tjoin
from horovod_tpu_torch.controller import fusion as tfusion
from horovod_tpu_torch.core.state import global_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
WORLDS = (2, 3, 4)
TAIL = (3,)
SEED = 16


# ---------------------------------------------------------------------------
# Planner parity
# ---------------------------------------------------------------------------

# (shape, numpy dtype) leaves of one flush: several dtypes, a scalar-like
# row, a big row and ragged sizes.
LEAVES = [((3,), np.float32), ((2, 2), np.float64), ((5,), np.float32),
          ((1,), np.float32), ((4, 4), np.float32), ((7,), np.float64),
          ((2,), np.int32), ((6,), np.float32), ((3, 3), np.int32)]


def _torch_dtype(dt):
    return torch.from_numpy(np.zeros(1, dt)).dtype


def _spec_rows(spec):
    from horovod_tpu_torch.controller.fusion import dtype_name
    out = []
    for dt, lspecs in spec.buffers:
        name = dtype_name(dt) if isinstance(dt, torch.dtype) \
            else np.dtype(dt).name
        out.append((name, [(s.index, tuple(s.shape), s.size)
                           for s in lspecs]))
    return out


@pytest.mark.parametrize("threshold", [16, 40, 64, 1 << 20])
def test_plan_eager_flush_matches_jax(threshold):
    from horovod_tpu.controller import fusion as jfusion
    jleaves = [np.zeros((1,) + shape, dt) for shape, dt in LEAVES]
    tleaves = [torch.zeros(shape, dtype=_torch_dtype(dt))
               for shape, dt in LEAVES]
    want = jfusion.plan_eager_flush(jleaves, 1, threshold, extra=("g",))
    got = tfusion.plan_eager_flush(tleaves, 1, threshold, extra=("g",))
    assert _spec_rows(got) == _spec_rows(want)
    assert got.num_leaves == want.num_leaves == len(LEAVES)
    # Memoized under the eager-flush key.
    assert tfusion.plan_eager_flush(tleaves, 1, threshold,
                                    extra=("g",)) is got


# (shape, dtype, op, prescale, codec) of a pending set: two fusable
# f32 Sum groups split by the threshold, an f64 pair, a prescale that
# breaks a key, an fp16 pair, an Average pair and a lone Max.
PENDING = [((4,), np.float32, "sum", 1.0, "none"),
           ((2, 2), np.float64, "sum", 1.0, "none"),
           ((8,), np.float32, "sum", 1.0, "none"),
           ((3,), np.float32, "sum", 0.5, "none"),
           ((6,), np.float32, "sum", 1.0, "fp16"),
           ((2,), np.float64, "sum", 1.0, "none"),
           ((5,), np.float32, "average", 1.0, "none"),
           ((16,), np.float32, "sum", 1.0, "none"),
           ((6,), np.float32, "sum", 1.0, "fp16"),
           ((5,), np.float32, "max", 1.0, "none"),
           ((1,), np.float32, "average", 1.0, "none"),
           ((2,), np.float32, "sum", 1.0, "none")]


class _Set:
    name = "global"


def _units(pending, flush_units):
    return [(u.pos, tuple(u.handles), u.fused)
            for u in flush_units(pending, True)]


@pytest.mark.parametrize("threshold", [48, 1 << 20])
@pytest.mark.parametrize("mode", ["program", "bandwidth"])
def test_flush_units_match_jax(monkeypatch, mode, threshold):
    from horovod_tpu.collectives import eager as jeager
    from horovod_tpu.collectives.compression import Compression as JComp
    from horovod_tpu.collectives.reduce_op import ReduceOp as JOp
    from horovod_tpu_torch.collectives.compression import Compression
    from horovod_tpu_torch.collectives.reduce_op import ReduceOp
    monkeypatch.setenv("HOROVOD_EXCHANGE_SCHEDULE", mode)
    for mod in (jeager, teager):
        monkeypatch.setattr(mod, "local_rank_count", lambda ps=None: 1)
        monkeypatch.setattr(mod, "_deferred_fuse_threshold",
                            lambda: threshold)
    ps = _Set()
    jpend, tpend = [], []
    for i, (shape, dt, op, pre, codec) in enumerate(PENDING):
        jpend.append((100 + i, jeager._DeferredAllreduce(
            np.zeros((1,) + shape, dt), JOp(op), None, ps, pre, 1.0,
            getattr(JComp, codec))))
        tpend.append((100 + i, teager._DeferredAllreduce(
            torch.zeros(shape, dtype=_torch_dtype(dt)), ReduceOp(op),
            None, ps, pre, 1.0, getattr(Compression, codec))))
    got = _units(tpend, teager._plan_flush_units)
    want = _units(jpend, jeager._plan_flush_units)
    assert got == want
    assert any(f for _, _, f in got) and any(not f for _, _, f in got)
    if mode == "bandwidth":
        fused = [u for u in got if u[2]]
        assert got[:len(fused)] == fused


OPS = ("sum", "average", "adasum", "product", "min", "max")
DTYPES = (np.float32, np.float64, np.float16, np.int32, np.int64, np.int8,
          np.uint8)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("op", OPS)
def test_identity_values_match_jax(op, dtype):
    from horovod_tpu.collectives import joinop as jjoin
    want = jjoin.identity_value(op, np.dtype(dtype))
    assert tjoin.identity_value(op, np.dtype(dtype)) == want
    assert tjoin.identity_value(op, _torch_dtype(dtype)) == want


# ---------------------------------------------------------------------------
# The ragged ops at gloo worlds of 2-4 against the JAX one-process mesh
# ---------------------------------------------------------------------------


def _ragged_inputs(n: int):
    """Per rank: rows (rank 1 has none), data ``[rows, 3]`` and the
    alltoallv splits summing to the rows."""
    rng = np.random.RandomState(SEED + n)
    lens = [int(rng.randint(1, 5)) for _ in range(n)]
    lens[1] = 0
    xs = [rng.randn(m, *TAIL).astype(np.float32) for m in lens]
    splits = []
    for m in lens:
        cuts = np.sort(rng.randint(0, m + 1, size=n - 1))
        splits.append(np.diff(np.concatenate([[0], cuts, [m]]))
                      .astype(np.int32))
    return xs, splits


def _spawn(tmp_path, mode, n):
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(n),
         str(tmp_path / "store"), str(tmp_path / f"r{r}.pt")], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
            for r in range(n)]


def _ragged_rank(rank: int, n: int) -> dict:
    xs, splits = _ragged_inputs(n)
    x = torch.from_numpy(xs[rank])
    out = {"allgatherv": thvd.allgatherv(x),
           "allgatherv_list": thvd.allgatherv([xs[rank]])}
    datas, recv = thvd.alltoallv([x], [splits[rank]])
    out["alltoallv"] = (datas, recv)
    out["alltoallv_row"] = thvd.alltoallv_row(x, splits[rank])
    y = torch.full((2, 3), float(rank + 1))
    out["local_result"] = thvd.local_result(thvd.allreduce(y, op=thvd.Sum))
    out["local_rank_count"] = thvd.local_rank_count()
    out["replicated_stack"] = thvd.replicated_stack(y)
    # The fused deferred flush at world > 1 (the join protocol applies,
    # so allreduce_async queues): 3 f32 + 2 f64 -> two fused buckets.
    hs = [thvd.allreduce_async(torch.full((2,), float(i + 1)), op=thvd.Sum)
          for i in range(3)]
    hs += [thvd.allreduce_async(torch.full((3,), 10.0 * (i + 1),
                                           dtype=torch.float64),
                                op=thvd.Sum) for i in range(2)]
    out["deferred_count"] = teager.deferred_count()
    out["deferred"] = [thvd.synchronize(h) for h in hs]
    out["fuse_stats"] = teager.deferred_fuse_stats()
    out["join_stats"] = tjoin.stats()
    return out


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    return {n: _spawn(tmp_path_factory.mktemp(f"ragged{n}"), "ragged", n)
            for n in WORLDS}


def _jax_world(n):
    import jax
    import horovod_tpu as jhvd
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:n])
    return jhvd


@pytest.mark.parametrize("n", WORLDS)
def test_allgatherv_matches_jax(ragged, n):
    jhvd = _jax_world(n)
    try:
        xs, _ = _ragged_inputs(n)
        want = jhvd.allgatherv(xs)
    finally:
        jhvd.shutdown()
    for r in range(n):
        for key in ("allgatherv", "allgatherv_list"):
            got = ragged[n][r][key]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WORLDS)
def test_alltoallv_matches_jax(ragged, n):
    jhvd = _jax_world(n)
    try:
        xs, splits = _ragged_inputs(n)
        wdatas, wsplits = jhvd.alltoallv(xs, splits)
    finally:
        jhvd.shutdown()
    for r in range(n):
        datas, recv = ragged[n][r]["alltoallv"]
        assert len(datas) == len(recv) == 1
        np.testing.assert_array_equal(datas[0].numpy(), wdatas[r])
        np.testing.assert_array_equal(recv[0].numpy(), wsplits[r])
        row, row_splits = ragged[n][r]["alltoallv_row"]
        np.testing.assert_array_equal(row.numpy(), wdatas[r])
        np.testing.assert_array_equal(row_splits.numpy(), wsplits[r])


@pytest.mark.parametrize("n", WORLDS)
def test_local_result_matches_jax(ragged, n):
    jhvd = _jax_world(n)
    try:
        ys = np.stack([np.full((2, 3), float(r + 1), np.float32)
                       for r in range(n)])
        want = jhvd.local_result(jhvd.allreduce(ys, jhvd.Sum))
    finally:
        jhvd.shutdown()
    for r in range(n):
        res = ragged[n][r]
        assert tuple(res["local_result"].shape) == (1, 2, 3)
        np.testing.assert_array_equal(res["local_result"][0].numpy(),
                                      want[r])
        assert res["local_rank_count"] == 1
        assert tuple(res["replicated_stack"].shape) == (1, 2, 3)


@pytest.mark.parametrize("n", WORLDS)
def test_deferred_flush_fuses_at_world(ragged, n):
    for r in range(n):
        res = ragged[n][r]
        assert res["deferred_count"] == 5
        for got, want in zip(res["deferred"], (1.0, 2.0, 3.0, 10.0, 20.0)):
            assert bool((got == n * want).all()), (got, want)
        assert res["fuse_stats"] == {"flushes": 1, "fused_buckets": 2,
                                     "fused_ops": 5, "singleton_ops": 0}
        # Nobody drained: presence rounds but no header.
        assert res["join_stats"]["presence_rounds"] >= 1
        assert res["join_stats"]["headers"] == 0


# ---------------------------------------------------------------------------
# World 1, deferral forced (tests/test_deferred_fuse.py and
# tests/test_joinop_units.py counterparts)
# ---------------------------------------------------------------------------


@pytest.fixture
def world1(monkeypatch):
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def _force_defer(monkeypatch):
    monkeypatch.setattr(teager, "_defer_applies", lambda ps: True)


def test_mixed_dtype_and_codec_pending_set_splits_into_buckets(
        world1, monkeypatch):
    _force_defer(monkeypatch)
    hs = [thvd.allreduce_async(torch.full((3,), i + 1.0), op=thvd.Sum,
                               name=f"f32_{i}") for i in range(4)]
    hs += [thvd.allreduce_async(torch.full((2, 2), 10.0 * (i + 1),
                                           dtype=torch.float64),
                                op=thvd.Sum) for i in range(2)]
    h_avg = thvd.allreduce_async(torch.full((5,), 6.0))
    h_max = thvd.allreduce_async(torch.full((4,), 2.0), op=thvd.Max,
                                 prescale_factor=0.5)
    assert teager.deferred_count() == 8
    vals = [thvd.synchronize(h) for h in hs]
    for i in range(4):
        assert torch.equal(vals[i], torch.full((3,), i + 1.0))
    for i in range(2):
        assert torch.equal(vals[4 + i], torch.full(
            (2, 2), 10.0 * (i + 1), dtype=torch.float64))
    assert torch.equal(thvd.synchronize(h_avg), torch.full((5,), 6.0))
    assert torch.equal(thvd.synchronize(h_max), torch.full((4,), 1.0))
    assert teager.deferred_fuse_stats() == {
        "flushes": 1, "fused_buckets": 2, "fused_ops": 6,
        "singleton_ops": 2}


def test_mixed_scale_factors_do_not_fuse(world1, monkeypatch):
    _force_defer(monkeypatch)
    h1 = thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
    h2 = thvd.allreduce_async(torch.ones(2), op=thvd.Sum,
                              prescale_factor=0.5)
    assert torch.equal(thvd.synchronize(h1), torch.ones(2))
    assert torch.equal(thvd.synchronize(h2), torch.full((2,), 0.5))
    st = teager.deferred_fuse_stats()
    assert st["fused_buckets"] == 0 and st["singleton_ops"] == 2


def test_threshold_splits_same_key_ops_into_multiple_buckets(
        world1, monkeypatch):
    _force_defer(monkeypatch)
    st = global_state()
    st.config = dataclasses.replace(st.config, deferred_fuse_threshold=32)
    hs = [thvd.allreduce_async(torch.full((4,), i + 1.0), op=thvd.Sum)
          for i in range(3)]
    for i, h in enumerate(hs):
        assert torch.equal(thvd.synchronize(h), torch.full((4,), i + 1.0))
    stats = teager.deferred_fuse_stats()
    assert (stats["fused_buckets"], stats["fused_ops"],
            stats["singleton_ops"]) == (1, 2, 1)


def test_single_pending_op_has_no_fusion_overhead(world1, monkeypatch):
    _force_defer(monkeypatch)
    h = thvd.allreduce_async(torch.full((3,), 5.0), op=thvd.Sum)
    assert teager.deferred_count() == 1
    assert torch.equal(thvd.synchronize(h), torch.full((3,), 5.0))
    assert teager.deferred_fuse_stats() == {
        "flushes": 1, "fused_buckets": 0, "fused_ops": 0,
        "singleton_ops": 1}


def test_deferred_fuse_disabled_keeps_per_op_dispatch(world1, monkeypatch):
    _force_defer(monkeypatch)
    st = global_state()
    st.config = dataclasses.replace(st.config, deferred_fuse=False)
    hs = [thvd.allreduce_async(torch.full((3,), i + 1.0), op=thvd.Sum)
          for i in range(4)]
    for i, h in enumerate(hs):
        assert torch.equal(thvd.synchronize(h), torch.full((3,), i + 1.0))
    stats = teager.deferred_fuse_stats()
    assert stats["fused_buckets"] == 0 and stats["singleton_ops"] == 4


def test_deferred_fuse_env_knobs():
    from horovod_tpu_torch.core.config import load_config
    env = {"HOROVOD_DEFERRED_FUSE": "0",
           "HOROVOD_DEFERRED_FUSE_THRESHOLD": "4096",
           "HOROVOD_JOIN_TIMEOUT": "123", "HOROVOD_JOIN_DISABLE": "1",
           "HOROVOD_DETERMINISTIC": "0", "HVD_TPU_NATIVE_CORE": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert (cfg.deferred_fuse, cfg.deferred_fuse_threshold,
            cfg.join_timeout, cfg.join_disable, cfg.deterministic,
            cfg.native_core) == (False, 4096, 123.0, True, False, True)
    assert load_config().deterministic is None


def test_inplace_deferred_allreduce_writes_back(world1, monkeypatch):
    _force_defer(monkeypatch)
    y = torch.full((3,), 2.0)
    z = torch.full((3,), 3.0)
    hy = thvd.allreduce_async_(y, op=thvd.Sum)
    hz = thvd.allreduce_async_(z, op=thvd.Sum)
    assert thvd.poll(hy) is True          # poll flushes the pending batch
    assert thvd.synchronize(hy) is y and thvd.synchronize(hz) is z
    assert torch.equal(y, torch.full((3,), 2.0))
    assert teager.deferred_fuse_stats()["fused_buckets"] == 1


def test_double_synchronize_after_fused_flush_raises_keyerror(
        world1, monkeypatch):
    _force_defer(monkeypatch)
    h1 = thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
    h2 = thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
    thvd.synchronize(h1)
    thvd.synchronize(h2)
    assert teager.deferred_fuse_stats()["fused_buckets"] == 1
    for h in (h1, h2):
        with pytest.raises(KeyError):
            thvd.synchronize(h)
        with pytest.raises(ValueError, match="has been synchronized"):
            thvd.poll(h)


def test_fused_dispatch_failure_stamps_every_member_handle(
        world1, monkeypatch):
    from horovod_tpu_torch.collectives import ops as tops
    _force_defer(monkeypatch)
    boom = RuntimeError("transport down")

    def raising_allreduce(*a, **k):
        raise boom
    h1 = thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
    h2 = thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
    h3 = thvd.allreduce_async(torch.ones(2, dtype=torch.float64))
    monkeypatch.setattr(tops, "allreduce", raising_allreduce)
    errs = []
    for h in (h1, h2, h3):
        with pytest.raises(RuntimeError) as ei:
            thvd.synchronize(h)
        errs.append(ei.value)
    assert errs[0] is not errs[1]
    assert errs[0].__cause__ is boom and errs[1].__cause__ is boom
    assert "failed during flush" in str(errs[0])
    assert "aborted" in str(errs[2])


def test_deferred_async_flush_order_and_results(world1):
    calls = []

    def mk(i):
        def thunk():
            calls.append(i)
            return torch.full((2,), float(i))
        return thunk

    h1, h2, h3 = (teager.defer(mk(1)), teager.defer(mk(2)),
                  teager.defer(mk(3)))
    assert teager.deferred_count() == 3
    out2 = teager.synchronize(h2)          # flushes the whole batch
    assert calls == [1, 2, 3] and teager.deferred_count() == 0
    assert torch.equal(out2, torch.full((2,), 2.0))
    assert torch.equal(teager.synchronize(h1), torch.full((2,), 1.0))
    assert teager.poll(h3) is True
    assert torch.equal(teager.synchronize(h3), torch.full((2,), 3.0))


def test_deferred_async_error_reaches_every_handle(world1):
    def boom():
        raise ValueError("deferred boom")

    h1 = teager.defer(boom)
    h2 = teager.defer(lambda: torch.ones(2))
    with pytest.raises(RuntimeError, match="aborted") as e2:
        teager.synchronize(h2)
    with pytest.raises(RuntimeError, match="failed during flush") as e1:
        teager.synchronize(h1)
    assert e1.value is not e2.value
    assert isinstance(e1.value.__cause__, ValueError)
    assert e1.value.__cause__ is e2.value.__cause__
    with pytest.raises(KeyError):
        teager.synchronize(h2)


def test_synchronize_unknown_handle_keyerror_despite_flush_failure(world1):
    def boom():
        raise ValueError("deferred boom 2")

    h = teager.defer(boom)
    with pytest.raises(KeyError):
        teager.synchronize(h + 1000)      # unknown handle, failing flush
    with pytest.raises(RuntimeError, match="failed during flush"):
        teager.synchronize(h)             # the real handle still delivers


def test_deferred_dropped_on_shutdown(world1, monkeypatch):
    _force_defer(monkeypatch)
    h = thvd.allreduce_async(torch.ones(1))
    assert teager.deferred_count() == 1
    thvd.shutdown()
    assert teager.deferred_count() == 0
    with pytest.raises(KeyError):
        teager.synchronize(h)
    thvd.init(device="cpu")


def test_allreduce_async_immediate_at_world_1(world1):
    h = thvd.allreduce_async(torch.ones(4), op=thvd.Sum)
    assert teager.deferred_count() == 0
    assert torch.equal(thvd.synchronize(h), torch.ones(4))
    assert not tjoin._applies(thvd.get_process_set(None))
    assert tjoin.sync(thvd.get_process_set(None)).mask is None


def test_join_at_world_1_is_a_barrier(world1):
    assert thvd.join() == -1
    assert thvd.join(device=0) == -1
    assert tjoin.generation() == 0


def test_reset_clears_generation(world1):
    tjoin._gen, tjoin._joined = 3, True
    tjoin.reset()
    assert tjoin._gen == 0 and not tjoin._joined


def test_join_timeout_config_is_honored(world1):
    st = global_state()
    st.config = dataclasses.replace(st.config, join_timeout=123.0)
    assert tjoin._timeout().total_seconds() == 123.0


@pytest.mark.parametrize("meta", [
    {"kind": "allreduce", "dtype": torch.float32, "shape": (2, 3),
     "op": "average", "pre": 0.5, "post": 1.25, "codec": "fp8",
     "fused_ops": 3, "fused_width": 6, "flush": 4},
    {"kind": "broadcast", "dtype": torch.bfloat16, "shape": (5,),
     "root": 3},
    {"kind": "reducescatter", "dtype": torch.int32, "shape": (4, 2),
     "op": "max", "axis": 1, "jk": 2},
    {"kind": "alltoallv", "dtype": torch.float64, "shape": (0, 7, 2)},
    {"kind": "abort", "message": "broadcast root_rank 0 has joined " * 4},
], ids=lambda m: m["kind"])
def test_header_round_trip(meta):
    h = tjoin.encode(meta)
    assert len(h) == tjoin.HEADER_LEN
    back = tjoin.decode(h)
    for key, value in meta.items():
        assert back[key] == value, key


def test_replay_abort_raises_with_message(world1):
    with pytest.raises(RuntimeError, match="root has left"):
        tjoin._replay({"kind": "abort", "message": "root has left"})


def test_replay_rejects_unknown_kind(world1):
    with pytest.raises(RuntimeError, match="unknown join replay kind"):
        tjoin._replay({"kind": "frobnicate", "shape": (1,),
                       "dtype": torch.float32})


@pytest.mark.parametrize("codec,op", [("none", "sum"), ("none", "min"),
                                      ("fp8", "average"),
                                      ("adasum_fp8", "adasum")])
def test_replay_knows_every_codec(world1, codec, op):
    """A drained rank's replay of each allreduce form runs (at world 1
    the collective is local); the header carries the codec."""
    meta = tjoin.decode(tjoin.encode(
        {"kind": "allreduce", "dtype": torch.float32, "shape": (4,),
         "op": op, "codec": codec}))
    tjoin._replay(meta)
    assert not tjoin._replaying


@pytest.mark.parametrize("kind,shape", [("broadcast", (3,)),
                                        ("allgather", (2, 3)),
                                        ("reducescatter", (4,)),
                                        ("alltoall", (2,)),
                                        ("alltoallv", (0, 3)),
                                        ("barrier", ())])
def test_replay_every_kind(world1, kind, shape):
    tjoin._replay({"kind": kind, "dtype": torch.float32, "shape": shape,
                   "op": "sum", "root": 0, "axis": 0})


def test_fence_policy_in_torch_terms(world1):
    assert tfusion._fence_policy() == "blocking(gloo)"
    leg = tfusion.plan_exchange("flat", size=8, dtype="float32").legs[0]
    assert leg.fence == "blocking(gloo)"
    thvd.shutdown()
    try:
        assert tfusion._fence_policy() == ""
    finally:
        thvd.init(device="cpu")


def test_plan_executable_memoizes_by_fingerprint():
    leg = tfusion.plan_exchange("flat", size=12, dtype="float32").legs[0]
    plan = tfusion.ExchangePlan(family="flat", legs=(leg,))
    calls = []

    def build():
        calls.append(1)
        return object()
    a = tfusion.plan_executable(plan, build, extra=("t", 1))
    b = tfusion.plan_executable(
        tfusion.ExchangePlan(family="flat", legs=(leg,)), build,
        extra=("t", 1))
    c = tfusion.plan_executable(plan, build, extra=("t", 2))
    assert a is b and c is not a and len(calls) == 2
    assert plan.fingerprint.startswith("flat:1:")


@pytest.mark.parametrize("mode,want", [("program", "program"),
                                       ("bandwidth", "bandwidth"),
                                       ("nonsense", "bandwidth")])
def test_exchange_schedule_mode_matches_jax(monkeypatch, mode, want):
    from horovod_tpu.controller import fusion as jfusion
    monkeypatch.setenv("HOROVOD_EXCHANGE_SCHEDULE", mode)
    assert tfusion.exchange_schedule_mode() == want == \
        jfusion.exchange_schedule_mode()


def test_flush_emits_timeline_counters(world1, monkeypatch, tmp_path):
    _force_defer(monkeypatch)
    path = tmp_path / "tl.json"
    thvd.start_timeline(str(path))
    hs = [thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
          for _ in range(3)]
    hs.append(thvd.allreduce_async(torch.ones(2, dtype=torch.float64)))
    for h in hs:
        thvd.synchronize(h)
    thvd.stop_timeline()
    events = json.loads(path.read_text())
    counters = [e for e in events if e.get("ph") == "C"
                and "deferred_fused_buckets" in e.get("args", {})]
    assert len(counters) == 1
    assert counters[0]["args"] == {"deferred_fused_buckets": 1.0,
                                   "deferred_fused_ops": 3.0,
                                   "deferred_singleton_ops": 1.0}


def test_metrics_collectors_render_eager_families(world1, monkeypatch):
    from horovod_tpu_torch.timeline import metrics as tmetrics
    _force_defer(monkeypatch)
    tmetrics.install_default_metrics()
    hs = [thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
          for _ in range(2)]
    for h in hs:
        thvd.synchronize(h)
    text = tmetrics.render_prometheus()
    for fam, value in (("horovod_deferred_flushes_total", 1),
                       ("horovod_deferred_fused_buckets_total", 1),
                       ("horovod_deferred_fused_ops_total", 2),
                       ("horovod_deferred_singleton_ops_total", 0)):
        assert f"{fam} {value}" in text.replace(".0\n", "\n") + "\n", fam
    assert "# TYPE horovod_eager_ops_total counter" in text
    assert "# TYPE horovod_eager_fences_total counter" in text


def test_unknown_handle_is_keyerror_and_valueerror(world1):
    with pytest.raises(KeyError):
        thvd.synchronize(10 ** 9)
    with pytest.raises(ValueError, match="was not created"):
        thvd.poll(10 ** 9)


# ---------------------------------------------------------------------------
# Worker entry
# ---------------------------------------------------------------------------


def _worker(mode, rank, n, store_path, out_path):
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, n), rank=rank,
              size=n)
    body = {"ragged": _ragged_rank}[mode]
    torch.save(body(rank, n), out_path)
    thvd.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
