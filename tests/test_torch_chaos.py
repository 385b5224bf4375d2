"""PyTorch/CUDA port: chaos-hardened elastic recovery against the JAX
package (``tests/test_chaos.py``'s cases on ``horovod_tpu_torch``).

* the ``HOROVOD_CHAOS`` grammar and its rejections, parsed alike by both
  packages; ``rank=any`` victims equal to the JAX injector's for the same
  ``(seed, fault index, size)``;
* the injector's firing rules and latches (``comm``, ``at=sync``,
  ``kill``, ``sigterm``, ``kv_blackout``, ``hb_drop``, ``slow``, ``nan``;
  consuming a ``bitflip`` raises: the silent-data-corruption plane is not
  ported), ``poison_batch`` on tensor trees against the JAX one;
* the commit boundary as the chaos clock: the port ticks it BEFORE the
  snapshot, so an injected fault rolls back to the commit before (the JAX
  package ticks after it);
* the comm-failure classifier on the JAX table plus torch's own errors
  (``DistBackendError`` from gloo and NCCL, ``DistStoreError``,
  ``DistNetworkError``);
* the stall inspector's reset threshold latching the preemption notice,
  and its knobs against the JAX config;
* ``ef_resize_residuals`` and ``zero_resize`` bitwise equal to the JAX
  functions on the same numpy state, for 8 -> 4, 4 -> 8 and 3 -> 2
  (plain, with a matching plan, irreconcilable plans, mixed-dtype arenas,
  the ZeRO error-feedback carry);
* the checkpointless drill: 4 gloo ranks (this file, run as a script, is
  each rank; ``FileStore``\\ s under ``tmp_path``) train an MLP with
  ZeRO-1 + ``topk:0.25`` error feedback (Adam 0.05) for 30 steps,
  uninterrupted, then again under ``@hvd.elastic.run`` with
  ``TorchState`` commits every 3 steps while chaos kills ranks 2 and 3 at
  the commit after step 12; ranks 0 and 1 meet the dead peers in the
  commit's gather, restore step 9, re-init at world 2 from the epoch the
  harness publishes, ``resize(4, 2)`` re-lays the gathered ZeRO-1 state
  and residuals, and they finish the 30 steps: the final loss within the
  JAX gate's 1.25 of the uninterrupted 4-rank run's, parameters bitwise
  equal on both survivors, no bucket zeroed.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.elastic import chaos
from horovod_tpu_torch.elastic.run_loop import _looks_like_comm_failure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HVD_TPU_RENDEZVOUS_FILE", "HOROVOD_CHAOS",
                 "HVD_TPU_CHAOS", "HVD_TPU_ELASTIC_ASSIGNMENT",
                 "HVD_TPU_ELASTIC_WORKER_ID", "HVD_TPU_ELASTIC_EPOCH")


@pytest.fixture(autouse=True)
def _clean_chaos():
    from horovod_tpu.elastic import chaos as jchaos
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


# ---------------------------------------------------------------------------
# Spec grammar
# ---------------------------------------------------------------------------

GOOD_SPECS = [
    "seed=42; kill@step=5,rank=1; kv_blackout@step=3,secs=2;"
    "comm@step=7,rank=any,at=sync; hb_drop@step=9,secs=0.5;"
    "sigterm@step=4,rank=0",
    "seed=1;",
    "seed=7; nan@step=3,rank=1; bitflip@step=5,rank=any; "
    "slow@step=2,rank=0,secs=0.25",
    "comm@step=2",
]


def _fields(faults):
    return [(f.kind, f.step, f.rank, f.secs, f.at_sync, f.fired)
            for f in faults]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_spec_equals_jax(spec):
    from horovod_tpu.elastic import chaos as jchaos
    seed, faults = chaos.parse_spec(spec)
    jseed, jfaults = jchaos.parse_spec(spec)
    assert seed == jseed and _fields(faults) == _fields(jfaults)


def test_parse_spec_grammar():
    seed, faults = chaos.parse_spec(GOOD_SPECS[0])
    assert seed == 42
    assert [f.kind for f in faults] == ["kill", "kv_blackout", "comm",
                                        "hb_drop", "sigterm"]
    kill, kv, comm, hb, sig = faults
    assert (kill.step, kill.rank) == (5, 1)
    assert (kv.step, kv.secs) == (3, 2.0)
    assert comm.rank is None and comm.at_sync
    assert (hb.step, hb.secs) == (9, 0.5)
    assert chaos.parse_spec("seed=1;") == (1, [])


@pytest.mark.parametrize("bad", [
    "seed=abc", "explode@step=1", "kill", "kill@rank=1",
    "kill@step=1,color=red", "kill@step=1,at=sync", "comm@step=1,at=launch",
    "nan@step=1,secs=2", "bitflip@step=1,secs=0.5", "kill@step=1,secs=1",
    "sigterm@step=1,secs=3", "comm@step=1,secs=1",
])
def test_parse_spec_rejects_malformed_like_jax(bad):
    from horovod_tpu.elastic import chaos as jchaos
    with pytest.raises(chaos.ChaosSpecError) as got:
        chaos.parse_spec(bad)
    with pytest.raises(jchaos.ChaosSpecError) as want:
        jchaos.parse_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 12, 99])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_rank_any_victims_equal_jax(seed, size):
    from horovod_tpu.elastic import chaos as jchaos
    spec = (f"seed={seed};comm@step=2,rank=any;kill@step=5,rank=any;"
            f"nan@step=3,rank=any")
    picks = [[f.rank for f in chaos.ChaosInjector(spec, rank=r,
                                                  size=size).faults]
             for r in range(size)]
    assert all(p == picks[0] for p in picks)
    assert picks[0] == [f.rank for f in jchaos.ChaosInjector(
        spec, rank=0, size=size).faults]
    assert picks[0] == [random.Random(seed * 1000003 + i).randrange(size)
                        for i in range(3)]


# ---------------------------------------------------------------------------
# Firing semantics and latches
# ---------------------------------------------------------------------------

def test_comm_fault_fires_once_on_target_rank_only():
    bystander = chaos.ChaosInjector("comm@step=2,rank=0", rank=1, size=2)
    for step in range(1, 6):
        bystander.on_step(step)
    victim = chaos.ChaosInjector("comm@step=2,rank=0", rank=0, size=2)
    victim.on_step(1)
    with pytest.raises(chaos.ChaosCommError, match="chaos injected"):
        victim.on_step(2)
    victim.on_step(2)
    victim.on_step(3)


def test_kill_fault_exits_hard(monkeypatch):
    codes = []
    monkeypatch.setattr(chaos.os, "_exit", lambda c: codes.append(c))
    chaos.ChaosInjector("kill@step=3,rank=0", rank=0, size=1).on_step(3)
    assert codes == [137]


def test_sigterm_fault_latches_preemption_notice():
    from horovod_tpu_torch.elastic import preemption
    try:
        chaos.ChaosInjector("sigterm@step=1,rank=0", rank=0,
                            size=1).on_step(1)
        assert preemption.notice_received()
        assert "chaos" in preemption.reason()
    finally:
        preemption.reset()


def test_at_sync_arms_and_raises_one_shot_from_synchronize_and_barrier(
        monkeypatch):
    import horovod_tpu_torch as hvd
    inj = chaos.install("comm@step=1,rank=0,at=sync", rank=0, size=1)
    inj.on_step(1)
    with pytest.raises(chaos.ChaosCommError):
        chaos.raise_if_armed()
    chaos.raise_if_armed()          # one-shot: drained
    # Armed again, it surfaces from the optimizer's synchronize() and
    # from barrier(), the port's blocking waits.
    hvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.ones(3))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       named_parameters=[("w", w)])
        (w * 2).sum().backward()
        chaos._arm(chaos.ChaosCommError("UNAVAILABLE: armed"))
        with pytest.raises(chaos.ChaosCommError):
            opt.step()
        opt.synchronize()           # drained: the step can go on
        chaos._arm(chaos.ChaosCommError("UNAVAILABLE: armed"))
        with pytest.raises(chaos.ChaosCommError):
            hvd.barrier()
        hvd.barrier()
    finally:
        hvd.shutdown()


def test_kv_blackout_and_hb_drop_latches_expire():
    inj = chaos.install(
        "kv_blackout@step=1,secs=0.15;hb_drop@step=1,secs=0.15",
        rank=0, size=1)
    assert not chaos.kv_blackout_active()
    assert not chaos.heartbeat_drop_active()
    inj.on_step(1)
    assert chaos.kv_blackout_active() and chaos.heartbeat_drop_active()
    deadline = time.monotonic() + 5.0
    while chaos.kv_blackout_active() or chaos.heartbeat_drop_active():
        assert time.monotonic() < deadline, "latches never expired"
        time.sleep(0.02)


def test_slow_fault_sleeps_on_its_rank():
    inj = chaos.ChaosInjector("slow@step=1,rank=0,secs=0.2", rank=0, size=2)
    t0 = time.monotonic()
    inj.on_step(1)
    assert time.monotonic() - t0 >= 0.19
    other = chaos.ChaosInjector("slow@step=1,rank=0,secs=5", rank=1, size=2)
    t0 = time.monotonic()
    other.on_step(1)
    assert time.monotonic() - t0 < 1.0


def test_internal_clock_counts_commits():
    inj = chaos.install("comm@step=3,rank=0", rank=0, size=1)
    inj.on_step()
    chaos.on_commit()
    with pytest.raises(chaos.ChaosCommError):
        chaos.on_commit()


def test_maybe_install_reads_env_and_is_idempotent(monkeypatch):
    monkeypatch.setenv("HOROVOD_CHAOS", "seed=3;comm@step=9,rank=2")
    inj = chaos.maybe_install(rank=2, size=4)
    assert inj is not None and inj.seed == 3 and inj.rank == 2
    assert chaos.maybe_install(rank=2, size=4) is inj
    chaos.reset()
    monkeypatch.setenv("HVD_TPU_CHAOS", "seed=8;kill@step=1,rank=0")
    assert chaos.maybe_install().seed == 8
    chaos.reset()
    monkeypatch.delenv("HOROVOD_CHAOS")
    monkeypatch.delenv("HVD_TPU_CHAOS")
    assert chaos.maybe_install() is None
    monkeypatch.setenv("HOROVOD_CHAOS", "comm@step=1,rank=0")
    assert chaos.maybe_install() is None     # checked once a life


def test_init_installs_injector_from_env(monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_CHAOS", "seed=4;comm@step=99,rank=0")
    hvd.init(device="cpu")
    try:
        inj = chaos.injector()
        assert inj is not None and inj.seed == 4 and inj.size == 1
        hvd.shutdown()
        hvd.init(device="cpu")      # a re-init keeps the same injector
        assert chaos.injector() is inj
    finally:
        hvd.shutdown()


def test_commit_boundary_ticks_the_chaos_clock_before_the_snapshot():
    """The port's order: the fault fires at the START of commit(), so the
    snapshot it interrupts is not taken and restore() goes back to the
    commit before (JAX fires after the snapshot, losing no step)."""
    from horovod_tpu_torch import elastic
    chaos.install("comm@step=3,rank=0", rank=0, size=1)
    s = elastic.ObjectState(x=1)   # chaos step 1
    s.x = 5
    s.commit()                     # step 2: snapshot x=5
    s.x = 42
    with pytest.raises(chaos.ChaosCommError):
        s.commit()                 # step 3: fires before the snapshot
    s.restore()
    assert s.x == 5


def test_heartbeat_writer_skips_beats_during_hb_drop(tmp_path):
    from horovod_tpu_torch.core.stall import HeartbeatWriter
    w = HeartbeatWriter(str(tmp_path / "hb"), interval_s=60.0)
    try:
        chaos.install("hb_drop@step=1,secs=30", rank=0, size=1).on_step(1)
        before = os.stat(w.path).st_mtime_ns
        time.sleep(0.02)
        w.beat()
        assert os.stat(w.path).st_mtime_ns == before
        chaos.reset()
        time.sleep(0.02)
        w.beat()
        assert os.stat(w.path).st_mtime_ns > before
    finally:
        w.stop()


def test_corruption_faults_fire_on_every_process():
    """nan/bitflip fire on every process (the victim rides in the latch);
    consuming a pending bitflip raises -- its consumer is the
    silent-data-corruption plane, not ported."""
    for rank in range(3):
        chaos.reset()
        inj = chaos.ChaosInjector(
            "nan@step=2,rank=1;bitflip@step=4,rank=2", rank=rank, size=3)
        inj.on_step(2)
        assert chaos.consume_nan_poison() == 1
        inj.on_step(3)
        assert chaos.consume_nan_poison() is None
        assert chaos.consume_bitflip() is None
        inj.on_step(4)
        with pytest.raises(NotImplementedError, match="1.11"):
            chaos.consume_bitflip()
        assert chaos.consume_bitflip() is None    # one-shot
        inj.on_step(4)
        assert chaos.consume_bitflip() is None


def test_corruption_latches_cleared_by_reset():
    chaos.ChaosInjector("nan@step=1;bitflip@step=1", rank=0,
                        size=1).on_step(1)
    assert chaos.corruption_armed() is False     # no injector installed
    chaos.reset()
    assert chaos.consume_nan_poison() is None
    assert chaos.consume_bitflip() is None


def test_poison_batch_equals_jax():
    from horovod_tpu.elastic import chaos as jchaos
    idx = np.arange(6, dtype=np.int32)
    a = np.ones((2, 3), np.float32)
    b = np.ones((4,), np.float32)
    batch = {"x": torch.from_numpy(a.copy()), "b": torch.from_numpy(b),
             "idx": torch.from_numpy(idx)}
    out = chaos.poison_batch(batch)
    want = jchaos.poison_batch({"x": a, "b": b, "idx": idx})
    for k in batch:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
    assert not torch.isnan(batch["b"]).any()       # input untouched
    t_out = chaos.poison_batch((torch.from_numpy(idx), torch.ones(2, 3)))
    assert torch.isnan(t_out[1].view(-1)[0]) and t_out[0].dtype == torch.int32
    with pytest.raises(ValueError, match="no floating leaf"):
        chaos.poison_batch({"tokens": torch.arange(4)})


# ---------------------------------------------------------------------------
# Comm-failure classifier
# ---------------------------------------------------------------------------

def _torch_errors():
    import torch.distributed as dist
    gloo = ("[../third_party/gloo/gloo/transport/tcp/pair.cc:553] "
            "Connection closed by peer [127.0.0.1]:9960")
    return [
        (dist.DistBackendError(gloo), True),
        (RuntimeError(gloo), True),
        (RuntimeError("[pair.cc:598] Connection reset by peer"), True),
        (dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp:1970, "
                               "unhandled system error"), True),
        (dist.DistBackendError(
            "[Rank 0] Watchdog caught collective operation timeout: "
            "WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for 600000 "
            "milliseconds before timing out."), True),
        (dist.DistStoreError("Socket Timeout"), True),
        (dist.DistNetworkError("The client socket has timed out while "
                               "trying to connect"), True),
        (RuntimeError("CUDA error: an illegal memory access"), False),
        (RuntimeError("ProcessGroupGloo::allgather: invalid tensor size at "
                      "index 0 (expected (1, 169), got (169))"), False),
        (dist.DistBackendError("invalid argument"), False),
    ]


def _jax_table():
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.run.http_kv import RendezvousAuthError
    return [
        (chaos.ChaosCommError("anything at all"), True),
        (ConnectionError("rendezvous GET /kv/elastic/assignment: "
                         "<urlopen error [Errno 111] Connection refused>"),
         True),
        (ConnectionError("rendezvous PUT /kv/hb/w0: timed out"), True),
        (ConnectionError("rendezvous GET /kv/x: chaos KV blackout"), True),
        (ConnectionError("rendezvous GET e/a -> HTTP 503"), True),
        (TimeoutError("timed out"), True),
        (RuntimeError("DEADLINE_EXCEEDED: barrier timed out"), True),
        (ValueError("UNKNOWN: Gloo all-reduce failed: Connection closed by "
                    "peer"), True),
        (HorovodInternalError("collective failed"), True),
        (RendezvousAuthError("rendezvous PUT rejected (403): per-job "
                             "secret mismatch"), False),
        (ValueError("bad connection string in config"), False),
        (KeyError("rendezvous"), False),
        (RuntimeError("shape mismatch in apply_fn"), False),
    ]


@pytest.mark.parametrize("case", range(13))
def test_classifier_jax_table(case):
    err, expected = _jax_table()[case]
    assert _looks_like_comm_failure(err) is expected


@pytest.mark.parametrize("case", range(10))
def test_classifier_torch_errors(case):
    err, expected = _torch_errors()[case]
    assert _looks_like_comm_failure(err) is expected


def test_classifier_agrees_with_jax_on_builtin_errors():
    """Where an error is a builtin type, both packages classify alike."""
    from horovod_tpu.elastic.run_loop import \
        _looks_like_comm_failure as jax_classify
    for err, _ in _jax_table():
        if type(err).__module__ == "builtins":
            assert _looks_like_comm_failure(err) == jax_classify(err), err


# ---------------------------------------------------------------------------
# Stall -> preemption escalation; knobs
# ---------------------------------------------------------------------------

def test_stall_reset_time_latches_preemption_once():
    from horovod_tpu_torch.core.stall import StallInspector
    from horovod_tpu_torch.elastic import preemption
    ins = StallInspector(warn_time_s=0.01, reset_time_s=0.02,
                         check_interval_s=100.0)
    try:
        token = ins.begin("allreduce.wedged")
        time.sleep(0.05)
        assert ins.check_now() == ["allreduce.wedged"]
        assert preemption.notice_received()
        assert "stall" in preemption.reason()
        preemption.reset()
        ins.check_now()
        assert not preemption.notice_received()
        ins.end(token)
        assert ins.stalled() == []
    finally:
        ins.stop()
        preemption.reset()


def test_stall_shutdown_threshold_calls_its_hook():
    from horovod_tpu_torch.core.stall import StallInspector
    doomed = []
    ins = StallInspector(warn_time_s=0.01, shutdown_time_s=0.02,
                         check_interval_s=100.0, on_shutdown=doomed.append)
    try:
        with ins.watch("barrier"):
            time.sleep(0.05)
            ins.check_now()
        assert doomed == [["barrier"]]
    finally:
        ins.stop()


KNOBS = {
    "HOROVOD_STALL_CHECK_TIME": ("stall_check_time", "7.5"),
    "HOROVOD_STALL_SHUTDOWN_TIME": ("stall_shutdown_time", "30"),
    "HOROVOD_STALL_RESET_TIME": ("stall_reset_time", "7.5"),
    "HOROVOD_STALL_RESET_TIME_SECONDS": ("stall_reset_time", "3.0"),
    "HOROVOD_SNAPSHOT_STEPS": ("snapshot_steps", "4"),
    "HOROVOD_DESYNC_MAX_RETRIES": ("desync_max_retries", "5"),
    "HOROVOD_ELASTIC_TIMEOUT": ("elastic_timeout", "120"),
    "HOROVOD_HEARTBEAT_TIMEOUT": ("heartbeat_timeout", "30"),
    "HOROVOD_STALL_CHECK_DISABLE": ("stall_check_disable", "1"),
}


@pytest.mark.parametrize("env", sorted(KNOBS))
def test_knobs_parse_like_jax(monkeypatch, env):
    from horovod_tpu.core.config import load_config as jax_config
    from horovod_tpu_torch.core.config import load_config
    field, value = KNOBS[env]
    assert getattr(load_config(), field) == getattr(jax_config(), field)
    monkeypatch.setenv(env, value)
    assert getattr(load_config(), field) == getattr(jax_config(), field)


@pytest.mark.parametrize("env,value", [("HOROVOD_DESYNC_CHECK_STEPS", "5"),
                                       ("HOROVOD_GUARD", "1"),
                                       ("HOROVOD_CHECK_DESYNC", "1")])
def test_sdc_plane_is_refused(monkeypatch, env, value):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match="1.11"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_init_configures_and_shutdown_stops_the_stall_inspector(
        monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import stall
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME", "11")
    hvd.init(device="cpu")
    try:
        assert stall.inspector().warn_time_s == 11.0
    finally:
        hvd.shutdown()
    assert stall.inspector() is None
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    try:
        assert stall.inspector() is None
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Carry-state reconstruction: bitwise against the JAX functions
# ---------------------------------------------------------------------------

RESIZES = [(8, 4), (4, 8), (3, 2)]


def _ef_inputs(old, shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(old, *s).astype(np.float32) for s in shapes]


def _both_ef(res, params_shapes, old, new, **kw):
    import jax.numpy as jnp

    from horovod_tpu.optim.distributed import ef_resize_residuals as jfn
    from horovod_tpu_torch.optim.distributed import ef_resize_residuals
    jp = None if params_shapes is None else \
        [jnp.zeros(s, jnp.float32) for s in params_shapes]
    tp = None if params_shapes is None else \
        [torch.zeros(s) for s in params_shapes]
    want, wrep = jfn(tuple(jnp.asarray(r) for r in res), jp, old, new, **kw)
    got, grep = ef_resize_residuals(tuple(torch.from_numpy(r) for r in res),
                                    tp, old, new, **kw)
    return [np.asarray(w) for w in want], wrep, [g.numpy() for g in got], \
        grep


def _bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("old,new", RESIZES)
def test_ef_resize_equals_jax_and_preserves_mass(old, new):
    res = _ef_inputs(old, [(40,), (7,)])
    want, wrep, got, grep = _both_ef(res, None, old, new)
    _bitwise(got, want)
    assert grep == wrep == {"carried_bytes": sum(r.nbytes for r in res),
                            "zeroed_buckets": 0}
    for r, g in zip(res, got):
        np.testing.assert_allclose(r.sum(0) / old, g.sum(0) / new,
                                   atol=1e-5)


@pytest.mark.parametrize("old,new", RESIZES)
@pytest.mark.parametrize("comp", ["topk:0.25", "powersgd:2"])
def test_ef_resize_with_plan_equals_jax(old, new, comp):
    shapes = [(6, 4), (5,), (3, 3)]
    res = _ef_inputs(old, [(24 + 5 + 9,)], seed=1)
    want, wrep, got, grep = _both_ef(res, shapes, old, new,
                                     compression=comp)
    _bitwise(got, want)
    assert grep == wrep and grep["zeroed_buckets"] == 0


@pytest.mark.parametrize("old,new", RESIZES)
def test_ef_resize_zeroes_irreconcilable_plan_like_jax(old, new):
    from horovod_tpu_torch.timeline import metrics as tm
    zeroed = tm.registry().counter("horovod_ef_residual_zeroed_total")
    before = zeroed.value
    res = [np.ones((old, 10), np.float32), np.ones((old, 3), np.float32)]
    want, wrep, got, grep = _both_ef(res, [(10,)], old, new,
                                     compression="topk:0.25")
    _bitwise(got, want)
    assert grep == wrep == {"carried_bytes": 0, "zeroed_buckets": 1}
    assert zeroed.value == before + 1
    res = [np.ones((old, 11), np.float32)]          # one bucket, wrong row
    want, wrep, got, grep = _both_ef(res, [(10,)], old, new,
                                     compression="topk:0.25")
    _bitwise(got, want)
    assert grep == wrep


def _zero_state(old, shards, dtypes, seed, ef):
    """A JAX-layout ZeRO state over ``shards`` arenas: an adam-like
    ``count`` [old] and ``mu``/``nu`` [old, shard] per arena, filled with
    distinct values (a fresh re-derivation, all zeros, cannot pass)."""
    rng = np.random.RandomState(seed)
    inner = {"count": np.full((old,), 7, np.int32),
             "mu": [(rng.randn(old, s) * 100).astype(dt)
                    for s, dt in zip(shards, dtypes)],
             "nu": [(rng.rand(old, s) * 100).astype(dt)
                    for s, dt in zip(shards, dtypes)]}
    res = [rng.randn(old, s).astype(np.float32) for s in shards] if ef \
        else None
    return inner, res


@pytest.mark.parametrize("old,new", RESIZES)
@pytest.mark.parametrize("ef", [False, True])
def test_zero_resize_equals_jax(old, new, ef):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.optim import zero as jzero
    from horovod_tpu_torch.optim import zero as tzero
    # jax.tree.leaves order: b (f32), i (int32), w (f32) -> arenas f32
    # (5 + 24 = 29 values) and int32 (3).
    shapes = {"b": ((5,), np.float32), "i": ((3,), np.int32),
              "w": ((6, 4), np.float32)}
    jparams = {k: jnp.zeros(s, dt) for k, (s, dt) in shapes.items()}
    tparams = [torch.zeros(s, dtype=torch.from_numpy(np.zeros(1, dt)).dtype)
               for _, (s, dt) in sorted(shapes.items())]
    spec = jzero.plan_arena(jax.tree.leaves(jparams), old)
    shards = [b.shard for b in spec.buffers]
    dtypes = [np.dtype(b.dtype) for b in spec.buffers]
    inner, res = _zero_state(old, shards, dtypes, seed=old * 10 + new, ef=ef)
    jstate = jax.tree.map(jnp.asarray, inner)
    tstate = {"count": torch.from_numpy(inner["count"]),
              "mu": [torch.from_numpy(a) for a in inner["mu"]],
              "nu": [torch.from_numpy(a) for a in inner["nu"]]}
    if ef:
        jstate = jzero._ZeroEFState(tuple(jnp.asarray(r) for r in res),
                                    jstate)
        tstate = tzero.StackedZeroState(
            tuple(torch.from_numpy(r) for r in res), tstate)
    want, wrep = jzero.zero_resize(jstate, jparams, old, new)
    got, grep = tzero.zero_resize(tstate, tparams, old, new)
    assert grep == wrep
    assert grep["zeroed_buckets"] == 0 and grep["carried_bytes"] > 0
    if ef:
        _bitwise([r.numpy() for r in got.residuals],
                 [np.asarray(r) for r in want.residuals])
        got, want = got.inner, want.inner
    np.testing.assert_array_equal(got["count"].numpy(),
                                  np.asarray(want["count"]))
    for key in ("mu", "nu"):
        for g, w in zip(got[key], want[key]):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_zero_resize_requires_params():
    from horovod_tpu_torch.optim import zero as tzero
    with pytest.raises(ValueError, match="params"):
        tzero.zero_resize({"mu": torch.zeros(8, 4)}, None, 8, 4)
    with pytest.raises(ValueError, match="matches no arena"):
        tzero.zero_resize({"mu": torch.zeros(8, 3)}, [torch.zeros(10)], 8, 4)


def test_torch_state_resize_noop_on_same_size():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    hvd.init(device="cpu")
    try:
        s = elastic.TorchState(params={"w": torch.ones(3)}, batch=0)
        report = s.resize(8, 8)
        assert report["resized"] == [] and report["carried_bytes"] == 0
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# The checkpointless drill: 4 gloo ranks -> 2
# ---------------------------------------------------------------------------

_COMP = "topk:0.25"
_STEPS = 30
_COMMIT_EVERY = 3
_KILL_AT_COMMIT = 5     # chaos clock: sync, steps 3, 6, 9, 12 -> the 12th


def _problem():
    rng = np.random.RandomState(0)
    w_true = rng.randn(16, 4).astype(np.float32)
    x = rng.randn(64, 16).astype(np.float32)
    y = x @ w_true
    params = {"w1": rng.randn(16, 32).astype(np.float32) * 0.3,
              "b1": np.zeros((32,), np.float32),
              "w2": rng.randn(32, 4).astype(np.float32) * 0.3,
              "b2": np.zeros((4,), np.float32)}
    return params, torch.from_numpy(x), torch.from_numpy(y)


class _MLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _loss(m, batch):
    x, y = batch
    return torch.mean((m(x) - y) ** 2)


def _local(x, y):
    import horovod_tpu_torch as hvd
    n, r = hvd.size(), hvd.rank()
    rows = x.shape[0] // n
    return x[r * rows:(r + 1) * rows], y[r * rows:(r + 1) * rows]


def _build(model):
    from horovod_tpu_torch.training import make_train_step
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    return make_train_step(model, _loss, opt, zero_stage=1,
                           zero_compression=_COMP)


def _worker(rank: int, out: str) -> None:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.timeline import metrics as tm
    hvd.init()
    params0, x, y = _problem()

    model = _MLP(params0)
    step = _build(model)
    for _ in range(_STEPS):
        loss = step(_local(x, y))
    base_loss = float(loss)

    model = _MLP(params0)
    step = _build(model)
    state = elastic.TorchState(model=model, zero=step.zero_state, batch=0)
    chaos.install(f"seed=7;kill@step={_KILL_AT_COMMIT},rank=2;"
                  f"kill@step={_KILL_AT_COMMIT},rank=3", rank=rank, size=4)
    losses = {}

    @elastic.run
    def train(state):
        step = _build(model)
        state.bind_zero("zero", step.zero_state)
        while state.batch < _STEPS:
            losses[state.batch + 1] = float(step(_local(x, y)))
            state.batch += 1
            if state.batch % _COMMIT_EVERY == 0:
                state.commit()
        return state.batch

    done = train(state)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    every = hvd.allgather(flat.reshape(1, -1))
    res = {"rank": hvd.rank(), "size": hvd.size(), "done": done,
           "base_loss": base_loss, "loss": losses[_STEPS],
           "losses": losses,
           "replicas_equal": all(torch.equal(every[0], every[i])
                                 for i in range(every.shape[0])),
           "report": state.last_resize,
           "steps_to_recover": tm.registry().gauge(
               "horovod_elastic_steps_to_recover").value,
           "recovered_bytes": tm.registry().counter(
               "horovod_ef_residual_recovered_bytes").value}
    with open(out, "w") as f:
        json.dump(res, f)
    hvd.shutdown()


def _write_doc(path, epoch, ranks, store):
    from horovod_tpu_torch.elastic.notify import write_assignment
    write_assignment(path, epoch, len(ranks), 0, ranks, store=store)


@pytest.mark.integration
def test_checkpointless_recovery_four_to_two_gloo(tmp_path):
    assign = str(tmp_path / "assignment.json")
    _write_doc(assign, 0, {f"w{r}": r for r in range(4)},
               str(tmp_path / "store0"))
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", HVD_TPU_FORCE_CPU="1",
               HVD_TPU_ELASTIC_ASSIGNMENT=assign, HVD_TPU_ELASTIC_EPOCH="0",
               HVD_TPU_RENDEZVOUS_FILE=str(tmp_path / "store0"),
               HOROVOD_SIZE="4", HOROVOD_LOCAL_SIZE="4",
               HOROVOD_ELASTIC_NO_SIGTERM="1")
    procs = []
    for r in range(4):
        e = dict(env, HOROVOD_RANK=str(r), HOROVOD_LOCAL_RANK=str(r),
                 HVD_TPU_ELASTIC_WORKER_ID=f"w{r}")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(r), str(tmp_path / f"r{r}.json")],
            env=e, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        # The victims die at the 12th step's commit; then the harness,
        # standing in for the driver, publishes the survivors' epoch.
        deadline = time.monotonic() + 180
        while not (procs[2].poll() is not None
                   and procs[3].poll() is not None):
            assert time.monotonic() < deadline, "the victims never died"
            assert procs[0].poll() is None and procs[1].poll() is None, \
                procs[0].communicate()[0] + procs[1].communicate()[0]
            time.sleep(0.1)
        assert procs[2].returncode == procs[3].returncode == 137
        _write_doc(assign, 1, {"w0": 0, "w1": 1}, str(tmp_path / "store1"))
        logs = [p.communicate(timeout=180)[0] for p in procs[:2]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs[:2], logs):
        assert p.returncode == 0, log[-4000:]
    out = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    for r, o in enumerate(out):
        assert (o["rank"], o["size"], o["done"]) == (r, 2, _STEPS)
        assert o["replicas_equal"]
        rep = o["report"]
        assert rep["old_size"] == 4 and rep["new_size"] == 2
        assert rep["resized"] == ["zero"]
        assert rep["carried_bytes"] > 0 and rep["zeroed_buckets"] == 0
        assert o["steps_to_recover"] == 3     # steps 10-12 replayed
        assert o["recovered_bytes"] > 0
        ratio = o["loss"] / o["base_loss"]
        assert 0 < ratio <= 1.25, (o["loss"], o["base_loss"])
    assert out[0]["losses"] == out[1]["losses"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
