"""PyTorch/CUDA port: ``hvd.join``'s drain protocol and the batched
``DistributedOptimizer`` (the native cycle batcher), at gloo worlds of 2
and 3 -- this file as each rank, over a ``FileStore`` under pytest's tmp
dir, so no port is fixed.

The join drill holds ``examples/join_check.py``'s expectations: rank
``r`` runs ``2 (r + 1)`` batches and averages are over the active ranks;
the last rank's ragged ``allgatherv`` receives zero rows from the
drained ranks; a grouped op and fused deferred buckets run during the
join; ``join`` returns the last rank on every rank, over two epochs.
Beside it: ``HOROVOD_JOIN_TIMEOUT`` raising on a drained rank whose peer
never joins, a subset collective raising while a member drains, and an
error after a presence round reaching the drained rank as an abort.

The batched optimizer (``HVD_TPU_NATIVE_CORE=1``) at world 2 on dyadic
data is bitwise the planned one, and a rank that joins early leaves the
other's gradient averaged over itself alone, and its
``hvd.SyncBatchNorm`` statistics its own batch's; at world 1 the wraps
it cannot serve are refused at construction (``ValueError``), a native
core that cannot be had raises, never falling back, and a deterministic
batcher keeps the autotuner's cycle axis pinned.  On the planned path a
step's own collectives (loss average, guard screen, BN statistics, eval
metrics) run no presence round.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.collectives import batching
from horovod_tpu_torch.collectives import eager as teager
from horovod_tpu_torch.collectives import joinop as tjoin
from horovod_tpu_torch.core.state import global_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
STEPS = 3


def _spawn(tmp_path, mode, n, env_extra=None, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(n),
         str(tmp_path / "store"), str(tmp_path / f"r{r}.pt")], env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# Worker bodies (one rank each)
# ---------------------------------------------------------------------------


def _drill_rank(rank: int, n: int) -> dict:
    """``examples/join_check.py`` as data, over two epochs."""
    out = {"avgs": []}
    for b in range(2 * (rank + 1)):
        got = thvd.allreduce(torch.full((3,), 1.0 + rank), thvd.Average)
        out["avgs"].append((b, got))
    if rank == n - 1:
        out["rows"] = thvd.allgatherv(torch.full((2, 2), 7.0))
        out["grouped"] = thvd.grouped_allreduce(
            [torch.full((2,), 6.0), torch.full((3,), 2, dtype=torch.int32)],
            op=thvd.Sum)
        hs = [thvd.allreduce_async(torch.full((2,), float(i + 1)),
                                   op=thvd.Sum) for i in range(3)]
        hs += [thvd.allreduce_async(torch.full((3,), 10.0 * (i + 1),
                                               dtype=torch.float64),
                                    op=thvd.Sum) for i in range(2)]
        out["async"] = [thvd.synchronize(h) for h in hs]
        out["fuse_stats"] = teager.deferred_fuse_stats()
        # Average over one active rank, and the reducescatter's mean.
        out["rs"] = thvd.reducescatter(torch.arange(2.0 * n), thvd.Average)
        out["max"] = thvd.allreduce(torch.full((2,), -5.0), op=thvd.Max)
    out["last"] = thvd.join()
    out["gen"] = tjoin.generation()
    if rank == n - 1:
        out["epoch2"] = thvd.allreduce(torch.full((2,), 4.0), op=thvd.Sum)
    out["last2"] = thvd.join()
    out["stats"] = tjoin.stats()
    return out


def _timeout_rank(rank: int, n: int) -> dict:
    """Rank 0 joins; rank 1 never issues another collective."""
    if rank == 0:
        t0 = time.perf_counter()
        try:
            thvd.join()
            out = {"error": None}
        except RuntimeError as e:
            out = {"error": str(e)}
        out["seconds"] = time.perf_counter() - t0
        return out
    time.sleep(6.0)
    return {}


def _subset_rank(rank: int, n: int) -> dict:
    """World 3, set {0, 1}: rank 0 joins; rank 1's subset op raises."""
    ps = thvd.add_process_set([0, 1])
    out = {}
    if rank == 0:
        out["last"] = thvd.join()
        return out
    out["avg"] = thvd.allreduce(torch.full((2,), float(rank)), thvd.Average)
    if rank == 1:
        try:
            thvd.allreduce(torch.ones(2), op=thvd.Sum, process_set=ps)
            out["subset_error"] = None
        except RuntimeError as e:
            out["subset_error"] = str(e)
    out["last"] = thvd.join()
    return out


def _abort_rank(rank: int, n: int) -> dict:
    """Rank 0 joins; rank 1 broadcasts from the joined root (an error
    after its presence round): both raise, rank 0 with the abort."""
    out = {}
    try:
        if rank == 0:
            thvd.join()
        else:
            thvd.broadcast(torch.ones(2), root_rank=0)
        out["error"] = None
    except RuntimeError as e:
        out["error"] = str(e)
    return out


def _dyadic(rng, shape):
    return torch.from_numpy(rng.randint(-8, 9, size=shape) / 8.0).float()


def _mlp():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                            torch.nn.Linear(8, 3))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.round(p * 8) / 8)
    return m


def _train(native: bool, rank: int, steps: int, join_after=None):
    st = global_state()
    st.config = dataclasses.replace(st.config, native_core=native)
    m = _mlp()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.125, momentum=0.5),
        named_parameters=m.named_parameters(),
        compression=thvd.Compression.fp16)
    rng = np.random.RandomState(7 + rank)
    losses, grads = [], []
    for _ in range(steps):
        x, y = _dyadic(rng, (4, 6)), _dyadic(rng, (4, 3))
        opt.zero_grad()
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        local = [p.grad.clone() for p in m.parameters()]
        opt.synchronize()
        grads.append((local, [p.grad.clone() for p in m.parameters()]))
        with opt.skip_synchronize():
            opt.step()
        losses.append(loss.detach())
    params = [p.detach().clone() for p in m.parameters()]
    return losses, params, grads, opt


def _batched_rank(rank: int, n: int) -> dict:
    out = {}
    planned = _train(False, rank, STEPS)
    batched = _train(True, rank, STEPS)
    out["planned"] = planned[:2]
    out["batched"] = batched[:2]
    out["deterministic"] = batching.current().deterministic
    out["batches"] = batching.current().batches()
    # Rank 0 leaves after one step; rank 1's second exchange then runs
    # with rank 0 drained: its gradient is averaged over itself alone.
    steps = 1 if rank == 0 else 2
    _, _, grads, _ = _train(True, rank, steps)
    out["join_grads"] = grads
    out["last"] = thvd.join()
    return out


def _sync_bn_mlp(bn):
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 8), bn, torch.nn.ReLU(),
                               torch.nn.Linear(8, 3))


def _step_rank(rank: int, n: int) -> dict:
    """The planned path's steps at world 2 under the SDC guard: a
    ``make_train_step`` step through ``hvd.SyncBatchNorm``, a
    ``make_flax_train_step`` step (BN statistics averaged) and an eval
    step.  Their own collectives take no join slot."""
    from horovod_tpu_torch.training import (make_eval_step,
                                            make_flax_train_step,
                                            make_train_step)
    st = global_state()
    st.config = dataclasses.replace(st.config, guard="1")
    m = _sync_bn_mlp(thvd.SyncBatchNorm(8, device="cpu"))
    step = make_train_step(
        m, lambda mod, b: ((mod(b[0]) - b[1]) ** 2).mean(),
        thvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                  named_parameters=m.named_parameters()))
    fm = _sync_bn_mlp(torch.nn.BatchNorm1d(8))
    flax_step = make_flax_train_step(
        fm, thvd.DistributedOptimizer(torch.optim.SGD(fm.parameters(),
                                                      lr=0.1),
                                      named_parameters=fm.named_parameters()))
    ev = make_eval_step(
        lambda mod, b: {"mse": ((mod(b[0]) - b[1]) ** 2).mean()})
    rng = np.random.RandomState(3 + rank)
    before = tjoin.stats()["presence_rounds"]
    out = {"losses": []}
    for _ in range(2):
        x = torch.from_numpy(rng.randn(4, 6)).float()
        y = torch.from_numpy(rng.randn(4, 3)).float()
        out["losses"].append(step((x, y)))
        out["losses"].append(flax_step((x, torch.from_numpy(
            rng.randint(0, 3, size=4)))))
    out["mse"] = ev(m, (x, y))["mse"]
    out["stats"] = [b.clone() for b in fm.buffers() if b.is_floating_point()]
    out["rounds"] = tjoin.stats()["presence_rounds"] - before
    out["last"] = thvd.join()
    return out


def _sync_bn_join_rank(rank: int, n: int) -> dict:
    """The batched path through ``hvd.SyncBatchNorm``: rank 0 leaves
    after one step, so rank 1's second step runs its sync-BN sums with
    rank 0 drained (they take join slots while the batcher runs)."""
    st = global_state()
    st.config = dataclasses.replace(st.config, native_core=True)
    bn = thvd.SyncBatchNorm(8, device="cpu")
    m = _sync_bn_mlp(bn)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.125),
        named_parameters=m.named_parameters())
    seen = []
    bn.register_forward_hook(lambda mod, inp, y: seen.append(
        [t.detach().clone() for t in (inp[0], y, mod.weight, mod.bias)]))
    rng = np.random.RandomState(11 + rank)
    for _ in range(1 if rank == 0 else 2):
        x, y = _dyadic(rng, (4, 6)), _dyadic(rng, (4, 3))
        opt.zero_grad()
        ((m(x) - y) ** 2).mean().backward()
        opt.step()
    return {"seen": seen, "last": thvd.join(),
            "rounds": tjoin.stats()["presence_rounds"]}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    return {n: _spawn(tmp_path_factory.mktemp(f"drill{n}"), "drill", n)
            for n in (2, 3)}


@pytest.mark.parametrize("n", [2, 3])
def test_join_averages_over_active_ranks(drills, n):
    for r, res in enumerate(drills[n]):
        assert len(res["avgs"]) == 2 * (r + 1)
        for b, got in res["avgs"]:
            active = [q for q in range(n) if 2 * (q + 1) > b]
            want = sum(1.0 + q for q in active) / len(active)
            assert torch.allclose(got, torch.full((3,), want), atol=1e-6)


@pytest.mark.parametrize("n", [2, 3])
def test_join_ragged_gather_gets_zero_rows_from_drained(drills, n):
    rows = drills[n][n - 1]["rows"]
    assert tuple(rows.shape) == (2, 2) and bool((rows == 7.0).all())


@pytest.mark.parametrize("n", [2, 3])
def test_join_grouped_and_fused_deferred_during_join(drills, n):
    res = drills[n][n - 1]
    g = res["grouped"]
    assert torch.equal(g[0], torch.full((2,), 6.0))
    assert torch.equal(g[1], torch.full((3,), 2, dtype=torch.int32))
    for got, want in zip(res["async"], (1.0, 2.0, 3.0, 10.0, 20.0)):
        assert bool((got == want).all()), (got, want)
    assert res["fuse_stats"]["fused_buckets"] == 2
    assert res["fuse_stats"]["fused_ops"] == 5
    # Average over the one active rank; Max ignores the drained +inf/-inf.
    shard = res["rs"]
    want = torch.arange(2.0 * n)[2 * (n - 1):2 * n]
    assert torch.equal(shard, want)
    assert torch.equal(res["max"], torch.full((2,), -5.0))


@pytest.mark.parametrize("n", [2, 3])
def test_join_returns_last_rank_over_two_epochs(drills, n):
    for r, res in enumerate(drills[n]):
        assert res["last"] == n - 1 and res["last2"] == n - 1
        assert res["gen"] == 1
    assert torch.equal(drills[n][n - 1]["epoch2"], torch.full((2,), 4.0))
    # The drained ranks received headers; the survivor published them.
    assert drills[n][0]["stats"]["headers"] > 0
    assert drills[n][n - 1]["stats"]["headers"] > 0


def test_join_timeout_raises_on_drained_rank(tmp_path):
    res = _spawn(tmp_path, "timeout", 2,
                 env_extra={"HOROVOD_JOIN_TIMEOUT": "1.5"})
    err = res[0]["error"]
    assert err is not None and "HOROVOD_JOIN_TIMEOUT" in err, err
    assert 1.0 < res[0]["seconds"] < 5.0, res[0]


def test_subset_collective_raises_while_member_drains(tmp_path):
    res = _spawn(tmp_path, "subset", 3)
    assert "drained in hvd.join" in res[1]["subset_error"]
    assert torch.equal(res[1]["avg"], torch.full((2,), 1.5))
    assert [r["last"] for r in res] == [2, 2, 2]


def test_error_after_presence_round_aborts_drained_rank(tmp_path):
    res = _spawn(tmp_path, "abort", 2)
    assert "has joined" in res[1]["error"]
    assert "aborted during join phase" in res[0]["error"]
    assert "has joined" in res[0]["error"]


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("batched"), "batched", 2)


def test_batched_optimizer_bitwise_planned_at_world_2(batched):
    for res in batched:
        (pl, pp), (bl, bp) = res["planned"], res["batched"]
        assert all(torch.equal(a, b) for a, b in zip(pl, bl))
        assert all(torch.equal(a, b) for a, b in zip(pp, bp))
        assert res["deterministic"] is True
        # Deterministic: one flush a step cuts one batch (one dtype).
        assert res["batches"] == STEPS
    # Both ranks hold the same parameters.
    assert all(torch.equal(a, b) for a, b in
               zip(batched[0]["batched"][1], batched[1]["batched"][1]))


def test_batched_optimizer_under_join(batched):
    r0, r1 = batched
    assert r0["last"] == r1["last"] == 1
    # Step 1: both active, so the same averaged gradient on both ranks.
    for a, b in zip(r0["join_grads"][0][1], r1["join_grads"][0][1]):
        assert torch.equal(a, b)
    # Step 2: rank 0 drained -> rank 1's own gradient through fp16.
    local, reduced = r1["join_grads"][1]
    for g, red in zip(local, reduced):
        assert torch.equal(red, g.half().float())


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def test_batched_optimizer_bitwise_planned_at_world_1(world1):
    pl, pp, _, _ = _train(False, 0, STEPS)
    bl, bp, _, _ = _train(True, 0, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(pl, bl))
    assert all(torch.equal(a, b) for a, b in zip(pp, bp))
    b = batching.current()
    assert b is not None and b.deterministic is False   # CPU, world 1
    thvd.shutdown()
    assert batching.current() is None
    thvd.init(device="cpu")


def _native(world1, **cfg):
    st = global_state()
    st.config = dataclasses.replace(st.config, native_core=True, **cfg)


@pytest.mark.parametrize("kw,cfg,match", [
    ({"compression": "powersgd:2"}, {}, "PowerSGD|casts"),
    ({"compression": "topk:0.5"}, {}, "casts"),
    ({"compression": "fp8"}, {}, "casts"),
    ({"compression": "ici:none,dcn:fp16"}, {}, "casts"),
    ({"op": thvd.Adasum}, {}, "Adasum"),
    ({}, {"zero_stage": 1}, "ZeRO-1"),
    ({}, {"hierarchical_allreduce": True}, "two-level"),
    ({}, {"exchange_chunk_bytes": 1 << 20}, "chunked"),
], ids=["powersgd", "topk", "fp8", "per_leg", "adasum", "zero1", "hier",
        "chunked"])
def test_batched_refuses_what_it_cannot_serve(world1, kw, cfg, match):
    _native(world1, **cfg)
    m = _mlp()
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    with pytest.raises(ValueError, match=match):
        thvd.DistributedOptimizer(opt, named_parameters=m.named_parameters(),
                                  **kw)
    assert type(opt) is torch.optim.SGD     # left as it was


def test_batched_refused_by_loops_and_microbatches(world1):
    from horovod_tpu_torch import training
    _native(world1)
    m = _mlp()
    opt = thvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                    named_parameters=m.named_parameters())

    def loss_fn(model, batch):
        return model(batch).sum()
    with pytest.raises(ValueError, match="CUDA graph"):
        training.make_train_loop(m, loss_fn, opt, steps_per_execution=2)
    with pytest.raises(ValueError, match="native batcher"):
        training.make_train_step(m, loss_fn, opt, microbatches=2)


def test_batched_native_core_failure_raises(world1, monkeypatch):
    from horovod_tpu_torch import _core

    def missing():
        raise RuntimeError("native core build failed: no g++")
    monkeypatch.setattr(_core, "require_lib", missing)
    _native(world1)
    m = _mlp()
    with pytest.raises(RuntimeError, match="native core build failed"):
        thvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))


def test_autotuner_cycle_axis_reaches_batcher(world1):
    """The cycle axis opens with the batched path and each sample's cycle
    time and threshold reach the running batcher."""
    from horovod_tpu_torch.autotune import Autotuner
    _native(world1)
    st = global_state()
    tuner = Autotuner(dataclasses.replace(st.config, autotune=True,
                                          autotune_log=None),
                      steps_per_sample=1)
    assert tuner.tunes_cycle
    assert {c for _, c, *_ in tuner.grid} == {0.5, 1.0, 5.0}
    st.autotuner = tuner
    b = batching.batcher()
    assert b.cycle_ms == tuner.cycle_time_ms()
    seen = []
    for _ in range(6):
        tuner.record_step(0.01, 1 << 20)
        seen.append((b.cycle_ms, b.fusion_bytes))
        assert seen[-1] == (tuner.cycle_time_ms(), tuner.fusion_threshold())
    assert len({c for c, _ in seen}) > 1
    st.autotuner = None


def test_autotuner_cycle_axis_pinned_on_a_deterministic_batcher(world1):
    """A deterministic batcher (the GPU's, every world > 1; here forced
    by ``HOROVOD_DETERMINISTIC``) cuts at synchronize() alone: the cycle
    member stays the configured one, explicit candidates are refused,
    and each sample's fusion threshold still reaches the batcher."""
    from horovod_tpu_torch.autotune import Autotuner
    _native(world1, deterministic=True)
    st = global_state()
    cfg = dataclasses.replace(st.config, autotune=True, autotune_log=None)
    tuner = Autotuner(cfg, steps_per_sample=1)
    assert not tuner.tunes_cycle
    assert {c for _, c, *_ in tuner.grid} == {cfg.cycle_time}
    with pytest.raises(ValueError, match="deterministic"):
        Autotuner(cfg, cycle_candidates=[0.5, 1.0])
    st.autotuner = tuner
    b = batching.batcher()
    assert b.deterministic
    seen = []
    for _ in range(6):
        tuner.record_step(0.01, 1 << 20)
        seen.append((b.cycle_ms, b.fusion_bytes))
        assert seen[-1] == (cfg.cycle_time, tuner.fusion_threshold())
    assert len({t for _, t in seen}) > 1
    st.autotuner = None


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("steps"), "step", 2)


def test_step_collectives_take_no_join_slot(steps):
    r0, r1 = steps
    # Loss averages, guard screens, sync-BN sums, flax BN statistics and
    # the eval metric: no presence round on the planned path.
    assert r0["rounds"] == r1["rounds"] == 0
    assert all(torch.equal(a, b) for a, b in zip(r0["losses"], r1["losses"]))
    assert all(torch.equal(a, b) for a, b in zip(r0["stats"], r1["stats"]))
    assert torch.equal(r0["mse"], r1["mse"])
    assert r0["last"] == r1["last"] == 1


def test_batched_sync_bn_under_join(tmp_path):
    r0, r1 = _spawn(tmp_path, "sync_bn_join", 2)
    assert r0["last"] == r1["last"] == 1
    assert r1["rounds"] > 0
    F = torch.nn.functional
    # Step 1, both active: each rank's output is its part of the
    # batch-norm over the two ranks' batches.
    (x0, y0, w, b), (x1, y1, _, _) = r0["seen"][0], r1["seen"][0]
    want = F.batch_norm(torch.cat([x0, x1]), None, None, w, b,
                        training=True)
    assert torch.allclose(torch.cat([y0, y1]), want, atol=1e-5)
    # Step 2, rank 0 drained: rank 1's statistics are its own batch's.
    x, y, w, b = r1["seen"][1]
    assert torch.allclose(y, F.batch_norm(x, None, None, w, b,
                                          training=True), atol=1e-5)


# ---------------------------------------------------------------------------
# Worker entry
# ---------------------------------------------------------------------------


def _worker(mode, rank, n, store_path, out_path):
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, n), rank=rank,
              size=n)
    body = {"drill": _drill_rank, "timeout": _timeout_rank,
            "subset": _subset_rank, "abort": _abort_rank,
            "batched": _batched_rank, "step": _step_rank,
            "sync_bn_join": _sync_bn_join_rank}[mode]
    res = body(rank, n)
    torch.save(res, out_path)
    if mode in ("timeout", "abort"):
        # A timed-out or aborted drain leaves a collective posted on the
        # group: leave without tearing it down.
        sys.stdout.flush()
        os._exit(0)
    thvd.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
