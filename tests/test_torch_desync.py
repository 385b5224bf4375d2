"""PyTorch/CUDA port: desync checksums, the corruption tripwire and the
elastic SDC drill, against the JAX package.

* ``_traced_bit_checksum`` bitwise the JAX function, jitted, for f32,
  bf16, f16, int32, int8, uint8 and bool, at sizes past 2**16 (the
  weights then pass 2**32 before the modulus).
* ``tree_checksums`` of a port model seen through ``module_tree`` equals
  the JAX ``tree_checksums`` of the flax variables it was loaded from:
  the same leaf paths in the same (flax) order, the same CRC32s; and of
  a tree of scalars, strings and ``None``.
* At gloo worlds (this file, run as a script, is each rank):
  ``check_desync`` with one rank perturbed raises ``DesyncError`` naming
  the leaf on every rank; the tripwire at world 3 with
  ``corrupt_replica`` on rank 1 raises ``CorruptRankError(ranks=[1])``
  on every rank, through ``TorchState.commit`` too, which leaves a
  wrap's per-rank error-feedback residuals out; at world 2 it cannot
  attribute (``ranks=[]``); ``collectives.ops.desync_check``.
* The ledger records no commit taken during a guard streak.
* The elastic SDC drill through the launcher: world 4 on gloo, a
  ``bitflip`` on rank 1 quarantined by the tripwire (the others finish
  at size 3 with equal replicas), then a ``nan`` input wedge rolled back
  through the ledger, the final loss within ``bench.py``'s 1.25x gate
  of the uninterrupted run.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.core import desync as tdesync
from horovod_tpu_torch.core import guard as tguard
from horovod_tpu_torch.core.exceptions import CorruptRankError, DesyncError
from horovod_tpu_torch.models import ResNet, resnet_state_from_jax
from horovod_tpu_torch.models.resnet import BottleneckBlock

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_CHAOS", "HVD_TPU_CHAOS",
                 "HVD_TPU_ELASTIC_ASSIGNMENT", "HVD_TPU_ELASTIC_WORKER_ID",
                 "HVD_TPU_ELASTIC_EPOCH")
LOSS_GATE = 1.25          # bench.py's SDC drill: replay loss parity


@pytest.fixture
def world1(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


# ---------------------------------------------------------------------------
# The bit checksum and the CRC tree checksums
# ---------------------------------------------------------------------------

CHECKSUM_DTYPES = ["float32", "bfloat16", "float16", "int32", "int8",
                   "uint8", "bool"]


def _array(dtype, n, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(n) < 0.5
    if dtype in ("int32", "int8", "uint8"):
        info = np.iinfo(dtype)
        return rng.randint(info.min, info.max, size=n).astype(dtype)
    return (rng.randn(n) * 100).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 1000, 70_001])
@pytest.mark.parametrize("dtype", CHECKSUM_DTYPES)
def test_bit_checksum_equals_jitted_jax(dtype, n):
    from horovod_tpu.core import desync as jdesync
    a = _array(dtype, n)
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    want = int(np.asarray(jax.jit(jdesync._traced_bit_checksum)(j)))
    got = tdesync._traced_bit_checksum(t)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    # A 2-D view of the same elements checksums the same.
    if n == 70_001:
        t2 = t[:70_000].reshape(350, 200).t().contiguous().t()
        want2 = int(np.asarray(jax.jit(jdesync._traced_bit_checksum)(
            jnp.asarray(a[:70_000]).astype(dtype).reshape(350, 200))))
        assert int(tdesync._traced_bit_checksum(t2)) == want2


def test_local_checksum_combines_leaves_like_the_jax_tripwire():
    """``c * 31 + leaf`` mod 2**32 over the leaves in flax order: the JAX
    tripwire's per-device value on one device."""
    from horovod_tpu.core import desync as jdesync
    tree = {"b": _array("float32", 300, 1), "a": {"y": _array("int8", 9, 2),
                                                  "x": _array("bool", 70, 3)}}
    c = 0
    for leaf in jax.tree.leaves(tree):
        c = (c * 31 + int(np.asarray(jax.jit(jdesync._traced_bit_checksum)(
            jnp.asarray(leaf))))) & 0xFFFFFFFF
    port = jax.tree.map(torch.from_numpy, tree)
    assert tdesync.local_checksum(port) == c


def _tiny(seed=3):
    from horovod_tpu.models import resnet as jresnet
    model = jresnet.ResNet(stage_sizes=[1, 1],
                           block_cls=jresnet.BottleneckBlock,
                           num_classes=10, num_filters=8, dtype=jnp.float32,
                           space_to_depth=True)
    x = np.random.RandomState(seed).randn(1, 32, 32, 3).astype(np.float32)
    variables = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                             model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x), train=True))
    port = ResNet(stage_sizes=[1, 1], block_cls=BottleneckBlock,
                  num_classes=10, num_filters=8, dtype=torch.float32,
                  space_to_depth=True, device="cpu")
    port.load_state_dict(resnet_state_from_jax(variables, device="cpu"))
    return variables, port


def test_tree_checksums_of_a_model_equal_jax_in_flax_order():
    from horovod_tpu.core import desync as jdesync
    variables, port = _tiny()
    jpaths, jsums = jdesync.tree_checksums(
        jax.tree.map(jnp.asarray, variables))
    paths, sums = tdesync.tree_checksums(tdesync.module_tree(port))
    assert paths == jpaths
    assert sums.tolist() == jsums.tolist()
    assert len(paths) > 20 and "batch_stats" in paths[0]
    # The tripwire's value equals the JAX one's on one device.
    jrow = np.asarray(jdesync.build_tripwire(
        jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)))(
        jax.tree.map(jnp.asarray, variables)))
    assert tdesync.local_checksum(tdesync.module_tree(port)) == int(jrow[0])


def test_tree_checksums_of_scalars_and_strings_equal_jax():
    from horovod_tpu.core import desync as jdesync
    tree = {"batch": 7, "lr": 0.1, "name": "run", "none": None,
            "flags": (True, 2.5), "nested": {"xs": [1, 2], "obj": {3: "a"}}}
    assert tdesync.tree_checksums(tree)[0] == jdesync.tree_checksums(tree)[0]
    assert tdesync.tree_checksums(tree)[1].tolist() == \
        jdesync.tree_checksums(tree)[1].tolist()
    assert tdesync._canonical_bytes({"b": {1, 2}, "a": [None, 1.5]}) == \
        jdesync._canonical_bytes({"b": {1, 2}, "a": [None, 1.5]})


def test_mismatched_rows_and_single_rank_checks(world1):
    rows = np.array([[1, 2, 3], [1, 5, 3]])
    assert tdesync.mismatched_rows(rows, ["a", "b", "c"]) == ["b"]
    _, port = _tiny()
    tree = tdesync.module_tree(port)
    assert tdesync.check_desync(tree) == []
    assert tdesync.tripwire_check(tree) == []
    assert tdesync.maybe_check(tree) is None      # HOROVOD_CHECK_DESYNC off
    assert not bool(thvd.collective_ops.desync_check(torch.ones(5)))
    before = port.state_dict()["Dense_0.kernel"].clone()
    tdesync.corrupt_replica(tdesync.module_tree(port)["params"], 0, bit=3)
    # The first floating leaf in flax order is the first BN's bias.
    first = tdesync.tree_leaves(tdesync.module_tree(port)["params"])[0]
    assert first.numel() and torch.equal(
        port.state_dict()["Dense_0.kernel"], before)
    with pytest.raises(ValueError, match="outside"):
        tdesync.corrupt_replica(tree, 1)


def test_corrupt_replica_flips_one_bit_of_a_permuted_view(world1):
    w = torch.arange(24, dtype=torch.float32).reshape(2, 3, 2, 2) + 1.0
    tree = {"params": {"Conv_0": {"kernel": w.permute(2, 3, 1, 0)}}}
    before = w.clone()
    tdesync.corrupt_replica(tree, 0, bit=0)
    diff = (w.view(torch.int32) ^ before.view(torch.int32)).reshape(-1)
    assert diff[0] == 1 and not diff[1:].any()


def test_ledger_skips_commits_during_a_guard_streak(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_SNAPSHOT_STEPS", "1")
    monkeypatch.setenv("HOROVOD_ELASTIC_NO_SIGTERM", "1")
    thvd.init(device="cpu")
    try:
        state = thvd.elastic.TorchState(w=torch.zeros(3), batch=0)
        for b in range(1, 5):
            state.w = state.w + 1
            state.batch = b
            if b == 3:
                tguard.policy().observe([1.0, float("nan"), 1.0])
            if b == 4:
                tguard.policy().observe([0.0, 1.0, 0.0])
            state.commit()
        # The commit of batch 3, taken during the streak, is missing.
        assert [e["commit"] for e in state._ledger] == [0, 1, 2, 4]
        state.batch = 9
        report = state.rollback(before_commit=3)
        assert report["commit"] == 2 and state.batch == 2
        assert torch.equal(state.w, torch.full((3,), 2.0))
    finally:
        tguard.reset()
        thvd.shutdown()


# ---------------------------------------------------------------------------
# Gloo worlds (this file as each rank)
# ---------------------------------------------------------------------------


def _spawn(tmp_path, mode, n):
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HOROVOD_ELASTIC_NO_SIGTERM="1")
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


def _catch(fn):
    try:
        fn()
    except (DesyncError, CorruptRankError) as e:
        return {"type": type(e).__name__, "leaves": e.leaves,
                "ranks": getattr(e, "ranks", None), "msg": str(e)}
    return None


def _rank_desync(rank, n):
    _, port = _tiny()
    tree = {"model": tdesync.module_tree(port), "step": 3}
    clean = _catch(lambda: tdesync.check_desync(tree, name="commit"))
    if rank == 1:
        with torch.no_grad():
            port.state_dict()["Dense_0.bias"][2] += 1.0
    bad = _catch(lambda: tdesync.check_desync(tree, name="commit"))
    quiet = tdesync.check_desync(tree, raise_error=False)
    x = torch.arange(70_001, dtype=torch.float32)
    same = bool(thvd.collective_ops.desync_check(x))
    x[rank] += 1.0
    differ = bool(thvd.collective_ops.desync_check(x))
    return {"clean": clean, "bad": bad, "quiet": quiet, "same": same,
            "differ": differ}


def _rank_tripwire(rank, n):
    _, port = _tiny()
    named = list(port.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression="topk:0.25")
    step = thvd.make_flax_train_step(port, opt)
    rng = np.random.RandomState(rank)
    x = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 2).astype(np.int32))
    step((x, y))
    state = thvd.elastic.TorchState(model=port, optimizer=opt, batch=1)
    residuals_differ = opt.residuals[0].sum().item()
    state.commit()      # the tripwire ran: residuals are per rank
    tdesync.corrupt_replica(tdesync.module_tree(port)["params"], 1)
    direct = _catch(lambda: tdesync.tripwire_check(
        tdesync.module_tree(port), name="model"))
    via_commit = _catch(state.commit)
    return {"direct": direct, "commit": via_commit,
            "residual_sum": residuals_differ,
            "checks": thvd.timeline.metrics.registry().counter(
                "horovod_guard_tripwire_checks_total").value}


def _worker(mode, rank, n, store_path, out_path):
    import torch.distributed as dist
    if mode == "tripwire":
        os.environ["HOROVOD_DESYNC_CHECK_STEPS"] = "1"
    thvd.init(device="cpu", store=dist.FileStore(store_path, n), rank=rank,
              size=n)
    body = {"desync": _rank_desync, "tripwire": _rank_tripwire}[mode]
    torch.save(body(rank, n), out_path)
    thvd.shutdown()


def test_check_desync_world2_names_the_perturbed_leaf(tmp_path):
    res = _spawn(tmp_path, "desync", 2)
    leaf = "['model']['params']['Dense_0']['bias']"
    for r in res:
        assert r["clean"] is None
        assert r["bad"]["type"] == "DesyncError"
        assert r["bad"]["leaves"] == [leaf]
        assert r["quiet"] == [leaf]
        assert r["same"] is False and r["differ"] is True


@pytest.mark.parametrize("n,ranks", [(3, [1]), (2, [])])
def test_tripwire_attributes_the_corrupt_rank(tmp_path, n, ranks):
    res = _spawn(tmp_path, "tripwire", n)
    for r in res:
        for key in ("direct", "commit"):
            assert r[key]["type"] == "CorruptRankError", r
            assert r[key]["ranks"] == ranks
        assert r["checks"] >= 3
    assert len({round(r["residual_sum"], 6) for r in res}) == n


# ---------------------------------------------------------------------------
# The elastic SDC drill through the launcher
# ---------------------------------------------------------------------------

DRILL_BATCHES = 24
DRILL_CHAOS = "seed=5;bitflip@step=5,rank=1;nan@step=14,rank=0"


def _reference_loss(batches: int) -> float:
    """The example's matmul model trained uninterrupted in one process
    (every rank holds the same batch, so the world size does not change
    the trajectory)."""
    from horovod_tpu_torch.examples.elastic_train import matmul_batch
    x, y = matmul_batch(2, "cpu")
    w = torch.zeros(4, 4, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.05)
    for _ in range(batches):
        opt.zero_grad()
        torch.mean((x @ w - y) ** 2).backward()
        opt.step()
    with torch.no_grad():
        return float(torch.mean((x @ w - y) ** 2))


@pytest.mark.integration
def test_elastic_sdc_drill_live(tmp_path):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("a\nb\nc\nd\n")
    disc = tmp_path / "disc.sh"
    disc.write_text(f"#!/bin/sh\ncat {hosts}\n")
    disc.chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               ELASTIC_TARGET_BATCHES=str(DRILL_BATCHES),
               ELASTIC_BATCH_DELAY_S="0.05", HOROVOD_GUARD="1",
               HOROVOD_GUARD_STREAK="3", HOROVOD_SNAPSHOT_STEPS="2",
               HOROVOD_DESYNC_CHECK_STEPS="2", HOROVOD_ELASTIC_TIMEOUT="60",
               HOROVOD_CHAOS=DRILL_CHAOS)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run",
         "--host-discovery-script", str(disc), "--min-np", "2", "--cpu",
         sys.executable, "-m", "horovod_tpu_torch.examples.elastic_train"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    watchdog = threading.Timer(150, proc.kill)
    watchdog.start()
    try:
        out = proc.communicate(timeout=180)[0]
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, out[-4000:]
    assert "minority rank(s) [1] attributed for quarantine" in out, \
        out[-4000:]
    assert "worker b:0 failed" in out
    finals = [ln for ln in out.splitlines() if "final loss" in ln]
    assert len(finals) == 3, out[-4000:]
    assert all(f"finished at batch {DRILL_BATCHES} (final size 3)" in out
               for _ in range(1))
    checksums = {ln.rsplit("checksum ", 1)[1] for ln in finals}
    assert len(checksums) == 1, finals          # replicas intact and equal
    assert out.count("SDC guard skipped 3 consecutive steps") == 3
    assert "rolled back to ledger snapshot" in out
    loss = float(finals[0].split("final loss ")[1].split()[0])
    ratio = loss / _reference_loss(DRILL_BATCHES)
    assert 0 < ratio <= LOSS_GATE, (loss, ratio)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
