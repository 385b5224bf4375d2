"""PyTorch/CUDA port: rank-0 npz checkpoints (``utils/checkpoint.py``)
against the JAX package's.

* the npz keys are ``jax.tree_util.keystr`` of the flattened path, for
  nested dicts, lists, tuples and a bare leaf;
* a checkpoint written by the JAX ``save_checkpoint`` restores bitwise in
  the port (f32, bf16, f16, int32, bool, 0-d, the step), and one
  written by the port restores bitwise in the JAX package;
* a model's ``state_dict`` round trip (int64 ``num_batches_tracked``
  included: JAX without x64 has no int64), a missing leaf, the atomic
  write,
  ``latest_checkpoint`` beside the JAX one;
* at a gloo world of two (``python -m horovod_tpu_torch.run -np 2
  --cpu``): rank 0 writes, both ranks restore through the broadcast, the
  values equal on both;
* the sharded checkpoints (``sharded_<step:010d>/shard_<rank>.npz`` and
  ``index.json``): ``tests/test_checkpoint.py``'s semantics (steps 7 and
  9, the newest, an explicit step, an empty directory), the values
  bitwise the JAX package's orbax round trip of the same seeded tree
  (bf16 included), a step without an index ignored, a missing leaf a
  ``KeyError``; at gloo world 3 (this file, run as a script, is each
  rank) every leaf written exactly once and restored bitwise on every
  rank; at world 2 a ZeRO-1 ``ZeroState`` (shards, momentum, top-k
  residuals) round trip bitwise on each rank, and its restore at world 1
  a ``ValueError`` naming ``zero_resize``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu_torch.utils import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def port():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _numpy_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "params": {"w": rng.randn(3, 4).astype(np.float32),
                   "b": rng.randn(4).astype(np.float32),
                   "h": rng.randn(2, 2).astype(np.float16)},
        "counts": np.asarray([1, 2, 3], np.int32),
        "mask": np.asarray([True, False, True]),
        "scale": np.asarray(0.5, np.float32),
        "layers": [rng.randn(2).astype(np.float32),
                   (rng.randn(1, 3).astype(np.float32),)],
    }


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["params"]["b"] = out["params"]["b"].astype(jnp.bfloat16)
    return out


def _torch_tree(t):
    def conv(x):
        return torch.from_numpy(np.array(x))
    out = {"params": {k: conv(v) for k, v in t["params"].items()},
           "counts": conv(t["counts"]),
           "mask": conv(t["mask"]), "scale": conv(t["scale"]),
           "layers": [conv(t["layers"][0]), (conv(t["layers"][1][0]),)]}
    out["params"]["b"] = out["params"]["b"].to(torch.bfloat16)
    return out


def _zeros_like_torch(tree):
    return _map_torch(torch.zeros_like, tree)


def _map_torch(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_torch(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_torch(fn, v) for v in tree)
    return fn(tree)


def _bits(x):
    """The raw bytes of a leaf, whichever package it comes from."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), tuple(t.shape)
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        a = a.view(np.int16)
    return a.tobytes(), a.shape


def _leaves(tree):
    return [v for _, v in tck._flatten(tree)]


@pytest.mark.parametrize("tree", [
    {"a": 1, "b": {"c": 2, "d": [3, (4, 5)]}},
    [1, [2, 3], {"z": 4, "a": 5}],
    7,
    {"x": None, "y": 1},
    {"k": {"nested": {"deep": 0}}, "j": (1,)},
])
def test_keys_equal_jax_keystr(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [(jax.tree_util.keystr(kp) or "<root>", v) for kp, v in flat]
    assert tck._flatten(tree) == want


def test_jax_checkpoint_restores_bitwise_in_the_port(hvd, port, tmp_path):
    t = _numpy_tree()
    path = jhvd.checkpoint_path(str(tmp_path), step=7)
    jhvd.save_checkpoint(path, _jax_tree(t), step=7)
    like = _zeros_like_torch(_torch_tree(t))
    got, step = tck.restore_checkpoint(path, like)
    assert step == 7
    want = _jax_tree(t)
    assert [_bits(g) for g in _leaves(got)] == \
        [_bits(w) for w in jax.tree.leaves(want)]
    assert got["params"]["b"].dtype == torch.bfloat16
    assert isinstance(got["layers"][1], tuple)


def test_port_checkpoint_restores_bitwise_in_jax(hvd, port, tmp_path):
    t = _numpy_tree(seed=1)
    path = tck.checkpoint_path(str(tmp_path), step=12)
    assert path == jhvd.checkpoint_path(str(tmp_path), step=12)
    tck.save_checkpoint(path, _torch_tree(t), step=12)
    like = jax.tree.map(jnp.zeros_like, _jax_tree(t))
    got, step = jhvd.restore_checkpoint(path, like)
    assert step == 12
    assert [_bits(g) for g in jax.tree.leaves(got)] == \
        [_bits(w) for w in _leaves(_torch_tree(t))]
    assert got["params"]["b"].dtype == jnp.bfloat16


def test_state_dict_round_trip_and_no_step(port, tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    sd = model.state_dict()
    path = str(tmp_path / "sub" / "m.npz")
    tck.save_checkpoint(path, sd)
    assert not [f for f in os.listdir(tmp_path / "sub") if ".tmp." in f]
    like = {k: torch.zeros_like(v) for k, v in sd.items()}
    got, step = tck.restore_checkpoint(path, like)
    assert step is None and list(got) == list(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]) and got[k].dtype == sd[k].dtype


def test_restore_missing_leaf_raises(port, tmp_path):
    path = str(tmp_path / "c.npz")
    tck.save_checkpoint(path, {"w": torch.ones(3)})
    with pytest.raises(KeyError, match="lacks"):
        tck.restore_checkpoint(path, {"w": torch.zeros(3),
                                      "extra": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="restore failed"):
        tck.restore_checkpoint(str(tmp_path / "none.npz"),
                               {"w": torch.zeros(3)})


def test_latest_checkpoint_equals_jax(port, tmp_path):
    from horovod_tpu.utils.checkpoint import latest_checkpoint
    assert tck.latest_checkpoint(str(tmp_path)) is None
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None
    for s in (3, 12, 7):
        tck.save_checkpoint(tck.checkpoint_path(str(tmp_path), s),
                            {"x": torch.ones(1)}, step=s)
    (tmp_path / "ckpt_x.npz").write_text("not a step")
    latest = tck.latest_checkpoint(str(tmp_path))
    assert latest == latest_checkpoint(str(tmp_path))
    assert latest.endswith("0000000012.npz")
    _, step = tck.restore_checkpoint(latest, {"x": torch.zeros(1)})
    assert step == 12
    assert tck.latest_checkpoint(str(tmp_path), prefix="other") is None


def test_sharded_steps_newest_explicit_and_empty(port, tmp_path):
    tree = {"w": torch.ones(3, 3), "data": torch.arange(32.0).reshape(8, 4),
            "scale": torch.tensor(0.5)}
    d = str(tmp_path / "sharded")
    p7 = thvd.save_checkpoint_sharded(d, tree, step=7)
    assert p7 == os.path.abspath(os.path.join(d, "sharded_0000000007"))
    tree9 = {k: v * 2 for k, v in tree.items()}
    thvd.save_checkpoint_sharded(d, tree9, step=9)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    out, step = thvd.restore_checkpoint_sharded(d, like)
    assert step == 9
    for k in tree:
        assert torch.equal(out[k], tree9[k]), k
    out7, step7 = thvd.restore_checkpoint_sharded(d, like, step=7)
    assert step7 == 7 and torch.equal(out7["data"], tree["data"])
    assert thvd.restore_checkpoint_sharded(str(tmp_path / "empty"),
                                           like) == (None, None)
    assert sorted(os.listdir(p7)) == ["index.json", "shard_0.npz"]


def test_sharded_values_bitwise_the_jax_orbax_round_trip(hvd, port,
                                                        tmp_path):
    t = _numpy_tree(seed=3)
    jtree = _jax_tree(t)
    jd = str(tmp_path / "jax")
    jhvd.save_checkpoint_sharded(jd, jtree, step=4)
    jgot, jstep = jhvd.restore_checkpoint_sharded(
        jd, jax.tree.map(jnp.zeros_like, jtree))
    td = str(tmp_path / "port")
    tck.save_checkpoint_sharded(td, _torch_tree(t), step=4)
    tgot, tstep = tck.restore_checkpoint_sharded(
        td, _zeros_like_torch(_torch_tree(t)))
    assert jstep == tstep == 4
    assert [_bits(g) for g in _leaves(tgot)] == \
        [_bits(w) for w in jax.tree.leaves(jgot)] == \
        [_bits(w) for w in jax.tree.leaves(jtree)]
    assert tgot["params"]["b"].dtype == torch.bfloat16
    assert isinstance(tgot["layers"][1], tuple)


def test_sharded_step_without_index_is_ignored(port, tmp_path):
    d = str(tmp_path / "s")
    tck.save_checkpoint_sharded(d, {"w": torch.ones(2)}, step=3)
    p5 = tck.save_checkpoint_sharded(d, {"w": torch.full((2,), 5.0)},
                                     step=5)
    os.remove(os.path.join(p5, "index.json"))       # a save cut short
    got, step = tck.restore_checkpoint_sharded(d, {"w": torch.zeros(2)})
    assert step == 3 and got["w"].tolist() == [1.0, 1.0]
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint_sharded(d, {"w": torch.zeros(2)}, step=5)


def test_sharded_overwrite_cut_short_leaves_no_mixed_step(port, tmp_path,
                                                          monkeypatch):
    """Saving a step again (after a rollback) replaces it whole: a save
    cut short while writing its shards leaves the step without an index,
    so the restore falls back to the step before, never to an index over
    a mix of new and old shards."""
    d = str(tmp_path / "s")
    tck.save_checkpoint_sharded(d, {"w": torch.ones(2)}, step=7)
    p9 = tck.save_checkpoint_sharded(d, {"w": torch.full((2,), 9.0)},
                                     step=9)
    real = tck._atomic_write

    def cut(path, data):
        if os.path.basename(path).startswith("shard_"):
            raise OSError("disk full")
        real(path, data)

    monkeypatch.setattr(tck, "_atomic_write", cut)
    with pytest.raises(RuntimeError, match="disk full"):
        tck.save_checkpoint_sharded(d, {"w": torch.full((2,), 4.0)}, step=9)
    assert not os.path.exists(os.path.join(p9, "index.json"))
    got, step = tck.restore_checkpoint_sharded(d, {"w": torch.zeros(2)})
    assert step == 7 and got["w"].tolist() == [1.0, 1.0]
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint_sharded(d, {"w": torch.zeros(2)}, step=9)


def test_sharded_overwrite_replaces_the_step_whole(port, tmp_path):
    d = str(tmp_path / "s")
    p = tck.save_checkpoint_sharded(d, {"w": torch.ones(2)}, step=9)
    stale = os.path.join(p, "shard_5.npz")     # from a larger world
    with open(stale, "wb") as f:
        f.write(b"stale")
    assert tck.save_checkpoint_sharded(
        d, {"w": torch.full((2,), 4.0)}, step=9) == p
    assert sorted(os.listdir(p)) == ["index.json", "shard_0.npz"]
    got, step = tck.restore_checkpoint_sharded(d, {"w": torch.zeros(2)})
    assert step == 9 and got["w"].tolist() == [4.0, 4.0]


def test_sharded_restore_missing_leaf_raises(port, tmp_path):
    d = str(tmp_path / "s")
    tck.save_checkpoint_sharded(d, {"w": torch.ones(3)}, step=1)
    with pytest.raises(KeyError, match="lacks"):
        tck.restore_checkpoint_sharded(d, {"w": torch.zeros(3),
                                           "extra": torch.zeros(2)})


def _sharded_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {f"w{i}": torch.randn(3, i + 1, generator=g)
                       for i in range(5)},
            "bf": torch.randn(4, generator=g).to(torch.bfloat16),
            "count": torch.tensor([7], dtype=torch.int64),
            "step": 11}


def _world_worker(rank: int, world: int, store: str, d: str,
                  out: str) -> None:
    """One rank of the gloo worlds: ``world`` 3 saves and restores a
    replicated tree; ``world`` 2 a ZeRO-1 state after two steps."""
    import torch.distributed as dist

    from horovod_tpu_torch.optim import zero as tzero
    thvd.init(device="cpu", store=dist.FileStore(store, world), rank=rank,
              size=world)
    res = {}
    if world == 3:
        tree = _sharded_tree()
        path = tck.save_checkpoint_sharded(d, tree, step=2)
        got, step = tck.restore_checkpoint_sharded(
            d, _map_torch(lambda v: torch.zeros_like(v)
                          if torch.is_tensor(v) else 0, tree))
        res = {"path": path, "step": step, "got": got}
    else:
        torch.manual_seed(0)
        params = [torch.nn.Parameter(torch.randn(5, 3)),
                  torch.nn.Parameter(torch.randn(7)),
                  torch.nn.Parameter(torch.randn(6).to(torch.bfloat16))]
        opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
        zs = tzero.zero_init(opt, params, compression="topk:0.5")
        for k in range(2):
            grads = [torch.full_like(p, 0.1 * (k + 1 + rank)) for p in params]
            tzero.zero_apply(opt, grads, zs, params, compression="topk:0.5")
        tree = {"params": list(params), "zero": zs}
        tck.save_checkpoint_sharded(d, tree, step=6)
        want = {"shards": [s.clone() for s in zs.shards],
                "res": [r.clone() for r in zs.residuals],
                "mom": [zs.inner.state[s]["momentum_buffer"].clone()
                        for s in zs.shards]}
        fresh = tzero.zero_init(opt, params, compression="topk:0.5")
        like = {"params": [torch.zeros_like(p) for p in params],
                "zero": fresh}
        got, step = tck.restore_checkpoint_sharded(d, like)
        assert got["zero"] is fresh and step == 6
        res = {"want": want, "params": [p.detach().clone() for p in params],
               "got_params": got["params"],
               "shards": fresh.shards, "res": fresh.residuals,
               "mom": [fresh.inner.state[s]["momentum_buffer"]
                       for s in fresh.shards]}
    thvd.shutdown()
    torch.save(res, out)


def _run_world(tmp_path, world):
    store, d = str(tmp_path / "store"), str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "HOROVOD_RANK",
                        "HOROVOD_SIZE", "HVD_TPU_RENDEZVOUS_FILE")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), store, d,
         str(tmp_path / f"r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return d, [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
               for r in range(world)]


def test_sharded_world3_each_leaf_once_restored_everywhere(tmp_path):
    import json
    d, ranks = _run_world(tmp_path, 3)
    tree = _sharded_tree()
    want = _leaves(tree)
    keys = [k for k, _ in tck._flatten(tree)]
    with open(os.path.join(ranks[0]["path"], "index.json")) as f:
        index = json.load(f)
    assert index["step"] == 2 and index["world"] == 3
    held = [k for r in range(3) for k in index["shards"][str(r)]]
    assert sorted(held) == sorted(keys)                   # each once
    for i, k in enumerate(keys):
        assert k in index["shards"][str(i % 3)]
    for r in ranks:
        assert r["step"] == 2
        for g, w in zip(_leaves(r["got"]), want):
            assert _bits(g) == _bits(torch.as_tensor(w)), (g, w)


def test_sharded_zero_state_round_trip_and_world_change(tmp_path, port):
    from horovod_tpu_torch.optim import zero as tzero
    d, ranks = _run_world(tmp_path, 2)
    for r in ranks:
        for k in ("shards", "res", "mom"):
            assert len(r[k]) == 2
            for g, w in zip(r[k], r["want"][k]):
                assert g.dtype == w.dtype and torch.equal(g, w), k
        for g, w in zip(r["got_params"], r["params"]):
            assert torch.equal(g, w)
    assert not torch.equal(ranks[0]["shards"][0], ranks[1]["shards"][0])
    params = [torch.nn.Parameter(torch.zeros(5, 3)),
              torch.nn.Parameter(torch.zeros(7)),
              torch.nn.Parameter(torch.zeros(6, dtype=torch.bfloat16))]
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    like = {"params": [torch.zeros_like(p) for p in params],
            "zero": tzero.zero_init(opt, params, compression="topk:0.5")}
    with pytest.raises(ValueError, match="zero_resize"):
        tck.restore_checkpoint_sharded(d, like)


_TWO_RANKS = """
import sys, torch
import horovod_tpu_torch as hvd
hvd.init()
path = sys.argv[1]
tree = {"w": torch.arange(6.0).reshape(2, 3) * (hvd.rank() + 1),
        "b": torch.tensor([hvd.rank()], dtype=torch.int64)}
hvd.save_checkpoint(path, tree, step=5, root_rank=0)
got, step = hvd.restore_checkpoint(path, {"w": torch.zeros(2, 3),
                                          "b": torch.zeros(1, dtype=torch.int64)})
assert step == 5
assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3)), got
assert got["b"].tolist() == [0], got
print(f"rank {hvd.rank()}: restored OK", flush=True)
hvd.shutdown()
"""


@pytest.mark.integration
def test_root_saves_every_rank_restores(tmp_path):
    script = tmp_path / "ck.py"
    script.write_text(_TWO_RANKS)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "HOROVOD_RANK",
                        "HOROVOD_SIZE", "HVD_TPU_RENDEZVOUS_FILE")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2", "--cpu",
         sys.executable, str(script), str(tmp_path / "c.npz")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    for r in range(2):
        assert f"rank {r}: restored OK" in out.stdout


if __name__ == "__main__":
    _world_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                  sys.argv[4], sys.argv[5])
