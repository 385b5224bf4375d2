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
  ``latest_checkpoint`` beside the JAX one, the sharded (orbax) calls'
  refusal;
* at a gloo world of two (``python -m horovod_tpu_torch.run -np 2
  --cpu``): rank 0 writes, both ranks restore through the broadcast, the
  values equal on both.
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


@pytest.mark.parametrize("fn", ["save_checkpoint_sharded",
                                "restore_checkpoint_sharded"])
def test_sharded_checkpoints_raise(fn, tmp_path):
    with pytest.raises(NotImplementedError, match="1.11"):
        getattr(tck, fn)(str(tmp_path), {"w": torch.ones(1)})


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
