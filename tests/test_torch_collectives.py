"""PyTorch/CUDA port: collectives, state sync and codecs.

The collectives run in a real two-rank gloo world on the CPU: two worker
processes (this file, run as a script) rendezvous through a ``FileStore``
under the test's temporary directory -- no fixed port -- and run every
check once; the tests read their results.  One world per module keeps
process start-up out of each test.  Expected values are recomputed here
from the same numpy inputs (each rank's come from ``RandomState(100 +
rank)``).  Tolerance 1e-6 absolute for float sums (two-term sums in
another order); exact for integers, gathers and broadcasts.

The cast codecs are held against the JAX package's ``BF16Compressor`` /
``FP16Compressor`` bitwise, in this process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ATOL = 1e-6


def _inputs(rank):
    rng = np.random.RandomState(100 + rank)
    return {
        "x": rng.randn(5, 3).astype(np.float32),
        "i": rng.randint(-50, 50, (7,)).astype(np.int32),
        "ragged": rng.randn(2 + rank, 4).astype(np.float32),
        "g32": rng.randn(4).astype(np.float32),
        "g16": rng.randn(3, 2).astype(np.float32),
        "g32b": rng.randn(6).astype(np.float32),
        "grads": [rng.randn(8, 3).astype(np.float32),
                  rng.randn(5).astype(np.float32)],
    }


def _worker(rank: int, store_path: str, out: str) -> None:
    """One rank of the world: every collective once, results saved."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import allreduce_gradients

    torch.manual_seed(rank)
    hvd.init(device="cpu", store=dist.FileStore(store_path, WORLD),
             rank=rank, size=WORLD)
    inp = _inputs(rank)
    x = torch.from_numpy(inp["x"])
    x_copy = x.clone()
    res = {"identity": (hvd.rank(), hvd.size(), hvd.local_rank(),
                        hvd.local_size(), hvd.cross_rank(),
                        hvd.cross_size())}
    res["sum"] = hvd.allreduce(x, hvd.Sum)
    res["avg_scaled"] = hvd.allreduce(x, hvd.Average, prescale_factor=0.5,
                                      postscale_factor=3.0)
    res["int_avg"] = hvd.allreduce(torch.from_numpy(inp["i"]), hvd.Average)
    res["min"] = hvd.allreduce(x, hvd.Min)
    res["max"] = hvd.allreduce(x, hvd.Max)
    res["prod"] = hvd.allreduce(x, hvd.Product)
    res["async"] = hvd.synchronize(hvd.allreduce_async(x, hvd.Sum))
    res["x_untouched"] = torch.equal(x, x_copy)
    res["grouped"] = hvd.grouped_allreduce(
        [torch.from_numpy(inp["g32"]),
         torch.from_numpy(inp["g16"]).to(torch.bfloat16),
         torch.from_numpy(inp["g32b"])], hvd.Average)
    res["gather"] = hvd.allgather(torch.from_numpy(inp["ragged"]))
    res["bcast"] = hvd.broadcast(x, root_rank=1)

    lin = torch.nn.Linear(4, 3)
    res["lin_before"] = {k: v.clone() for k, v in lin.state_dict().items()}
    hvd.broadcast_parameters(lin.state_dict(), root_rank=0)
    res["lin_after"] = {k: v.clone() for k, v in lin.state_dict().items()}

    opt = torch.optim.AdamW(lin.parameters(), lr=1e-3 * (rank + 1))
    lin(torch.full((2, 4), rank + 1.0)).square().sum().backward()
    opt.step()
    state = opt.state[lin.weight]
    res["opt_before"] = (state["exp_avg"].clone(), float(state["step"]),
                         opt.param_groups[0]["lr"])
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    state = opt.state[lin.weight]
    res["opt_after"] = (state["exp_avg"].clone(), float(state["step"]),
                        opt.param_groups[0]["lr"])
    res["object"] = hvd.broadcast_object({"rank": rank, "tag": "x" * rank},
                                         root_rank=1)

    grads = [torch.from_numpy(g) for g in inp["grads"]]
    from horovod_tpu_torch.collectives import Compression
    res["grads_bf16"] = allreduce_gradients(
        grads, compression=Compression.bf16, fusion_threshold=64)
    res["grads_none"] = allreduce_gradients(grads)
    hvd.barrier()
    torch.save(res, out)
    hvd.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the two ranks once; ``{rank: results}``."""
    tmp = tmp_path_factory.mktemp("gloo_world")
    store = str(tmp / "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), store, str(tmp / f"r{r}.pt")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {r: torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(WORLD)}


def _both(world, key):
    return [world[r][key] for r in range(WORLD)]


def test_identity(world):
    for r in range(WORLD):
        assert world[r]["identity"] == (r, WORLD, 0, WORLD, 0, 1)


def test_allreduce_sum_average_and_scales(world):
    x = [_inputs(r)["x"] for r in range(WORLD)]
    for got in _both(world, "sum") + _both(world, "async"):
        np.testing.assert_allclose(got.numpy(), x[0] + x[1], atol=ATOL)
    want = (x[0] * 0.5 + x[1] * 0.5) / 2 * 3.0
    for got in _both(world, "avg_scaled"):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert all(_both(world, "x_untouched"))


def test_allreduce_integer_average_truncates(world):
    i = [_inputs(r)["i"].astype(np.int64) for r in range(WORLD)]
    want = np.trunc((i[0] + i[1]) / 2).astype(np.int32)
    for got in _both(world, "int_avg"):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,fn", [("min", np.minimum), ("max", np.maximum),
                                   ("prod", np.multiply)])
def test_allreduce_min_max_product(world, op, fn):
    x = [_inputs(r)["x"] for r in range(WORLD)]
    for got in _both(world, op):
        np.testing.assert_allclose(got.numpy(), fn(x[0], x[1]), atol=ATOL)


def test_grouped_allreduce_mixed_dtypes(world):
    ins = [_inputs(r) for r in range(WORLD)]
    for got in _both(world, "grouped"):
        assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                          torch.float32]
        np.testing.assert_allclose(
            got[0].numpy(), (ins[0]["g32"] + ins[1]["g32"]) / 2, atol=ATOL)
        np.testing.assert_allclose(
            got[2].numpy(), (ins[0]["g32b"] + ins[1]["g32b"]) / 2, atol=ATOL)
        b16 = [torch.from_numpy(i["g16"]).to(torch.bfloat16) for i in ins]
        assert torch.equal(got[1], (b16[0] + b16[1]) / 2)


def test_allgather_ragged_first_dim(world):
    want = np.concatenate([_inputs(r)["ragged"] for r in range(WORLD)])
    for got in _both(world, "gather"):
        np.testing.assert_array_equal(got.numpy(), want)


def test_broadcast_and_object(world):
    for got in _both(world, "bcast"):
        np.testing.assert_array_equal(got.numpy(), _inputs(1)["x"])
    assert _both(world, "object") == [{"rank": 1, "tag": "x"}] * WORLD


def test_broadcast_parameters(world):
    root = world[0]["lin_before"]
    assert not torch.equal(world[1]["lin_before"]["weight"], root["weight"])
    for r in range(WORLD):
        for k in root:
            assert torch.equal(world[r]["lin_after"][k], root[k])


def test_broadcast_optimizer_state(world):
    exp_avg0, step0, lr0 = world[0]["opt_before"]
    assert not torch.equal(world[1]["opt_before"][0], exp_avg0)
    for r in range(WORLD):
        exp_avg, step, lr = world[r]["opt_after"]
        assert torch.equal(exp_avg, exp_avg0)
        assert (step, lr) == (step0, lr0) == (1.0, 1e-3)


def test_allreduce_gradients_fused_and_compressed(world):
    grads = [_inputs(r)["grads"] for r in range(WORLD)]
    for r in range(WORLD):
        for k, got in enumerate(world[r]["grads_none"]):
            np.testing.assert_allclose(
                got.numpy(), (grads[0][k] + grads[1][k]) / 2, atol=ATOL)
        for k, got in enumerate(world[r]["grads_bf16"]):
            # bf16 on the wire: each rank's gradient rounds to bf16, the
            # sum and the division run in bf16, the result comes back f32.
            b = [torch.from_numpy(g[k]).to(torch.bfloat16) for g in grads]
            assert got.dtype == torch.float32
            assert torch.equal(got, ((b[0] + b[1]) / 2).float())


@pytest.mark.parametrize("codec", ["bf16", "fp16"])
def test_cast_codecs_bitwise_equal_to_jax(codec):
    import jax.numpy as jnp

    from horovod_tpu.collectives.compression import Compression as JC
    from horovod_tpu_torch.collectives import Compression as TC

    rng = np.random.RandomState(7)
    x = (rng.randn(4096) * np.exp(rng.uniform(-10, 10, 4096))).astype(
        np.float32)
    jc, tc = getattr(JC, codec), getattr(TC, codec)
    jw, jctx = jc.compress(jnp.asarray(x))
    tw, tctx = tc.compress(torch.from_numpy(x))
    assert str(jw.dtype) == str(tw.dtype).replace("torch.", "")
    bits = np.asarray(jw).view(np.uint16)
    np.testing.assert_array_equal(tw.view(torch.int16).numpy().view(
        np.uint16), bits)
    back = tc.decompress(tw, tctx)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jc.decompress(jw, jctx)))
    # Integers and tensors no wider than the wire pass through.
    for t in (torch.arange(5, dtype=torch.int32),
              torch.ones(3, dtype=tc.wire_dtype)):
        w, ctx = tc.compress(t)
        assert w is t and ctx is None and tc.decompress(w, ctx) is t
    w, ctx = TC.none.compress(torch.from_numpy(x))
    assert ctx is None and torch.equal(TC.none.decompress(w, ctx),
                                       torch.from_numpy(x))


def test_world_of_one_and_lifecycle():
    """No launcher environment: ``init`` is a world of size 1 (through a
    HashStore, no port); ``shutdown`` destroys what it created; APIs
    before ``init`` raise."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import NotInitializedError

    with pytest.raises(NotInitializedError):
        hvd.size()
    env = {k: os.environ.pop(k) for k in list(os.environ)
           if k in ("RANK", "WORLD_SIZE", "HOROVOD_RANK", "HOROVOD_SIZE")}
    try:
        hvd.init(device="cpu")
        assert (hvd.size(), hvd.rank(), hvd.is_initialized()) == (1, 0,
                                                                  True)
        x = torch.arange(6, dtype=torch.float32)
        assert torch.equal(hvd.allreduce(x), x)
        assert torch.equal(hvd.allgather(x), x)
        hvd.shutdown()
        assert not hvd.is_initialized()
        assert not torch.distributed.is_initialized()
    finally:
        os.environ.update(env)
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert isinstance(hvd.nccl_built(), bool)


def test_init_defaults_to_the_gpu():
    import horovod_tpu_torch as hvd
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
