"""PyTorch/CUDA port: the microbatched backward-overlap exchange
(``make_train_step(..., microbatches=k)``), against the port's own
single-shot step and against the JAX package.

The ports of ``tests/test_microbatch.py``'s thirteen tests, in one
process at world 1:

* k in {2, 4} against the single-shot step within RTOL 2e-5 / ATOL 2e-6
  (the cross-microbatch sum runs in f32), and k = 1 bitwise the
  single-shot step;
* the overlap order (the counterpart of the JAX HLO interleaving test):
  microbatch i's reduce-scatter is launched before microbatch i+1's
  backward starts and the closing allgather after the last backward, as
  the collective counters read from inside each backward show; one
  reduce-scatter a microbatch and one allgather a bucket;
* bf16 wire compression composes (the reduce-scatter rows ride bf16);
* the flax MLP step (``make_flax_train_step``) at k = 4 against k = 1;
* the refusals (``zero_stage=1``, ``backward_passes_per_step > 1``,
  Adasum, fp8), an invalid k, an indivisible batch, the
  ``HOROVOD_MICROBATCHES`` knob and the reverse bucket plan.

Against JAX:

* a gloo world of 2 (this file, run as a script, is each rank): four
  microbatched steps at k = 2 and 4 against ``make_train_step(
  microbatches=k)`` on a two-device mesh within 1e-5, and with the
  error-feedback codecs powersgd:2 and topk:0.25 at k = 2 -- parameters
  and each rank's residuals within 1e-5 of JAX's, so the residual is
  applied once a step, not once a microbatch;
* a one-stage ResNet converted with ``resnet_state_from_jax`` at
  ``microbatches=2`` (the BatchNorm statistics chain through the
  microbatches) against the JAX ``make_flax_train_step(microbatches=2)``
  on a one-device mesh, within ``test_torch_resnet.py``'s tolerances.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.timeline import metrics as tmetrics
from horovod_tpu_torch.timeline import spans as tspans
from horovod_tpu_torch.training import make_flax_train_step, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_MICROBATCHES", "HOROVOD_COMPRESSION",
                 "HOROVOD_ZERO", "HOROVOD_HIERARCHICAL",
                 "HOROVOD_EXCHANGE_CHUNK_MB")
RTOL, ATOL = 2e-5, 2e-6      # the documented f32 accumulation tolerance
JAX_ATOL = 1e-5
STEPS = 4


def _params0():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(6, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


def _data(n_rows=32):
    return (np.random.RandomState(1).randn(n_rows, 6).astype(np.float32),
            np.random.RandomState(2).randn(n_rows, 4).astype(np.float32))


class _Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _params0().items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v)))

    def forward(self, x):
        return x @ self.w + self.b


def _loss(model, batch):
    # Per-example MEAN: what makes the microbatches add up to the batch.
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def _jax_loss(p, b):
    return jnp.mean((b[0] @ p["w"] + p["b"] - b[1]) ** 2)


@pytest.fixture
def world1(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _run(k, steps=STEPS, compression=None, rows=slice(None), model=None):
    """``steps`` steps at ``microbatches=k``: (parameters, last loss)."""
    model = model or _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=compression or "none")
    step = make_train_step(model, _loss, opt, microbatches=k)
    x, y = _data()
    batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    for _ in range(steps):
        loss = step(batch)
    return {n: p.detach().clone() for n, p in model.named_parameters()}, \
        loss.item()


@pytest.mark.parametrize("k", [2, 4])
def test_microbatch_parity_with_single_shot(world1, k):
    p1, l1 = _run(1)
    pk, lk = _run(k)
    assert np.isclose(l1, lk, rtol=RTOL)
    for n in p1:
        np.testing.assert_allclose(pk[n].numpy(), p1[n].numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_microbatch_k1_is_bitwise_single_shot(world1):
    """k = 1 is the single-shot builder: bitwise identical."""
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), compression="none")
    step = make_train_step(model, _loss, opt)
    x, y = _data()
    for _ in range(STEPS):
        loss = step((torch.from_numpy(x), torch.from_numpy(y)))
    p1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    pk, lk = _run(1)
    assert loss.item() == lk
    for n in p1:
        assert torch.equal(p1[n], pk[n])


def test_microbatch_exchange_interleaves_with_backward(world1):
    """The overlap order: each microbatch's backward sees every earlier
    microbatch's reduce-scatter already launched and no allgather; the
    step runs k reduce-scatters and one allgather a bucket (one bucket
    here), and one allreduce (the loss)."""
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), compression="none")
    step = make_train_step(model, _loss, opt, microbatches=4)
    seen = []

    def calls(op):
        return tmetrics.collective_totals().get((op, "global"),
                                                {}).get("calls", 0)

    model.w.register_hook(lambda g: seen.append(
        (calls("reducescatter"), calls("allgather"))))
    tmetrics.reset_metrics()
    x, y = _data()
    step((torch.from_numpy(x), torch.from_numpy(y)))
    assert seen == [(0, 0), (1, 0), (2, 0), (3, 0)]
    assert calls("reducescatter") == 4 and calls("allgather") == 1
    assert calls("allreduce") == 1


def test_microbatch_compressed_exchange_runs(world1):
    """bf16 wire compression composes: the reduce-scatter rows ride
    bf16, and the parameters stay finite."""
    tspans.recorder().reset()
    pk, lk = _run(2, compression=thvd.Compression.bf16)
    assert np.isfinite(lk)
    assert all(torch.isfinite(p).all() for p in pk.values())
    reg = tspans.recorder().leg_registry()
    values = sum(v.numel() for v in pk.values())
    assert reg["microbatch_rs"] == {"nbytes": STEPS * 2 * 2 * values,
                                    "buckets": STEPS * 2}
    assert reg["microbatch_ag"]["buckets"] == STEPS


class _MLP(torch.nn.Module):
    """flax's ``Dense(4)(relu(Dense(8)(x)))`` with flax's names."""

    def __init__(self):
        super().__init__()
        from horovod_tpu_torch.models.layers import Dense
        self.Dense_0 = Dense(6, 8, device="cpu")
        self.Dense_1 = Dense(8, 4, device="cpu")
        rng = np.random.RandomState(3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(
                    0.5 * rng.randn(*p.shape).astype(np.float32)))

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def test_microbatch_flax_parity(world1):
    x = np.random.RandomState(3).randn(32, 6).astype(np.float32)
    y = np.random.RandomState(4).randint(0, 4, (32,)).astype(np.int64)

    def frun(k):
        model = _MLP()
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        step = make_flax_train_step(model, opt, microbatches=k)
        for _ in range(3):
            loss = step((torch.from_numpy(x), torch.from_numpy(y)))
        return {n: p.detach().clone()
                for n, p in model.named_parameters()}, loss.item()

    f1, l1 = frun(1)
    f4, l4 = frun(4)
    assert np.isclose(l1, l4, rtol=RTOL)
    for n in f1:
        np.testing.assert_allclose(f4[n].numpy(), f1[n].numpy(), rtol=RTOL,
                                   atol=ATOL)


# -- refusals ---------------------------------------------------------------

def test_microbatch_rejects_zero_stage(world1):
    model = _Lin()
    with pytest.raises(ValueError, match="zero_stage"):
        make_train_step(model, _loss, torch.optim.SGD(model.parameters(),
                                                      lr=0.1),
                        zero_stage=1, microbatches=2)


def test_microbatch_rejects_backward_passes_per_step(world1):
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        backward_passes_per_step=2)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        make_train_step(model, _loss, opt, microbatches=2)


def test_microbatch_rejects_adasum(world1):
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), op=thvd.Adasum)
    with pytest.raises(ValueError, match="Sum/Average"):
        make_train_step(model, _loss, opt, microbatches=2)


def test_microbatch_rejects_fp8_compression(world1):
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        compression=thvd.Compression.fp8)
    with pytest.raises(NotImplementedError):
        make_train_step(model, _loss, opt, microbatches=2)


def test_microbatch_rejects_invalid_k(world1):
    model = _Lin()
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, _loss, torch.optim.SGD(model.parameters(),
                                                      lr=0.1),
                        microbatches=0)


def test_microbatch_rejects_indivisible_batch(world1):
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    step = make_train_step(model, _loss, opt, microbatches=3)
    x, y = _data(48)
    step((torch.from_numpy(x[:6]), torch.from_numpy(y[:6])))   # 6 % 3 == 0
    with pytest.raises(ValueError, match="must divide"):
        step((torch.from_numpy(x[:4]), torch.from_numpy(y[:4])))


def test_microbatch_env_reaches_builders(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_MICROBATCHES", "2")
    thvd.init(device="cpu")
    try:
        assert thvd.microbatches() == 2
        model = _Lin()
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        step = make_train_step(model, _loss, opt)   # k from the env
        tmetrics.reset_metrics()
        x, y = _data()
        step((torch.from_numpy(x), torch.from_numpy(y)))
        assert tmetrics.collective_totals()[
            ("reducescatter", "global")]["calls"] == 2
    finally:
        thvd.shutdown()
    assert thvd.microbatches() == 1


def test_reverse_bucket_plan_orders_last_leaves_first():
    """``reverse=True`` walks the leaves last-to-first: the last layers'
    gradients are ready first, so their bucket leads."""
    from horovod_tpu_torch.controller.fusion import plan_buckets
    leaves = [torch.zeros(4), torch.zeros(8), torch.zeros(1024)]
    fwd = plan_buckets(leaves, threshold_bytes=64)
    rev = plan_buckets(leaves, threshold_bytes=64, reverse=True)
    assert [s.index for s in fwd.buffers[0][1]][0] == 0
    assert [s.index for s in rev.buffers[0][1]][0] == 2
    assert sorted(s.index for _, ls in rev.buffers for s in ls) == [0, 1, 2]


# ---------------------------------------------------------------------------
# A gloo world of two against a two-device JAX mesh
# ---------------------------------------------------------------------------


WORLD = 2
CASES = {"k2": (2, "none"), "k4": (4, "none"),
         "powersgd": (2, "powersgd:2"), "topk": (2, "topk:0.25")}


def _worker(rank: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, WORLD),
              rank=rank, size=WORLD)
    rows = slice(rank * 16, (rank + 1) * 16)
    res = {}
    for name, (k, codec) in CASES.items():
        model = _Lin()
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(), compression=codec)
        step = make_train_step(model, _loss, opt, microbatches=k)
        x, y = _data()
        batch = (torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
        losses = [step(batch).item() for _ in range(STEPS)]
        res[name] = ({n: p.detach().clone()
                      for n, p in model.named_parameters()}, losses,
                     [r.clone() for r in opt.residuals])
    thvd.barrier()
    torch.save(res, out)
    thvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mb2")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp / "store"),
         str(tmp / f"r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {r: torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(WORLD)}


@pytest.fixture
def jax2():
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:WORLD])
    yield hvd
    hvd.shutdown()


def _jax_steps(hvd, k, codec):
    opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                   compression=codec)
    params = hvd.replicate({k_: jnp.asarray(v)
                            for k_, v in _params0().items()})
    opt_state = hvd.replicate(opt.init(params))
    step = hvd.make_train_step(_jax_loss, opt, microbatches=k)
    batch = hvd.shard_batch(tuple(map(jnp.asarray, _data())))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    residuals = [np.asarray(r) for r in getattr(opt_state, "residuals", ())]
    return {k_: np.asarray(v) for k_, v in params.items()}, losses, \
        residuals


@pytest.mark.parametrize("name", sorted(CASES))
def test_microbatch_world2_matches_jax(world2, jax2, name):
    k, codec = CASES[name]
    want, want_losses, want_res = _jax_steps(jax2, k, codec)
    for r in range(WORLD):
        params, losses, residuals = world2[r][name]
        np.testing.assert_allclose(losses, want_losses, rtol=JAX_ATOL)
        for n, w in want.items():
            np.testing.assert_allclose(params[n].numpy(), w, atol=JAX_ATOL,
                                       rtol=0, err_msg=f"{name} {n}")
        assert len(residuals) == len(want_res)
        for got, w in zip(residuals, want_res):
            # One residual a bucket, replaced once a step: rank r's row.
            assert w.shape == (WORLD,) + tuple(got.shape)
            np.testing.assert_allclose(got.numpy(), w[r], atol=JAX_ATOL,
                                       rtol=0)
            assert got.abs().max().item() > 0
    if codec == "none":
        assert world2[0][name][2] == []


def test_microbatch_flax_resnet_matches_jax(monkeypatch):
    import horovod_tpu as hvd
    from horovod_tpu.training import make_flax_train_step as jstep
    from test_torch_resnet import (LOSS_RTOL, STATE_ATOL, _batch,
                                   _tiny_flax, _tiny_port)
    from horovod_tpu_torch.models import resnet_state_from_jax
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")   # JAX: interpret kernels
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    model, variables = _tiny_flax(seed=3)
    batch = _batch(n=8)
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    try:
        opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
        step = jstep(model.apply, opt, microbatches=2)
        jv = jax.tree.map(jnp.asarray, variables)
        params = hvd.replicate(jv["params"])
        stats = hvd.replicate(jv["batch_stats"])
        state = hvd.replicate(opt.init(jv["params"]))
        data = hvd.shard_batch(tuple(map(jnp.asarray, batch)))
        want_losses = []
        for _ in range(3):
            params, stats, state, loss = step(params, stats, state, data)
            want_losses.append(float(loss))
        want = resnet_state_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": jax.tree.map(np.asarray, stats)}, device="cpu")
    finally:
        hvd.shutdown()
    thvd.init(device="cpu")
    try:
        ours = _tiny_port(variables)
        named = list(ours.named_parameters())
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
            named_parameters=named)
        tstep = make_flax_train_step(ours, opt, microbatches=2)
        data = tuple(torch.from_numpy(a) for a in batch)
        losses = [tstep(data).item() for _ in range(3)]
        got = ours.state_dict()
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                   atol=STATE_ATOL, rtol=0, err_msg=name)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
