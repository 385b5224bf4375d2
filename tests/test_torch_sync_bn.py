"""PyTorch/CUDA port: synchronized BatchNorm vs one process on the
concatenated batch and vs the JAX package.

* :func:`~horovod_tpu_torch.training.sync_batch_norm` (flax-style, NHWC)
  at gloo worlds of 2 and 4, each rank on its shard of one batch: the
  output, dx, the LOCAL dgamma / dbeta and the running statistics equal
  one process's plain BatchNorm on the concatenated batch (dx and y
  sliced; dgamma / dbeta the shard's own sums under the global
  statistics), and the JAX package's ``sync_batch_norm`` (flax
  ``BatchNorm(axis_name=...)``) under ``jax.shard_map`` on 2 and 4 of
  the conftest's 8 CPU devices (its parameter cotangents per device).
  Two allreduces a step, at every world size.
* At world 1 the sync layer is the plain one, bit for bit, over every
  rank and over the ``data`` axis of a rank mesh (``axes=``).
* ``hvd.SyncBatchNorm`` (torch-style) at worlds 1 and 2 against
  ``torch.nn.BatchNorm2d`` on the concatenated batch, two steps at
  ``momentum=None`` (a cumulative average, the unbiased variance with the
  global count); at world 1 against the JAX shim's
  ``horovod_tpu.torch.SyncBatchNorm``.
* ``bn_backward_dx(count=...)`` against the closed form.
* A world-2 ResNet-18 with sync BN, one ``make_flax_train_step`` step,
  against one process on the concatenated batch.

Multi-rank runs spawn this file as its own worker over a ``FileStore``
under ``tmp_path``.  f32 on the CPU (the ResNet-18 step in f64).
Tolerance 1e-5 absolute plus 1e-5 relative (sums over the ranks in
another order); the ResNet-18 step: losses 1e-5 relative, parameters and
statistics 2e-5 absolute (those of ``tests/test_torch_resnet.py``).
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import bn as tbn
from horovod_tpu_torch.timeline.metrics import sync_bn_totals
from horovod_tpu_torch.training import sync_batch_norm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
STATE_ATOL = 2e-5
EPS = 1e-5
C = 16
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def _data(n, seed, nchw=False):
    """``n`` ranks' batch of 2 ``[7, 5, C]`` images (NHWC, or NCHW) with
    an offset, its cotangent, and BN parameters and statistics."""
    rng = np.random.RandomState(seed)
    shape = (2 * n, C, 7, 5) if nchw else (2 * n, 7, 5, C)
    x = (1.5 * rng.randn(*shape) + 0.7).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    params = {"scale": 1 + 0.1 * rng.randn(C), "bias": 0.1 * rng.randn(C),
              "mean": 0.1 * rng.randn(C), "var": 1 + 0.1 * rng.rand(C)}
    return x, dy, {k: v.astype(np.float32) for k, v in params.items()}


def _spawn(tmp_path, mode, n, data):
    """Run ``n`` ranks of ``mode``; each returns its results dict."""
    torch.save(data, tmp_path / "in.pt")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(n),
         str(tmp_path / "store"), str(tmp_path / "in.pt"),
         str(tmp_path / f"r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
            for r in range(n)]


def _shard(a, r, n):
    b = a.shape[0] // n
    return a[r * b:(r + 1) * b]


# ---------------------------------------------------------------------------
# Worker bodies (one rank each)
# ---------------------------------------------------------------------------


def _flax_style_rank(data):
    x, dy, p = data["x"], data["dy"], data["params"]
    m = sync_batch_norm(features=C, momentum=0.9, epsilon=EPS, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    before = sync_bn_totals()
    y = m(xt)
    y.backward(torch.from_numpy(dy))
    moved = {k: v - before[k] for k, v in sync_bn_totals().items()}
    return {"y": y.detach(), "dx": xt.grad, "dscale": m.scale.grad,
            "dbias": m.bias.grad, "mean": m.mean, "var": m.var,
            "moved": moved}


def _torch_style_rank(data, steps=2):
    m = thvd.SyncBatchNorm(C, momentum=None, device="cpu")
    out = []
    for s in range(steps):
        xt = torch.from_numpy(data["x"][s]).requires_grad_(True)
        m.zero_grad()
        y = m(xt)
        y.backward(torch.from_numpy(data["dy"][s]))
        out.append({"y": y.detach(), "dx": xt.grad,
                    "dweight": m.weight.grad.clone(),
                    "dbias": m.bias.grad.clone()})
    return {"steps": out, "running_mean": m.running_mean,
            "running_var": m.running_var,
            "tracked": int(m.num_batches_tracked)}


def _resnet18(sync, variables=None):
    from horovod_tpu_torch.models import ResNet18, init_resnet_params
    model = ResNet18(num_classes=10, dtype=torch.float64,
                     device="cpu").double()
    for m in model.modules():
        if isinstance(m, tbn.BatchNorm):
            m.sync = sync
    if variables is None:
        variables = init_resnet_params(
            model, generator=torch.Generator().manual_seed(0))
        rng = np.random.RandomState(1)
        for k, v in variables.items():
            if k.endswith(".scale"):   # no branch starts switched off
                variables[k] = torch.from_numpy(1 + 0.1 * rng.randn(
                    *v.shape))
    model.load_state_dict(variables)
    return model, variables


def _resnet_step(model, batch):
    from horovod_tpu_torch.training import make_flax_train_step
    named = list(model.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=thvd.Compression.none)
    step = make_flax_train_step(model, opt)
    loss = step(tuple(torch.from_numpy(a) for a in batch)).item()
    return loss, {k: v.detach().clone() for k, v in
                  model.state_dict().items()}


def _resnet_rank(data):
    model, _ = _resnet18(True, data["variables"])
    before = sync_bn_totals()
    loss, state = _resnet_step(model, (data["x"], data["y"]))
    return {"loss": loss, "state": state,
            "allreduces": sync_bn_totals()["allreduces"]
            - before["allreduces"]}


def _worker(mode, rank, n, store_path, in_path, out_path):
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, n), rank=rank,
              size=n)
    data = torch.load(in_path, weights_only=False)
    shard = {k: (np.stack([_shard(a, rank, n) for a in v])
                 if mode == "torch" else _shard(v, rank, n))
             if k in ("x", "dy", "y") else v for k, v in data.items()}
    body = {"flax": _flax_style_rank, "torch": _torch_style_rank,
            "resnet": _resnet_rank}[mode]
    torch.save(body(shard), out_path)
    thvd.shutdown()


# ---------------------------------------------------------------------------
# Flax-style sync BN
# ---------------------------------------------------------------------------


def _one_process(x, dy, p):
    """Plain BatchNorm on the whole batch: y, dx, and the per-channel rows
    dbeta / dgamma need (global mean and inv)."""
    m = tbn.BatchNorm(C, momentum=0.9, epsilon=EPS, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m(xt)
    y.backward(torch.from_numpy(dy))
    mean, var = tbn.batch_stats(torch.from_numpy(x))
    return y.detach(), xt.grad, m, mean, torch.rsqrt(var + EPS)


def _jax_sync_bn(n, x, dy, p):
    """The JAX package's ``sync_batch_norm`` under ``shard_map`` on ``n``
    devices: y, dx, per-device parameter cotangents, batch_stats."""
    import horovod_tpu as hvd
    from jax.sharding import PartitionSpec as P
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:n])
    try:
        axes = tuple(hvd.mesh().axis_names)

        class Sync(fnn.Module):
            @fnn.compact
            def __call__(self, a):
                return hvd.sync_batch_norm(use_running_average=False,
                                           momentum=0.9, epsilon=EPS)(a)

        model = Sync()
        params = {"BatchNorm_0": {"scale": p["scale"], "bias": p["bias"]}}
        stats = {"BatchNorm_0": {"mean": p["mean"], "var": p["var"]}}

        def body(prm, st, xs, dys):
            def f(q, a):
                y, mut = model.apply({"params": q, "batch_stats": st}, a,
                                     mutable=["batch_stats"])
                return y, mut
            y, vjp, mut = jax.vjp(f, prm, xs, has_aux=True)
            dprm, dx = vjp(dys)
            return y, dx, jax.tree.map(lambda t: t[None], dprm), mut

        run = jax.jit(jax.shard_map(
            body, mesh=hvd.mesh(), in_specs=(P(), P(), P(axes), P(axes)),
            out_specs=(P(axes), P(axes), P(axes), P()), check_vma=False))
        y, dx, dprm, mut = run(params, stats, jnp.asarray(x),
                               jnp.asarray(dy))
        return (np.asarray(y), np.asarray(dx),
                jax.tree.map(np.asarray, dprm["BatchNorm_0"]),
                jax.tree.map(np.asarray, mut["batch_stats"]["BatchNorm_0"]))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_matches_one_process_and_jax(tmp_path, n):
    x, dy, p = _data(n, seed=n)
    ranks = _spawn(tmp_path, "flax", n, {"x": x, "dy": dy, "params": p})
    y, dx, plain, mean, inv = _one_process(x, dy, p)
    jy, jdx, jgrads, jstats = _jax_sync_bn(n, x, dy, p)
    for r, res in enumerate(ranks):
        xs, dys = (torch.from_numpy(_shard(a, r, n)) for a in (x, dy))
        dbeta, dgamma = tbn.bn_backward_reduce(xs, dys, mean, inv)
        for got, want, jwant, name in (
                (res["y"], _shard(y, r, n), _shard(jy, r, n), "y"),
                (res["dx"], _shard(dx, r, n), _shard(jdx, r, n), "dx"),
                (res["dscale"], dgamma, jgrads["scale"][r], "dscale"),
                (res["dbias"], dbeta, jgrads["bias"][r], "dbias"),
                (res["mean"], plain.mean, jstats["mean"], "mean"),
                (res["var"], plain.var, jstats["var"], "var")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"rank {r} {name}", **TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                       err_msg=f"rank {r} {name} (JAX)",
                                       **TOL)
        # Two allreduces of 2C f32 values a step.
        assert res["moved"] == {"allreduces": 2, "wire_bytes": 2 * 8 * C,
                                "layout_copies": 0}
    # The local sums add up to the plain layer's gradients.
    np.testing.assert_allclose(sum(r["dscale"] for r in ranks).numpy(),
                               plain.scale.grad.numpy(), **TOL)


def test_sync_batch_norm_at_world_one_is_the_plain_layer(world1):
    """At world 1 the allreduces are identities: output, dx, dgamma,
    dbeta and the running statistics bitwise the plain layer's."""
    x, dy, p = _data(1, seed=5)
    outs = []
    for sync in (False, True):
        m = tbn.BatchNorm(C, momentum=0.9, epsilon=EPS, sync=sync,
                          device="cpu")
        m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
        xt = torch.from_numpy(x).requires_grad_(True)
        before = sync_bn_totals()["allreduces"]
        y = m(xt)
        y.backward(torch.from_numpy(dy))
        outs.append((y, xt.grad, m.scale.grad, m.bias.grad, m.mean, m.var,
                     sync_bn_totals()["allreduces"] - before))
    for a, b in zip(outs[0][:6], outs[1][:6]):
        assert torch.equal(a, b)
    assert (outs[0][6], outs[1][6]) == (0, 2)
    assert set(m.state_dict()) == {"scale", "bias", "mean", "var"}


def test_sync_batch_norm_refuses_sub_mesh_axes(world1):
    """``axes=`` over a sub-mesh (the refusal this test once pinned is
    gone with ``parallel/mesh``): at world 1 on ``build_3d_mesh()`` the
    layer over ``("data",)`` is the plain layer bit for bit (its
    allreduces run over the data set, one rank), and over the ``model``
    axis the mesh dropped as well; an axis no mesh has raises when the
    layer is built (the JAX layer at its trace).  The sub-mesh of a world
    of 4 is ``tests/test_torch_parallel.py``'s."""
    from horovod_tpu_torch.parallel import axis_set, build_3d_mesh
    build_3d_mesh()
    x, dy, p = _data(1, seed=6)
    outs = []
    for kw in ({"sync": False},
               {"sync": True, "process_set": axis_set(("data",))},
               {"sync": True, "process_set": axis_set("model")}):
        m = tbn.BatchNorm(C, momentum=0.9, epsilon=EPS, device="cpu", **kw)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
        xt = torch.from_numpy(x).requires_grad_(True)
        before = sync_bn_totals()["allreduces"]
        y = m(xt)
        y.backward(torch.from_numpy(dy))
        outs.append((y, xt.grad, m.scale.grad, m.bias.grad, m.mean, m.var,
                     sync_bn_totals()["allreduces"] - before))
    for got in outs[1:]:
        for a, b in zip(outs[0][:6], got[:6]):
            assert torch.equal(a, b)
        assert got[6] == 2
    m = sync_batch_norm(axes=("data",), features=C, device="cpu")
    assert m.process_set is axis_set(("data",)) and m.sync
    with pytest.raises(ValueError, match="unknown mesh axis"):
        sync_batch_norm(axes=("rows",), features=C, device="cpu")


# ---------------------------------------------------------------------------
# hvd.SyncBatchNorm (torch-style)
# ---------------------------------------------------------------------------


def _torch_bn_steps(x, dy):
    """``torch.nn.BatchNorm2d(momentum=None)`` over the whole batch, one
    forward and backward per step."""
    m = torch.nn.BatchNorm2d(C, momentum=None)
    out = []
    for xs, dys in zip(x, dy):
        xt = torch.from_numpy(xs).requires_grad_(True)
        m.zero_grad()
        y = m(xt)
        y.backward(torch.from_numpy(dys))
        out.append((y.detach(), xt.grad, m.weight.grad.clone(),
                    m.bias.grad.clone()))
    return out, m


def _two_steps(n, seed):
    (x0, dy0, _), (x1, dy1, _) = (_data(n, seed + s, nchw=True)
                                  for s in range(2))
    return np.stack([x0, x1]), np.stack([dy0, dy1])


@pytest.mark.parametrize("n", [1, 2])
def test_hvd_sync_batch_norm_matches_batchnorm2d(tmp_path, world1, n):
    x, dy = _two_steps(n, seed=10 + n)
    if n == 1:
        ranks = [_torch_style_rank({"x": x, "dy": dy})]
    else:
        ranks = _spawn(tmp_path, "torch", n, {"x": x, "dy": dy})
    want, ref = _torch_bn_steps(x, dy)
    for r, res in enumerate(ranks):
        for s, (y, dx, dw, db) in enumerate(want):
            got = res["steps"][s]
            np.testing.assert_allclose(got["y"].numpy(),
                                       _shard(y, r, n).numpy(), **TOL)
            np.testing.assert_allclose(got["dx"].numpy(),
                                       _shard(dx, r, n).numpy(), **TOL)
        np.testing.assert_allclose(res["running_mean"].numpy(),
                                   ref.running_mean.numpy(), **TOL)
        np.testing.assert_allclose(res["running_var"].numpy(),
                                   ref.running_var.numpy(), **TOL)
        assert res["tracked"] == 2
    # weight / bias: local sums, which add up to BatchNorm2d's.
    for s, (_, _, dw, db) in enumerate(want):
        np.testing.assert_allclose(
            sum(r["steps"][s]["dweight"] for r in ranks).numpy(),
            dw.numpy(), **TOL)
        np.testing.assert_allclose(
            sum(r["steps"][s]["dbias"] for r in ranks).numpy(),
            db.numpy(), **TOL)


def test_hvd_sync_batch_norm_matches_the_jax_shim_at_world_one(world1):
    """At world 1 the JAX shim hands the layer to ``_BatchNorm``; the
    port takes its own path (the kernels' on the card) and agrees."""
    import horovod_tpu as hvd
    import horovod_tpu.torch as shim
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    try:
        x, dy = _two_steps(1, seed=20)
        theirs = shim.SyncBatchNorm(C, momentum=0.1)
        ours = thvd.SyncBatchNorm(C, momentum=0.1, device="cpu")
        ours.load_state_dict(theirs.state_dict())
        for xs, dys in zip(x, dy):
            got = []
            for m in (ours, theirs):
                xt = torch.from_numpy(xs).requires_grad_(True)
                m.zero_grad()
                y = m(xt)
                y.backward(torch.from_numpy(dys))
                got.append((y.detach(), xt.grad, m.weight.grad.clone(),
                            m.bias.grad.clone()))
            for a, b in zip(*got):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(ours, name).numpy(),
                                       getattr(theirs, name).numpy(), **TOL)
        ours.eval()
        theirs.eval()
        with torch.no_grad():
            np.testing.assert_allclose(ours(torch.from_numpy(x[0])).numpy(),
                                       theirs(torch.from_numpy(x[0])).numpy(),
                                       **TOL)
    finally:
        hvd.shutdown()


def test_hvd_sync_batch_norm_layouts_and_refusals(world1):
    """A channels-last input goes to the kernels as a view; any other
    layout is copied once, and counted.  No affine parameters, 2-D and
    1-D inputs, and a process set (unregistered: refused)."""
    rng = np.random.RandomState(21)
    x = torch.from_numpy(rng.randn(4, C, 5, 3).astype(np.float32))
    m = thvd.SyncBatchNorm(C, device="cpu")
    before = sync_bn_totals()["layout_copies"]
    y = m(x.to(memory_format=torch.channels_last).requires_grad_(True))
    y.backward(torch.ones_like(y))
    assert sync_bn_totals()["layout_copies"] == before
    assert y.is_contiguous(memory_format=torch.channels_last)
    y = m(x.requires_grad_(True))          # NCHW: one copy
    assert sync_bn_totals()["layout_copies"] == before + 1
    y.backward(torch.ones_like(y))         # y is channels-last: none
    assert sync_bn_totals()["layout_copies"] == before + 1
    y = m(x.to(memory_format=torch.channels_last))
    y.sum().backward()                     # an expanded gradient: one
    assert sync_bn_totals()["layout_copies"] == before + 2
    plain = thvd.SyncBatchNorm(C, affine=False, device="cpu")
    x2 = torch.from_numpy(rng.randn(6, C).astype(np.float32))
    want = torch.nn.functional.batch_norm(x2, None, None, training=True)
    np.testing.assert_allclose(plain(x2).detach().numpy(), want.numpy(),
                               **TOL)
    assert plain.weight is None
    with pytest.raises(ValueError, match="2D"):
        m(torch.randn(C))
    # A process set must be registered; over {0} at world 1 the layer is
    # the global one.
    with pytest.raises(thvd.ProcessSetError):
        thvd.SyncBatchNorm(C, process_set=object(), device="cpu")
    ps = thvd.add_process_set([0])
    one = thvd.SyncBatchNorm(C, process_set=ps, device="cpu")
    one.load_state_dict(m.state_dict())
    xs = x.detach().to(memory_format=torch.channels_last)
    np.testing.assert_array_equal(one(xs).detach().numpy(),
                                  m(xs).detach().numpy())
    thvd.remove_process_set(ps)


# ---------------------------------------------------------------------------
# The count argument of pass 2
# ---------------------------------------------------------------------------


def test_bn_backward_dx_count_is_the_closed_form():
    rng = np.random.RandomState(22)
    x = rng.randn(40, 6).astype(np.float32)
    dy = rng.randn(40, 6).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(6)).astype(np.float32)
    mean, var = x.mean(0), x.var(0)
    inv = 1 / np.sqrt(var + EPS)
    dbeta = (4 * rng.randn(6)).astype(np.float32)      # e.g. summed over
    dgamma = (4 * rng.randn(6)).astype(np.float32)     # four ranks
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xhat = (x - mean) * inv
    for count in (None, 160, 160.0, 7.5):
        got = tbn.bn_backward_dx(t(x), t(dy), t(mean), t(inv), t(scale),
                                 t(dbeta), t(dgamma), count=count)
        k = 40 if count is None else count
        want = scale * inv * (dy - dbeta / k - xhat * dgamma / k)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for bad in (0, -1.0):
        with pytest.raises(ValueError, match="count"):
            tbn.bn_backward_dx(t(x), t(dy), t(mean), t(inv), t(scale),
                               t(dbeta), t(dgamma), count=bad)


# ---------------------------------------------------------------------------
# ResNet-18 with sync BN, one training step at world 2
# ---------------------------------------------------------------------------


def test_sync_bn_resnet18_step_at_world_two_matches_one_process(tmp_path,
                                                                world1):
    """Each rank on half of a 4-image batch (64 x 64, so stage 4's BN
    sites see 16 values a channel): the loss averaged over the ranks,
    the parameters after ``DistributedOptimizer`` averaged the local
    gradients, and the running statistics (global at every site) equal
    one process's step on the whole batch.  In float64: in f32 the
    full-width backward through 20 BN sites turns the other summation
    order of the ranks' statistics (the losses agree to 7e-7) into
    weights 4e-3 apart after one step at lr 0.1; in f64, 4e-9."""
    rng = np.random.RandomState(23)
    x = rng.randn(4, 64, 64, 3)
    y = rng.randint(0, 10, 4).astype(np.int32)
    _, variables = _resnet18(False)
    ranks = _spawn(tmp_path, "resnet", 2,
                   {"x": x, "y": y, "variables": variables})
    model, _ = _resnet18(False, variables)
    want_loss, want_state = _resnet_step(model, (x, y))
    sites = sum(isinstance(m, tbn.BatchNorm) for m in model.modules())
    for res in ranks:
        np.testing.assert_allclose(res["loss"], want_loss, rtol=LOSS_RTOL)
        assert res["allreduces"] == 2 * sites == 2 * 20
        for k, t in want_state.items():
            np.testing.assert_allclose(res["state"][k].numpy(), t.numpy(),
                                       atol=STATE_ATOL, rtol=0, err_msg=k)
            assert not torch.equal(res["state"][k], variables[k]), k


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
