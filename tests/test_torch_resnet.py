"""PyTorch/CUDA port: ResNet, LeNet and their training step vs the JAX
package.

* ``space_to_depth`` and ``s2d_conv_init_kernel`` equal the flax
  versions (the port's kernels are OIHW, flax's HWIO), and the s2d stem
  computes the 7x7/2 stem's convolution.
* SAME padding is flax's asymmetric split, for the convolutions and the
  max-pool; a symmetric ``padding=k // 2`` would give the same shape and
  other numbers, and the test shows it.
* ResNet-50 at full widths, f32, after :func:`resnet_state_from_jax`:
  the eval-mode logits equal flax's (32 x 32 images, batch 2); in train
  mode (64 x 64, batch 2) the stem, every block and the classifier, each
  fed flax's input for it, and the updated ``batch_stats`` equal flax's;
  every BN site sees a contiguous input and gradient (the GPU kernels
  never copy).  LeNet logits equal flax's.
* Three steps of the port's :func:`make_flax_train_step` with
  ``DistributedOptimizer(SGD(0.1, momentum 0.9))`` equal the JAX
  ``make_flax_train_step`` with ``DistributedOptimizer(optax.sgd(0.1,
  momentum=0.9))`` on a one-device mesh (a tiny s2d bottleneck ResNet,
  the JAX BN kernels in interpret mode): losses, parameters and running
  statistics.  A gloo world of two, each rank on half the batch, equals
  a two-device JAX mesh: the running statistics are averaged over the
  ranks, and so is :func:`make_eval_step`'s metric.

The JAX step computes BN statistics per device, so each port world is
held against a mesh of as many devices (the ``hvd`` fixture's 8 would
not do).  f32 on the CPU.  Tolerances: logits and activations 1e-4
absolute (53 BN sites, each a sum in another order, between input and
logits); losses 1e-5 relative; parameters and statistics after the steps
2e-5 absolute (SGD at lr 0.1 moves a weight by ~1e-2 a step, and the two
packages' gradients differ only by summation order).
"""

import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import lenet as jlenet
from horovod_tpu.models import resnet as jresnet
import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import (LeNet, ResNet, ResNet50, init_params,
                                      init_resnet_params,
                                      resnet_state_from_jax,
                                      s2d_conv_init_kernel, space_to_depth)
from horovod_tpu_torch.models.layers import Conv, max_pool, same_pads
from horovod_tpu_torch.models.resnet import BottleneckBlock
from horovod_tpu_torch.ops import bn as tbn
from horovod_tpu_torch.training import (make_eval_step, make_flax_train_step,
                                        softmax_xent)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT_ATOL = 1e-4
ACT_RTOL = 1e-4
LOSS_RTOL = 1e-5
STATE_ATOL = 2e-5
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")


@pytest.fixture
def world1():
    """The port initialized as a CPU world of one, torn down after."""
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def _jax_world(n):
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:n])
    return hvd


@pytest.fixture
def jax1():
    """The JAX package on a one-device mesh (BN statistics per device)."""
    yield _jax_world(1)
    import horovod_tpu as hvd
    hvd.shutdown()


@pytest.fixture
def jax2():
    yield _jax_world(2)
    import horovod_tpu as hvd
    hvd.shutdown()


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _perturb_bn(variables, seed):
    """Every BN scale from N(1, 0.1), bias N(0, 0.1), running mean N(0,
    0.1), var 1 + U(0, 0.1): no site starts at its init (the last BN of a
    block would otherwise zero its branch)."""
    rng = np.random.RandomState(seed)

    def walk(tree, stats):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, stats)
            elif stats and key == "mean":
                tree[key] = (0.1 * rng.randn(*val.shape)).astype(np.float32)
            elif stats and key == "var":
                tree[key] = (1 + 0.1 * rng.rand(*val.shape)).astype(
                    np.float32)
            elif not stats and key == "scale":
                tree[key] = (1 + 0.1 * rng.randn(*val.shape)).astype(
                    np.float32)
                tree["bias"] = (0.1 * rng.randn(*val.shape)).astype(
                    np.float32)

    walk(variables["params"], False)
    walk(variables.get("batch_stats", {}), True)
    return variables


def _images(n, side, channels=3, seed=0):
    return np.random.RandomState(seed).randn(n, side, side, channels).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The stem: space-to-depth and SAME padding
# ---------------------------------------------------------------------------


def test_space_to_depth_matches_jax():
    x = _images(2, 8, channels=3, seed=1)
    got = space_to_depth(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jresnet.space_to_depth(jnp.asarray(x), 2)))


def test_s2d_conv_init_kernel_matches_jax_and_the_7x7_stem():
    rng = np.random.RandomState(2)
    k7 = rng.randn(7, 7, 3, 16).astype(np.float32)           # HWIO
    want = np.asarray(jresnet.s2d_conv_init_kernel(jnp.asarray(k7)))
    got = s2d_conv_init_kernel(torch.from_numpy(k7).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    # The s2d stem computes the 7x7/2 SAME stem's convolution.
    x = torch.from_numpy(_images(2, 32, seed=3))
    c7 = Conv(3, 16, 7, 2, use_bias=False, device="cpu")
    c4 = Conv(12, 16, 4, 1, use_bias=False, device="cpu")
    with torch.no_grad():
        c7.kernel.copy_(torch.from_numpy(k7).permute(3, 2, 0, 1))
        c4.kernel.copy_(got)
    np.testing.assert_allclose(c4(space_to_depth(x)).detach().numpy(),
                               c7(x).detach().numpy(), atol=ACT_ATOL)


@pytest.mark.parametrize("size,k,s,pads", [
    (224, 7, 2, (2, 3)),     # the 7x7/2 stem at 224
    (112, 4, 1, (1, 2)),     # the s2d stem's 4x4/1
    (56, 3, 2, (0, 1)),      # each 3x3/2, and the 3x3/2 max-pool
    (57, 3, 2, (1, 1)),
    (28, 5, 1, (2, 2))])
def test_same_pads_are_flax(size, k, s, pads):
    assert same_pads(size, k, s) == pads
    assert tuple(jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]) \
        == pads


@pytest.mark.parametrize("side,k,s", [(32, 7, 2), (16, 4, 1), (8, 3, 2)])
def test_conv_same_padding_matches_flax_and_symmetric_would_not(side, k, s):
    x = _images(2, side, channels=4, seed=4)
    conv = nn.Conv(6, (k, k), (s, s), padding="SAME", use_bias=False)
    variables = _numpy_tree(conv.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    ours = Conv(4, 6, k, s, use_bias=False, device="cpu")
    ours.load_state_dict(resnet_state_from_jax(variables, device="cpu"))
    got = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ACT_ATOL)
    # No symmetric pad computes it: either the shape or the numbers
    # differ (for the odd kernels the shape is the same).
    for pad in {k // 2, (k - 1) // 2}:
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), ours.kernel,
                       stride=s, padding=pad).permute(0, 2, 3, 1)
        if k % 2:
            assert tuple(sym.shape) == want.shape
        assert tuple(sym.shape) != want.shape or not np.allclose(
            sym.detach().numpy(), want, atol=1e-2)


def test_max_pool_same_pads_with_minus_infinity():
    """All-negative input: a zero pad would win the max at the edge."""
    x = -np.abs(_images(2, 8, channels=3, seed=5)) - 1.0
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = max_pool(torch.from_numpy(x), (3, 3), (2, 2), padding="SAME")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).all()


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _flax_resnet50(x, seed):
    model = jresnet.ResNet50(num_classes=1000, dtype=jnp.float32,
                             space_to_depth=True)
    variables = _numpy_tree(model.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x), train=True))
    return model, _perturb_bn(variables, seed)


def test_resnet50_matches_flax_in_eval_mode():
    x = _images(2, 32, seed=6)
    model, variables = _flax_resnet50(x, seed=0)
    want = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    ours = ResNet50(num_classes=1000, dtype=torch.float32,
                    space_to_depth=True, device="cpu")
    state = resnet_state_from_jax(variables, device="cpu")
    assert set(state) == set(ours.state_dict())
    ours.load_state_dict(state)
    ours.eval()
    got = ours(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ACT_ATOL, rtol=0)
    # Eval mode leaves the running statistics alone.
    for name, t in state.items():
        assert torch.equal(ours.state_dict()[name], t), name


def test_resnet50_train_mode_matches_flax_block_by_block():
    """Train mode, every top-level module fed flax's own input for it
    (flax's captured intermediates): the stem, each of the 16 blocks and
    the classifier agree within 1e-4 absolute plus 1e-4 relative (block
    outputs reach 12), and the updated ``batch_stats`` within 1e-4.  At
    64 x 64: at 32 x 32 each stage-4 BN normalizes 2 values per channel,
    and the fast variance's cancellation turns inputs that agree to 1e-6
    into block outputs 0.1 apart."""
    x = _images(2, 64, seed=6)
    model, variables = _flax_resnet50(x, seed=0)
    logits, inter = jax.jit(lambda v, a: model.apply(
        v, a, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(jax.tree.map(jnp.asarray, variables),
                                     jnp.asarray(x))
    outs = {k: np.array(v["__call__"][0])
            for k, v in inter["intermediates"].items() if k != "__call__"}
    outs["logits"] = np.asarray(logits)
    ours = ResNet50(num_classes=1000, dtype=torch.float32,
                    space_to_depth=True, device="cpu")
    ours.load_state_dict(resnet_state_from_jax(variables, device="cpu"))
    t = torch.from_numpy
    with torch.no_grad():
        got = {"conv_init": ours.conv_init(space_to_depth(t(x))),
               "bn_init": ours.bn_init(t(outs["conv_init"]))}
        h = max_pool(F.relu(t(outs["bn_init"])), (3, 3), (2, 2),
                     padding="SAME")
        for name in ours.block_names:
            got[name] = getattr(ours, name)(h)
            h = t(outs[name])
        got["logits"] = ours.Dense_0(h.mean(dim=(1, 2)))
    assert len(got) == 19
    for name, y in got.items():
        np.testing.assert_allclose(y.numpy(), outs[name], atol=ACT_ATOL,
                                   rtol=ACT_RTOL, err_msg=name)
    stats = resnet_state_from_jax(
        {"batch_stats": _numpy_tree(inter["batch_stats"])}, device="cpu")
    assert len(stats) == 2 * 53
    for name, s in stats.items():
        np.testing.assert_allclose(ours.state_dict()[name].numpy(),
                                   s.numpy(), atol=ACT_ATOL, rtol=0,
                                   err_msg=name)


def test_resnet50_bn_sites_see_contiguous_tensors(monkeypatch):
    """Every one of the 53 BN sites gets a contiguous ``[..., C]`` input in
    the forward and a contiguous gradient in the backward: on the GPU the
    kernels take them as they are, without a copy."""
    model = ResNet50(num_classes=10, dtype=torch.float32,
                     space_to_depth=True, device="cpu")
    model.load_state_dict(init_resnet_params(
        model, generator=torch.Generator().manual_seed(0)))
    seen = []
    real = tbn.fused_bn_backward

    def spy(x, scale, mean, var, dy, **kw):
        seen.append((x.is_contiguous(), dy.is_contiguous()))
        return real(x, scale, mean, var, dy, **kw)

    monkeypatch.setattr(tbn, "fused_bn_backward", spy)
    model(torch.from_numpy(_images(2, 32, seed=7))).sum().backward()
    sites = sum(isinstance(m, tbn.BatchNorm) for m in model.modules())
    assert sites == len(seen) == 53
    assert all(a and b for a, b in seen)


def test_resnet_state_from_jax_transposes_and_copies():
    x = _images(1, 32, seed=8)
    _, variables = _flax_resnet50(x, seed=1)
    state = resnet_state_from_jax(variables, device="cpu")
    k = variables["params"]["BottleneckBlock_3"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(
        state["BottleneckBlock_3.Conv_1.kernel"].numpy(),
        k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["Dense_0.kernel"].numpy(),
                                  variables["params"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(
        state["bn_init.var"].numpy(),
        variables["batch_stats"]["bn_init"]["var"])
    k[...] = 0.0                        # nothing aliases the caller's arrays
    assert state["BottleneckBlock_3.Conv_1.kernel"].abs().sum() > 0


def test_init_resnet_params_draws_like_flax():
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, device="cpu")
    p = init_resnet_params(model, generator=torch.Generator().manual_seed(0))
    assert set(p) == set(model.state_dict())
    assert len(list(model.parameters())) == 161
    k = p["BottleneckBlock_5.Conv_1.kernel"]          # [128, 128, 3, 3]
    assert abs(k.std().item() - (1 / (128 * 9)) ** 0.5) < 2e-3
    assert k.abs().max().item() <= 2 * 1.14 * (1 / (128 * 9)) ** 0.5
    assert all(p[f"BottleneckBlock_{i}.BatchNorm_2.scale"].eq(0).all()
               for i in range(16))
    assert p["BottleneckBlock_0.BatchNorm_0.scale"].eq(1).all()
    assert p["Dense_0.bias"].eq(0).all() and p["bn_init.var"].eq(1).all()
    assert all(t.dtype == torch.float32 for t in p.values())


def test_lenet_logits_match_flax():
    x = _images(3, 28, channels=1, seed=9)
    model = jlenet.LeNet()
    variables = _numpy_tree(model.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    ours = LeNet(device="cpu")
    ours.load_state_dict(resnet_state_from_jax(variables, device="cpu"))
    np.testing.assert_allclose(ours(torch.from_numpy(x)).detach().numpy(),
                               want, atol=ACT_ATOL, rtol=0)
    p = init_params(ours, generator=torch.Generator().manual_seed(0))
    assert set(p) == set(ours.state_dict())


def test_softmax_xent_matches_optax():
    rng = np.random.RandomState(10)
    logits = rng.randn(6, 10).astype(np.float32)
    y = rng.randint(0, 10, 6).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(y)).mean()
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Training steps vs the JAX make_flax_train_step
# ---------------------------------------------------------------------------


def _tiny_flax(seed=0):
    """The tiny bottleneck ResNet of the step tests, flax side."""
    model = jresnet.ResNet(stage_sizes=[1, 1],
                           block_cls=jresnet.BottleneckBlock,
                           num_classes=10, num_filters=8, dtype=jnp.float32,
                           space_to_depth=True)
    variables = _numpy_tree(model.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(_images(1, 32)),
                                       train=True))
    return model, _perturb_bn(variables, seed)


def _tiny_port(variables):
    model = ResNet(stage_sizes=[1, 1], block_cls=BottleneckBlock,
                   num_classes=10, num_filters=8, dtype=torch.float32,
                   space_to_depth=True, device="cpu")
    model.load_state_dict(resnet_state_from_jax(variables, device="cpu"))
    return model


def _batch(n=4, seed=11):
    rng = np.random.RandomState(seed)
    return _images(n, 32, seed=seed), rng.randint(0, 10, n).astype(np.int32)


def _eval_loss_jax(model):
    def metric(variables, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(variables, x, train=False), y).mean()
    return metric


def _eval_loss_port(model, batch):
    model.eval()
    x, y = batch
    loss = softmax_xent(model(x), y)
    model.train()
    return loss


def _jax_flax_steps(hvd, model, variables, batch, steps):
    """``steps`` JAX steps; ``(losses, state dict, eval metric)``."""
    from horovod_tpu.training import make_flax_train_step as jstep
    opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    step = jstep(model.apply, opt)
    jv = jax.tree.map(jnp.asarray, variables)
    params = hvd.replicate(jv["params"])
    stats = hvd.replicate(jv["batch_stats"])
    opt_state = hvd.replicate(opt.init(jv["params"]))
    data = hvd.shard_batch(tuple(map(jnp.asarray, batch)))
    losses = []
    for _ in range(steps):
        params, stats, opt_state, loss = step(params, stats, opt_state, data)
        losses.append(float(loss))
    final = {"params": _numpy_tree(params),
             "batch_stats": _numpy_tree(stats)}
    metric = hvd.make_eval_step(_eval_loss_jax(model))(
        jax.tree.map(jnp.asarray, final), data)
    return losses, resnet_state_from_jax(final, device="cpu"), float(metric)


def _port_flax_steps(variables, batch, steps):
    model = _tiny_port(variables)
    named = list(model.named_parameters())
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named)
    step = make_flax_train_step(model, opt)
    data = tuple(torch.from_numpy(a) for a in batch)
    losses = [step(data).item() for _ in range(steps)]
    metric = make_eval_step(_eval_loss_port)(model, data)
    return losses, {k: v.detach().clone() for k, v in
                    model.state_dict().items()}, metric.item()


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                   atol=STATE_ATOL, rtol=0, err_msg=name)


def test_three_steps_match_jax_make_flax_train_step(monkeypatch, jax1,
                                                    world1):
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")  # JAX: interpret kernels
    model, variables = _tiny_flax(seed=2)
    batch = _batch()
    want_losses, want_state, want_metric = _jax_flax_steps(
        jax1, model, variables, batch, 3)
    losses, state, metric = _port_flax_steps(variables, batch, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    _assert_states_equal(state, want_state)
    np.testing.assert_allclose(metric, want_metric, rtol=LOSS_RTOL)
    # Every parameter and running statistic moved.
    before = resnet_state_from_jax(variables, device="cpu")
    assert all(not torch.equal(state[n], before[n]) for n in before)


def _train_worker(rank: int, store_path: str, vars_path: str,
                  out: str) -> None:
    """One rank of the two-rank world: two steps on its half batch."""
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, 2), rank=rank,
              size=2)
    variables = torch.load(vars_path, weights_only=False)
    x, y = _batch()
    half = (x[2 * rank:2 * rank + 2], y[2 * rank:2 * rank + 2])
    losses, state, metric = _port_flax_steps(variables, half, 2)
    torch.save({"losses": losses, "state": state, "metric": metric}, out)
    thvd.shutdown()


def test_world_of_two_matches_two_device_jax_mesh(monkeypatch, tmp_path,
                                                   jax2):
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")
    model, variables = _tiny_flax(seed=3)
    torch.save(variables, tmp_path / "vars.pt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path / "store"),
         str(tmp_path / "vars.pt"), str(tmp_path / f"r{r}.pt")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    want_losses, want_state, want_metric = _jax_flax_steps(
        jax2, model, variables, _batch(), 2)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    for r in range(2):
        res = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        np.testing.assert_allclose(res["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        _assert_states_equal(res["state"], want_state)
        np.testing.assert_allclose(res["metric"], want_metric,
                                   rtol=LOSS_RTOL)


if __name__ == "__main__":
    _train_worker(int(sys.argv[1]), *sys.argv[2:5])
