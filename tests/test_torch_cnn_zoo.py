"""PyTorch/CUDA port: VGG, Inception-v3 and the synthetic benchmark vs
the JAX package.

Weights are drawn once per model with the port's
:func:`~horovod_tpu_torch.models.init_params` (flax's initialisers), every
BN scale, bias and running statistic perturbed, and handed to flax as its
variable tree; the port loads them back through
:func:`~horovod_tpu_torch.models.flax_state_from_jax`.  Inputs are numpy
from a seed.  f32 on the CPU.

* Forwards: VGG-16 with and without BatchNorm at 32 x 32, in eval and
  train mode; Inception-v3 at 75 x 75 in eval mode, and in train mode
  block by block (each top-level module fed flax's own input for it, as
  ``test_resnet50_train_mode_matches_flax_block_by_block`` does: at 75 x
  75 the 8 x 8 grid is 1 x 1, so a BN site there normalizes four values a
  channel and the fast variance turns f32 roundoff upstream into
  differences far above it), with the running statistics after it; at
  299 x 299, batch 2, with the auxiliary head: the logits whole, the
  auxiliary head's three units block by block (its second BN normalizes
  two values a channel).
* Each Inception block against flax's block: the concatenations' channel
  order, the avg-pool's padded zeros, VALID pools, the ``(1, 7)`` /
  ``(7, 1)`` SAME pads; and its train-mode VJP in f32 (dx and every
  parameter's gradient).
* Full-width parameter counts and names against ``jax.eval_shape``.
* All 94 Inception BN sites see a contiguous x and dy.
* Three ``make_flax_train_step`` steps of VGG-16 (32 x 32) and
  Inception-v3 (75 x 75, batch 8) against the JAX step on a one-device
  mesh.
* ``python -m horovod_tpu_torch.synthetic_benchmark --device cpu``.

Tolerances (those of ``tests/test_torch_resnet.py``): activations and
logits 1e-4 absolute plus 1e-4 relative; losses 1e-5 relative;
parameters and statistics after the steps 2e-5 absolute.  Gradients and
the float64 Inception steps' updates are held relative to their own
size (see the tests).
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import inception as jinc
from horovod_tpu.models import vgg as jvgg
import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import (VGG16, VGG19, InceptionV3,
                                      flax_state_from_jax, init_params)
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models.layers import Dropout, avg_pool, max_pool
from horovod_tpu_torch.ops import bn as tbn
from horovod_tpu_torch.training import make_flax_train_step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT_ATOL = 1e-4
ACT_RTOL = 1e-4
LOSS_RTOL = 1e-5
STATE_ATOL = 2e-5
UPDATE_RTOL = 1e-5
INCEPTION_BN_SITES = 94
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


@pytest.fixture
def jax1():
    """The JAX package on a one-device mesh (BN statistics per device)."""
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    yield hvd
    hvd.shutdown()


def _images(n, side, seed):
    return np.random.RandomState(seed).randn(n, side, side, 3).astype(
        np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ACT_ATOL, rtol=ACT_RTOL, err_msg=msg)


def _weights(model, seed, scale_mean=1.0):
    """``init_params`` from ``seed``, then every BN scale N(scale_mean,
    0.1), bias N(0, 0.1), running mean N(0, 0.1) and var 1 + U(0, 0.1)."""
    state = init_params(model, generator=torch.Generator().manual_seed(seed))
    state = {k: v.float() for k, v in state.items()}
    rng = np.random.RandomState(seed)
    for name, t in state.items():
        leaf = name.rsplit(".", 1)[-1]
        owner = name[:-len(leaf) - 1]
        if not isinstance(model.get_submodule(owner), tbn.BatchNorm):
            continue
        c = t.shape[0]
        draw = {"scale": scale_mean + 0.1 * rng.randn(c),
                "bias": 0.1 * rng.randn(c), "mean": 0.1 * rng.randn(c),
                "var": 1.0 + 0.1 * rng.rand(c)}[leaf]
        state[name] = torch.from_numpy(draw.astype(np.float32))
    return state


def _flax_tree(state):
    """The port's state dict as flax's ``{"params", "batch_stats"}``
    (numpy; HWIO convolution kernels)."""
    tree = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in path:
            node = node.setdefault(p, {})
        a = t.detach().numpy().copy()
        node[leaf] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return tree


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def _load(model, variables):
    state = flax_state_from_jax(variables, device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vgg_models():
    """VGG-16 (plain and BN) at 32 x 32, 10 classes: ``{batch_norm: (flax
    model, variables)}``."""
    out = {}
    for bn in (False, True):
        ours = VGG16(num_classes=10, batch_norm=bn, dropout_rate=0.0,
                     dtype=torch.float32, image_size=32, device="cpu")
        out[bn] = (jvgg.VGG16(num_classes=10, batch_norm=bn,
                              dropout_rate=0.0, dtype=jnp.float32),
                   _flax_tree(_weights(ours, seed=1 + bn)))
    return out


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg16_forward_matches_flax(vgg_models, batch_norm, train):
    model, variables = vgg_models[batch_norm]
    x = _images(2, 32, seed=3)
    ours = _load(VGG16(num_classes=10, batch_norm=batch_norm,
                       dropout_rate=0.0, dtype=torch.float32, image_size=32,
                       device="cpu"), variables)
    ours.train(train)
    if train and batch_norm:
        want, mutated = model.apply(_jnp(variables), jnp.asarray(x),
                                    train=True, mutable=["batch_stats"])
    else:
        want = model.apply(_jnp(variables), jnp.asarray(x), train=train)
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    if train and batch_norm:
        stats = flax_state_from_jax(
            {"batch_stats": _numpy_tree(mutated["batch_stats"])},
            device="cpu")
        assert len(stats) == 2 * 13
        for name, s in stats.items():
            _close(ours.state_dict()[name].numpy(), s.numpy(), name)


def test_dropout_is_inverted_and_needs_a_generator():
    """flax's Dropout: kept values scaled by 1 / (1 - rate); eval mode and
    rate 0 pass through; train mode at rate > 0 needs the generator."""
    x = torch.ones(4000)
    d = Dropout(0.25)
    y = d(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    with pytest.raises(ValueError, match="generator"):
        d(x)
    d.eval()
    assert d(x) is x
    assert Dropout(0.0)(x) is x
    # flax's: the same scaling of the values it keeps.
    want = fnn.Dropout(0.25, deterministic=False).apply(
        {}, jnp.ones(4000), rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(np.unique(np.asarray(want)),
                               [0.0, 1 / 0.75], rtol=1e-6)


# ---------------------------------------------------------------------------
# Inception-v3
# ---------------------------------------------------------------------------


_INCEPTION_TOP = ("ConvBN_0", "ConvBN_1", "ConvBN_2", "ConvBN_3",
                  "ConvBN_4", "InceptionA_0", "InceptionA_1", "InceptionA_2",
                  "InceptionB_0", "InceptionC_0", "InceptionC_1",
                  "InceptionC_2", "InceptionC_3", "InceptionD_0",
                  "InceptionE_0", "InceptionE_1")


def _inception(side, aux=False, classes=10):
    return InceptionV3(num_classes=classes, aux_logits=aux, dropout_rate=0.0,
                       dtype=torch.float32, image_size=side, device="cpu")


def _flax_inception(aux=False, classes=10):
    return jinc.InceptionV3(num_classes=classes, aux_logits=aux,
                            dropout_rate=0.0, dtype=jnp.float32)


@pytest.fixture(scope="module")
def inception75():
    """Weights for Inception-v3 at 75 x 75 (BN scales near 1.4, so eval
    mode's activations stay of order 1 through 47 ConvBN units)."""
    return _flax_tree(_weights(_inception(75), seed=4, scale_mean=1.4))


def test_inception_eval_forward_matches_flax(inception75):
    x = _images(2, 75, seed=5)
    want = jax.jit(lambda v, a: _flax_inception().apply(v, a, train=False))(
        _jnp(inception75), jnp.asarray(x))
    ours = _load(_inception(75), inception75).eval()
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert np.abs(np.asarray(want)).max() > 0.1
    _close(got.numpy(), want)


def _captured(model, variables, x, **kw):
    """flax's train-mode outputs, its every top-level module's output and
    the updated batch_stats."""
    out, inter = jax.jit(lambda v, a: model.apply(
        v, a, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(_jnp(variables), jnp.asarray(x))
    mods = {k: np.array(v["__call__"][0])
            for k, v in inter["intermediates"].items() if k != "__call__"}
    return out, mods, _numpy_tree(inter["batch_stats"])


def _inception_blocks(ours, x, outs):
    """Each top-level unit and block fed flax's input for it."""
    t = torch.from_numpy
    got, h = {}, t(x)
    with torch.no_grad():
        for name in _INCEPTION_TOP:
            if name in ("ConvBN_3", "InceptionA_0"):
                h = max_pool(h, 3, 2, "VALID")
            got[name] = getattr(ours, name)(h)
            h = t(outs[name])
        got["Dense_0"] = ours.Dense_0(h.mean(dim=(1, 2)))
    return got


def test_inception_train_forward_matches_flax_block_by_block(inception75):
    x = _images(4, 75, seed=6)
    model = _flax_inception()
    logits, outs, stats = _captured(model, inception75, x)
    ours = _load(_inception(75), inception75).train()
    got = _inception_blocks(ours, x, outs)
    assert len(got) == 17
    for name, y in got.items():
        _close(y.numpy(), outs[name], name)
    _close(got["Dense_0"].numpy(), logits)
    state = flax_state_from_jax({"batch_stats": stats}, device="cpu")
    assert len(state) == 2 * INCEPTION_BN_SITES
    for name, s in state.items():
        _close(ours.state_dict()[name].numpy(), s.numpy(), name)


def test_inception_aux_logits_at_299_match_flax():
    """299 x 299, batch 2, ``aux_logits=True``, train mode: the logits of
    the whole model, and the auxiliary head's pool, two ConvBN units and
    ``aux_head``, fed flax's 17 x 17 grid."""
    ours = _inception(299, aux=True)
    variables = _flax_tree(_weights(ours, seed=7))
    x = _images(2, 299, seed=8)
    (logits, aux), outs, stats = _captured(_flax_inception(aux=True),
                                           variables, x)
    _load(ours, variables).train()
    t = torch.from_numpy
    with torch.no_grad():
        got, got_aux = ours(t(x))
        a5 = ours.ConvBN_5(avg_pool(t(outs["InceptionC_3"]), 5, 3, "VALID"))
        a6 = ours.ConvBN_6(t(outs["ConvBN_5"]))
        head = ours.aux_head(t(outs["ConvBN_6"]).reshape(2, -1)).float()
    assert got_aux.shape == (2, 10) and got_aux.dtype == torch.float32
    _close(got.numpy(), logits)
    for name, y in (("ConvBN_5", a5), ("ConvBN_6", a6), ("aux_head", head)):
        _close(y.numpy(), outs[name], name)
    _close(head.numpy(), aux)
    assert ours.ConvBN_6.Conv_0.kernel.shape == (768, 128, 5, 5)
    # Eval mode: the logits alone.
    ours.eval()
    with torch.no_grad():
        assert ours(t(x)).shape == (2, 10)


_BLOCKS = [("A", 192, 9), ("B", 288, 9), ("C", 768, 9), ("D", 768, 9),
           ("E", 1280, 5)]


def _inception_block(block, in_c, side):
    """``(port block, flax block factory of its BN, variables, x)``: one
    block at full width, its weights from ``_weights`` and a non-negative
    input ``[4, side, side, in_c]``, as a ReLU's output would be."""
    cbn = tinc.partial(tinc.ConvBN, dtype=torch.float32, device="cpu")
    ours = {"A": lambda: tinc.InceptionA(in_c, 32, cbn),
            "B": lambda: tinc.InceptionB(in_c, cbn),
            "C": lambda: tinc.InceptionC(in_c, 128, cbn),
            "D": lambda: tinc.InceptionD(in_c, cbn),
            "E": lambda: tinc.InceptionE(in_c, cbn)}[block]()
    variables = _flax_tree(_weights(ours, seed=9))
    jcbn = jinc.partial(
        jinc.ConvBN,
        conv=jinc.partial(fnn.Conv, use_bias=False, dtype=jnp.float32),
        norm=jinc.partial(fnn.BatchNorm, momentum=0.9, epsilon=1e-3,
                          dtype=jnp.float32))
    jblock = {"A": lambda n: jinc.InceptionA(32, n),
              "B": lambda n: jinc.InceptionB(n),
              "C": lambda n: jinc.InceptionC(128, n),
              "D": lambda n: jinc.InceptionD(n),
              "E": lambda n: jinc.InceptionE(n)}[block]

    def theirs(train):
        return jblock(jinc.partial(
            jcbn, norm=jinc.partial(fnn.BatchNorm,
                                    use_running_average=not train,
                                    momentum=0.9, epsilon=1e-3)))

    x = np.abs(np.random.RandomState(10).randn(4, side, side, in_c)).astype(
        np.float32)
    return ours, theirs, variables, x


@pytest.mark.parametrize("block,in_c,side", _BLOCKS)
def test_inception_blocks_match_flax(block, in_c, side):
    """One block at full width, fed the same input as flax's, in train and
    eval mode: the concatenations' order (1x1 branch first, pool branch
    last), the 3x3/1 SAME average pool counting its padded zeros, the
    VALID max-pools and the asymmetric 7-tap SAME pads all show here."""
    ours, theirs, variables, x = _inception_block(block, in_c, side)
    for train in (True, False):
        _load(ours, variables)       # the train pass moved the statistics
        want = theirs(train).apply(_jnp(variables), jnp.asarray(x),
                                   mutable=["batch_stats"])[0]
        ours.train(train)
        with torch.no_grad():
            got = ours(torch.from_numpy(x))
        assert got.shape[-1] == ours.out_features == want.shape[-1]
        _close(got.numpy(), want, f"{block} train={train}")


@pytest.mark.parametrize("block,in_c,side", _BLOCKS)
def test_inception_block_gradients_match_flax(block, in_c, side):
    """One block's train-mode VJP in f32 against flax's, for a cotangent
    from a seed: dx and every parameter's gradient (each BN site's
    backward kernels' plain version among them), to the activations'
    tolerance.  Each parameter's gradient is divided by flax's largest
    entry of it first, so every leaf is held to the same precision
    relative to its own size, whatever that size is (f32 sums over the
    rows leave conv kernel gradients of order 10 some 1e-5 of that apart):
    a gradient of the wrong sign or size cannot pass on the absolute
    term."""
    ours, theirs, variables, x = _inception_block(block, in_c, side)
    jv = _jnp(variables)

    def apply(params, a):
        return theirs(True).apply(
            {"params": params, "batch_stats": jv["batch_stats"]}, a,
            mutable=["batch_stats"])[0]

    y, vjp = jax.vjp(apply, jv["params"], jnp.asarray(x))
    ct = np.random.RandomState(17).randn(*y.shape).astype(np.float32)
    dparams, dx = vjp(jnp.asarray(ct))
    want = flax_state_from_jax({"params": _numpy_tree(dparams)},
                               device="cpu")
    _load(ours, variables).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    ours(xt).backward(torch.from_numpy(ct))
    _close(xt.grad.numpy(), dx, f"{block} dx")
    got = dict(ours.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        size = g.abs().max().item()
        assert size > 0, name
        _close(got[name].grad.numpy() / size, g.numpy() / size,
               f"{block} {name}")


def test_avg_pool_counts_the_padded_zeros():
    """flax's SAME average pool divides each border window by its full
    size (``count_include_pad=True``): a corner of an all-ones input is
    4 / 9, not 1."""
    x = np.ones((1, 5, 5, 2), np.float32)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), (1, 1), "SAME"))
    got = avg_pool(torch.from_numpy(x), 3, 1, "SAME").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0, 0, 0], [4 / 9] * 2, rtol=1e-6)
    np.testing.assert_allclose(got[0, 2, 2], [1.0] * 2, rtol=1e-6)
    skip_pad = torch.nn.functional.avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, 1, padding=1,
        count_include_pad=False)
    assert not np.allclose(skip_pad.permute(0, 2, 3, 1).numpy(), want)
    # The auxiliary head's 5x5/3 VALID pool, and a VALID max-pool.
    y = np.random.RandomState(11).randn(2, 17, 17, 3).astype(np.float32)
    np.testing.assert_allclose(
        avg_pool(torch.from_numpy(y), 5, 3, "VALID").numpy(),
        np.asarray(fnn.avg_pool(jnp.asarray(y), (5, 5), (3, 3), "VALID")),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        max_pool(torch.from_numpy(y), 3, 2, "VALID").numpy(),
        np.asarray(fnn.max_pool(jnp.asarray(y), (3, 3), (2, 2), "VALID")))


def test_inception_bn_sites_see_contiguous_tensors(monkeypatch):
    """Each of the 94 BN sites gets a contiguous ``[..., C]`` input in the
    forward and a contiguous gradient in the backward, though every
    concatenation's backward hands its branches strided slices: on the
    GPU the kernels take them as they are."""
    model = _inception(75)
    model.load_state_dict(init_params(
        model, generator=torch.Generator().manual_seed(12)))
    seen = []
    real = tbn.fused_bn_backward

    def spy(x, scale, mean, var, dy, **kw):
        seen.append((x.is_contiguous(), dy.is_contiguous()))
        return real(x, scale, mean, var, dy, **kw)

    monkeypatch.setattr(tbn, "fused_bn_backward", spy)
    model(torch.from_numpy(_images(2, 75, seed=13))).sum().backward()
    sites = sum(isinstance(m, tbn.BatchNorm) for m in model.modules())
    assert sites == len(seen) == INCEPTION_BN_SITES
    assert all(a and b for a, b in seen)


# ---------------------------------------------------------------------------
# Full-width shapes and names
# ---------------------------------------------------------------------------


def _flax_shapes(model, side):
    """``{port name: port shape}`` of ``jax.eval_shape`` of the flax init
    (HWIO kernels as the port's OIHW)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)), train=True))
    out = {}
    for col in ("params", "batch_stats"):
        leaves = jax.tree_util.tree_flatten_with_path(shapes.get(col, {}))[0]
        for path, leaf in leaves:
            name = ".".join(p.key for p in path)
            shape = tuple(leaf.shape)
            if name.endswith(".kernel") and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            out[name] = shape
    return out


@pytest.mark.parametrize("name,values", [
    ("vgg16", 138_357_544), ("vgg16_bn", 138_361_768),
    ("vgg19", 143_667_240), ("inception_v3", 23_834_568),
    ("inception_v3_aux", 27_161_264)])
def test_full_width_parameters_match_flax(name, values):
    """Names, shapes and counts of the port's full-width models (built on
    the meta device) against ``jax.eval_shape`` of the flax init, at 1000
    classes and the models' own image sizes."""
    aux = name.endswith("_aux")
    if name.startswith("vgg"):
        bn = name.endswith("_bn")
        depth = 19 if name == "vgg19" else 16
        ours = (VGG19 if depth == 19 else VGG16)(batch_norm=bn,
                                                 device="meta")
        theirs = jvgg.VGG(depth=depth, batch_norm=bn)
        side = 224
    else:
        ours = InceptionV3(aux_logits=aux, device="meta")
        theirs = jinc.InceptionV3(aux_logits=aux)
        side = 299
    want = _flax_shapes(theirs, side)
    got = ours.state_dict()
    assert {k: tuple(t.shape) for k, t in got.items()} == want
    assert sum(p.numel() for p in ours.parameters()) == values
    if name == "vgg16":
        assert ours.Dense_0.kernel.numel() == 102_760_448
    if name.startswith("inception"):
        assert "InceptionA_0.ConvBN_3.Conv_0.kernel" in got
        assert ("aux_head.kernel" in got) == aux
        sites = sum(isinstance(m, tbn.BatchNorm) for m in ours.modules())
        assert sites == INCEPTION_BN_SITES + 2 * aux


def test_init_params_draws_vgg_and_inception_like_flax():
    for model, name in ((VGG16(batch_norm=True, dtype=torch.float32,
                               image_size=32, device="cpu"),
                         "Conv_5.kernel"),
                        (_inception(75),
                         "InceptionC_0.ConvBN_0.Conv_0.kernel")):
        p = init_params(model, generator=torch.Generator().manual_seed(0))
        assert set(p) == set(model.state_dict())
        assert all(t.dtype == torch.float32 for t in p.values())
        k = p[name]
        std = (k.shape[1] * k.shape[2] * k.shape[3]) ** -0.5
        assert abs(k.std().item() - std) < 0.05 * std
        assert k.abs().max().item() <= 2 * 1.14 * std
        assert all(t.eq(0).all() for n, t in p.items()
                   if n.endswith(".bias") or n.endswith(".mean"))
        assert all(t.eq(1).all() for n, t in p.items()
                   if n.endswith(".scale") or n.endswith(".var"))


# ---------------------------------------------------------------------------
# Training steps vs the JAX make_flax_train_step
# ---------------------------------------------------------------------------


def _jax_steps(hvd, model, variables, batch, steps, lr):
    from horovod_tpu.training import make_flax_train_step as jstep
    opt = hvd.DistributedOptimizer(optax.sgd(lr, momentum=0.9))
    step = jstep(model.apply, opt)
    jv = _jnp(variables)
    params = hvd.replicate(jv["params"])
    stats = hvd.replicate(jv["batch_stats"])
    opt_state = hvd.replicate(opt.init(jv["params"]))
    data = hvd.shard_batch(tuple(map(jnp.asarray, batch)))
    losses = []
    for _ in range(steps):
        params, stats, opt_state, loss = step(params, stats, opt_state, data)
        losses.append(float(loss))
    final = {"params": jax.tree.map(np.array, params),
             "batch_stats": jax.tree.map(np.array, stats)}
    return losses, flax_state_from_jax(final, device="cpu")


def _port_steps(model, variables, batch, steps, lr):
    _load(model, variables)
    named = list(model.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=lr, momentum=0.9),
        named_parameters=named, compression=thvd.Compression.none)
    step = make_flax_train_step(model, opt)
    data = tuple(torch.from_numpy(a) for a in batch)
    losses = [step(data).item() for _ in range(steps)]
    return losses, {k: v.detach().clone()
                    for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["vgg16", "inception_v3"])
def test_three_steps_match_jax_make_flax_train_step(jax1, world1, name):
    """Three steps of ``DistributedOptimizer(SGD(lr, momentum 0.9))``:
    losses, parameters and running statistics, every tensor moved, and
    the first step lowering the loss.

    VGG-16 at 32 x 32, batch 4, f32, lr 0.01 (the synthetic benchmark's).
    Inception-v3 at 75 x 75, batch 8, runs in float64 in both packages at
    lr 1e-5, because in f32, at any batch, the comparison is
    ill-conditioned.  Its 94 BN sites without a skip connection make the
    backward explode (stem gradients near 80 at this init): JAX in f32
    and JAX in f64 disagree by a median 6.5 % of each gradient's max
    after one backward, and JAX's f32 loss is 1e-4 off its f64 loss (its
    BN reductions where a site's mean dwarfs its spread, first at
    ``ConvBN_3``).  The loss is as sharp in the weights: at lr 1e-4 the
    two f64 runs already part by 3e-5 in a weight after three steps (the
    logits are cast to f32 in both, so f32 roundoff still enters), and
    at lr 0.01 by 0.5 % in the third loss.  At lr 1e-5 they agree to
    2e-7, and every tensor still moves by more than 6e-7.  So an
    absolute tolerance alone would not see a wrong gradient there: each
    tensor's update (after minus before) is also held to JAX's update, to
    ``UPDATE_RTOL`` of that update's largest entry (the two packages' f64
    updates agree to 2e-6 of it at worst).  Each block's f32 gradient is
    held to flax's in ``test_inception_block_gradients_match_flax``."""
    f64 = name == "inception_v3"
    if name == "vgg16":
        ours = VGG16(num_classes=10, dropout_rate=0.0, dtype=torch.float32,
                     image_size=32, device="cpu")
        theirs = jvgg.VGG16(num_classes=10, dropout_rate=0.0,
                            dtype=jnp.float32)
        x, lr = _images(4, 32, seed=14), 0.01
    else:
        ours = InceptionV3(num_classes=10, dropout_rate=0.0,
                           dtype=torch.float64, image_size=75,
                           device="cpu").double()
        theirs = jinc.InceptionV3(num_classes=10, dropout_rate=0.0,
                                  dtype=jnp.float64)
        x, lr = _images(8, 75, seed=14).astype(np.float64), 1e-5
    variables = jax.tree.map(lambda a: a.astype(x.dtype),
                             _flax_tree(_weights(ours, seed=15)))
    y = np.random.RandomState(16).randint(0, 10, len(x)).astype(np.int32)
    with jax.enable_x64(f64):
        want_losses, want_state = _jax_steps(jax1, theirs, variables,
                                             (x, y), 3, lr)
    losses, state = _port_steps(ours, variables, (x, y), 3, lr)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[1] < losses[0]
    assert set(state) == set(want_state)
    before = flax_state_from_jax(variables, device="cpu")
    for k, t in want_state.items():
        assert state[k].dtype == t.dtype, k
        np.testing.assert_allclose(state[k].numpy(), t.numpy(),
                                   atol=STATE_ATOL, rtol=0, err_msg=k)
        assert not torch.equal(state[k], before[k]), k
        if f64:
            want_update = (t - before[k]).numpy()
            size = np.abs(want_update).max()
            np.testing.assert_allclose(
                (state[k] - before[k]).numpy(), want_update,
                atol=UPDATE_RTOL * size, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# The synthetic benchmark
# ---------------------------------------------------------------------------


def test_synthetic_benchmark_runs_lenet_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.synthetic_benchmark",
         "--device", "cpu", "--model", "lenet", "--num-iters", "1",
         "--num-warmup", "1"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "model: lenet  devices: 1  global batch: 32  image: 28"
    assert "1 iters in" in lines[1] and "images/s/chip" in lines[1]


def test_synthetic_benchmark_surface(world1):
    from horovod_tpu_torch import synthetic_benchmark as sb
    assert sb.MODELS == ("lenet", "resnet50", "resnet101", "vgg16", "vgg19",
                         "inception_v3")
    assert [sb.default_image_size(m) for m in sb.MODELS] == \
        [28, 224, 224, 224, 224, 299]
    bench = sb.setup("vgg16", batch_size=2, image_size=32, num_classes=10)
    assert bench.batch[0].shape == (2, 32, 32, 3)
    assert bench.batch[0].dtype == torch.bfloat16
    assert bench.model.Dropout_0.rate == 0.0
    assert bench.optimizer.defaults["lr"] == 0.01
    assert bench.optimizer.defaults["momentum"] == 0.9
    assert np.isfinite(bench.step(bench.batch).item())
    # --compression fp8 runs a step through the e4m3 exchange.
    run = sb.main(["--device", "cpu", "--model", "lenet", "--compression",
                   "fp8", "--num-iters", "1", "--num-warmup", "1"])
    assert np.isfinite(run["loss"]) and run["images_per_s"] > 0
