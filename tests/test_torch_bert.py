"""PyTorch/CUDA port: BERT against the JAX package.

* ``LayerNorm`` against ``flax.linen.LayerNorm`` (epsilon 1e-12, f32
  parameters), with an input of mean 20 where flax's fast variance
  ``E[x^2] - E[x]^2`` is visibly not the two-pass one, in f32 and with a
  bf16 output.
* ``BERT_TINY``'s forward in f32 against the flax ``Bert.apply`` on
  converted weights: MLM and NSP logits, plain, with ``pack_segment_ids``
  (two packed segments of unequal lengths a row) and with
  ``token_types``.  The conversion is a rename: every flax leaf lands
  bitwise under its dotted path.
* The pretraining loss and every parameter's gradient against
  ``jax.value_and_grad`` of the same loss (``wk.bias``'s is zero in exact
  arithmetic, so both packages must hold no more than roundoff there,
  1e-7 of the largest gradient).
* Three ``make_train_step`` steps of ``DistributedAdasumOptimizer(AdamW,
  compression=fp16)`` at world 1 against the JAX ``make_train_step`` with
  ``DistributedAdasumOptimizer(optax.adamw, fp16)`` on a one-device mesh.
* ``BERT_LARGE`` on the meta device: 399 tensors and 336,197,634 values,
  the names and shapes of ``jax.eval_shape`` of the flax init.

f32 on the CPU.  Tolerances: logits, the loss and gradients within 1e-5
of the max |value| of the JAX result (sums in another order); after the
three steps losses within 1e-5 relative and weights within 1e-5 absolute
(each AdamW step moves a weight by about lr = 1e-3).  LayerNorm: 1e-6 of
max |value| in f32; bf16 outputs at most one bf16 ulp apart.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import BERT_LARGE as J_BERT_LARGE
from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
from horovod_tpu.models.transformer import Bert as JBert
import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import (BERT_LARGE, BERT_TINY, Bert,
                                      LLAMA_TINY, LayerNorm, LlamaLM,
                                      freeze_base, init_bert_params,
                                      params_from_jax)
from horovod_tpu_torch.models.transformer import bert_param_shapes
from horovod_tpu_torch.training import (bert_pretrain_loss,
                                        make_train_step, mlm_nsp_loss)

torch.set_num_threads(2)

REL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
LN_REL = 1e-6
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _batch(b=4, t=16, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, J_BERT_TINY.vocab_size, (b, t)).astype(np.int32)
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    return tokens, nsp


def _packed_segments(b, t):
    """Two packed segments of unequal lengths a row, the split moving from
    row to row."""
    seg = np.zeros((b, t), np.int32)
    for r in range(b):
        seg[r, 5 + 2 * r:] = 1
    return seg


def _flax_params(seed=0):
    model = JBert(J_BERT_TINY, dtype=jnp.float32)
    tokens, _ = _batch()
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens[:1]))
    return model, jax.tree.map(np.asarray, params)


def _port_model(params):
    return Bert.from_params(BERT_TINY, params_from_jax(params, device="cpu"))


def _flax_names(tree):
    return [".".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mean", [0.0, 20.0])
def test_layernorm_matches_flax(mean, dtype):
    """Values on a grid of 1/8 over 64 features: every sum of x and x**2
    is exact in f32 whatever its order, so the statistics round only
    where the formula does.  At mean 20 flax's fast variance (E[x^2] -
    E[x]^2, with mean**2 rounded) is visibly not the two-pass one, and
    the port follows flax."""
    rng = np.random.RandomState(1)
    k = np.clip(np.round(8 * rng.randn(6, 64)), -32, 32)
    x = (mean + k / 8).astype(np.float32)
    scale = (1.0 + np.round(8 * rng.randn(64)) / 64).astype(np.float32)
    bias = (np.round(8 * rng.randn(64)) / 64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ln = nn.LayerNorm(dtype=jdt, epsilon=1e-12, param_dtype=jnp.float32)
    want = np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}},
                               jnp.asarray(x).astype(jdt)).astype(
                                   jnp.float32))
    mod = LayerNorm(64, tdt, device="cpu")
    mod.load_state_dict({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x).to(tdt)
    got = mod(xt)
    assert got.dtype == tdt
    got = got.float().detach().numpy()
    if dtype == "float32":
        assert _rel_err(got, want) <= LN_REL
    else:
        # At most one bf16 ulp (2**-7 of the value) apart.
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
    if mean and dtype == "float32":
        two_pass = torch.nn.functional.layer_norm(
            xt, (64,), torch.from_numpy(scale), torch.from_numpy(bias),
            1e-12).numpy()
        assert _rel_err(two_pass, want) > LN_REL


# ---------------------------------------------------------------------------
# Model: conversion, forward, loss and gradients
# ---------------------------------------------------------------------------


def test_bert_conversion_is_a_rename():
    _, params = _flax_params(seed=2)
    tp = params_from_jax(params, device="cpu")
    assert sorted(tp) == sorted(_flax_names(params["params"]))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        bert_param_shapes(BERT_TINY)
    model = _port_model(params)
    state = model.state_dict()
    for name, leaf in zip(_flax_names(params["params"]),
                          jax.tree.leaves(params["params"])):
        np.testing.assert_array_equal(state[name].numpy(), leaf)
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("inputs", ["plain", "packed", "token_types"])
def test_bert_forward_matches_flax(inputs):
    jmodel, params = _flax_params(seed=3)
    tokens, _ = _batch(seed=4)
    kw_j, kw_t = {}, {}
    if inputs == "packed":
        seg = _packed_segments(*tokens.shape)
        kw_j["pack_segment_ids"] = jnp.asarray(seg)
        kw_t["pack_segment_ids"] = torch.from_numpy(seg)
    args_j, args_t = [jnp.asarray(tokens)], [torch.from_numpy(tokens).long()]
    if inputs == "token_types":
        types = np.zeros_like(tokens)
        types[:, 7:] = 1
        args_j.append(jnp.asarray(types))
        args_t.append(torch.from_numpy(types).long())
    want = jmodel.apply(params, *args_j, **kw_j)
    got = _port_model(params)(*args_t, **kw_t)
    for g, w, shape in zip(got, want, ((4, 16, 256), (4, 2))):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        assert _rel_err(g.detach().numpy(), np.asarray(w)) <= REL


def test_mlm_nsp_loss_matches_optax():
    rng = np.random.RandomState(5)
    mlm = rng.randn(3, 7, 256).astype(np.float32)
    nsp = rng.randn(3, 2).astype(np.float32)
    tokens, labels = _batch(3, 7, seed=6)
    want = (optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(mlm), jnp.asarray(tokens)).mean()
        + optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(nsp), jnp.asarray(labels)).mean())
    got = mlm_nsp_loss(torch.from_numpy(mlm), torch.from_numpy(nsp),
                       torch.from_numpy(tokens).long(),
                       torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _jax_loss_fn(model):
    def loss_fn(p, batch):
        toks, nsp_y = batch
        mlm, nsp = model.apply(p, toks)
        return (optax.softmax_cross_entropy_with_integer_labels(
            mlm, toks).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                nsp, nsp_y).mean())
    return loss_fn


def test_bert_loss_and_gradients_match_jax_grad():
    jmodel, params = _flax_params(seed=7)
    tokens, nsp = _batch(seed=8)
    loss_j, grads_j = jax.value_and_grad(_jax_loss_fn(jmodel))(
        params, (jnp.asarray(tokens), jnp.asarray(nsp)))
    model = _port_model(params)
    loss = bert_pretrain_loss(model, (torch.from_numpy(tokens).long(),
                                      torch.from_numpy(nsp).long()))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=REL)
    grads = dict(model.named_parameters())
    names = _flax_names(grads_j["params"])
    assert len(names) == len(grads)
    top = max(np.abs(g).max() for g in jax.tree.leaves(grads_j["params"]))
    for name, g in zip(names, jax.tree.leaves(grads_j["params"])):
        got = grads[name].grad.numpy()
        if name.endswith("wk.bias"):
            # Zero in exact arithmetic (a key bias shifts every logit of
            # a query alike): both packages hold roundoff only.
            assert max(np.abs(got).max(), np.abs(g).max()) <= 1e-7 * top
        else:
            assert _rel_err(got, g) <= REL, name


# ---------------------------------------------------------------------------
# Training: DistributedAdasumOptimizer(AdamW, fp16) at world 1
# ---------------------------------------------------------------------------


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


@pytest.fixture
def jax1():
    """The JAX package on a one-device mesh (Adasum over one device is
    the identity, as in a port world of one)."""
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    yield hvd
    hvd.shutdown()


def test_three_adasum_fp16_steps_match_jax(jax1, world1):
    jmodel, params = _flax_params(seed=9)
    tokens, nsp = _batch(seed=10)
    opt_j = jax1.DistributedAdasumOptimizer(
        optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"],
                    eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"]),
        compression=jax1.Compression.fp16)
    step_j = jax1.make_train_step(_jax_loss_fn(jmodel), opt_j)
    p = jax1.replicate(jax.tree.map(jnp.asarray, params))
    state = opt_j.init(p)
    data = jax1.shard_batch((jnp.asarray(tokens), jnp.asarray(nsp)))
    want_losses = []
    for _ in range(3):
        p, state, loss = step_j(p, state, data)
        want_losses.append(float(loss))
    want = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")

    model = _port_model(params)
    named = list(model.named_parameters())
    opt = thvd.DistributedAdasumOptimizer(
        torch.optim.AdamW([q for _, q in named], lr=ADAMW["lr"],
                          betas=(ADAMW["b1"], ADAMW["b2"]), eps=ADAMW["eps"],
                          weight_decay=ADAMW["weight_decay"]),
        named_parameters=named, compression=thvd.Compression.fp16)
    step = make_train_step(model, bert_pretrain_loss, opt)
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(nsp).long())
    losses = [step(batch).item() for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    for n, q in named:
        np.testing.assert_allclose(q.detach().numpy(), want[n].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_adasum_buckets_follow_the_flax_leaf_order(world1):
    """One bucket a step at the default threshold, holding every tensor
    in ``jax.tree.leaves`` order; fp16 puts 2 bytes a value on the wire
    (the JAX flat exchange's accounting)."""
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    _, params = _flax_params(seed=11)
    model = _port_model(params)
    named = list(model.named_parameters())
    opt = thvd.DistributedAdasumOptimizer(
        torch.optim.SGD([q for _, q in named], lr=0.1),
        named_parameters=named, compression=thvd.Compression.fp16)
    names = _flax_names(params["params"])
    assert [[opt._names[s.index] for s in lspecs]
            for _, lspecs in opt.bucket_plan.buffers] == [names]
    step = make_train_step(model, bert_pretrain_loss, opt)
    tokens, nsp = _batch(seed=12)
    before = exchange_totals()
    step((torch.from_numpy(tokens).long(), torch.from_numpy(nsp).long()))
    moved = {k: v - before[k] for k, v in exchange_totals().items()}
    values = sum(q.numel() for _, q in named)
    assert moved == {"buckets": 1, "handles": 1, "wire_bytes": 2 * values}


# ---------------------------------------------------------------------------
# Sizes, devices, and the LoRA Dense left as it was
# ---------------------------------------------------------------------------


def test_bert_large_matches_jax_eval_shape():
    model = Bert(BERT_LARGE, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert len(shapes) == 399
    assert sum(p.numel() for p in model.parameters()) == 336_197_634
    abstract = jax.eval_shape(
        JBert(J_BERT_LARGE, dtype=jnp.bfloat16).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    assert dict(zip(_flax_names(abstract),
                    (tuple(x.shape) for x in jax.tree.leaves(abstract)))) \
        == shapes
    assert all(x.dtype == jnp.float32 for x in jax.tree.leaves(abstract))


def test_init_bert_params_draws_like_flax():
    p = init_bert_params(BERT_TINY, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        bert_param_shapes(BERT_TINY)
    for name, t in p.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            assert t.eq(0).all(), name
        elif leaf == "scale":
            assert t.eq(1).all(), name
        elif leaf == "kernel":
            assert abs(t.std().item() * t.shape[0] ** 0.5 - 1.0) < 0.15, name
        else:
            assert abs(t.std().item() - 0.02) < 2e-3, name


def test_bert_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Bert(BERT_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_bert_params(BERT_TINY, generator=torch.Generator())


def test_llama_dense_stays_frozen_and_bias_free():
    model = LlamaLM(LLAMA_TINY, device="cpu", lora_rank=2)
    assert not any(n.endswith(".bias") for n, _ in model.named_parameters())
    assert not model.layer_0.attn.wq.kernel.requires_grad
    assert all(n.rsplit(".", 1)[1] in ("lora_a", "lora_b")
               for n, _ in freeze_base(model))
