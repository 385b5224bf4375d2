"""PyTorch/CUDA port: the int8 frozen base, remat and merge_lora against
the JAX package.

* ``quantize_int8`` bitwise the JAX function, across shapes, scales and
  both axes (a zero channel included: its scale clamps at 1e-12).
* ``quantize_frozen_base`` over the port's flat dict: the names, order
  and values of the JAX tree's, bitwise.
* ``LlamaLM(base_dtype="int8", lora_rank=4)`` on converted weights: the
  logits and every LoRA gradient within 1e-5 of max |value| of the flax
  model's (gradients through ``jax.grad`` of the adapters only).
* ``merge_lora``: every merged kernel within 1e-6 of max |kernel| of the
  JAX function's; an int8 node keeps its adapters, as in the reference.
* ``remat=True``: gradients bitwise the port's gradients without it, and
  within 1e-5 of the flax model's ``remat=True`` gradients (LlamaLM with
  the int8 base, and Bert).
* ``init_llama_params(base_dtype="int8")`` is ``quantize_int8`` of the
  f32 draw from the same seed; an int8 Llama-3 8B on the meta device
  holds about 7.5 GB of base.

Everything in f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
from horovod_tpu.models.transformer import LLAMA_TINY as J_TINY
from horovod_tpu.models.transformer import Bert as JBert
from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
from horovod_tpu.models.transformer import merge_frozen as j_merge_frozen
from horovod_tpu.models.transformer import merge_lora as j_merge_lora
from horovod_tpu.models.transformer import quantize_frozen_base as j_qfb
from horovod_tpu.models.transformer import quantize_int8 as j_quantize_int8
from horovod_tpu.models.transformer import split_frozen as j_split_frozen
from horovod_tpu_torch.models import (BERT_TINY, LLAMA3_8B, LLAMA_TINY, Bert,
                                      LlamaLM, flax_leaf_order, freeze_base,
                                      init_llama_params, merge_lora,
                                      params_from_jax, quantize_frozen_base,
                                      quantize_int8)
from horovod_tpu_torch.models.transformer import param_shapes
from horovod_tpu_torch.training import bert_pretrain_loss, next_token_loss

torch.set_num_threads(2)

RANK = 4
REL = 1e-5          # logits and gradients: of max |JAX value|
MERGE_REL = 1e-6    # merged kernels: of max |kernel|


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _names(tree):
    return [".".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


def _nonzero_b(params, seed):
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: ((0.02 * rng.randn(*v.shape)).astype(np.float32)
                    if k == "lora_b" else
                    walk(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    return walk(params)


def _flax_llama(seed=0, base_dtype="int8", remat=False):
    model = JLlamaLM(J_TINY, dtype=jnp.float32, lora_rank=RANK,
                     base_dtype=base_dtype, remat=remat)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
    return model, _nonzero_b(params, seed + 50)


def _tokens(b=2, t=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(
        np.int32)


def _jax_lora_grads(model, params, toks):
    """Loss and the adapters' gradients (flax dotted name -> array)."""
    train, frozen = j_split_frozen(params)

    def loss_fn(tp):
        logits = model.apply(j_merge_frozen(tp, frozen), toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], toks[:, 1:]).mean()

    loss, grads = jax.value_and_grad(loss_fn)(train)
    return float(loss), dict(zip(_names(grads["params"]),
                                 jax.tree.leaves(grads["params"])))


def _port_lora_grads(model, toks):
    named = freeze_base(model)
    loss = next_token_loss(model(torch.from_numpy(toks).long()),
                           torch.from_numpy(toks).long())
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in named}


# ---------------------------------------------------------------------------
# quantize_int8 and quantize_frozen_base: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (256, 64), (7, 13),
                                   (128, 384)])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_is_bitwise_jax(shape, axis):
    rng = np.random.RandomState(sum(shape) + axis)
    w = (rng.randn(*shape) * rng.choice([0.02, 1.0, 30.0])).astype(
        np.float32)
    w[:, 3] = 0.0       # an all-zero output channel
    w[2, :] = 0.0       # and an all-zero input row
    want = j_quantize_int8(jnp.asarray(w), axis)
    got = quantize_int8(torch.from_numpy(w), axis)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


def test_quantize_frozen_base_names_and_values_are_bitwise_jax():
    _, params = _flax_llama(seed=2, base_dtype=None)
    want = params_from_jax(jax.tree.map(np.asarray, j_qfb(params)),
                           device="cpu")
    got = quantize_frozen_base(params_from_jax(params, device="cpu"))
    assert list(got) == list(want)
    assert set(got) == set(param_shapes(LLAMA_TINY, RANK, "int8"))
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    # The result loads into the int8 model as is.
    LlamaLM.from_params(LLAMA_TINY, got, lora_rank=RANK, base_dtype="int8")


def test_flax_leaf_order_of_the_int8_names():
    _, params = _flax_llama(seed=3)
    flat = params_from_jax(params, device="cpu")
    names = list(flat)
    ordered = [names[i] for i in flax_leaf_order(names)]
    assert ordered == _names(params["params"])


# ---------------------------------------------------------------------------
# The int8 LlamaLM: logits and LoRA gradients
# ---------------------------------------------------------------------------


def test_int8_llama_logits_and_lora_grads_match_flax():
    jmodel, params = _flax_llama(seed=4)
    toks = _tokens(seed=5)
    model = LlamaLM.from_params(LLAMA_TINY,
                                params_from_jax(params, device="cpu"),
                                lora_rank=RANK, base_dtype="int8")
    assert model.layer_0.attn.wq.kernel_q8.q.dtype == torch.int8
    want = np.asarray(jmodel.apply(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    assert _rel_err(got, want) <= REL
    loss_j, grads_j = _jax_lora_grads(jmodel, params, jnp.asarray(toks))
    loss, grads = _port_lora_grads(model, toks)
    np.testing.assert_allclose(loss, loss_j, rtol=REL)
    assert set(grads) == set(grads_j) and len(grads) == 2 * 7 * 2
    for name, g in grads_j.items():
        assert _rel_err(grads[name].numpy(), g) <= REL, name


def test_int8_product_saves_int8_not_a_converted_copy():
    """Autograd keeps the int8 kernel for the backward, not its
    compute-dtype copy (the copy the int8 base exists to avoid)."""
    g = torch.Generator().manual_seed(0)
    model = LlamaLM.from_params(
        LLAMA_TINY, init_llama_params(LLAMA_TINY, generator=g, device="cpu",
                                      lora_rank=RANK, base_dtype="int8"),
        lora_rank=RANK, base_dtype="int8")
    freeze_base(model)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    toks = torch.from_numpy(_tokens(seed=1)).long()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = next_token_loss(model(toks), toks)
    loss.backward()
    kernel_shapes = {tuple(p.shape) for n, p in model.named_parameters()
                     if n.endswith("kernel_q8.q")}
    big = [t for t in saved if tuple(t.shape) in kernel_shapes]
    assert big and all(t.dtype == torch.int8 for t in big)


# ---------------------------------------------------------------------------
# merge_lora
# ---------------------------------------------------------------------------


def test_merge_lora_matches_jax_and_keeps_int8_nodes():
    _, params = _flax_llama(seed=6, base_dtype=None)
    want = params_from_jax(jax.tree.map(np.asarray,
                                        j_merge_lora(params, alpha=16.0)),
                           device="cpu")
    flat = params_from_jax(params, device="cpu")
    got = merge_lora(flat, alpha=16.0)
    assert list(got) == list(want)
    assert not any(n.endswith(("lora_a", "lora_b")) for n in got)
    for name, t in want.items():
        if name.endswith(".kernel"):
            assert _rel_err(got[name].numpy(), t.numpy()) <= MERGE_REL, name
        else:
            assert torch.equal(got[name], t), name
    # A bf16 kernel comes back bf16, the sum taken in f32.
    bf = {n: (t.to(torch.bfloat16) if n.endswith(".kernel") else t)
          for n, t in flat.items()}
    merged = merge_lora(bf)["layer_0.attn.wq.kernel"]
    assert merged.dtype == torch.bfloat16
    a, b = flat["layer_0.attn.wq.lora_a"], flat["layer_0.attn.wq.lora_b"]
    exact = bf["layer_0.attn.wq.kernel"].float() + a @ b * (16.0 / RANK)
    assert torch.equal(merged, exact.to(torch.bfloat16))
    # An int8 node has no kernel to fold into: node and adapters stay,
    # as the JAX function leaves them.
    _, q8 = _flax_llama(seed=6)
    q8_flat = params_from_jax(q8, device="cpu")
    q8_want = params_from_jax(jax.tree.map(np.asarray, j_merge_lora(q8)),
                              device="cpu")
    q8_got = merge_lora(q8_flat)
    assert list(q8_got) == list(q8_want) == list(q8_flat)
    assert all(torch.equal(q8_got[n], q8_flat[n]) for n in q8_flat)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def test_llama_remat_grads_bitwise_and_match_flax_remat():
    jmodel, params = _flax_llama(seed=8, remat=True)
    toks = _tokens(seed=9)
    flat = params_from_jax(params, device="cpu")
    runs = []
    for remat in (False, True):
        model = LlamaLM.from_params(LLAMA_TINY, dict(flat), lora_rank=RANK,
                                    base_dtype="int8", remat=remat)
        runs.append(_port_lora_grads(model, toks))
    (loss0, g0), (loss1, g1) = runs
    assert loss0 == loss1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    loss_j, grads_j = _jax_lora_grads(jmodel, params, jnp.asarray(toks))
    np.testing.assert_allclose(loss1, loss_j, rtol=REL)
    for name, g in grads_j.items():
        assert _rel_err(g1[name].numpy(), g) <= REL, name


def test_bert_remat_grads_bitwise_and_match_flax_remat():
    jmodel = JBert(J_BERT_TINY, dtype=jnp.float32, remat=True)
    rng = np.random.RandomState(10)
    tokens = rng.randint(0, 256, (3, 16)).astype(np.int32)
    nsp = rng.randint(0, 2, (3,)).astype(np.int32)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(11), jnp.asarray(tokens[:1])))

    def loss_fn(p):
        mlm, nsp_logits = jmodel.apply(p, jnp.asarray(tokens))
        return (optax.softmax_cross_entropy_with_integer_labels(
            mlm, jnp.asarray(tokens)).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                nsp_logits, jnp.asarray(nsp)).mean())

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    flat = params_from_jax(params, device="cpu")
    runs = []
    for remat in (False, True):
        model = Bert.from_params(BERT_TINY, dict(flat), remat=remat)
        loss = bert_pretrain_loss(model, (torch.from_numpy(tokens).long(),
                                          torch.from_numpy(nsp).long()))
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone()
                                   for n, p in model.named_parameters()}))
    (loss0, g0), (loss1, g1) = runs
    assert loss0 == loss1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    np.testing.assert_allclose(loss1, float(loss_j), rtol=REL)
    top = max(np.abs(g).max() for g in jax.tree.leaves(grads_j["params"]))
    for name, g in zip(_names(grads_j["params"]),
                       jax.tree.leaves(grads_j["params"])):
        got = g1[name].numpy()
        if name.endswith("wk.bias"):
            # Zero in exact arithmetic: both packages hold roundoff only.
            assert max(np.abs(got).max(), np.abs(g).max()) <= 1e-7 * top
        else:
            assert _rel_err(got, g) <= REL, name


# ---------------------------------------------------------------------------
# Seeded init and the 8B's size
# ---------------------------------------------------------------------------


def test_int8_init_is_the_quantized_f32_draw():
    f32 = init_llama_params(LLAMA_TINY, generator=torch.Generator()
                            .manual_seed(3), device="cpu", lora_rank=RANK)
    q8 = init_llama_params(LLAMA_TINY, generator=torch.Generator()
                           .manual_seed(3), device="cpu", lora_rank=RANK,
                           base_dtype="int8")
    assert list(q8) == list(param_shapes(LLAMA_TINY, RANK, "int8"))
    want = quantize_frozen_base(f32)
    assert list(q8) == list(want)
    assert all(torch.equal(q8[n], want[n]) for n in want)


def test_int8_llama3_8b_base_is_about_8_gb():
    model = LlamaLM(LLAMA3_8B, torch.bfloat16, device="meta", lora_rank=8,
                    base_dtype="int8")
    base = sum(p.numel() * p.element_size()
               for n, p in model.named_parameters()
               if not n.endswith(("lora_a", "lora_b")))
    q8 = sum(p.numel() for n, p in model.named_parameters()
             if n.endswith(".q"))
    f32 = sum(int(np.prod(s)) for s in param_shapes(LLAMA3_8B).values())
    assert 7.4e9 < base < 7.6e9          # a quarter of the f32 base
    assert q8 > 0.999 * f32 and base < 0.26 * 4 * f32
    assert {p.dtype for n, p in model.named_parameters()
            if n.endswith(".q")} == {torch.int8}
    with pytest.raises(ValueError, match="base_dtype"):
        LlamaLM(LLAMA_TINY, device="meta", base_dtype="int4")
