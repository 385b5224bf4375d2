"""PyTorch/CUDA port: LoRA adapters in serving -- in-tree leaves and
banked multi-LoRA -- against the JAX package.

* In-tree ``lora_a``/``lora_b`` leaves change prefill and decode logits
  as the JAX ``_dense`` / ``_node_lora`` apply them (the port once served
  a LoRA model as its bare base).
* ``stack_adapters`` over the port's flat dicts equals the JAX function
  over flax trees.
* Banked prefill (one adapter a prompt) and the banked decode step (a
  per-slot gather) equal the JAX functions.
* The banked engine's token streams equal the JAX banked engine's, and
  each equals the port's single-adapter engine with that adapter's
  leaves in the tree.

Weights come from the flax ``LlamaLM(lora_rank=4)`` init with ``lora_b``
drawn non-zero (else the adapters add exactly 0), carried across with
``params_from_jax``; token inputs come from numpy seeds.  Everything
runs in f32 on the CPU: logits within 1e-5 of max |logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.controller import fusion as j_fusion
from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
from horovod_tpu.models.transformer import LLAMA_TINY as J_TINY
from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
from horovod_tpu.serving import CacheConfig as JCacheConfig
from horovod_tpu.serving import LoadSpec as JLoadSpec
from horovod_tpu.serving import PagedKVCache as JPagedKVCache
from horovod_tpu.serving import ServingEngine as JServingEngine
from horovod_tpu.serving import build_decode_step as j_build_decode_step
from horovod_tpu.serving import cache_sharding
from horovod_tpu.serving import generate as j_generate
from horovod_tpu.serving import prefill_forward as j_prefill_forward
from horovod_tpu.serving import stack_adapters as j_stack_adapters
from horovod_tpu_torch.models import LLAMA_SERVE, LLAMA_TINY, params_from_jax
from horovod_tpu_torch.serving import (CacheConfig, LoadSpec, PagedKVCache,
                                       ServingEngine, build_decode_step,
                                       generate, prefill_forward,
                                       stack_adapters)

torch.set_num_threads(2)

RANK = 4
REL_TOL = 1e-5          # f32: of max |logit|


def mesh_1d():
    return Mesh(np.asarray(jax.devices()[:1], dtype=object).reshape(1),
                ("tp",))


def _flax_lora(jcfg, seed=0, b_scale=0.05):
    """Flax LoRA params (numpy leaves), ``lora_b`` drawn from
    ``b_scale * normal``."""
    model = JLlamaLM(jcfg, dtype=jnp.float32, lora_rank=RANK)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.RandomState(seed + 50)

    def walk(tree):
        for key, val in tree.items():
            if key == "lora_b":
                tree[key] = (b_scale * rng.randn(*val.shape)).astype(
                    np.float32)
            elif isinstance(val, dict):
                walk(val)

    params = jax.tree.map(lambda x: x, params)      # a fresh dict tree
    walk(params["params"])
    return model, params


def _zero_adapters(params):
    def walk(tree):
        return {k: (np.zeros_like(v) if k == "lora_b" else
                    walk(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    return walk(params)


def _tokens(seed, t, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (1, t)).astype(
        np.int32)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    tol = REL_TOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |err| {err} > {tol}"


# ---------------------------------------------------------------------------
# In-tree adapters: prefill and decode apply them as the JAX package does
# ---------------------------------------------------------------------------


def test_in_tree_adapters_reach_prefill_and_decode_logits():
    """A LoRA model is served with its adapters, not as its bare base."""
    _, jparams = _flax_lora(J_TINY, seed=1)
    tparams = params_from_jax(jparams, device="cpu")
    toks = _tokens(2, 16)
    jl, jk, jv = j_prefill_forward(jparams, J_TINY, jnp.asarray(toks))
    tl, tk, tv = prefill_forward(tparams, LLAMA_TINY,
                                 torch.from_numpy(toks).long())
    _close(tl.numpy(), jl, "prefill logits")
    # The adapters move the logits far beyond the tolerance: a prefill
    # that dropped them would fail above.
    jl0, _, _ = j_prefill_forward(_zero_adapters(jparams), J_TINY,
                                  jnp.asarray(toks))
    assert np.abs(np.asarray(jl) - np.asarray(jl0)).max() > \
        100 * REL_TOL * np.abs(np.asarray(jl)).max()

    kw = dict(num_layers=J_TINY.num_layers,
              num_kv_heads=J_TINY.num_kv_heads, head_dim=J_TINY.head_dim,
              slots=2, page_size=8, max_len=32)
    mesh = mesh_1d()
    jcache = JPagedKVCache(JCacheConfig(**kw), cache_sharding(mesh))
    tcache = PagedKVCache(CacheConfig(**kw), device="cpu")
    jcache.write_prefill(0, jk[:, 0], jv[:, 0])
    tcache.write_prefill(0, tk[:, 0], tv[:, 0])
    jstep = j_build_decode_step(J_TINY, mesh, slots=2, page_size=8,
                                pages_per_slot=4)
    tstep = build_decode_step(LLAMA_TINY, slots=2, page_size=8,
                              pages_per_slot=4)
    active = np.array([True, False])
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for _ in range(3):
        jcache.reserve(0, int(jcache.lengths[0]) + 1)
        tcache.reserve(0, int(tcache.lengths[0]) + 1)
        toks2 = np.array([tok, 0], np.int32)
        jlog, jcache.k, jcache.v = jstep(
            jparams, jcache.k, jcache.v, jnp.asarray(toks2),
            jcache.lengths_device(), jcache.table_device(),
            jnp.asarray(active))
        tlog, tcache.k, tcache.v = tstep(
            tparams, tcache.k, tcache.v, torch.from_numpy(toks2).long(),
            tcache.lengths_device().long(), tcache.table_device(),
            torch.from_numpy(active))
        _close(tlog.numpy()[0], np.asarray(jlog)[0], "decode logits")
        jcache.lengths[0] += 1
        tcache.lengths[0] += 1
        tok = int(np.argmax(np.asarray(jlog)[0]))


# ---------------------------------------------------------------------------
# Banked adapters
# ---------------------------------------------------------------------------


def _random_adapters(flat_params, n, seed):
    """``n`` adapters (dotted name -> numpy) with every ``lora_a`` /
    ``lora_b`` of ``flat_params`` drawn from ``0.05 * normal``."""
    rng = np.random.RandomState(seed)
    names = [k for k in flat_params if k.endswith(("lora_a", "lora_b"))]
    return [{k: (0.05 * rng.randn(*flat_params[k].shape)).astype(np.float32)
             for k in names} for _ in range(n)]


def _nest(flat):
    tree = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flatten(val, name))
        else:
            out[name] = np.asarray(val)
    return out


def _torch(adapter):
    return {k: torch.from_numpy(v.copy()) for k, v in adapter.items()}


@pytest.fixture(autouse=True)
def _fresh_jax_plan_cache():
    """The JAX package memoizes a serving step's executable by exchange
    plan and page geometry, not by the params' or adapters' tree, in a
    cache that lives as long as the process: a step another test file
    cached at the same geometry would take this file's trees with its
    own ``in_specs``.  Start each test from an empty cache."""
    j_fusion.clear_plan_cache()


@pytest.fixture(scope="module")
def serve_lora():
    """LLAMA_SERVE with rank-4 adapters: the flax params (numpy), the
    port's flat dict, and three random adapters."""
    _, jparams = _flax_lora(J_SERVE, seed=0, b_scale=0.0)
    tparams = params_from_jax(jparams, device="cpu")
    return jparams, tparams, _random_adapters(tparams, 3, seed=100)


def test_stack_adapters_matches_jax(serve_lora):
    jparams, tparams, ads = serve_lora
    want = _flatten(j_stack_adapters([_nest(a) for a in ads]))
    got = stack_adapters([_torch(a) for a in ads])
    assert list(got) == sorted(got) == sorted(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name])
    # Full param dicts stack their adapter entries only.
    full = stack_adapters([tparams, tparams])
    assert set(full) == set(got)
    assert full["layer_1.mlp.w_up.lora_a"].shape == (2, 64, RANK)
    with pytest.raises(ValueError):
        stack_adapters([])
    with pytest.raises(ValueError, match="no lora_a"):
        stack_adapters([{"tok_embed": torch.zeros(2, 2)}])


def test_banked_prefill_and_decode_match_jax(serve_lora):
    jparams, tparams, ads = serve_lora
    jbanks = j_stack_adapters([_nest(a) for a in ads[:2]])
    tbanks = stack_adapters([_torch(a) for a in ads[:2]])
    toks = np.concatenate([_tokens(11, 14), _tokens(12, 14)])
    t0, slots = 6, 4
    kw = dict(num_layers=J_SERVE.num_layers,
              num_kv_heads=J_SERVE.num_kv_heads, head_dim=J_SERVE.head_dim,
              slots=slots, page_size=4, max_len=32)
    mesh = mesh_1d()
    jcache = JPagedKVCache(JCacheConfig(**kw), cache_sharding(mesh))
    tcache = PagedKVCache(CacheConfig(**kw), device="cpu")
    for slot in (0, 1):
        jl, jk, jv = j_prefill_forward(
            jparams, J_SERVE, jnp.asarray(toks[slot:slot + 1, :t0]),
            adapters=jbanks, adapter_id=slot)
        tl, tk, tv = prefill_forward(
            tparams, LLAMA_SERVE, torch.from_numpy(toks[slot:slot + 1, :t0])
            .long(), adapters=tbanks, adapter_id=slot)
        _close(tl.numpy(), jl, f"banked prefill, adapter {slot}")
        jcache.write_prefill(slot, jk[:, 0], jv[:, 0])
        tcache.write_prefill(slot, tk[:, 0], tv[:, 0])
    jstep = j_build_decode_step(J_SERVE, mesh, slots=slots, page_size=4,
                                pages_per_slot=8, with_lora=True)
    tstep = build_decode_step(LLAMA_SERVE, slots=slots, page_size=4,
                              pages_per_slot=8, with_lora=True)
    ids = np.array([0, 1, 0, 0], np.int32)
    active = np.array([True, True, False, False])
    for i in range(t0, toks.shape[1]):
        tok = np.zeros(slots, np.int32)
        tok[:2] = toks[:, i]
        for slot in (0, 1):
            jcache.reserve(slot, i + 1)
            tcache.reserve(slot, i + 1)
        jlog, jcache.k, jcache.v = jstep(
            jparams, jcache.k, jcache.v, jnp.asarray(tok),
            jcache.lengths_device(), jcache.table_device(),
            jnp.asarray(active), {"params": jbanks}, jnp.asarray(ids))
        tlog, tcache.k, tcache.v = tstep(
            tparams, tcache.k, tcache.v, torch.from_numpy(tok).long(),
            tcache.lengths_device().long(), tcache.table_device(),
            torch.from_numpy(active), tbanks, torch.from_numpy(ids))
        for slot in (0, 1):
            _close(tlog.numpy()[slot], np.asarray(jlog)[slot],
                   f"banked decode, slot {slot}")
            jcache.lengths[slot] += 1
            tcache.lengths[slot] += 1
    # A step built with_lora needs the banks, and only it takes them.
    with pytest.raises(ValueError, match="with_lora"):
        tstep(tparams, tcache.k, tcache.v, torch.from_numpy(tok).long(),
              tcache.lengths_device().long(), tcache.table_device(),
              torch.from_numpy(active))


def _lora_requests():
    return generate(LoadSpec(num_requests=6, rate_rps=200.0,
                             prompt_lens=(5, 11), output_lens=(6, 9),
                             vocab_size=256, num_adapters=3, seed=5))


def test_banked_engine_streams_match_jax_and_in_tree_engines(serve_lora):
    jparams, tparams, ads = serve_lora
    geom = dict(slots=4, page_size=8, max_len=64)
    jreqs = j_generate(JLoadSpec(num_requests=6, rate_rps=200.0,
                                 prompt_lens=(5, 11), output_lens=(6, 9),
                                 vocab_size=256, num_adapters=3, seed=5))
    JServingEngine(J_SERVE, jparams, mesh=mesh_1d(),
                   adapters=j_stack_adapters([_nest(a) for a in ads]),
                   **geom).serve(jreqs)
    treqs = _lora_requests()
    assert [r.adapter_id for r in treqs] == [0, 1, 2, 0, 1, 2]
    eng = ServingEngine(LLAMA_SERVE, tparams, device="cpu",
                        adapters=stack_adapters([_torch(a) for a in ads]),
                        **geom)
    rep = eng.serve(treqs)
    assert rep.completed == 6
    streams = {r.rid: r.tokens for r in treqs}
    assert streams == {r.rid: r.tokens for r in jreqs}
    # Each stream equals an engine serving that adapter from the tree,
    # bitwise: same slots, so every product has the same shape.
    for j, ad in enumerate(ads):
        ref = [r for r in _lora_requests() if r.adapter_id == j]
        for r in ref:
            r.adapter_id = 0
        flat = dict(tparams)
        flat.update(_torch(ad))
        ServingEngine(LLAMA_SERVE, flat, device="cpu", **geom).serve(ref)
        for r in ref:
            assert r.tokens == streams[r.rid], (j, r.rid)
    # Distinct adapters steer the shared base differently.
    same_prompt = generate(LoadSpec(num_requests=3, rate_rps=200.0,
                                    prompt_lens=(8,), output_lens=(8,),
                                    vocab_size=256, num_adapters=3, seed=6))
    for r in same_prompt:
        r.prompt = same_prompt[0].prompt.copy()
    ServingEngine(LLAMA_SERVE, tparams, device="cpu",
                  adapters=stack_adapters([_torch(a) for a in ads]),
                  **geom).serve(same_prompt)
    assert len({tuple(r.tokens) for r in same_prompt}) > 1


def test_engine_bank_refusals(serve_lora):
    _, tparams, ads = serve_lora
    banks = stack_adapters([_torch(a) for a in ads])
    for kw in (dict(spec_decode=True), dict(kv_compress=True),
               dict(prefix_cache=True)):
        with pytest.raises(NotImplementedError):
            ServingEngine(LLAMA_SERVE, tparams, device="cpu",
                          adapters=banks, **kw)
