"""PyTorch/CUDA port: model, prefill, decode step and engine vs the JAX
package, plus the package's import and device rules.

Weights come from the flax ``LlamaLM.init`` and are carried across with
``params_from_jax``; token inputs are made with numpy from a seed.  Both
packages run in f32 on the CPU; atol 1e-4 for logits (a dozen f32
matmuls deep, summed in another order), 1e-5 for K/V pools.
"""

import ast
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

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
from horovod_tpu_torch.models import (LLAMA3_8B, LLAMA_SERVE, LLAMA_TINY,
                                      LlamaLM, init_llama_params,
                                      params_from_jax)
from horovod_tpu_torch.models.transformer import param_shapes
from horovod_tpu_torch.ops import registry
from horovod_tpu_torch.serving import (CacheConfig, LoadSpec, PagedKVCache,
                                       ServingEngine, build_decode_step,
                                       generate, greedy_sample,
                                       prefill_forward)
from horovod_tpu_torch.timeline import spans

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
LOGIT_ATOL = 1e-4


def _flax_params(cfg, seed=0):
    model = JLlamaLM(cfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4),
                                                            jnp.int32))
    return model, params


@pytest.fixture(scope="module")
def serve_params():
    model, params = _flax_params(J_SERVE)
    return model, params, params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")


def _tokens(seed, t, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (1, t)).astype(
        np.int32)


def mesh_1d(n=1):
    return Mesh(np.asarray(jax.devices()[:n], dtype=object).reshape(n),
                ("tp",))


# ---------------------------------------------------------------------------
# 3. Weights carried across; LlamaLM logits vs flax apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "serve"])
def test_params_from_jax_and_llama_logits_match_flax(name):
    jcfg, tcfg = {"tiny": (J_TINY, LLAMA_TINY),
                  "serve": (J_SERVE, LLAMA_SERVE)}[name]
    model, params = _flax_params(jcfg, seed=3)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    # A rename: every flax leaf lands under its dotted path, same shape,
    # same bytes (Dense kernels stay [in, out]).
    assert set(tp) == set(param_shapes(tcfg))
    np.testing.assert_array_equal(
        tp["layer_1.attn.wq.kernel"].numpy(),
        np.asarray(params["params"]["layer_1"]["attn"]["wq"]["kernel"]))
    lm = LlamaLM(tcfg, device="cpu")
    lm.load_state_dict(tp)
    toks = _tokens(4, 12, tcfg.vocab_size)
    want = np.asarray(model.apply(params, jnp.asarray(toks)))
    got = lm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_llama_segment_positions_match_flax():
    model, params = _flax_params(J_TINY, seed=5)
    lm = LlamaLM(LLAMA_TINY, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"))
    toks = _tokens(6, 10)
    seg = np.array([[1] * 4 + [2] * 6], np.int32)
    want = np.asarray(model.apply(params, jnp.asarray(toks),
                                  segment_ids=jnp.asarray(seg)))
    got = lm(torch.from_numpy(toks).long(),
             segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_init_llama_params_mirrors_flax_initialisers():
    _, params = _flax_params(J_SERVE)
    flat = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got = init_llama_params(LLAMA_SERVE,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    assert got["final_norm.scale"].eq(1).all()
    # normal(0.02) embedding; lecun_normal kernels: std 1/sqrt(fan_in),
    # truncated at 2 sigma of the underlying normal.
    assert abs(got["tok_embed"].std().item() - 0.02) < 2e-3
    w = got["layer_0.mlp.w_down.kernel"]
    assert abs(w.std().item() - w.shape[0] ** -0.5) < 0.1 * w.shape[0] ** -0.5
    assert w.abs().max().item() <= 2 / 0.87962566103423978 * \
        w.shape[0] ** -0.5 + 1e-6
    again = init_llama_params(LLAMA_SERVE,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    bf = init_llama_params(LLAMA_SERVE, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert bf["layer_0.attn.wq.kernel"].dtype == torch.bfloat16
    assert bf["tok_embed"].dtype == torch.float32


def test_llama3_8b_config_is_the_public_one():
    c = LLAMA3_8B
    assert (c.num_layers, c.num_heads, c.num_kv_heads, c.head_dim,
            c.d_model, c.ffn_hidden, c.vocab_size, c.rope_theta) == (
        32, 32, 8, 128, 4096, 14336, 128256, 500000.0)
    n = sum(int(np.prod(s)) for s in param_shapes(c).values())
    # ~7.5B: the repo's LlamaLM ties the readout to the embedding, so the
    # public model's separate 0.53B output matrix is not there.
    assert 7.4e9 < n < 7.6e9


# ---------------------------------------------------------------------------
# 4. prefill_forward vs JAX, whole and chunked (past=)
# ---------------------------------------------------------------------------


def test_prefill_matches_jax_whole_and_with_past(serve_params):
    _, jparams, tparams = serve_params
    toks = _tokens(7, 20)
    jl, jk, jv = j_prefill_forward(jparams, J_SERVE, jnp.asarray(toks))
    tl, tk, tv = prefill_forward(tparams, LLAMA_SERVE,
                                 torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)

    # Chunk continuation: the last 8 tokens attend over past ++ chunk
    # (tq < tk through the attention), positions continue at 12.
    _, jk0, jv0 = j_prefill_forward(jparams, J_SERVE,
                                    jnp.asarray(toks[:, :12]))
    jl1, jk1, jv1 = j_prefill_forward(jparams, J_SERVE,
                                      jnp.asarray(toks[:, 12:]),
                                      past=(jk0, jv0))
    _, tk0, tv0 = prefill_forward(tparams, LLAMA_SERVE,
                                  torch.from_numpy(toks[:, :12]).long())
    tl1, tk1, tv1 = prefill_forward(tparams, LLAMA_SERVE,
                                    torch.from_numpy(toks[:, 12:]).long(),
                                    past=(tk0, tv0))
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(tk1.numpy(), np.asarray(jk1), atol=1e-5)
    np.testing.assert_allclose(tv1.numpy(), np.asarray(jv1), atol=1e-5)
    # ...and the chunk's rows equal the whole prompt's.
    np.testing.assert_allclose(tl1.numpy(), tl[:, 12:].numpy(),
                               atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# 5. Decode step + paged pools vs JAX build_decode_step (tp=1 mesh)
# ---------------------------------------------------------------------------


def test_decode_step_and_pools_match_jax(serve_params):
    _, jparams, tparams = serve_params
    kw = dict(num_layers=J_SERVE.num_layers,
              num_kv_heads=J_SERVE.num_kv_heads, head_dim=J_SERVE.head_dim,
              slots=3, page_size=4, max_len=32)
    mesh = mesh_1d(1)
    jcache = JPagedKVCache(JCacheConfig(**kw), cache_sharding(mesh))
    tcache = PagedKVCache(CacheConfig(**kw), device="cpu")
    assert tcache.layout() == jcache.layout()
    jstep = j_build_decode_step(J_SERVE, mesh, slots=3, page_size=4,
                                pages_per_slot=8)
    tstep = build_decode_step(LLAMA_SERVE, slots=3, page_size=4,
                              pages_per_slot=8)
    # Slots 0 and 2 hold prompts of different lengths; slot 1 stays idle.
    seqs = {0: _tokens(8, 14)[0], 2: _tokens(9, 22)[0]}
    for slot, seq in seqs.items():
        _, jk, jv = j_prefill_forward(jparams, J_SERVE,
                                      jnp.asarray(seq[None, :6]))
        jcache.write_prefill(slot, jk[:, 0], jv[:, 0])
        _, tk, tv = prefill_forward(tparams, LLAMA_SERVE,
                                    torch.from_numpy(seq[None, :6]).long())
        tcache.write_prefill(slot, tk[:, 0], tv[:, 0])
    active = np.array([True, False, True])
    for i in range(6, 12):      # teacher-forced; crosses a page boundary
        tok = np.zeros(3, np.int32)
        for slot, seq in seqs.items():
            tok[slot] = seq[i]
            jcache.reserve(slot, i + 1)
            tcache.reserve(slot, i + 1)
        np.testing.assert_array_equal(tcache.page_table, jcache.page_table)
        jl, jcache.k, jcache.v = jstep(
            jparams, jcache.k, jcache.v, jnp.asarray(tok),
            jcache.lengths_device(), jcache.table_device(),
            jnp.asarray(active))
        tl, tcache.k, tcache.v = tstep(
            tparams, tcache.k, tcache.v, torch.from_numpy(tok).long(),
            tcache.lengths_device().long(), tcache.table_device(),
            torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=LOGIT_ATOL)
        for slot in seqs:
            jcache.lengths[slot] += 1
            tcache.lengths[slot] += 1
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               atol=1e-5)


def test_decode_step_refuses_later_slices():
    # LoRA banks, the verify width, fp8 pages and tp > 1 are ported; LoRA
    # banks at tp > 1 and banks at width > 1 raise, as in the reference.
    tp2 = SimpleNamespace(axis_names=("tp",), shape={"tp": 2})
    for mesh, kw in ((tp2, dict(with_lora=True)),
                     (None, dict(with_lora=True, width=3))):
        with pytest.raises(NotImplementedError):
            build_decode_step(LLAMA_SERVE, mesh, slots=2, page_size=4,
                              pages_per_slot=2, **kw)
    with pytest.raises(ValueError, match="width"):
        build_decode_step(LLAMA_SERVE, slots=2, page_size=4,
                          pages_per_slot=2, width=0)
    for kw in (dict(with_lora=True), dict(width=3), dict(compress=True),
               dict(compress=True, width=3)):
        build_decode_step(LLAMA_SERVE, slots=2, page_size=4,
                          pages_per_slot=2, **kw)


def test_kvcache_accounting_and_explicit_copies():
    cache = PagedKVCache(CacheConfig(num_layers=1, num_kv_heads=2,
                                     head_dim=4, slots=2, page_size=4,
                                     max_len=8), device="cpu")
    assert cache.free_pages == 4 and cache.can_admit(16)
    cache.reserve(0, 5)
    assert cache.allocated_pages == 2 and not cache.can_admit(12)
    table, lengths = cache.table_device(), cache.lengths_device()
    cache.page_table[0, 0] = 3      # host update after the copy...
    cache.lengths[0] = 5
    assert table[0, 0].item() == 0 and lengths[0].item() == 0  # ...unseen
    cache.reserve(1, 8)
    assert cache.free_pages == 0 and not cache.can_admit(1)
    with pytest.raises(ValueError, match="exceeds max_len"):
        cache.reserve(1, 9)
    cache.free_slot(0)
    assert cache.free_pages == 2 and cache.lengths[0] == 0
    assert cache.refcounts_balanced()
    # fp8 cold pages are ported: the e4m3 pools sit beside the pools.
    fp8 = PagedKVCache(CacheConfig(num_layers=1, num_kv_heads=1, head_dim=4,
                                   slots=1, page_size=4, max_len=8,
                                   compress=True), device="cpu")
    assert fp8.kq.dtype == torch.float8_e4m3fn
    assert fp8.kq.shape == fp8.k.shape and fp8.compressed_pages == 0


# ---------------------------------------------------------------------------
# 6. The whole serve() vs the JAX engine
# ---------------------------------------------------------------------------


def test_engine_token_streams_match_jax(serve_params):
    _, jparams, tparams = serve_params
    spec_kw = dict(num_requests=6, rate_rps=100.0, prompt_lens=(5, 11),
                   output_lens=(4, 7), vocab_size=256, seed=3)
    jreqs = j_generate(JLoadSpec(**spec_kw))
    treqs = generate(LoadSpec(**spec_kw))
    # Byte-identical request streams from the two load generators.
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.arrival_s, a.max_new_tokens) == (b.arrival_s,
                                                   b.max_new_tokens)
    geom = dict(slots=3, page_size=4, max_len=32)
    jrep = JServingEngine(J_SERVE, jparams, mesh=mesh_1d(1),
                          **geom).serve(jreqs)
    registry.reset_launch_counts()
    spans.recorder().reset()
    teng = ServingEngine(LLAMA_SERVE, tparams, device="cpu", **geom)
    trep = teng.serve(treqs)
    # One span per prefill and per decode step, booked under its leg.
    legs = spans.recorder().legs()
    assert legs["serving_prefill"]["count"] == trep.prefills
    assert legs["serving_decode"]["count"] == trep.decode_steps
    for a, b in zip(sorted(jreqs, key=lambda r: r.rid),
                    sorted(treqs, key=lambda r: r.rid)):
        assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)
    assert (trep.completed, trep.rejected, trep.new_tokens) == (
        jrep.completed, jrep.rejected, jrep.new_tokens)
    assert trep.prefills == trep.completed
    assert teng.cache.release_all() == 0 and teng.cache.refcounts_balanced()
    # The CPU path is the plain version: no kernel launch is counted.
    assert not any(registry.launch_counts().values())


def test_engine_rejects_oversize_and_refuses_later_slices(serve_params,
                                                           monkeypatch):
    _, _, tparams = serve_params
    eng = ServingEngine(LLAMA_SERVE, tparams, device="cpu", slots=2,
                        page_size=4, max_len=16)
    reqs = generate(LoadSpec(num_requests=2, prompt_lens=(4, 14),
                             prompt_weights=(1.0, 0.0), output_lens=(3,),
                             seed=1))
    reqs[1].prompt = np.arange(14, dtype=np.int32)   # 14 + 3 > 16
    rep = eng.serve(reqs)
    assert rep.completed == 1 and rep.rejected == 1
    # Speculative decoding, LoRA banks, chunked prefill, fp8 pages and
    # the prefix cache are ported (their own test files); banks refuse
    # speculation, fp8 pages and the prefix cache as the reference does,
    # and chunked prefill besides.
    for kw in (dict(prefill_chunk=8), dict(kv_compress=True),
               dict(prefix_cache=True)):
        ServingEngine(LLAMA_SERVE, tparams, device="cpu", **kw)
    for kw in (dict(spec_decode=True), dict(kv_compress=True),
               dict(prefix_cache=True), dict(prefill_chunk=8)):
        with pytest.raises(NotImplementedError):
            ServingEngine(LLAMA_SERVE, tparams, device="cpu", adapters={},
                          **kw)
    monkeypatch.setenv("HOROVOD_PREFILL_CHUNK", "8")
    with pytest.raises(NotImplementedError):
        ServingEngine(LLAMA_SERVE, tparams, device="cpu", adapters={})
    assert ServingEngine(LLAMA_SERVE, tparams, device="cpu"
                         ).prefill_chunk == 8
    monkeypatch.delenv("HOROVOD_PREFILL_CHUNK")
    monkeypatch.setenv("HVD_TPU_SERVING_SLOTS", "3")
    monkeypatch.setenv("HOROVOD_SERVING_SLOTS", "5")
    monkeypatch.setenv("HOROVOD_SERVING_PAGE_SIZE", "4")
    monkeypatch.setenv("HOROVOD_SERVING_MAX_LEN", "32")
    eng = ServingEngine(LLAMA_SERVE, tparams, device="cpu")
    assert (eng.slots, eng.page_size, eng.max_len) == (3, 4, 32)


def test_greedy_sample_first_index_on_ties():
    logits = torch.tensor([[0.0, 2.0, 2.0], [5.0, 1.0, 5.0]])
    assert greedy_sample(logits).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)
                      ).tolist() == [1, 0]


# ---------------------------------------------------------------------------
# 7. Import hygiene: no JAX, nothing of horovod_tpu
# ---------------------------------------------------------------------------


# The port's root scripts: run on the GPU machine, which has no JAX.
ROOT_SCRIPTS = ("chip_smoke", "profile_torch_serving",
                "profile_torch_training", "profile_torch_decode")


def _package_modules():
    """Every module of the package, then the port's root scripts."""
    mods = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods) + list(ROOT_SCRIPTS)


# The shims whose import needs TensorFlow, which itself imports JAX where
# JAX is installed (``tensorflow/lite/python/util.py``).
TF_BOUND = ("horovod_tpu_torch.tensorflow", "horovod_tpu_torch.keras")


def test_import_leaves_no_jax_and_no_reference_package():
    """Importing every module of the package and every root script of
    the port (their ``main()`` runs only as ``__main__``) loads nothing
    of JAX and nothing of ``horovod_tpu``.  The TensorFlow and Keras
    shims come last, after ``tensorflow`` and ``keras`` themselves, and
    may add nothing of JAX or ``horovod_tpu`` to what those loaded (their
    source imports neither: ``test_ast_scan_finds_no_jax_or_reference_
    import``)."""
    assert all(os.path.exists(os.path.join(REPO, f"{m}.py"))
               for m in ROOT_SCRIPTS)
    mods = _package_modules()
    code = (
        "import importlib, importlib.util, sys\n"
        "def bad(names):\n"
        "    return sorted(m for m in names if m == 'jax' or "
        "m.startswith(('jax.', 'flax', 'horovod_tpu.')) or "
        "m == 'horovod_tpu')\n"
        f"mods, tf_bound = {mods!r}, {TF_BOUND!r}\n"
        "for m in mods:\n"
        "    if not m.startswith(tf_bound):\n"
        "        importlib.import_module(m)\n"
        "print(len(sys.modules)); assert not bad(sys.modules), "
        "bad(sys.modules)\n"
        "if importlib.util.find_spec('tensorflow'):\n"
        "    import tensorflow, keras\n"
        "    before = set(sys.modules)\n"
        "    for m in mods:\n"
        "        if m.startswith(tf_bound):\n"
        "            importlib.import_module(m)\n"
        "    added = bad(set(sys.modules) - before)\n"
        "    assert not added, added\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_ast_scan_finds_no_jax_or_reference_import():
    bad = []
    for mod in _package_modules():
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "flax", "jaxlib", "horovod_tpu"):
                    bad.append((path, n))
    assert not bad, bad


# ---------------------------------------------------------------------------
# 8. Device rules: the GPU unless the CPU is asked for, never silently
# ---------------------------------------------------------------------------


def test_entry_points_raise_without_cuda(serve_params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, _, tparams = serve_params
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_llama_params(LLAMA_SERVE, generator=gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(LLAMA_SERVE, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaLM(LLAMA_SERVE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"tok_embed": np.zeros((2, 2), np.float32)})
