"""PyTorch/CUDA port: the rest of the serving plane at tp = 1 -- chunked
prefill, refcounted copy-on-write pages, fp8 cold pages and the decode
step over them, the radix prefix cache and the engine knobs that drive
them -- against the JAX package.

Weights come from the flax ``LlamaLM.init`` of ``LLAMA_SERVE`` (a
``LLAMA_TINY``-width config: 2 layers, 8 heads of 16) and are carried
across with ``params_from_jax``; tokens and K/V inputs come from numpy
seeds.  Both packages run in f32 on the CPU.  Tolerances: K/V 1e-5,
logits 1e-4 (a dozen f32 matmuls deep, summed in another order), the
compressed decode step 1e-5 of max |logit|; the e4m3 pools, scales,
page tables and refcounts bitwise; token streams token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.controller import fusion as j_fusion
from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
from horovod_tpu.serving import CacheConfig as JCacheConfig
from horovod_tpu.serving import LoadSpec as JLoadSpec
from horovod_tpu.serving import PagedKVCache as JPagedKVCache
from horovod_tpu.serving import PrefixCache as JPrefixCache
from horovod_tpu.serving import ServingEngine as JServingEngine
from horovod_tpu.serving import build_decode_step as j_build_decode_step
from horovod_tpu.serving import generate as j_generate
from horovod_tpu.serving import prefill_forward as j_prefill_forward
from horovod_tpu.serving import prefix_spec as j_prefix_spec
from horovod_tpu.serving.kvcache import _quantize_pages as j_quantize_pages
from horovod_tpu_torch.models import LLAMA_SERVE, params_from_jax
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import registry
from horovod_tpu_torch.serving import (CacheConfig, LoadSpec, PagedKVCache,
                                       PrefixCache, ServingControlPlane,
                                       ServingEngine, build_decode_step,
                                       build_verify_step, generate,
                                       prefill_forward, prefix_spec)
from horovod_tpu_torch.serving.kvcache import _quantize_pages
from horovod_tpu_torch.timeline import spans
from horovod_tpu_torch.timeline.metrics import render_prometheus

torch.set_num_threads(2)

CFG = LLAMA_SERVE
L, H, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
STEP_REL = 1e-5


def mesh_1d():
    return Mesh(np.asarray(jax.devices()[:1], dtype=object).reshape(1),
                ("tp",))


@pytest.fixture(autouse=True)
def _fresh_jax_executables():
    """The JAX decode step caches its executable by plan fingerprint: a
    step built over a tree without LoRA leaves would take this file's
    LoRA tree with its own ``in_specs``.  Start each test empty."""
    j_fusion.clear_plan_cache()


@pytest.fixture(scope="module")
def params():
    model = JLlamaLM(J_SERVE, dtype=jnp.float32)
    jp = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, t, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (1, t)).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _caches(compress=False, slots=4, page_size=8, max_len=64,
            dtype="float32", layers=L, heads=H, head_dim=D):
    kw = dict(num_layers=layers, num_kv_heads=heads, head_dim=head_dim,
              slots=slots, page_size=page_size, max_len=max_len,
              dtype=dtype, compress=compress)
    return (JPagedKVCache(JCacheConfig(**kw)),
            PagedKVCache(CacheConfig(**kw), device="cpu"))


def _bits(x):
    """Any pool, JAX or torch, as raw bytes."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _same_host_state(jc, tc):
    np.testing.assert_array_equal(tc.page_table, jc.page_table)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    np.testing.assert_array_equal(tc._refcount, jc._refcount)
    assert tc._free == jc._free
    if jc.compress:
        np.testing.assert_array_equal(tc.cpage_table, jc.cpage_table)
        np.testing.assert_array_equal(tc.comp_mask, jc.comp_mask)
        np.testing.assert_array_equal(tc._crefcount, jc._crefcount)
        assert tc._cfree == jc._cfree
        assert tc.compressed_pages == jc.compressed_pages
    assert (tc.free_pages, tc.live_pages, tc.allocated_pages) == (
        jc.free_pages, jc.live_pages, jc.allocated_pages)


def _same_pools(jc, tc):
    names = ("k", "v", "kq", "vq", "kscale", "vscale") if jc.compress \
        else ("k", "v")
    for n in names:
        assert _bits(getattr(tc, n)) == _bits(getattr(jc, n)), n


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [5, 8])
def test_chunked_prefill_matches_whole_and_jax(params, chunk):
    jp, tp = params
    toks = _tokens(9, 24)
    wl, wk, wv = prefill_forward(tp, CFG, _t(toks).long())
    past = jpast = None
    for lo in range(0, 24, chunk):
        logits, kl, vl = prefill_forward(tp, CFG,
                                         _t(toks[:, lo:lo + chunk]).long(),
                                         past=past)
        jl, jk, jv = j_prefill_forward(jp, J_SERVE,
                                       jnp.asarray(toks[:, lo:lo + chunk]),
                                       past=jpast)
        past, jpast = (kl, vl), (jk, jv)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(kl.numpy(), np.asarray(jk), atol=KV_ATOL)
        np.testing.assert_allclose(vl.numpy(), np.asarray(jv), atol=KV_ATOL)
    # Each chunk returns the full context's K/V: the last covers the
    # whole prompt, and its rows' logits are the whole prompt's.
    np.testing.assert_allclose(kl.numpy(), wk.numpy(), atol=KV_ATOL)
    np.testing.assert_allclose(vl.numpy(), wv.numpy(), atol=KV_ATOL)
    tail = 24 - (24 - 1) // chunk * chunk
    np.testing.assert_allclose(logits.numpy(), wl[:, -tail:].numpy(),
                               atol=LOGIT_ATOL)


def _load(seed=13, n=4, prompts=(24, 40), outs=(4, 6), rate=100.0):
    kw = dict(num_requests=n, rate_rps=rate, prompt_lens=prompts,
              output_lens=outs, vocab_size=256, seed=seed)
    return j_generate(JLoadSpec(**kw)), generate(LoadSpec(**kw))


def _streams(reqs):
    return {r.rid: tuple(r.tokens) for r in reqs}


def test_engine_chunked_streams_match_whole_and_jax(params):
    jp, tp = params
    geom = dict(slots=2, page_size=8, max_len=64)
    jreqs, treqs = _load()
    JServingEngine(J_SERVE, jp, mesh=mesh_1d(), prefill_chunk=8,
                   **geom).serve(jreqs)
    _, whole = _load()
    wrep = ServingEngine(CFG, tp, device="cpu", **geom).serve(whole)
    spans.recorder().reset()
    eng = ServingEngine(CFG, tp, device="cpu", prefill_chunk=8, **geom)
    rep = eng.serve(treqs)
    assert rep.completed == 4
    assert _streams(treqs) == _streams(whole) == _streams(jreqs)
    # Every admission chunked: 24 tokens in 3 chunks, 40 in 5.
    want_chunks = sum(-(-r.prompt_len // 8) for r in treqs)
    assert rep.prefill_chunks == rep.prefill_forwards == want_chunks
    assert wrep.prefill_forwards == wrep.prefills == 4
    assert spans.recorder().legs()["serving_prefill_chunk"]["count"] == \
        want_chunks
    assert eng.cache.release_all() == 0 and eng.cache.refcounts_balanced()


def test_engine_chunk_gets_lora_alpha_and_banks_refuse_chunking(
        params, monkeypatch):
    """In-tree adapters at ``lora_alpha=8``: the chunked engine's streams
    equal the whole-prompt engine's and the JAX whole-prompt engine's (a
    chunk forward that fell back to alpha 16, as the reference's chunk
    path does, would not).  Banks refuse chunking, by argument and by
    ``HOROVOD_PREFILL_CHUNK``."""
    model = JLlamaLM(J_SERVE, dtype=jnp.float32, lora_rank=4)
    jp = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.RandomState(51)

    def walk(tree):
        return {k: ((0.05 * rng.randn(*v.shape)).astype(np.float32)
                    if k == "lora_b" else
                    walk(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    jp = walk(jp)
    tp = params_from_jax(jp, device="cpu")
    geom = dict(slots=2, page_size=8, max_len=64, lora_alpha=8.0)
    jreqs, treqs = _load(seed=14)
    JServingEngine(J_SERVE, jax.tree.map(jnp.asarray, jp), mesh=mesh_1d(),
                   **geom).serve(jreqs)
    eng = ServingEngine(CFG, tp, device="cpu", prefill_chunk=8, **geom)
    rep = eng.serve(treqs)
    assert rep.prefill_chunks > 0
    assert _streams(treqs) == _streams(jreqs)
    # The chunk forward applies the engine's alpha, not 16.
    toks = _t(_tokens(3, 12)).long()
    _, kl, vl = prefill_forward(tp, CFG, toks[:, :8], lora_alpha=8.0)
    got = eng._prefill(toks[:, 8:], None, past=(kl, vl))[0]
    want = prefill_forward(tp, CFG, toks[:, 8:], past=(kl, vl),
                           lora_alpha=8.0)[0]
    at16 = prefill_forward(tp, CFG, toks[:, 8:], past=(kl, vl))[0]
    assert torch.equal(got, want) and not torch.allclose(got, at16)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(CFG, tp, device="cpu", adapters={}, prefill_chunk=8)
    monkeypatch.setenv("HOROVOD_PREFILL_CHUNK", "8")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        ServingEngine(CFG, tp, device="cpu", adapters={})


# ---------------------------------------------------------------------------
# Refcounted pages, copy-on-write
# ---------------------------------------------------------------------------


def test_shared_prefix_page_read_bitwise_and_cow_isolation(params):
    """A slot reading shared prefix pages decodes bitwise as a slot
    reading private copies of the same bytes, and a copy-on-write
    divergence never changes the shared pages."""
    _, tp = params
    _, cache = _caches(slots=4, page_size=8, max_len=64)
    step = build_decode_step(CFG, slots=4, page_size=8, pages_per_slot=8)
    pc = PrefixCache(cache)
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, 256, (1, 16))
    p1 = np.concatenate([prefix, rng.randint(0, 256, (1, 4))], 1)
    p2 = np.concatenate([prefix, rng.randint(0, 256, (1, 4))], 1)
    _, kl, vl = prefill_forward(tp, CFG, _t(p1).long())
    cache.write_prefill(0, kl[:, 0], vl[:, 0])
    assert pc.insert(p1[0], 0) == 2
    matched, entries = pc.match(p2[0])
    assert matched == 16 and [k for k, _ in entries] == ["f", "f"]
    cache.attach_pages(1, entries, matched)
    shared = [int(p) for _, p in entries]
    np.testing.assert_array_equal(cache.page_table[1, :2],
                                  cache.page_table[0, :2])
    past = cache.gather_pages(entries)
    _, kl2, vl2 = prefill_forward(tp, CFG, _t(p2[:, 16:]).long(), past=past)
    cache.write_prefill(1, kl2[:, 0, 16:], vl2[:, 0, 16:], start=16)
    # Slot 3: the same bytes in private pages (forced clone).
    cache.attach_pages(3, entries, matched)
    cache.write_prefill(3, kl2[:, 0, 16:], vl2[:, 0, 16:], start=16)
    cache.reserve(3, 20, writable_from=0)
    assert all(int(cache.page_table[3, i]) not in shared for i in range(2))
    # Slot 2: diverges from position 0 over the shared pages.
    orig_k, orig_v = cache.k[:, shared].clone(), cache.v[:, shared].clone()
    cache.attach_pages(2, entries, matched)
    _, klo, vlo = prefill_forward(tp, CFG, _t(_tokens(5, 20)).long())
    cache.write_prefill(2, klo[:, 0], vlo[:, 0])
    assert all(int(cache.page_table[2, i]) not in shared for i in range(2))
    assert torch.equal(cache.k[:, shared], orig_k)
    assert torch.equal(cache.v[:, shared], orig_v)

    def decode(slot, seq, t0, t1):
        out = []
        for i in range(t0, t1):
            cache.reserve(slot, i + 1, writable_from=i)
            tok = torch.zeros(4, dtype=torch.long)
            tok[slot] = int(seq[i])
            active = torch.zeros(4, dtype=torch.bool)
            active[slot] = True
            logits, cache.k, cache.v = step(
                tp, cache.k, cache.v, tok, cache.lengths_device().long(),
                cache.table_device(), active)
            cache.lengths[slot] += 1
            out.append(logits[slot])
        return torch.stack(out)

    seq = np.concatenate([p2[0], p2[0, :6]])
    assert torch.equal(decode(1, seq, 20, 26), decode(3, seq, 20, 26))
    for s in range(4):
        cache.free_slot(s)
    pc.drop_all()
    assert cache.live_pages == 0 and cache.refcounts_balanced()


def test_refcounts_attach_adopt_and_errors_match_jax():
    jc, tc = _caches(slots=3, page_size=4, max_len=16)
    rng = np.random.RandomState(4)
    k = rng.randn(L, 10, H, D).astype(np.float32)
    v = rng.randn(L, 10, H, D).astype(np.float32)
    for c, conv in ((jc, jnp.asarray), (tc, _t)):
        c.write_prefill(0, conv(k), conv(v))
        c.attach_pages(1, [("f", int(c.page_table[0, 0])),
                           ("f", int(c.page_table[0, 1]))], 8)
        c.add_page_ref(int(c.page_table[0, 0]))
        c.drop_page_ref(int(c.page_table[0, 0]))
        c.reserve(1, 9, writable_from=4)      # clones page 1 of slot 1
    _same_host_state(jc, tc)
    _same_pools(jc, tc)
    pages = k[:, :8].reshape(L, 2, 4, H, D)
    assert tc.adopt_pages(_t(pages), _t(pages)) == \
        jc.adopt_pages(pages, pages)
    _same_host_state(jc, tc)
    _same_pools(jc, tc)
    for got, want in zip(tc.gather_pages([("f", 2), ("f", 5)]),
                         jc.gather_pages([("f", 2), ("f", 5)])):
        assert _bits(got) == _bits(want)
    with pytest.raises(RuntimeError, match="not empty"):
        tc.attach_pages(0, [("f", 3)], 4)
    with pytest.raises(ValueError, match="cannot back"):
        tc.attach_pages(2, [("f", 3)], 5)
    with pytest.raises(RuntimeError, match="compress=False"):
        tc.attach_pages(2, [("c", 3)], 4)
    for c in (jc, tc):
        for s in range(3):
            c.free_slot(s)
    assert tc.live_pages == jc.live_pages == 2     # the adopted pages


# ---------------------------------------------------------------------------
# fp8 cold pages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_cold_demote_and_quantize_bitwise_jax(dtype):
    """``_quantize_pages``, ``compress_cold`` and ``demote_page`` leave
    e4m3 pools, scales, page tables, masks, free lists and refcounts
    bitwise the JAX cache's; an all-zero row gets scale 1."""
    jc, tc = _caches(compress=True, slots=3, page_size=4, max_len=24,
                     dtype=dtype)
    rng = np.random.RandomState(8)
    k = (3.0 * rng.randn(L, 17, H, D)).astype(np.float32)
    v = rng.randn(L, 17, H, D).astype(np.float32)
    k[:, 2] = 0.0                               # one all-zero row
    for c, conv in ((jc, jnp.asarray), (tc, _t)):
        c.write_prefill(0, conv(k), conv(v))
        c.write_prefill(1, conv(v[:, :9]), conv(k[:, :9]))
    pids = np.asarray([0, 2, 5], np.int32)
    for pool in ("k", "v"):
        jq, js = j_quantize_pages(getattr(jc, pool), jnp.asarray(pids))
        tq, ts = _quantize_pages(getattr(tc, pool), _t(pids).long())
        assert _bits(tq) == _bits(jq) and _bits(ts) == _bits(js)
    # 4 full pages, 1 hot: 3 cold; at most 2 now, then the rest.
    assert tc.compress_cold(0, max_pages=2) == jc.compress_cold(
        0, max_pages=2) == 2
    assert tc.compress_cold(0) == jc.compress_cold(0) == 1
    assert tc.compress_cold(1) == jc.compress_cold(1) == 1
    assert float(tc.kscale[0, int(tc.cpage_table[0, 0]), 2]) == 1.0
    _same_host_state(jc, tc)
    _same_pools(jc, tc)
    assert tc.resident_bytes == jc.resident_bytes
    assert tc.demote_page(int(tc.page_table[0, 3])) == \
        jc.demote_page(int(jc.page_table[0, 3]))
    _same_host_state(jc, tc)
    _same_pools(jc, tc)
    # Reads of a compressed page dequantize as the JAX gather does.
    entries = [("c", int(tc.cpage_table[0, 0])),
               ("f", int(tc.page_table[0, 3]))]
    for got, want in zip(tc.gather_pages(entries), jc.gather_pages(entries)):
        assert _bits(got) == _bits(want)
    for c in (jc, tc):
        c.free_slot(0)
        c.free_slot(1)
    _same_host_state(jc, tc)


def test_admission_prices_cold_pages_and_reclaims_like_jax():
    """With compression, ``can_admit`` counts cold pages as free and
    ``reserve`` compresses other slots' cold pages on demand."""
    jc, tc = _caches(compress=True, slots=2, page_size=4, max_len=32)
    rng = np.random.RandomState(2)
    k = rng.randn(L, 30, H, D).astype(np.float32)
    for c, conv in ((jc, jnp.asarray), (tc, _t)):
        c.write_prefill(0, conv(k), conv(k))
        c.write_prefill(1, conv(k[:, :20]), conv(k[:, :20]))
    for n in (4, 16, 24, 40):
        assert tc.can_admit(n) == jc.can_admit(n), n
    for c in (jc, tc):
        c.free_slot(1)
        c.reserve(1, 32)           # 8 pages, 6 free: reclaims slot 0's
    _same_host_state(jc, tc)
    _same_pools(jc, tc)
    with pytest.raises(ValueError, match="hot_pages"):
        CacheConfig(num_layers=1, num_kv_heads=1, head_dim=4, slots=1,
                    page_size=4, max_len=8, hot_pages=-1)


def _cold_pool(slots=4, ps=8, pps=8, seed=21):
    """A compress=True pool with half the live full pages compressed and
    their old pages poisoned; returns the fp8 operands, the table, the
    lengths and a pool with the dequantised rows at the old pages."""
    rng = np.random.RandomState(seed)
    c = PagedKVCache(CacheConfig(num_layers=1, num_kv_heads=2, head_dim=8,
                                 slots=slots, page_size=ps,
                                 max_len=ps * pps, compress=True,
                                 hot_pages=0), device="cpu")
    lengths = [0, 9, 33, 64][:slots]
    for s, n in enumerate(lengths):
        if n:
            kv = _t(rng.randn(1, n, 2, 8).astype(np.float32))
            c.write_prefill(s, kv, 2.0 * kv)
    deq_k, deq_v = c.k.clone(), c.v.clone()
    table = c.page_table.copy()
    for s, n in enumerate(lengths):
        for i in range(0, n // ps, 2):
            pid = int(c.page_table[s, i])
            cp = c.demote_page(pid)
            c.cpage_table[s, i], c.comp_mask[s, i] = cp, True
            deq_k[:, pid] = c.dequantized("k", [cp])[:, 0]
            deq_v[:, pid] = c.dequantized("v", [cp])[:, 0]
            c.page_table[s, i] = c.config.scratch_page
    c.k[:, c.config.scratch_page] = 1e9
    c.v[:, c.config.scratch_page] = -1e9
    return c, table, torch.tensor(lengths, dtype=torch.int32), deq_k, deq_v


def test_fp8_decode_plain_version_is_decode_on_the_blended_pool():
    """On the CPU the e4m3 wrapper is its plain version: bitwise the
    plain paged decode over a pool holding the dequantised rows at the
    old pages, with the scratch page (where compressed entries point)
    full of garbage; no launch is counted."""
    c, table, lengths, deq_k, deq_v = _cold_pool()
    q = _t(np.random.RandomState(3).randn(4, 4, 1, 8).astype(np.float32))
    registry.reset_launch_counts()
    got = tattn.paged_decode_attention_fp8(
        q, c.k[0], c.v[0], c.table_device(), lengths, c.kq[0], c.vq[0],
        c.kscale[0], c.vscale[0], c.ctable_device(), c.cmask_device())
    want = tattn.paged_decode_attention(q, deq_k[0], deq_v[0], _t(table),
                                        lengths)
    assert torch.equal(got, want) and got[0].abs().max().item() == 0.0
    assert not any(registry.launch_counts().values())
    assert c.comp_mask.any()


def _compressed_step_case(jp, tp, ps=4, max_len=32, prompt_len=12):
    """Both caches hold the JAX prefill's K/V of one ``prompt_len``-token
    prompt in slot 0 with its 2 cold pages compressed; the next token's
    operands."""
    jc, tc = _caches(compress=True, slots=2, page_size=ps, max_len=max_len)
    prompt = _tokens(2, prompt_len)
    _, kl, vl = j_prefill_forward(jp, J_SERVE, jnp.asarray(prompt))
    jc.write_prefill(0, kl[:, 0], vl[:, 0])
    tc.write_prefill(0, _t(kl[:, 0]), _t(vl[:, 0]))
    assert tc.compress_cold(0) == jc.compress_cold(0) == 2
    assert (tc.page_table[0, :2] == tc.config.scratch_page).all()
    jc.reserve(0, prompt_len + 1)
    tc.reserve(0, prompt_len + 1)
    tok = np.zeros(2, np.int32)
    tok[0] = prompt[0, -1]
    active = np.array([True, False])
    return jc, tc, tok, active


def _check_compressed_step(jp, tp, ps=4, max_len=32, prompt_len=12):
    """The port's compressed decode step against the JAX step on
    :func:`_compressed_step_case`, then bitwise itself with every free
    page and the scratch page poisoned.  Returns the port's step and its
    operands."""
    jc, tc, tok, active = _compressed_step_case(jp, tp, ps, max_len,
                                                prompt_len)
    pps = max_len // ps
    jstep = j_build_decode_step(J_SERVE, mesh_1d(), slots=2, page_size=ps,
                                pages_per_slot=pps, compress=True)
    tstep = build_decode_step(CFG, slots=2, page_size=ps,
                              pages_per_slot=pps, compress=True)
    jl, jk, jv = jstep(jp, jc.k, jc.v, jnp.asarray(tok),
                       jc.lengths_device(), jc.table_device(),
                       jnp.asarray(active), *jc.compress_operands())
    args = (_t(tok).long(), tc.lengths_device().long(), tc.table_device(),
            _t(active), *tc.compress_operands())
    clean, tk, tv = tstep(tp, tc.k.clone(), tc.v.clone(), *args)
    want = np.asarray(jl)[0]
    assert np.abs(clean[0].numpy() - want).max() <= \
        STEP_REL * np.abs(want).max()
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=KV_ATOL)
    # Poison every free page and the scratch page with finite garbage:
    # the compressed slot reads the e4m3 pool, never them.
    bad = torch.tensor(tc._free + [tc.config.scratch_page])
    pk, pv = tc.k.clone(), tc.v.clone()
    pk[:, bad], pv[:, bad] = 1e9, 1e9
    dirty, _, _ = tstep(tp, pk, pv, *args)
    assert torch.equal(dirty[0], clean[0])
    return tstep, tc, args


def test_compressed_decode_step_matches_jax_and_survives_poisoning(params):
    jp, tp = params
    tstep, tc, args = _check_compressed_step(jp, tp)
    with pytest.raises(ValueError, match="compress_operands"):
        tstep(tp, tc.k, tc.v, *args[:4])


@pytest.mark.parametrize("ps,max_len", [(4, 32), (8, 64), (24, 96)])
def test_compressed_decode_step_matches_jax_at_page_size(params, ps,
                                                         max_len):
    """The same at page sizes that cut the decode kernel's 16-key tile
    differently: 4 and 8 (four and two pages a tile, compressed and plain
    mixed) and 24 (pages straddling tiles).  Three full pages, the last
    one hot, so two are compressed."""
    jp, tp = params
    _check_compressed_step(jp, tp, ps, max_len, prompt_len=3 * ps + 1)


def test_compressed_verify_step_columns_are_compressed_decode_steps(params):
    jp, tp = params
    _, tc, tok, active = _compressed_step_case(jp, tp)
    tc.reserve(0, 15)
    step = build_decode_step(CFG, slots=2, page_size=4, pages_per_slot=8,
                             compress=True)
    verify = build_verify_step(CFG, slots=2, width=3, page_size=4,
                               pages_per_slot=8, compress=True)
    toks = np.zeros((2, 3), np.int64)
    toks[0] = [tok[0], 7, 9]
    ops = tc.compress_operands()
    got, _, _ = verify(tp, tc.k.clone(), tc.v.clone(), _t(toks),
                       tc.lengths_device().long(), tc.table_device(),
                       _t(active), *ops)
    kp, vp = tc.k.clone(), tc.v.clone()
    pos = tc.lengths_device().long()
    for j in range(3):
        want, kp, vp = step(tp, kp, vp, _t(toks[:, j]), pos + j,
                            tc.table_device(), _t(active), *ops)
        assert torch.equal(got[0, j], want[0])


def _serve_pair(jp, tp, n=8, seed=3, **kw):
    geom = dict(slots=4, page_size=8, max_len=64)
    jreqs, treqs = _load(seed=seed, n=n, prompts=(4, 9, 16), outs=(5, 9),
                         rate=200.0)
    JServingEngine(J_SERVE, jp, mesh=mesh_1d(), **geom, **kw).serve(jreqs)
    eng = ServingEngine(CFG, tp, device="cpu", **geom, **kw)
    rep = eng.serve(treqs)
    assert rep.completed == n
    return _streams(jreqs), _streams(treqs), eng, rep


def test_engine_kv_compress_streams_match_plain_and_jax(params):
    jp, tp = params
    _, plain, _, _ = _serve_pair(jp, tp)
    jstreams, tstreams, eng, _ = _serve_pair(jp, tp, kv_compress=True)
    assert tstreams == plain == jstreams
    assert eng.cache.compress and eng.cache.refcounts_balanced()
    _, spec, _, rep = _serve_pair(jp, tp, kv_compress=True,
                                  spec_decode=True, spec_k=2)
    assert spec == plain and rep.spec_rounds > 0


class _ColdEngineMixin:
    """Compress every decode slot's cold pages before each step: page
    pressure on demand, so the steps read e4m3 pages."""

    def decode_once(self, st, now):
        for slot in self._decode_slots():
            self.cache.compress_cold(slot)
        return super().decode_once(st, now)


class _TColdEngine(_ColdEngineMixin, ServingEngine):
    pass


class _JColdEngine(_ColdEngineMixin, JServingEngine):
    pass


def test_engine_on_cold_pages_streams_match_jax(params):
    """Decode over compressed pages: the port's streams equal the JAX
    engine's under the same sweeps, token for token; every page comes
    back."""
    jp, tp = params
    geom = dict(slots=4, page_size=4, max_len=64, kv_compress=True)
    jreqs, treqs = _load(seed=5, n=6, prompts=(9, 17, 30), outs=(6, 12),
                         rate=200.0)
    _JColdEngine(J_SERVE, jp, mesh=mesh_1d(), **geom).serve(jreqs)
    eng = _TColdEngine(CFG, tp, device="cpu", **geom)
    eng.cache.compress_cold = _counting(eng.cache.compress_cold)
    eng.serve(treqs)
    assert eng.cache.compress_cold.moved > 0
    assert _streams(treqs) == _streams(jreqs)
    assert eng.cache.live_pages == 0 and eng.cache.compressed_pages == 0
    assert eng.cache.refcounts_balanced()


def _counting(fn):
    def wrapped(*a, **kw):
        n = fn(*a, **kw)
        wrapped.moved += n
        return n
    wrapped.moved = 0
    return wrapped


# ---------------------------------------------------------------------------
# The radix prefix cache
# ---------------------------------------------------------------------------


def _prefix_script(PC, cache, conv, compress):
    """One sequence of tree and cache operations; returns what each
    observed (the same list from either package means the same tree)."""
    out = []
    pc = PC(cache, session_ttl_steps=3)
    rng = np.random.RandomState(3)
    prompt = np.arange(10, dtype=np.int32)
    out.append(pc.match(prompt))
    kl = conv(rng.randn(L, 10, H, D).astype(np.float32))
    cache.write_prefill(0, kl, kl)
    out += [pc.insert(prompt, 0), pc.insert(prompt, 0)]
    p2 = np.concatenate([prompt[:8], np.asarray([9, 9], np.int32)])
    out += [pc.match(p2), pc.match(prompt[:8])]
    cache.free_slot(0)
    out.append((cache.free_pages, cache.live_pages))
    matched, entries = pc.match(p2)
    cache.attach_pages(1, entries, matched)
    out.append((int(cache.lengths[1]), cache.live_pages))
    cache.free_slot(1)
    pc.pin_session("s0", prompt)
    out.append((pc.sessions_live, pc.touch_session("s0")))
    pc.tick(2)
    out.append(pc.touch_session("s0"))
    pc.tick(4)
    out.append((pc.sessions_live, pc.touch_session("s0")))
    out.append(pc.release_pages(1))
    out.append(pc.match(np.concatenate([prompt, prompt[:4]])))
    if compress:
        out.append((cache.compressed_pages, cache.live_pages))
    out.append(pc.stats())
    pc.drop_all()
    out.append((cache.live_pages, cache.refcounts_balanced()))
    return out


@pytest.mark.parametrize("compress", [False, True])
def test_prefix_cache_follows_jax_op_for_op(compress):
    """Match lengths, hits, inserts, refcounts, session pins and TTL,
    demotion (compress) or eviction under pressure, and the drain: the
    same observations and host state as the JAX tree, op for op."""
    jc, tc = _caches(compress=compress, slots=2, page_size=4, max_len=16)
    want = _prefix_script(JPrefixCache, jc, jnp.asarray, compress)
    got = _prefix_script(PrefixCache, tc, _t, compress)
    assert got == want
    _same_host_state(jc, tc)


def test_prefix_cache_demotes_to_fp8_then_stays_matchable(params):
    jc, tc = _caches(compress=True, slots=2, page_size=4, max_len=16)
    rng = np.random.RandomState(3)
    prompt = np.arange(8, dtype=np.int32)
    kl = rng.randn(L, 8, H, D).astype(np.float32)
    vl = rng.randn(L, 8, H, D).astype(np.float32)
    trees = []
    for c, PC, conv in ((jc, JPrefixCache, jnp.asarray), (tc, PrefixCache,
                                                          _t)):
        pc = PC(c)
        c.write_prefill(0, conv(kl), conv(vl))
        pc.insert(prompt, 0)
        c.free_slot(0)
        assert pc.release_pages(2) == 2 and c.live_pages == 0
        trees.append(pc)
    jm, tm = (pc.match(np.concatenate([prompt, prompt[:4]]))
              for pc in trees)
    assert tm == jm and all(k == "c" for k, _ in tm[1])
    for got, want in zip(tc.gather_pages(tm[1]), jc.gather_pages(jm[1])):
        assert _bits(got) == _bits(want)
    np.testing.assert_allclose(tc.gather_pages(tm[1])[0][:, 0].numpy(), kl,
                               rtol=0.2, atol=0.1)
    _same_pools(jc, tc)
    for pc in trees:
        pc.drop_all()
    assert tc.refcounts_balanced() and jc.refcounts_balanced()


_REPORT_FIELDS = ("completed", "rejected", "prefix_queries", "prefix_hits",
                  "prefix_hit_rate", "prefill_tokens_cached",
                  "prefill_flops_avoided", "session_resumes", "new_tokens")


def test_engine_prefix_cache_report_and_streams_match_jax(params):
    jp, tp = params
    geom = dict(slots=4, page_size=8, max_len=128, prefix_cache=True,
                session_ttl_steps=64)
    # Arrivals ~100 s apart on the virtual clock: each request is served
    # before the next arrives, so the hits do not depend on how fast
    # either package runs.
    spec = dict(num_requests=12, prompt_lens=(8,), output_lens=(4,),
                prefix_lens=(32,), num_prefixes=2, vocab_size=256,
                rate_rps=0.01)
    jreqs, treqs = (j_generate(j_prefix_spec(**spec)),
                    generate(prefix_spec(**spec)))
    jrep = JServingEngine(J_SERVE, jp, mesh=mesh_1d(), **geom).serve(jreqs)
    eng = ServingEngine(CFG, tp, device="cpu", **geom)
    rep = eng.serve(treqs)
    for f in _REPORT_FIELDS:
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.prefix_hits > 0 and 0 < rep.prefill_flops_avoided < 1
    assert _streams(treqs) == _streams(jreqs)
    assert eng.cache.live_pages > 0           # the tree still holds pages
    eng._prefix.drop_all()
    assert eng.cache.live_pages == 0 and eng.cache.refcounts_balanced()
    text = render_prometheus()
    for fam in ("horovod_serving_prefix_hit_rate",
                "horovod_serving_prefix_pages",
                "horovod_serving_sessions_live",
                "horovod_serving_prefix_tokens_total",
                "horovod_serving_ttft_by_tenant_seconds",
                "horovod_serving_tenant_occupancy",
                "horovod_serving_tenant_queue_depth"):
        assert fam in text


def test_engine_prefix_hit_with_chunked_tail_matches_jax(params):
    """A hit whose tail is still longer than a chunk prefills the tail
    chunk by chunk from the cached pages."""
    jp, tp = params
    geom = dict(slots=2, page_size=8, max_len=128, prefix_cache=True,
                prefill_chunk=8)
    spec = dict(num_requests=8, prompt_lens=(24,), output_lens=(3,),
                prefix_lens=(32,), num_prefixes=1, session_share=0.0,
                vocab_size=256, rate_rps=0.01)
    jreqs, treqs = (j_generate(j_prefix_spec(**spec)),
                    generate(prefix_spec(**spec)))
    jrep = JServingEngine(J_SERVE, jp, mesh=mesh_1d(), **geom).serve(jreqs)
    rep = ServingEngine(CFG, tp, device="cpu", **geom).serve(treqs)
    for f in _REPORT_FIELDS:
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.prefix_hits > 0 and rep.prefill_flops_avoided > 0
    assert rep.prefill_chunks > 0
    assert _streams(treqs) == _streams(jreqs)


# ---------------------------------------------------------------------------
# Knobs and refusals
# ---------------------------------------------------------------------------


def test_engine_knobs_from_env(params, monkeypatch):
    _, tp = params
    monkeypatch.setenv("HOROVOD_PREFILL_CHUNK", "16")
    monkeypatch.setenv("HOROVOD_KV_COMPRESS", "1")
    monkeypatch.setenv("HOROVOD_PREFIX_CACHE", "1")
    monkeypatch.setenv("HOROVOD_SESSION_TTL_STEPS", "7")
    eng = ServingEngine(CFG, tp, device="cpu", slots=2, page_size=8,
                        max_len=64)
    assert eng.prefill_chunk == 16 and eng.kv_compress
    assert eng.cache.compress and eng.step.compress
    assert eng._prefix is not None and eng._prefix.session_ttl_steps == 7
    assert eng.cache.reclaim_cb == eng._prefix.release_pages
    for name in ("HOROVOD_PREFILL_CHUNK", "HOROVOD_KV_COMPRESS",
                 "HOROVOD_PREFIX_CACHE", "HOROVOD_SESSION_TTL_STEPS"):
        monkeypatch.delenv(name)
    eng = ServingEngine(CFG, tp, device="cpu", slots=2, page_size=8,
                        max_len=64)
    assert eng.prefill_chunk == 0 and not eng.kv_compress
    assert eng._prefix is None and eng.session_ttl_steps == 512


def test_tp_and_control_plane_refuse_naming_item_1_12(params):
    # At world 1: the plane builds over the ladder [1], and the step on a
    # tp 1 mesh is bitwise the mesh=None step.
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.parallel import build_parallel_mesh
    jp, tp = params
    thvd.init(device="cpu")
    try:
        plane = ServingControlPlane(CFG, tp, device="cpu", slots=2,
                                    page_size=8, max_len=64)
        assert plane.policy.valid_sizes == [1] and plane.mesh_ranks == [0]
        assert plane.engine.tp == 1 and plane.engine.decode_params is tp
        assert plane.engine._ls is None
        mesh = build_parallel_mesh(tp=1)
    finally:
        thvd.shutdown()
    _, tc, tok, active = _compressed_step_case(jp, tp)
    args = (_t(tok).long(), tc.lengths_device().long(), tc.table_device(),
            _t(active), *tc.compress_operands())
    outs = []
    for m in (None, mesh):
        step = build_decode_step(CFG, m, slots=2, page_size=4,
                                 pages_per_slot=8, compress=True)
        assert step._meta["tp"] == 1 and step.process_set is None
        outs.append(step(tp, tc.k.clone(), tc.v.clone(), *args))
    for a, b in zip(*outs):
        assert _bits(a) == _bits(b)
