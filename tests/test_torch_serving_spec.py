"""PyTorch/CUDA port: speculative decoding against the JAX package
(the cases of ``tests/test_serving_spec.py`` for what is ported).

* ``verify_attention`` over the page pool equals the JAX function over
  the gathered cache view, and each of its rows is bitwise the plain
  decode attention at that row's length.
* The verify step's ``width`` rows are bitwise ``width`` sequential
  plain decode steps.
* Speculative streams equal plain decode's and the JAX engine's, token
  for token, for the model drafter (the target's own weights), the
  n-gram drafter and a drafter that always proposes token 0.
* Round accounting, ``horovod_serving_spec_tokens_total{outcome}``, the
  report's zeros when speculation is off, the n-gram lookup against the
  JAX drafter's, and the refusals.

Weights come from the flax ``LlamaLM.init`` carried across with
``params_from_jax``; everything runs in f32 on the CPU.
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
from horovod_tpu.ops.attention import verify_attention as j_verify_attention
from horovod_tpu.serving import LoadSpec as JLoadSpec
from horovod_tpu.serving import NgramDrafter as JNgramDrafter
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving import ServingEngine as JServingEngine
from horovod_tpu.serving import generate as j_generate
from horovod_tpu_torch.models import LLAMA_SERVE, params_from_jax
from horovod_tpu_torch.ops.attention import (gather_pages,
                                             paged_decode_attention,
                                             verify_attention)
from horovod_tpu_torch.serving import (CacheConfig, LoadSpec, ModelDrafter,
                                       NgramDrafter, PagedKVCache, Request,
                                       ServingEngine, build_decode_step,
                                       build_verify_step, generate,
                                       prefill_forward)
from horovod_tpu_torch.timeline.metrics import render_prometheus

torch.set_num_threads(2)

CFG = LLAMA_SERVE
GEOM = dict(slots=4, page_size=8, max_len=64)
LOAD = dict(num_requests=8, rate_rps=200.0, prompt_lens=(4, 9, 16),
            output_lens=(5, 9), vocab_size=256, seed=3)


def mesh_1d():
    return Mesh(np.asarray(jax.devices()[:1], dtype=object).reshape(1),
                ("tp",))


@pytest.fixture(autouse=True)
def _fresh_jax_plan_cache():
    """The JAX package memoizes a serving step's executable by exchange
    plan and page geometry, not by the params' or adapters' tree, in a
    cache that lives as long as the process: a step another test file
    cached at the same geometry would take this file's trees with its
    own ``in_specs``.  Start each test from an empty cache."""
    j_fusion.clear_plan_cache()


@pytest.fixture(scope="module")
def params():
    model = JLlamaLM(J_SERVE, dtype=jnp.float32)
    jparams = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    return jparams, params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module")
def plain_streams(params):
    """The JAX engine's and the port's plain-decode streams."""
    jparams, tparams = params
    jreqs = j_generate(JLoadSpec(**LOAD))
    JServingEngine(J_SERVE, jparams, mesh=mesh_1d(), **GEOM).serve(jreqs)
    port, _ = _serve(tparams)
    return {r.rid: tuple(r.tokens) for r in jreqs}, port


def _serve(tparams, **engine_kw):
    eng = ServingEngine(CFG, tparams, device="cpu", **GEOM, **engine_kw)
    reqs = generate(LoadSpec(**LOAD))
    report = eng.serve(reqs)
    assert report.completed == LOAD["num_requests"], report
    assert eng.cache.release_all() == 0 and eng.cache.refcounts_balanced()
    return {r.rid: tuple(r.tokens) for r in reqs}, report


class ZeroDrafter(NgramDrafter):
    """The weakest drafter: token 0, always."""

    def propose(self, reqs, k, last_tokens):
        return np.zeros((last_tokens.shape[0], k), np.int32)


def _drafter(name, tparams):
    if name == "model":
        return ModelDrafter(CFG, tparams, device="cpu", **GEOM)
    return {"ngram": NgramDrafter, "zeros": ZeroDrafter}[name]()


# ---------------------------------------------------------------------------
# verify_attention
# ---------------------------------------------------------------------------


def _pool(seed, slots=3, pps=4, ps=4, h_kv=2, d=16):
    rng = np.random.RandomState(seed)
    pages = slots * pps + 1
    k = rng.randn(pages, ps, h_kv, d).astype(np.float32)
    v = rng.randn(pages, ps, h_kv, d).astype(np.float32)
    table = rng.permutation(slots * pps).reshape(slots, pps).astype(
        np.int32)
    return k, v, table


@pytest.mark.parametrize("width", [2, 5])
def test_verify_attention_matches_jax_and_plain_decode_rows(width):
    k, v, table = _pool(width)
    rng = np.random.RandomState(10 + width)
    q = rng.randn(3, 4, width, 16).astype(np.float32)
    # A live slot, one that reaches the capacity (rows past it are
    # capped), and an idle one (every row exactly zero).
    lengths = np.array([5, 14, 0], np.int32)
    kt, vt, tt = (torch.from_numpy(a) for a in (k, v, table))
    got = verify_attention(torch.from_numpy(q), kt, vt, tt,
                           torch.from_numpy(lengths))
    view_k = gather_pages(kt, tt).numpy()
    view_v = gather_pages(vt, tt).numpy()
    want = j_verify_attention(jnp.asarray(q), jnp.asarray(view_k),
                              jnp.asarray(view_v),
                              lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    assert not got[2].any()
    for i in range(width):
        li = np.where(lengths > 0, np.minimum(lengths + i, 16), 0)
        row = paged_decode_attention(
            torch.from_numpy(q[:, :, i:i + 1].copy()), kt, vt, tt,
            torch.from_numpy(li.astype(np.int32)))
        assert torch.equal(got[:, :, i:i + 1], row)


# ---------------------------------------------------------------------------
# The verify step: width rows bitwise sequential plain decode
# ---------------------------------------------------------------------------


def test_verify_step_rows_bitwise_match_sequential_decode(params):
    _, tparams = params
    t0, width = 8, 3
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, CFG.vocab_size, (1, t0 + width))).long()
    ccfg = CacheConfig(num_layers=CFG.num_layers,
                       num_kv_heads=CFG.num_kv_heads, head_dim=CFG.head_dim,
                       **GEOM)
    cache = PagedKVCache(ccfg, device="cpu")
    plain = build_decode_step(CFG, slots=ccfg.slots,
                              page_size=ccfg.page_size,
                              pages_per_slot=ccfg.pages_per_slot)
    verify = build_verify_step(CFG, slots=ccfg.slots, width=width,
                               page_size=ccfg.page_size,
                               pages_per_slot=ccfg.pages_per_slot)
    _, kl, vl = prefill_forward(tparams, CFG, tokens[:, :t0])
    cache.write_prefill(0, kl[:, 0], vl[:, 0])
    cache.reserve(0, t0 + width)        # one page table for both runs
    table = cache.table_device()
    base = cache.lengths_device().long()
    active = torch.zeros(ccfg.slots, dtype=torch.bool)
    active[0] = True

    k, v = cache.k.clone(), cache.v.clone()
    rows = []
    for i in range(width):
        tok = torch.zeros(ccfg.slots, dtype=torch.long)
        tok[0] = tokens[0, t0 + i]
        logits, k, v = plain(tparams, k, v, tok, base + i, table, active)
        rows.append(logits[0])
    tok2 = torch.zeros((ccfg.slots, width), dtype=torch.long)
    tok2[0] = tokens[0, t0:]
    wide, kw, vw = verify(tparams, cache.k, cache.v, tok2, base, table,
                          active)
    assert wide.shape == (ccfg.slots, width, CFG.vocab_size)
    for i in range(width):
        assert torch.equal(wide[0, i], rows[i]), i
    # The same K/V landed in the slot's pages.
    pages = torch.from_numpy(cache.page_table[0]).long()
    assert torch.equal(kw[:, pages], k[:, pages])
    assert torch.equal(vw[:, pages], v[:, pages])
    with pytest.raises(ValueError, match="width >= 2"):
        build_verify_step(CFG, slots=4, width=1, page_size=8,
                          pages_per_slot=8)


# ---------------------------------------------------------------------------
# The engine: greedy-exact streams, accounting, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drafter,spec_k", [("model", 3), ("ngram", 4),
                                            ("zeros", 2)])
def test_spec_decode_streams_equal_plain_and_jax(params, plain_streams,
                                                 drafter, spec_k):
    _, tparams = params
    jax_plain, port_plain = plain_streams
    assert port_plain == jax_plain
    spec, rep = _serve(tparams, spec_decode=True, spec_k=spec_k,
                       drafter=_drafter(drafter, tparams))
    assert spec == port_plain
    assert rep.spec_rounds > 0 and rep.spec_rounds == rep.decode_steps
    if drafter == "model":
        # The target's own weights: near-total agreement, so the verify
        # width really is amortising rounds.
        assert rep.acceptance_rate > 0.5, rep
    else:
        assert 0.0 <= rep.acceptance_rate < 0.5, rep


def test_spec_round_accounting_and_metric_family(params):
    _, tparams = params
    drafter = _drafter("model", tparams)
    _, rep = _serve(tparams, spec_decode=True, spec_k=3, drafter=drafter)
    assert rep.proposed_tokens >= rep.spec_rounds * 3 > 0
    assert rep.proposed_tokens % 3 == 0
    assert 0 <= rep.accepted_tokens <= rep.proposed_tokens
    assert rep.acceptance_rate == pytest.approx(
        rep.accepted_tokens / rep.proposed_tokens)
    assert rep.new_tokens > rep.accepted_tokens
    # The drafter ran k steps a round it drafted, plus its catch-up.
    assert drafter.steps >= 3 * rep.spec_rounds
    assert drafter.prefills == LOAD["num_requests"]
    text = render_prometheus()
    assert 'horovod_serving_spec_tokens_total{outcome="proposed"}' in text
    assert 'horovod_serving_spec_tokens_total{outcome="accepted"}' in text


def test_spec_fields_zero_when_disabled(params):
    _, tparams = params
    _, rep = _serve(tparams)
    assert (rep.spec_rounds, rep.proposed_tokens, rep.accepted_tokens,
            rep.acceptance_rate) == (0, 0, 0, 0.0)


def test_ngram_drafter_prompt_lookup_matches_jax():
    d, jd = NgramDrafter(ngram=2), JNgramDrafter(ngram=2)
    req = Request(rid=0, prompt=np.asarray([7, 8, 9, 4, 7, 8], np.int32),
                  max_new_tokens=8, arrival_s=0.0)
    drafts = d.propose({0: req}, 3, np.asarray([0, 0], np.int32))
    assert drafts.shape == (2, 3)       # sized by last_tokens
    assert drafts[0, 0] == 9            # the lookup hit
    assert drafts[1].tolist() == [0, 0, 0]
    rng = np.random.RandomState(4)
    for trial in range(40):
        prompt = rng.randint(0, 6, rng.randint(1, 12)).astype(np.int32)
        emitted = rng.randint(0, 6, rng.randint(1, 6)).tolist()
        reqs = {1: Request(rid=trial, prompt=prompt, max_new_tokens=16)}
        reqs[1].tokens = list(emitted)
        jreqs = {1: JRequest(rid=trial, prompt=prompt, max_new_tokens=16)}
        jreqs[1].tokens = list(emitted)
        last = np.zeros(3, np.int32)
        np.testing.assert_array_equal(d.propose(reqs, 4, last),
                                      jd.propose(jreqs, 4, last))
    with pytest.raises(ValueError):
        NgramDrafter(ngram=0)


def test_spec_refusals_and_knobs(params, monkeypatch):
    _, tparams = params
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(CFG, tparams, device="cpu", spec_decode=True,
                      spec_k=-1, **GEOM)
    monkeypatch.setenv("HOROVOD_SPEC_DECODE", "1")
    monkeypatch.setenv("HOROVOD_SPEC_K", "3")
    eng = ServingEngine(CFG, tparams, device="cpu", **GEOM)
    assert eng.spec_decode and eng.spec_k == 3
    assert eng.verify_step.width == 4
    assert isinstance(eng.drafter, NgramDrafter)
    assert eng.scheduler.token_budget == 4
    monkeypatch.delenv("HOROVOD_SPEC_DECODE")
    eng = ServingEngine(CFG, tparams, device="cpu", **GEOM)
    assert not eng.spec_decode and eng.verify_step is None
    assert eng.scheduler.token_budget == 1
