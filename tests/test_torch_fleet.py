"""PyTorch/CUDA port: the KV-page wire, the fleet router, the scale
policies, the fleet scaler and the disaggregated fleet, against the JAX
package.

* ``encode_kv`` payloads are byte-identical to the JAX ``encode_kv`` on
  the same pages, in both tiers; either package decodes the other's;
  malformed frames and page-size mismatches are refused alike.
* ``FleetRouter``, ``FleetPolicy``, ``ScalePolicy`` and
  ``valid_tp_sizes`` decide as the JAX ones on the same inputs.
* A one-prefill, one-decode fleet over a loopback KV plane streams
  bitwise the colocated engine's tokens and the JAX fleet's; a dead
  prefill worker falls back to local prefills with no page leaked.

Weights: the flax ``LLAMA_SERVE`` init carried across with
``params_from_jax``; K/V and tokens from numpy seeds; f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.controller import fusion as j_fusion
from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
from horovod_tpu.run.http_kv import KVClient as JKVClient
from horovod_tpu.run.http_kv import RendezvousServer as JRendezvousServer
from horovod_tpu.serving import CacheConfig as JCacheConfig
from horovod_tpu.serving import ContinuousBatchScheduler as JScheduler
from horovod_tpu.serving import DecodeWorker as JDecodeWorker
from horovod_tpu.serving import FleetPolicy as JFleetPolicy
from horovod_tpu.serving import FleetPolicyConfig as JFleetPolicyConfig
from horovod_tpu.serving import FleetRouter as JFleetRouter
from horovod_tpu.serving import FleetSample as JFleetSample
from horovod_tpu.serving import LoadSpec as JLoadSpec
from horovod_tpu.serving import PagedKVCache as JPagedKVCache
from horovod_tpu.serving import PolicyConfig as JPolicyConfig
from horovod_tpu.serving import PrefillWorker as JPrefillWorker
from horovod_tpu.serving import ScalePolicy as JScalePolicy
from horovod_tpu.serving import ServingEngine as JServingEngine
from horovod_tpu.serving import ServingFleet as JServingFleet
from horovod_tpu.serving import SLOSample as JSLOSample
from horovod_tpu.serving import decode_kv as j_decode_kv
from horovod_tpu.serving import encode_kv as j_encode_kv
from horovod_tpu.serving import fleet_spec as j_fleet_spec
from horovod_tpu.serving import generate as j_generate
from horovod_tpu.serving import valid_tp_sizes as j_valid_tp_sizes
from horovod_tpu.models.transformer import LLAMA3_8B as J_8B
from horovod_tpu_torch.models import LLAMA3_8B, LLAMA_SERVE, params_from_jax
from horovod_tpu_torch.run.http_kv import KVClient, RendezvousServer
from horovod_tpu_torch.run.secret import make_secret_key
from horovod_tpu_torch.serving import (CacheConfig, ContinuousBatchScheduler,
                                       DecodeWorker, FleetPolicy,
                                       FleetPolicyConfig, FleetRouter,
                                       FleetSample, LoadSpec, PagedKVCache,
                                       PolicyConfig, PrefillWorker, Request,
                                       ScalePolicy, ServingEngine,
                                       ServingFleet, SLOSample, decode_kv,
                                       encode_kv, fleet_spec, generate,
                                       import_pages, valid_tp_sizes,
                                       wire_tier)
from horovod_tpu_torch.serving.kvwire import MAGIC, WIRE_VERSION, _FRAME
from horovod_tpu_torch.timeline.metrics import render_prometheus

torch.set_num_threads(2)

CFG = LLAMA_SERVE
L, H, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
PS = 8


def mesh_1d():
    return Mesh(np.asarray(jax.devices()[:1], dtype=object).reshape(1),
                ("tp",))


@pytest.fixture(autouse=True)
def _fresh_jax_executables():
    """The JAX decode step caches its executable by plan fingerprint,
    process-wide; start each test empty."""
    j_fusion.clear_plan_cache()


@pytest.fixture(scope="module")
def params():
    model = JLlamaLM(J_SERVE, dtype=jnp.float32)
    jp = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture()
def kv_plane():
    """The port's KV server and client, and the JAX package's, each on
    127.0.0.1 at a port the OS picks."""
    secret = make_secret_key()
    srv, jsrv = (RendezvousServer(secret, host="127.0.0.1"),
                 JRendezvousServer(secret, host="127.0.0.1"))
    try:
        yield (KVClient("127.0.0.1", srv.port, secret),
               JKVClient("127.0.0.1", jsrv.port, secret))
    finally:
        srv.stop()
        jsrv.stop()


def _kv(t, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    k = (2.0 * rng.randn(L, t, H, D)).astype(np.float32)
    v = rng.randn(L, t, H, D).astype(np.float32)
    k[:, 0] = 0.0                     # an all-zero row: scale 1
    return k, v


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _cache(compress=False, slots=4, max_len=64):
    return PagedKVCache(CacheConfig(
        num_layers=L, num_kv_heads=H, head_dim=D, slots=slots, page_size=PS,
        max_len=max_len, compress=compress), device="cpu")


# ---------------------------------------------------------------------------
# The KV wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["f32", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 16, 21])
def test_encode_kv_byte_identical_to_jax(tier, dtype, t):
    k, v = _kv(t)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = encode_kv(_torch(k, tdt), _torch(v, tdt), page_size=PS, tier=tier)
    want = j_encode_kv(np.asarray(_jax(k, jdt)), np.asarray(_jax(v, jdt)),
                       page_size=PS, tier=tier)
    assert got == want


@pytest.mark.parametrize("tier", ["f32", "fp8"])
def test_payloads_decode_across_packages(tier):
    """A JAX payload decodes in the port and a port payload in the JAX
    package, to the same bytes field by field."""
    k, v = _kv(21, seed=1)
    tbuf = encode_kv(_torch(k, torch.float32), _torch(v, torch.float32),
                     page_size=PS, tier=tier)
    jbuf = j_encode_kv(k, v, page_size=PS, tier=tier)
    for twp, jwp in ((decode_kv(jbuf), j_decode_kv(tbuf)),
                     (decode_kv(tbuf), j_decode_kv(jbuf))):
        assert (twp.tier, twp.length, twp.page_size, twp.dtype) == (
            jwp.tier, jwp.length, jwp.page_size, jwp.dtype)
        for f in ("k_pages", "v_pages", "kq", "vq", "kscale", "vscale",
                  "k_tail", "v_tail"):
            a, b = getattr(twp, f), getattr(jwp, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.view(torch.uint8).numpy().tobytes() == \
                    b.tobytes(), f


def test_f32_import_is_bitwise_local_write_prefill():
    k, v = _kv(21)
    local, remote = _cache(), _cache()
    local.write_prefill(0, _torch(k, torch.float32),
                        _torch(v, torch.float32))
    wp = decode_kv(encode_kv(_torch(k, torch.float32),
                             _torch(v, torch.float32), page_size=PS,
                             tier="f32"))
    assert import_pages(remote, 2, wp) == 2 and int(remote.lengths[2]) == 21
    for i in range(3):
        lp, rp = int(local.page_table[0, i]), int(remote.page_table[2, i])
        assert torch.equal(local.k[:, lp], remote.k[:, rp])
        assert torch.equal(local.v[:, lp], remote.v[:, rp])
    remote.free_slot(2)
    assert remote.release_all() == 0 and remote.refcounts_balanced()


def test_fp8_import_is_bitwise_demote_page_and_jax():
    """An fp8-tier page lands bitwise as ``demote_page`` of the same
    resident page, in the port and in the JAX cache."""
    k, v = _kv(16)
    kt, vt = _torch(k, torch.float32), _torch(v, torch.float32)
    local = _cache(compress=True)
    local.write_prefill(0, kt, vt)
    cpids = [local.demote_page(int(local.page_table[0, i]))
             for i in range(2)]
    remote = _cache(compress=True)
    import_pages(remote, 0, decode_kv(encode_kv(kt, vt, page_size=PS,
                                                tier="fp8")))
    rc = [int(remote.cpage_table[0, i]) for i in range(2)]
    for pool in ("kq", "vq", "kscale", "vscale"):
        assert torch.equal(getattr(local, pool)[:, cpids].view(torch.uint8),
                           getattr(remote, pool)[:, rc].view(torch.uint8))
    jc = JPagedKVCache(JCacheConfig(num_layers=L, num_kv_heads=H,
                                    head_dim=D, slots=4, page_size=PS,
                                    max_len=64, compress=True))
    jc.write_prefill(0, jnp.asarray(k), jnp.asarray(v))
    jcp = [jc.demote_page(int(jc.page_table[0, i])) for i in range(2)]
    assert np.asarray(jc.kq[:, jcp]).tobytes() == \
        local.kq[:, cpids].view(torch.uint8).numpy().tobytes()
    for got, want in zip(remote.gather_pages([("c", c) for c in rc]),
                         local.gather_pages([("c", c) for c in cpids])):
        assert torch.equal(got, want)
    remote.free_slot(0)
    assert remote.release_all() == 0 and remote.refcounts_balanced()


def test_wire_refusals_match_jax(monkeypatch):
    k, v = _kv(12)
    kt, vt = _torch(k, torch.float32), _torch(v, torch.float32)
    buf = encode_kv(kt, vt, page_size=PS, tier="f32")
    magic, version, hlen = _FRAME.unpack_from(buf)
    assert (magic, version) == (MAGIC, WIRE_VERSION)
    corrupt = bytearray(buf)
    corrupt[-1] ^= 0xFF
    cases = [(b"XXXX" + buf[4:], "not a KV-page wire"),
             (buf[:_FRAME.size - 2], "shorter than"),
             (_FRAME.pack(MAGIC, WIRE_VERSION + 1, hlen) + buf[_FRAME.size:],
              "version mismatch"),
             (buf[:_FRAME.size + hlen - 3], "header cut short"),
             (buf[:-10], "header promises"),
             (bytes(corrupt), "hash mismatch")]
    for bad, msg in cases:
        for dec in (decode_kv, j_decode_kv):
            with pytest.raises(ValueError, match=msg):
                dec(bad)
    with pytest.raises(ValueError, match="page_size"):
        import_pages(_cache(), 0, decode_kv(encode_kv(kt, vt, page_size=4,
                                                      tier="f32")))
    with pytest.raises(ValueError, match="compress=True"):
        import_pages(_cache(), 0, decode_kv(encode_kv(kt, vt, page_size=PS,
                                                      tier="fp8")))
    with pytest.raises(ValueError, match="matching"):
        encode_kv(kt, vt[:, :4], page_size=PS)
    with pytest.raises(ValueError, match="empty"):
        encode_kv(kt[:, :0], vt[:, :0], page_size=PS)
    with pytest.raises(ValueError, match="unknown KV wire tier"):
        encode_kv(kt, vt, page_size=PS, tier="int4")
    monkeypatch.delenv("HOROVOD_KV_PAGE_WIRE", raising=False)
    assert wire_tier() == "f32"
    monkeypatch.setenv("HOROVOD_KV_PAGE_WIRE", "fp8")
    assert wire_tier() == "fp8"
    monkeypatch.setenv("HOROVOD_KV_PAGE_WIRE", "int4")
    with pytest.raises(ValueError, match="KV_PAGE_WIRE"):
        wire_tier()


# ---------------------------------------------------------------------------
# Router and policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("affinity", [True, False])
def test_router_picks_as_jax_on_the_fleet_stream(affinity):
    """Both routers over three engines fed the same ``fleet_spec``
    stream (skewed hints, shared prefixes), each request submitted where
    it was routed and every third engine's head admitted: the same
    engine and reason every time."""
    spec = dict(num_requests=60, vocab_size=256, seed=2,
                engine_skew=(3.0, 1.0, 0.0, 0.0))
    routers = []
    for Router, Sched, gen, Spec in (
            (FleetRouter, ContinuousBatchScheduler, generate, fleet_spec),
            (JFleetRouter, JScheduler, j_generate, j_fleet_spec)):
        r = Router(affinity=affinity, spill_factor=1.5)
        scheds = [Sched(2) for _ in range(3)]
        for i, s in enumerate(scheds):
            r.register(f"e{i}", s)
        routers.append((r, scheds, gen(Spec(**spec))))
    picks = []
    for (r, scheds, reqs) in routers:
        out = []
        for i, req in enumerate(reqs):
            if i % 7 == 6:
                req.engine_hint = 5         # out of range: falls through
            name, reason = r.route(req)
            scheds[int(name[1:])].submit(req)
            if i % 3 == 2:
                scheds[i % 3].admit(0.0)
            out.append((name, reason))
        picks.append(out)
    assert picks[0] == picks[1]
    assert {reason for _, reason in picks[0]} >= (
        {"hint", "affinity", "spill"} if affinity
        else {"hint", "least-loaded"})


def _fleet_samples():
    rng = np.random.RandomState(7)
    out, now = [], 0.0
    for i in range(60):
        now += float(rng.choice([0.05, 0.3, 1.1]))
        queue = int(rng.choice([0, 2, 9, 12]))
        p99 = None if i % 4 == 0 else float(rng.choice([0.1, 0.7]))
        out.append(dict(now_s=now, queue_depth=queue, ttft_p99_s=p99,
                        occupancy=float(rng.rand()),
                        engines=1 + int(rng.randint(0, 4))))
    return out


def test_fleet_policy_decides_as_jax():
    cfg = dict(queue_high=8, ttft_slo_s=0.5, hysteresis=2, cooldown_s=1.0,
               max_engines=3)
    pols = (FleetPolicy(FleetPolicyConfig(**cfg)),
            JFleetPolicy(JFleetPolicyConfig(**cfg)))
    got, want = [], []
    for smp in _fleet_samples():
        for pol, Sample, out in ((pols[0], FleetSample, got),
                                 (pols[1], JFleetSample, want)):
            d = pol.decide(Sample(**smp))
            pol.mark_applied(d, smp["now_s"])
            out.append(dataclasses.astuple(d))
    assert got == want
    assert {d[0] for d in got} == {"hold", "add-engine"}


def test_scale_policy_decides_as_jax():
    rng = np.random.RandomState(9)
    cfg = dict(queue_high=6, ttft_slo_s=0.4, occupancy_low=0.3,
               hysteresis=2, cooldown_s=0.5, min_tp=1, max_tp=8)
    sizes = [1, 2, 4, 8]
    pols = (ScalePolicy(PolicyConfig(**cfg), sizes),
            JScalePolicy(JPolicyConfig(**cfg), sizes))
    got, want, now, mesh = [], [], 0.0, (0, 1, 2, 3)
    for i in range(80):
        now += float(rng.choice([0.1, 0.6]))
        smp = dict(now_s=now, queue_depth=int(rng.choice([0, 3, 8])),
                   ttft_p99_s=None if i % 5 == 0 else float(rng.rand()),
                   occupancy=float(rng.rand()), mesh_size=len(mesh),
                   mesh_ranks=mesh, healthy=tuple(range(8)),
                   dead_ranks=(2,) if i == 40 else (),
                   evict_candidate=(1, 0.3) if i in (20, 21) else None)
        for pol, Sample, out in ((pols[0], SLOSample, got),
                                 (pols[1], JSLOSample, want)):
            d = pol.decide(Sample(**smp))
            pol.mark_applied(d, now)
            out.append(dataclasses.astuple(d))
    assert got == want
    assert {d[0] for d in got} >= {"hold", "grow", "shrink", "evict"}
    for n in (1, 3, 8, 64):
        assert valid_tp_sizes(LLAMA3_8B, n) == j_valid_tp_sizes(J_8B, n)
        assert valid_tp_sizes(CFG, n) == j_valid_tp_sizes(J_SERVE, n)


def test_policy_configs_from_env_match_jax(monkeypatch):
    for name, val in (("FLEET_QUEUE_HIGH", "3"), ("FLEET_TTFT_SLO_S", "0.25"),
                      ("FLEET_HYSTERESIS", "5"), ("FLEET_COOLDOWN_S", "2.5"),
                      ("FLEET_MAX_ENGINES", "6"), ("FLEET_INTERVAL_S", "0.125"),
                      ("CTL_QUEUE_HIGH", "4"), ("CTL_MAX_TP", "4"),
                      ("CTL_OCC_LOW", "0.1")):
        monkeypatch.setenv(f"HOROVOD_{name}", val)
    assert dataclasses.astuple(FleetPolicyConfig.from_env()) == \
        dataclasses.astuple(JFleetPolicyConfig.from_env())
    assert dataclasses.astuple(PolicyConfig.from_env()) == \
        dataclasses.astuple(JPolicyConfig.from_env())
    monkeypatch.setenv("HOROVOD_FLEET_AFFINITY", "0")
    assert FleetRouter().affinity is JFleetRouter().affinity is False


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


def _engine(tp, **kw):
    geom = dict(slots=4, page_size=PS, max_len=64, prefetch_depth=1)
    geom.update(kw)
    return ServingEngine(CFG, tp, device="cpu", **geom)


def _j_engine(jp, **kw):
    geom = dict(slots=4, page_size=PS, max_len=64, prefetch_depth=1)
    geom.update(kw)
    return JServingEngine(J_SERVE, jp, mesh=mesh_1d(), **geom)


_SPEC = dict(num_requests=10, rate_rps=50.0, prompt_lens=(8, 13, 21),
             output_lens=(6, 9), seed=3, vocab_size=256)


def _streams(reqs):
    return {r.rid: list(r.tokens) for r in reqs}


def test_fleet_streams_equal_colocated_and_jax_fleet(params, kv_plane):
    jp, tp = params
    kv, jkv = kv_plane
    colo = generate(LoadSpec(**_SPEC))
    assert _engine(tp).serve(colo).completed == 10
    reqs = generate(LoadSpec(**_SPEC))
    fleet = ServingFleet([PrefillWorker("p0", CFG, tp, kv, page_size=PS,
                                        tier="f32", device="cpu")],
                         [DecodeWorker("decode0", _engine(tp), kv)], kv)
    frep = fleet.serve(reqs)
    jreqs = j_generate(JLoadSpec(**_SPEC))
    jrep = JServingFleet(
        [JPrefillWorker("p0", J_SERVE, jp, jkv, page_size=PS, tier="f32")],
        [JDecodeWorker("decode0", _j_engine(jp), jkv)], jkv).serve(jreqs)
    assert frep.completed == jrep.completed == 10
    assert frep.handoffs_streamed == 10 and frep.handoffs_local == 0
    assert frep.kv_bytes_out == frep.kv_bytes_in == jrep.kv_bytes_out
    assert _streams(reqs) == _streams(colo) == _streams(jreqs)
    assert frep.leaked_pages == {"decode0": 0} and frep.refcounts_balanced


def test_fleet_fp8_tier_imports_demoted_pages(params, kv_plane):
    """The fp8 wire into a ``kv_compress`` decode engine: every request
    completes over imported e4m3 pages, as many wire bytes in as out,
    fewer than the f32 tier's, and no page leaks."""
    _, tp = params
    kv, _ = kv_plane
    reqs = generate(LoadSpec(**_SPEC))
    fleet = ServingFleet([PrefillWorker("p0", CFG, tp, kv, page_size=PS,
                                        tier="fp8", device="cpu")],
                         [DecodeWorker("decode0",
                                       _engine(tp, kv_compress=True), kv)],
                         kv)
    worker = fleet.decode["decode0"]
    cache = worker.engine.cache
    seen = []
    join = worker.engine._join_decode

    def spy(st, slot, req, first, now):
        seen.append(int(cache.comp_mask[slot].sum()))
        join(st, slot, req, first, now)
    worker.engine._join_decode = spy
    frep = fleet.serve(reqs)
    assert frep.completed == 10 and frep.handoffs_streamed == 10
    assert frep.kv_bytes_in == frep.kv_bytes_out
    assert sum(seen) == sum(r.prompt_len // PS for r in reqs) > 0
    f32 = sum(len(encode_kv(torch.zeros(L, r.prompt_len, H, D),
                            torch.zeros(L, r.prompt_len, H, D),
                            page_size=PS, tier="f32")) for r in reqs)
    assert frep.kv_bytes_out < f32
    assert frep.leaked_pages == {"decode0": 0} and frep.refcounts_balanced


def test_handoff_slot_is_out_of_the_decode_batch(params):
    _, tp = params
    eng = _engine(tp)
    sched = eng.scheduler
    req = Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                  max_new_tokens=4)
    sched.submit(req)
    [(slot, r)] = sched.admit(0.0)
    sched.note_handoff(r)
    assert r.state == "handoff" and eng._decode_slots() == []
    assert 'horovod_serving_slot_states{state="handoff"} 1' in \
        render_prometheus()
    sched.note_prefill(r, 0.1)
    assert eng._decode_slots() == [slot]


def test_dead_prefill_worker_falls_back_local_zero_leaks(params, kv_plane):
    _, tp = params
    kv, _ = kv_plane
    reqs = generate(LoadSpec(num_requests=16, rate_rps=60.0,
                             prompt_lens=(8, 16), output_lens=(6, 10),
                             seed=5, vocab_size=256))
    want = generate(LoadSpec(num_requests=16, rate_rps=60.0,
                             prompt_lens=(8, 16), output_lens=(6, 10),
                             seed=5, vocab_size=256))
    _engine(tp).serve(want)
    fleet = ServingFleet([PrefillWorker("p0", CFG, tp, kv, page_size=PS,
                                        device="cpu")],
                         [DecodeWorker("decode0", _engine(tp), kv)], kv)
    frep = fleet.serve(reqs, kill_prefill_at_step=2)
    assert frep.completed == 16 and frep.handoffs_local >= 1
    assert frep.handoffs_streamed + frep.handoffs_local == 16
    assert frep.leaked_pages == {"decode0": 0} and frep.refcounts_balanced
    assert not fleet.prefill_workers[0].alive
    assert _streams(reqs) == _streams(want)


def test_fleet_scaler_grows_under_surge(params, kv_plane):
    """A sustained queue breach commissions a second decode engine
    mid-run; queued requests move to it and both pools drain clean."""
    _, tp = params
    kv, _ = kv_plane
    reqs = generate(fleet_spec(num_requests=24, rate_rps=80.0, seed=1,
                               vocab_size=256))
    pol = FleetPolicy(FleetPolicyConfig(interval_s=0.01, queue_high=4,
                                        hysteresis=2, cooldown_s=0.5,
                                        max_engines=2))
    fleet = ServingFleet(
        [PrefillWorker("p0", CFG, tp, kv, page_size=PS, device="cpu")],
        [DecodeWorker("decode0", _engine(tp, max_len=256), kv)], kv,
        scaler_policy=pol, engine_factory=lambda: _engine(tp, max_len=256))
    frep = fleet.serve(reqs)
    assert frep.completed == 24 and frep.engines == 2 and frep.migrated > 0
    adds = [d for d in fleet.scaler.decisions if d["action"] == "add-engine"]
    assert len(adds) == 1 and adds[0]["reason"] == "fleet-slo-breach"
    assert frep.leaked_pages == {"decode0": 0, "decode1": 0}
    assert frep.refcounts_balanced
    assert frep.per_engine_completed["decode1"] > 0
    text = render_prometheus()
    assert "horovod_fleet_migrated_total" in text
    assert "horovod_fleet_engines 2" in text
