"""PyTorch/CUDA port: the disaggregated fleet with a tensor-parallel
decode worker -- the KV wire into a kv-head-sharded pool and the fleet
loop in lock-step -- against the JAX package.

Gloo worlds of 2 and 4 (this file, run as a script, is each rank; they
meet through a ``FileStore`` under pytest's temporary directory; each
world has its own loopback ``RendezvousServer``, started here).  The
world's rank 0 runs the prefill worker; the decode worker is one
``ServingEngine(mesh=build_parallel_mesh(tp=world))`` over every rank.
The JAX fleet is the reference: a decode engine on ``mesh_1d(2)`` /
``mesh_1d(4)`` of the conftest's CPU devices, the same load over its own
KV server.  Weights: the flax ``LLAMA_SERVE`` init (8 kv heads, split
over tp 2 and 4) carried across with ``params_from_jax``; K/V from numpy
seeds; f32 on the CPU.

* f32 wire: every request completes, the streams equal the JAX fleet's
  and the port's colocated tp engine's, token for token; as many bytes
  imported as published, the JAX fleet's count; no page leaks on any
  rank; every rank's streams and ``FleetReport`` equal rank 0's (its
  times included: they are the leader's).
* fp8 wire into a ``kv_compress`` pool: each rank's imported ``kq`` /
  ``vq`` and scales are bitwise its heads of the JAX pool's after the
  same import (and the same rows' scales); the fleet completes with no
  leak on any rank, and its streams equal across ranks.
* ``adopt_pages`` / ``adopt_compressed_pages`` on a sharded pool:
  bitwise ``write_prefill`` / ``demote_page`` of the same bytes.
* A dead prefill worker (killed at the JAX test's step 2): the lost
  handoffs fall back to local prefill on every rank in the same turn,
  nothing is lost, no page leaks, the streams are the undisturbed ones.
* ``FleetScaler`` growth at tp 2 under the JAX test's surge: one
  ``add-engine`` for ``fleet-slo-breach``, a second tp 2 engine built on
  every rank, queued requests migrated to it, both pools clean -- the
  JAX fleet's decisions on the same load -- and every rank's decisions
  and report equal rank 0's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import horovod_tpu_torch as thvd  # noqa: E402
from horovod_tpu_torch.models import LLAMA_SERVE  # noqa: E402
from horovod_tpu_torch.serving import (  # noqa: E402
    CacheConfig, DecodeWorker, FleetPolicy, FleetPolicyConfig, LoadSpec,
    PagedKVCache, PrefillWorker, ServingEngine, ServingFleet,
    cache_sharding, decode_kv, encode_kv, fleet_spec, generate,
    import_pages)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
CFG = LLAMA_SERVE
L, H, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
WORLDS = (2, 4)
PS = 8
GEOM = dict(slots=4, page_size=PS, max_len=64, prefetch_depth=1)
SPEC = dict(num_requests=10, rate_rps=50.0, prompt_lens=(8, 13, 21),
            output_lens=(6, 9), seed=3, vocab_size=256)
DEAD_SPEC = dict(num_requests=16, rate_rps=60.0, prompt_lens=(8, 16),
                 output_lens=(6, 10), seed=5, vocab_size=256)
DEAD_STEP = 2
SURGE_SPEC = dict(num_requests=24, rate_rps=80.0, seed=1, vocab_size=256)
SURGE_POLICY = dict(interval_s=0.01, queue_high=4, hysteresis=2,
                    cooldown_s=0.5, max_engines=2)
SURGE_GEOM = dict(GEOM, max_len=256)
KV_T = 21              # tokens of the direct imports: 2 pages + a tail


def _streams(reqs):
    return {r.rid: list(r.tokens) for r in reqs}


def _kv(seed=0):
    rng = np.random.RandomState(seed)
    k = (2.0 * rng.randn(L, KV_T, H, D)).astype(np.float32)
    v = rng.randn(L, KV_T, H, D).astype(np.float32)
    k[:, 0] = 0.0                     # an all-zero row: scale 1
    return k, v


# ---------------------------------------------------------------------------
# The ranks (this file as each worker)
# ---------------------------------------------------------------------------


def _pool(mesh, compress):
    return PagedKVCache(CacheConfig(
        num_layers=L, num_kv_heads=H, head_dim=D, slots=2, page_size=PS,
        max_len=32, compress=compress), cache_sharding(mesh, device="cpu"))


def _adopt_rank(mesh):
    """The sharded pool's imports against its local writes, and the fp8
    wire's import as it lands (for the JAX pool's)."""
    k, v = _kv()
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    full = (KV_T // PS) * PS
    pages = lambda x: x[:, :full].reshape(L, KV_T // PS, PS, H, D)  # noqa
    ref = _pool(mesh, True)
    ref.write_prefill(0, kt, vt)
    pids = [int(ref.page_table[0, i]) for i in range(KV_T // PS)]
    got = _pool(mesh, True)
    fentries = got.adopt_pages(pages(kt), pages(vt))
    f_equal = all(torch.equal(got.k[:, p], ref.k[:, q]) and
                  torch.equal(got.v[:, p], ref.v[:, q])
                  for (_, p), q in zip(fentries, pids))
    demoted = [ref.demote_page(p) for p in pids]
    wp = decode_kv(encode_kv(kt, vt, page_size=PS, tier="fp8"))
    centries = got.adopt_compressed_pages(wp.kq, wp.vq, wp.kscale,
                                          wp.vscale)
    c_equal = all(
        torch.equal(got.kq[:, p].view(torch.uint8),
                    ref.kq[:, q].view(torch.uint8)) and
        torch.equal(got.vq[:, p].view(torch.uint8),
                    ref.vq[:, q].view(torch.uint8)) and
        torch.equal(got.kscale[:, p], ref.kscale[:, q]) and
        torch.equal(got.vscale[:, p], ref.vscale[:, q])
        for (_, p), q in zip(centries, demoted))
    # The fp8 wire through import_pages, as a fleet lands it.
    pool = _pool(mesh, True)
    import_pages(pool, 0, wp)
    cp = [int(pool.cpage_table[0, i]) for i in range(KV_T // PS)]
    return {"adopt_equal": f_equal, "adopt_fp8_equal": c_equal,
            "heads": (pool.head0, pool.local_heads),
            "kq": pool.kq[:, cp].view(torch.uint8).clone(),
            "vq": pool.vq[:, cp].view(torch.uint8).clone(),
            "kscale": pool.kscale[:, cp].clone(),
            "vscale": pool.vscale[:, cp].clone(),
            "length": int(pool.lengths[0]),
            "tail": pool.k[:, int(pool.page_table[0, KV_T // PS]),
                           :KV_T - full].clone()}


def _fleet(params, kv, mesh, tier="f32", scaler=False, **eng):
    geom = SURGE_GEOM if scaler else GEOM
    make = lambda: ServingEngine(CFG, params, mesh=mesh, device="cpu",  # noqa
                                 **geom, **eng)
    return ServingFleet(
        [PrefillWorker("p0", CFG, params, kv, page_size=PS, tier=tier,
                       device="cpu")],
        [DecodeWorker("decode0", make(), kv)], kv,
        scaler_policy=FleetPolicy(FleetPolicyConfig(**SURGE_POLICY))
        if scaler else None, engine_factory=make if scaler else None)


def _run(fleet, spec, **kw):
    reqs = generate(spec)
    rep = fleet.serve(reqs, **kw)
    return {"streams": _streams(reqs), "report": rep.as_dict(),
            "pages": {n: w.engine.cache.allocated_pages
                      for n, w in fleet.decode.items()},
            "headers": fleet._ls.headers}


def _fleet_rank(world, params, kv):
    from horovod_tpu_torch.parallel import build_parallel_mesh
    mesh = build_parallel_mesh(tp=world)
    out = {"adopt": _adopt_rank(mesh)}
    out["f32"] = _run(_fleet(params, kv, mesh), LoadSpec(**SPEC))
    colo = generate(LoadSpec(**SPEC))
    ServingEngine(CFG, params, mesh=mesh, device="cpu", **GEOM).serve(colo)
    out["colocated"] = _streams(colo)
    fleet = _fleet(params, kv, mesh, tier="fp8", kv_compress=True)
    cache = fleet.decode["decode0"].engine.cache
    seen = []
    join = fleet.decode["decode0"].engine._join_decode

    def spy(st, slot, req, first, now):
        seen.append(int(cache.comp_mask[slot].sum()))
        join(st, slot, req, first, now)
    fleet.decode["decode0"].engine._join_decode = spy
    out["fp8"] = _run(fleet, LoadSpec(**SPEC))
    out["fp8"]["compressed_pages"] = sum(seen)
    out["dead"] = _run(_fleet(params, kv, mesh), LoadSpec(**DEAD_SPEC),
                       kill_prefill_at_step=DEAD_STEP)
    undisturbed = generate(LoadSpec(**DEAD_SPEC))
    ServingEngine(CFG, params, mesh=mesh, device="cpu",
                  **GEOM).serve(undisturbed)
    out["undisturbed"] = _streams(undisturbed)
    if world == 2:
        fleet = _fleet(params, kv, mesh, scaler=True)
        out["surge"] = _run(fleet, fleet_spec(**SURGE_SPEC))
        out["surge"]["decisions"] = fleet.scaler.decisions
        out["short_mesh"] = _short_mesh(params, kv)
    return out


def _short_mesh(params, kv):
    from horovod_tpu_torch.parallel import build_parallel_mesh
    fleet = _fleet(params, kv, build_parallel_mesh(ranks=[0], tp=1))
    try:
        fleet.serve(generate(LoadSpec(**SPEC)))
    except ValueError as e:
        return str(e)
    return ""


def _worker(rank, world, store_path, in_path, port, secret, out_path):
    import torch.distributed as dist
    from horovod_tpu_torch.run.http_kv import KVClient
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    torch.set_num_threads(1)
    params = {k: torch.from_numpy(v) for k, v in
              torch.load(in_path, weights_only=False).items()}
    res = _fleet_rank(world, params, KVClient("127.0.0.1", int(port),
                                              secret))
    thvd.barrier()
    torch.save(res, out_path)
    thvd.shutdown()


# ---------------------------------------------------------------------------
# The harness and the JAX references
# ---------------------------------------------------------------------------


def _mesh_1d(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:n], dtype=object).reshape(n),
                ("tp",))


@pytest.fixture(scope="module")
def flax_params():
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
    model = JLlamaLM(J_SERVE, dtype=jnp.float32)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, flax_params):
    import jax
    from horovod_tpu_torch.models import params_from_jax
    from horovod_tpu_torch.run.http_kv import RendezvousServer
    from horovod_tpu_torch.run.secret import make_secret_key
    tmp = tmp_path_factory.mktemp("fleet_tp")
    params = params_from_jax(jax.tree.map(np.asarray, flax_params),
                             device="cpu")
    torch.save({k: v.numpy() for k, v in params.items()}, tmp / "in.pt")
    secret = make_secret_key()
    servers = {w: RendezvousServer(secret, host="127.0.0.1")
               for w in WORLDS}
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    try:
        procs = {(w, r): subprocess.Popen(
            [sys.executable, __file__, str(r), str(w),
             str(tmp / f"store{w}"), str(tmp / "in.pt"),
             str(servers[w].port), secret, str(tmp / f"w{w}r{r}.pt")],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for w in WORLDS for r in range(w)}
        logs = {key: p.communicate(timeout=400)[0]
                for key, p in procs.items()}
    finally:
        for srv in servers.values():
            srv.stop()
    for key, p in procs.items():
        assert p.returncode == 0, logs[key]
    return {w: [torch.load(tmp / f"w{w}r{r}.pt", weights_only=False)
                for r in range(w)] for w in WORLDS}


@pytest.fixture()
def jax_kv():
    from horovod_tpu.run.http_kv import KVClient as JKVClient
    from horovod_tpu.run.http_kv import RendezvousServer as JServer
    from horovod_tpu_torch.run.secret import make_secret_key
    secret = make_secret_key()
    srv = JServer(secret, host="127.0.0.1")
    try:
        yield JKVClient("127.0.0.1", srv.port, secret)
    finally:
        srv.stop()


def _jax_fleet(jp, jkv, tp, spec, scaler=False, **kw):
    from horovod_tpu.controller import fusion as j_fusion
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import DecodeWorker as JDecodeWorker
    from horovod_tpu.serving import FleetPolicy as JFleetPolicy
    from horovod_tpu.serving import FleetPolicyConfig as JFleetPolicyConfig
    from horovod_tpu.serving import PrefillWorker as JPrefillWorker
    from horovod_tpu.serving import ServingEngine as JServingEngine
    from horovod_tpu.serving import ServingFleet as JServingFleet
    j_fusion.clear_plan_cache()
    geom = dict(SURGE_GEOM if scaler else GEOM)
    make = lambda: JServingEngine(J_SERVE, jp, mesh=_mesh_1d(tp),  # noqa
                                  **geom)
    fleet = JServingFleet(
        [JPrefillWorker("p0", J_SERVE, jp, jkv, page_size=PS, tier="f32")],
        [JDecodeWorker("decode0", make(), jkv)], jkv,
        scaler_policy=JFleetPolicy(JFleetPolicyConfig(**SURGE_POLICY))
        if scaler else None, engine_factory=make if scaler else None)
    reqs = spec
    return fleet, fleet.serve(reqs, **kw), reqs


def _agree(ranks, part):
    """Every rank's streams and report equal rank 0's (lock-step: the
    report's times are the leader's)."""
    r0 = ranks[0][part]
    for res in ranks[1:]:
        assert res[part]["streams"] == r0["streams"], part
        assert res[part]["report"] == r0["report"], part
        assert res[part]["headers"] == r0["headers"] > 0, part


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_tp_fleet_f32_streams_equal_jax_fleet_and_colocated(
        worlds, flax_params, jax_kv, world):
    from horovod_tpu.serving import LoadSpec as JLoadSpec
    from horovod_tpu.serving import generate as j_generate
    _, jrep, jreqs = _jax_fleet(flax_params, jax_kv, world,
                                j_generate(JLoadSpec(**SPEC)))
    ranks = worlds[world]
    _agree(ranks, "f32")
    f = ranks[0]["f32"]
    rep = f["report"]
    assert rep["completed"] == jrep.completed == SPEC["num_requests"]
    assert rep["handoffs_streamed"] == SPEC["num_requests"]
    assert rep["handoffs_local"] == 0
    assert rep["kv_bytes_in"] == rep["kv_bytes_out"] == jrep.kv_bytes_out
    assert f["streams"] == _streams(jreqs) == ranks[0]["colocated"]
    for res in ranks:
        assert res["f32"]["pages"] == {"decode0": 0}
        assert res["f32"]["report"]["leaked_pages"] == {"decode0": 0}
        assert res["f32"]["report"]["refcounts_balanced"]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_fleet_fp8_import_is_bitwise_the_jax_pool_heads(worlds, world):
    """The fp8 wire's pages land in each rank's pool as its heads of the
    JAX pool's ``kq`` / ``vq`` after the same import, the row scales
    whole; and a fleet over the fp8 wire completes clean on every
    rank."""
    import jax.numpy as jnp
    from horovod_tpu.serving import CacheConfig as JCacheConfig
    from horovod_tpu.serving import PagedKVCache as JPagedKVCache
    from horovod_tpu.serving import decode_kv as j_decode_kv
    from horovod_tpu.serving import encode_kv as j_encode_kv
    from horovod_tpu.serving import import_pages as j_import_pages
    k, v = _kv()
    jpool = JPagedKVCache(JCacheConfig(
        num_layers=L, num_kv_heads=H, head_dim=D, slots=2, page_size=PS,
        max_len=32, compress=True))
    j_import_pages(jpool, 0, j_decode_kv(j_encode_kv(
        jnp.asarray(k), jnp.asarray(v), page_size=PS, tier="fp8")))
    cp = [int(jpool.cpage_table[0, i]) for i in range(KV_T // PS)]
    jkq = np.asarray(jpool.kq[:, cp]).view(np.uint8)
    jvq = np.asarray(jpool.vq[:, cp]).view(np.uint8)
    for r, res in enumerate(worlds[world]):
        a = res["adopt"]
        assert a["adopt_equal"] and a["adopt_fp8_equal"], r
        h0, n = a["heads"]
        assert (h0, n) == (r * H // world, H // world)
        np.testing.assert_array_equal(a["kq"].numpy(),
                                      jkq[..., h0:h0 + n, :])
        np.testing.assert_array_equal(a["vq"].numpy(),
                                      jvq[..., h0:h0 + n, :])
        np.testing.assert_array_equal(a["kscale"].numpy(),
                                      np.asarray(jpool.kscale[:, cp]))
        np.testing.assert_array_equal(a["vscale"].numpy(),
                                      np.asarray(jpool.vscale[:, cp]))
        assert a["length"] == KV_T
        full = (KV_T // PS) * PS
        np.testing.assert_array_equal(a["tail"].numpy(),
                                      k[:, full:, h0:h0 + n])
    ranks = worlds[world]
    _agree(ranks, "fp8")
    rep = ranks[0]["fp8"]["report"]
    assert rep["completed"] == SPEC["num_requests"]
    assert rep["handoffs_streamed"] == SPEC["num_requests"]
    assert rep["kv_bytes_in"] == rep["kv_bytes_out"]
    for res in ranks:
        assert res["fp8"]["pages"] == {"decode0": 0}
        assert res["fp8"]["compressed_pages"] == ranks[0]["fp8"][
            "compressed_pages"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_tp_fleet_dead_prefill_falls_back_on_every_rank(worlds, world):
    ranks = worlds[world]
    _agree(ranks, "dead")
    rep = ranks[0]["dead"]["report"]
    n = DEAD_SPEC["num_requests"]
    assert rep["completed"] == n and rep["handoffs_local"] >= 1
    assert rep["handoffs_streamed"] + rep["handoffs_local"] == n
    assert ranks[0]["dead"]["streams"] == ranks[0]["undisturbed"]
    for res in ranks:
        assert res["dead"]["pages"] == {"decode0": 0}
        assert res["dead"]["report"]["refcounts_balanced"]


def test_tp_fleet_scaler_grows_as_the_jax_fleet(worlds, flax_params,
                                                 jax_kv):
    from horovod_tpu.serving import fleet_spec as j_fleet_spec
    from horovod_tpu.serving import generate as j_generate
    jfleet, jrep, _ = _jax_fleet(flax_params, jax_kv, 2, j_generate(
        j_fleet_spec(**SURGE_SPEC)), scaler=True)
    ranks = worlds[2]
    _agree(ranks, "surge")
    s = ranks[0]["surge"]
    rep = s["report"]

    def acts(decisions):
        return [(d["action"], d["reason"]) for d in decisions
                if d["action"] != "hold"]
    assert acts(s["decisions"]) == acts(jfleet.scaler.decisions) == [
        ("add-engine", "fleet-slo-breach")]
    assert rep["engines"] == jrep.engines == 2
    assert rep["completed"] == jrep.completed == SURGE_SPEC["num_requests"]
    assert rep["migrated"] > 0 and jrep.migrated > 0
    assert rep["per_engine_completed"]["decode1"] > 0
    for res in ranks:
        assert res["surge"]["decisions"] == s["decisions"]
        assert res["surge"]["pages"] == {"decode0": 0, "decode1": 0}
        assert res["surge"]["report"]["refcounts_balanced"]


def test_tp_fleet_refuses_a_mesh_short_of_the_world(worlds):
    """``serve`` takes only decode engines whose mesh covers the world,
    as ``ServingEngine.serve`` does."""
    for res in worlds[2]:
        assert "covers the world of 2" in res["short_mesh"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5], sys.argv[6], sys.argv[7])
