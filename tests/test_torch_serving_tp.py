"""PyTorch/CUDA port: tensor-parallel serving -- the decode and verify
steps over a rank mesh, the kv-head-sharded page pool, the engine's mesh
and ``rebuild_mesh``, and the serving control plane -- against the JAX
package.

Gloo worlds of 2 and 4 (this file, run as a script, is each rank; they
meet through a ``FileStore`` under pytest's temporary directory; rank
``r`` is the JAX mesh's device ``r``), the JAX side under its own
``shard_map`` over as many of the conftest's CPU devices.  Weights: the
flax ``LlamaLM.init`` of ``LLAMA_SERVE`` (8 query and 8 kv heads, which
divide over tp 2 and 4), carried across with ``params_from_jax``; both
packages in f32.  Token and K/V inputs come from numpy seeds (the K/V
the pools start from is the JAX prefill's, written into both).

Tolerances: decode and verify logits within 1e-5 of the JAX step's
max |logit|; each rank's pool within 1e-5 (absolute) of the JAX pool's
head slice ``[..., r * kvh_l:(r + 1) * kvh_l, :]`` (the prefill rows
bitwise, the stepped rows computed by each package); the e4m3 pools and
scales after ``compress_cold`` bitwise; token streams token for token;
the control plane's report field for field but its times.  Every rank's
streams, decisions and report equal rank 0's (lock-step).
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
    CacheConfig, Decision, LoadSpec, PagedKVCache, PolicyConfig, Request,
    ServingControlPlane, ServingEngine, build_decode_step,
    build_verify_step, cache_sharding, decode_param_specs, generate)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
CFG = LLAMA_SERVE
WORLDS = (2, 4)
STEP_REL = 1e-5
KV_ATOL = 1e-5
STEP_GEOM = dict(slots=3, page_size=4, max_len=32)      # 8 pages a slot
STEP_SEQS = {0: (8, 14), 2: (9, 22)}    # slot: (seed, length); 1 idle
STEP_PREFILL = 6
STEP_RANGE = range(6, 10)               # 4 teacher-forced steps
FP8_GEOM = dict(slots=2, page_size=4, max_len=32)
FP8_PROMPT = 12
VERIFY_TOKENS = (7, 9)
ENGINE_KW = dict(slots=4, page_size=8, max_len=64)
ENGINE_LOAD = dict(num_requests=6, rate_rps=50.0, prompt_lens=(5, 12, 20),
                   output_lens=(4, 9), vocab_size=256, seed=3)
PLANE_KW = dict(slots=2, page_size=8, max_len=64)
PLANE_SCRIPTS = {          # name: (decision at decide-call 2, drain steps)
    "completion": (("shrink", "scripted", 1), 64),
    "reprefill": (("shrink", "scripted", 1), 0),
    "swap": (("shrink", "scripted-swap", 2), 0),
}
CHAOS_CFG = dict(interval_s=0.01, ttft_slo_s=10.0, queue_high=1000,
                 occupancy_low=-1.0, hysteresis=2, cooldown_s=0.1,
                 evict_lateness_s=0.05, drain_steps=4, max_tp=4)
CHAOS_SPEC = "kill@step=6,rank=3;slow@step=12,rank=1,secs=0.3"
CHAOS_KW = dict(slots=4, page_size=8, max_len=64)
CTL_FAMILIES = ("horovod_ctl_decisions_total", "horovod_ctl_resizes_total",
                "horovod_ctl_evictions_total",
                "horovod_ctl_drained_requests_total",
                "horovod_ctl_mesh_size", "horovod_ctl_healthy_ranks")


class ScriptedPolicy:
    """``script`` maps a decide-call index to a Decision; every other
    call holds (JAX ``tests/test_controlplane.py``'s)."""

    def __init__(self, script):
        self.script = dict(script)
        self.calls = 0

    def decide(self, sample):
        d = self.script.pop(self.calls, None)
        self.calls += 1
        return d if d is not None else Decision("hold", "scripted")

    def mark_applied(self, decision, now_s):
        pass


def _tokens(seed, t, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (1, t)).astype(
        np.int32)


def _plane_req():
    return Request(rid=0, prompt=np.full((8,), 0, np.int32),
                   max_new_tokens=12)


def _chaos_reqs():
    return [Request(rid=i, prompt=np.full((4,), i % 7, np.int32),
                    max_new_tokens=16) for i in range(12)]


def _resumed(req):
    """A request resumed after three emitted tokens of ``req``."""
    return Request(rid=100, prompt=np.asarray(req.prompt),
                   max_new_tokens=len(req.tokens) + 4,
                   tokens=list(req.tokens[:3]))


def _streams(reqs):
    return {r.rid: list(r.tokens) for r in reqs}


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The ranks (this file as each worker)
# ---------------------------------------------------------------------------


def _step_rank(world, params, inp):
    from horovod_tpu_torch.parallel import build_parallel_mesh, shard_params
    from horovod_tpu_torch.timeline import spans
    mesh = build_parallel_mesh(tp=world)
    cache = PagedKVCache(CacheConfig(
        num_layers=CFG.num_layers, num_kv_heads=CFG.num_kv_heads,
        head_dim=CFG.head_dim, **STEP_GEOM), cache_sharding(mesh,
                                                            device="cpu"))
    step = build_decode_step(CFG, mesh, slots=3, page_size=4,
                             pages_per_slot=8)
    local = shard_params(params, decode_param_specs(params),
                         mesh.axis_index("tp"), world)
    full_refused = ""
    try:
        step(params, cache.k, cache.v, *inp["args0"])
    except ValueError as e:
        full_refused = str(e)
    for slot, (k, v) in inp["prefill"].items():
        cache.write_prefill(slot, _t(k), _t(v))
    spans.recorder().reset()
    logits = []
    for tok in inp["tokens"]:
        for slot in STEP_SEQS:
            cache.reserve(slot, int(cache.lengths[slot]) + 1)
        out, cache.k, cache.v = step(
            local, cache.k, cache.v, _t(tok).long(),
            cache.lengths_device().long(), cache.table_device(),
            _t(inp["active"]))
        logits.append(out)
        for slot in STEP_SEQS:
            cache.lengths[slot] += 1
    return {"logits": logits, "k": cache.k, "v": cache.v,
            "head0": cache.head0, "heads": cache.local_heads,
            "legs": spans.recorder().leg_registry(), "meta": step._meta,
            "full_refused": full_refused}


def _fp8_cache(mesh, inp):
    cache = PagedKVCache(CacheConfig(
        num_layers=CFG.num_layers, num_kv_heads=CFG.num_kv_heads,
        head_dim=CFG.head_dim, compress=True, **FP8_GEOM),
        cache_sharding(mesh, device="cpu"))
    cache.write_prefill(0, _t(inp["k"]), _t(inp["v"]))
    return cache


def _fp8_verify_rank(world, params, inp):
    """The verify step (width 3) and the compressed pool and step."""
    from horovod_tpu_torch.parallel import build_parallel_mesh, shard_params
    mesh = build_parallel_mesh(tp=world)
    local = shard_params(params, decode_param_specs(params),
                         mesh.axis_index("tp"), world)
    cache = _fp8_cache(mesh, inp)
    cache.reserve(0, FP8_PROMPT + 3)
    verify = build_verify_step(CFG, mesh, slots=2, width=3, page_size=4,
                               pages_per_slot=8)
    vlog, _, _ = verify(local, cache.k.clone(), cache.v.clone(),
                        _t(inp["verify_tokens"]).long(),
                        cache.lengths_device().long(), cache.table_device(),
                        _t(inp["active"]))
    cache = _fp8_cache(mesh, inp)
    compressed = cache.compress_cold(0)
    pools = {n: getattr(cache, n).clone()
             for n in ("kq", "vq", "kscale", "vscale")}
    cache.reserve(0, FP8_PROMPT + 1)
    step = build_decode_step(CFG, mesh, slots=2, page_size=4,
                             pages_per_slot=8, compress=True)
    slog, _, _ = step(local, cache.k, cache.v, _t(inp["token"]).long(),
                      cache.lengths_device().long(), cache.table_device(),
                      _t(inp["active"]), *cache.compress_operands())
    return {"verify": vlog, "compressed": compressed, "pools": pools,
            "step": slog, "head0": cache.head0, "heads": cache.local_heads,
            "resident": cache.resident_bytes, "layout": cache.layout()}


def _engine_rank(world, params):
    from horovod_tpu_torch.parallel import build_parallel_mesh
    mesh = build_parallel_mesh(tp=world)
    eng = ServingEngine(CFG, params, mesh=mesh, device="cpu", **ENGINE_KW)
    reqs = generate(LoadSpec(**ENGINE_LOAD))
    rep = eng.serve(reqs)
    out = {"streams": _streams(reqs), "report": rep.as_dict(),
           "headers": eng._ls.headers, "leaked": eng.cache.allocated_pages}
    # rebuild_mesh to tp 1 over rank 0, then a resumed request through
    # re_prefill and decode_once, turn by turn as the control plane runs
    # them (every rank; rank 1 outside the new mesh).
    eng.rebuild_mesh(build_parallel_mesh(ranks=[0], tp=1))
    req = _resumed(reqs[0])
    st = eng.new_state()
    slot = eng.scheduler.restore(req)
    st["last_tokens"][slot] = eng.re_prefill(slot, req)
    while eng.scheduler.active:
        eng.decode_once(st, eng._ls.now)
        eng.sync()
    out.update(rebuilt=list(req.tokens), meta=eng.step._meta,
               in_mesh=eng.in_mesh, heads=eng.cache.local_heads)
    return out


def _plane_rank(world, params):
    out = {}
    for name, ((action, reason, size), drain) in PLANE_SCRIPTS.items():
        plane = ServingControlPlane(
            CFG, params, initial_tp=2,
            policy=ScriptedPolicy({2: Decision(action, reason,
                                               target_size=size)}),
            policy_config=PolicyConfig(interval_s=0.0, drain_steps=drain),
            device="cpu", **PLANE_KW)
        req = _plane_req()
        rep = plane.serve([req])
        out[name] = {"tokens": list(req.tokens), "report": rep.as_dict(),
                     "pages": plane.engine.cache.allocated_pages,
                     "mesh": plane.mesh_ranks}
    from horovod_tpu_torch.parallel import build_parallel_mesh
    eng = ServingEngine(CFG, params, mesh=build_parallel_mesh(tp=2),
                        device="cpu", **PLANE_KW)
    req = _plane_req()
    eng.serve([req])
    out["baseline"] = list(req.tokens)
    return out


def _chaos_rank(world, params):
    from horovod_tpu_torch.timeline import spans
    from horovod_tpu_torch.timeline.metrics import render_prometheus
    spans.recorder().reset()
    plane = ServingControlPlane(
        CFG, params, initial_tp=4, policy_config=PolicyConfig(**CHAOS_CFG),
        chaos_spec=CHAOS_SPEC, device="cpu", **CHAOS_KW)
    reqs = _chaos_reqs()
    rep = plane.serve(reqs)
    text = render_prometheus()
    legs = set()
    for acc in spans.recorder()._acc.values():
        legs.update(acc["legs"])
    return {"report": rep.as_dict(), "mesh": plane.mesh_ranks,
            "pages": plane.engine.cache.allocated_pages,
            "streams": _streams(reqs),
            "families": [f for f in CTL_FAMILIES if f in text],
            "legs": sorted(l for l in legs if l.startswith("ctl/"))}


def _worker(rank, world, store_path, in_path, out_path):
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    torch.set_num_threads(1)
    inp = torch.load(in_path, weights_only=False)
    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    res = {"step": _step_rank(world, params, inp["step"][world])}
    if world == 2:
        res["fp8"] = _fp8_verify_rank(world, params, inp["fp8"])
        res["engine"] = _engine_rank(world, params)
        res["plane"] = _plane_rank(world, params)
    else:
        res["chaos"] = _chaos_rank(world, params)
    thvd.barrier()
    torch.save(res, out_path)
    thvd.shutdown()


# ---------------------------------------------------------------------------
# The harness and the JAX side
# ---------------------------------------------------------------------------


def _jax_mesh(n):
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


def _step_inputs(jp):
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import prefill_forward as j_prefill_forward
    seqs = {s: _tokens(*a)[0] for s, a in STEP_SEQS.items()}
    prefill = {}
    for slot, seq in seqs.items():
        _, k, v = j_prefill_forward(jp, J_SERVE,
                                    jnp.asarray(seq[None, :STEP_PREFILL]))
        prefill[slot] = (np.asarray(k[:, 0]), np.asarray(v[:, 0]))
    tokens = []
    for i in STEP_RANGE:
        tok = np.zeros(3, np.int32)
        for slot, seq in seqs.items():
            tok[slot] = seq[i]
        tokens.append(tok)
    return {"prefill": prefill, "tokens": tokens,
            "active": np.array([True, False, True])}


def _fp8_inputs(jp):
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import prefill_forward as j_prefill_forward
    prompt = _tokens(2, FP8_PROMPT)
    _, k, v = j_prefill_forward(jp, J_SERVE, jnp.asarray(prompt))
    tok = np.zeros(2, np.int32)
    tok[0] = prompt[0, -1]
    vt = np.zeros((2, 3), np.int32)
    vt[0] = [tok[0], *VERIFY_TOKENS]
    return {"k": np.asarray(k[:, 0]), "v": np.asarray(v[:, 0]),
            "token": tok, "verify_tokens": vt,
            "active": np.array([True, False])}


@pytest.fixture(scope="module")
def inputs(flax_params):
    import jax
    from horovod_tpu_torch.models import params_from_jax
    params = params_from_jax(jax.tree.map(np.asarray, flax_params),
                             device="cpu")
    step = {w: _step_inputs(flax_params) for w in WORLDS}
    for w in WORLDS:
        # A full dict handed to the tp step: refused on its shapes.
        step[w]["args0"] = (torch.zeros(3, dtype=torch.long),
                            torch.zeros(3, dtype=torch.long),
                            torch.zeros((3, 8), dtype=torch.int32),
                            torch.zeros(3, dtype=torch.bool))
    return {"params": {k: v.numpy() for k, v in params.items()},
            "step": step, "fp8": _fp8_inputs(flax_params)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("serving_tp")
    torch.save(inputs, tmp / "in.pt")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = {(w, r): subprocess.Popen(
        [sys.executable, __file__, str(r), str(w), str(tmp / f"store{w}"),
         str(tmp / "in.pt"), str(tmp / f"w{w}r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for w in WORLDS for r in range(w)}
    logs = {key: p.communicate(timeout=400)[0] for key, p in procs.items()}
    for key, p in procs.items():
        assert p.returncode == 0, logs[key]
    return {w: [torch.load(tmp / f"w{w}r{r}.pt", weights_only=False)
                for r in range(w)] for w in WORLDS}


def _close_rel(got, want, rel=STEP_REL, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _bits(x):
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _report_fields(rep):
    """A control-plane report without its times."""
    out = {k: v for k, v in rep.items()
           if k not in ("serving", "slo_violation_s", "decisions")}
    out["decisions"] = [{k: v for k, v in d.items() if k != "now_s"}
                        for d in rep["decisions"]]
    s = rep["serving"]
    out["serving"] = {k: s[k] for k in (
        "num_requests", "completed", "rejected", "prompt_tokens",
        "new_tokens", "decode_steps", "mean_occupancy")}
    return out


# ---------------------------------------------------------------------------
# 1. decode_param_specs
# ---------------------------------------------------------------------------


def test_decode_param_specs_match_jax_leaf_for_leaf(flax_params, inputs):
    import jax
    from horovod_tpu.serving import decode_param_specs as j_specs
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            j_specs(flax_params), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        names = [getattr(k, "key", "") for k in path]
        flat[".".join(names[1:])] = tuple(spec)
    got = decode_param_specs(inputs["params"])
    assert got == flat
    assert got["layer_1.mlp.w_down.kernel"] == ("tp", None)
    assert got["layer_0.attn.wk.kernel"] == (None, "tp")
    assert decode_param_specs(inputs["params"], "m")[
        "layer_0.attn.wo.kernel"] == ("m", None)


# ---------------------------------------------------------------------------
# 2. The decode step at tp 2 and 4
# ---------------------------------------------------------------------------


def _jax_step_run(jp, inp, world):
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import CacheConfig as JCacheConfig
    from horovod_tpu.serving import PagedKVCache as JPagedKVCache
    from horovod_tpu.serving import build_decode_step as j_build
    from horovod_tpu.serving import cache_sharding as j_sharding
    mesh = _jax_mesh(world)
    cache = JPagedKVCache(JCacheConfig(
        num_layers=CFG.num_layers, num_kv_heads=CFG.num_kv_heads,
        head_dim=CFG.head_dim, **STEP_GEOM), j_sharding(mesh))
    step = j_build(J_SERVE, mesh, slots=3, page_size=4, pages_per_slot=8)
    for slot, (k, v) in inp["prefill"].items():
        cache.write_prefill(slot, jnp.asarray(k), jnp.asarray(v))
    logits = []
    for tok in inp["tokens"]:
        for slot in STEP_SEQS:
            cache.reserve(slot, int(cache.lengths[slot]) + 1)
        out, cache.k, cache.v = step(
            jp, cache.k, cache.v, jnp.asarray(tok), cache.lengths_device(),
            cache.table_device(), jnp.asarray(inp["active"]))
        logits.append(np.asarray(out))
        for slot in STEP_SEQS:
            cache.lengths[slot] += 1
    return logits, np.asarray(cache.k), np.asarray(cache.v), step._meta


@pytest.mark.parametrize("world", WORLDS)
def test_decode_step_matches_jax_at_tp(flax_params, inputs, worlds, world):
    inp = inputs["step"][world]
    want, jk, jv, jmeta = _jax_step_run(flax_params, inp, world)
    active = inp["active"]
    kvh = CFG.num_kv_heads // world
    for r, res in enumerate(worlds[world]):
        s = res["step"]
        assert (s["head0"], s["heads"]) == (r * kvh, kvh)
        assert "shard" in s["full_refused"]
        for got, w in zip(s["logits"], want):
            _close_rel(got.numpy()[active], w[active], what=f"rank {r}")
        hs = slice(r * kvh, (r + 1) * kvh)
        np.testing.assert_allclose(s["k"].numpy(), jk[..., hs, :],
                                   atol=KV_ATOL)
        np.testing.assert_allclose(s["v"].numpy(), jv[..., hs, :],
                                   atol=KV_ATOL)
        # Logits replicated over the tp set: every rank's are rank 0's.
        for got, w in zip(s["logits"], worlds[world][0]["step"]["logits"]):
            assert torch.equal(got, w)
        assert s["meta"] == dict(jmeta)
        # Each executed row-parallel sum noted its plan row once a step.
        steps = len(STEP_RANGE)
        assert s["legs"] == {
            f"serving_decode/layer{li}/{part}": {
                "nbytes": steps * 3 * CFG.d_model * 4, "buckets": steps}
            for li in range(CFG.num_layers)
            for part in ("attn_wo", "mlp_down")}


def test_decode_plan_rows_match_jax_and_verify_rows_are_the_ports():
    from horovod_tpu.controller import fusion as j_fusion
    from horovod_tpu_torch.controller import fusion as t_fusion
    kw = dict(layers=2, slots=3, d_model=64, dtype="float32", axis="tp")
    got = t_fusion.plan_exchange("serving", kind="serving_decode", **kw)
    want = j_fusion.plan_exchange("serving", kind="serving_decode", **kw)
    assert [dataclasses_tuple(l) for l in got.legs] == \
        [dataclasses_tuple(l) for l in want.legs]
    # The verify step is width calls of the decode step's shapes: width x
    # 2 rows a layer of slots x d_model (JAX: 2 of slots x width x d).
    v = t_fusion.plan_exchange("serving", kind="serving_verify", width=3,
                               **kw).legs
    assert len(v) == 3 * 2 * 2 and {l.elements for l in v} == {3 * 64}
    assert v[4].tag == "serving_verify/col1/layer0/attn_wo"
    assert {l.kind for l in v} == {"serving_verify"}


def dataclasses_tuple(leg):
    return (leg.tag, leg.axis, leg.collective, leg.codec, leg.wire_dtype,
            leg.elements, leg.nbytes, leg.kind, leg.bucket, leg.audit)


# ---------------------------------------------------------------------------
# 3-4. The verify step and fp8 cold pages at tp 2
# ---------------------------------------------------------------------------


def _jax_fp8_cache(inp, mesh):
    import jax.numpy as jnp
    from horovod_tpu.serving import CacheConfig as JCacheConfig
    from horovod_tpu.serving import PagedKVCache as JPagedKVCache
    from horovod_tpu.serving import cache_sharding as j_sharding
    cache = JPagedKVCache(JCacheConfig(
        num_layers=CFG.num_layers, num_kv_heads=CFG.num_kv_heads,
        head_dim=CFG.head_dim, compress=True, **FP8_GEOM), j_sharding(mesh))
    cache.write_prefill(0, jnp.asarray(inp["k"]), jnp.asarray(inp["v"]))
    return cache


def test_verify_step_matches_jax_at_tp2(flax_params, inputs, worlds):
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import build_verify_step as j_verify
    inp = inputs["fp8"]
    mesh = _jax_mesh(2)
    cache = _jax_fp8_cache(inp, mesh)
    cache.reserve(0, FP8_PROMPT + 3)
    step = j_verify(J_SERVE, mesh, slots=2, width=3, page_size=4,
                    pages_per_slot=8)
    want, _, _ = step(flax_params, cache.k, cache.v,
                      jnp.asarray(inp["verify_tokens"]),
                      cache.lengths_device(), cache.table_device(),
                      jnp.asarray(inp["active"]))
    want = np.asarray(want)
    for r, res in enumerate(worlds[2]):
        _close_rel(res["fp8"]["verify"][0], want[0], what=f"rank {r}")


def test_kv_compress_scales_and_e4m3_shards_bitwise_jax_at_tp2(
        flax_params, inputs, worlds):
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import build_decode_step as j_build
    from horovod_tpu_torch.collectives.compression import fp8_quantize
    inp = inputs["fp8"]
    mesh = _jax_mesh(2)
    cache = _jax_fp8_cache(inp, mesh)
    pool_k = np.asarray(cache.k)
    assert cache.compress_cold(0) == 2
    want = {n: np.asarray(getattr(cache, n))
            for n in ("kq", "vq", "kscale", "vscale")}
    cache.reserve(0, FP8_PROMPT + 1)
    step = j_build(J_SERVE, mesh, slots=2, page_size=4, pages_per_slot=8,
                   compress=True)
    jl, _, _ = step(flax_params, cache.k, cache.v,
                    jnp.asarray(inp["token"]), cache.lengths_device(),
                    cache.table_device(), jnp.asarray(inp["active"]),
                    *cache.compress_operands())
    kvh = CFG.num_kv_heads // 2
    for r, res in enumerate(worlds[2]):
        f = res["fp8"]
        assert f["compressed"] == 2 and f["heads"] == kvh
        hs = slice(r * kvh, (r + 1) * kvh)
        for n in ("kscale", "vscale"):
            assert _bits(f["pools"][n]) == _bits(want[n]), (r, n)
        for n in ("kq", "vq"):
            assert _bits(f["pools"][n]) == _bits(
                np.ascontiguousarray(want[n][..., hs, :])), (r, n)
        _close_rel(f["step"][0], np.asarray(jl)[0], what=f"rank {r}")
        # Reported sizes and the layout stay the whole pool's.
        assert f["layout"] == cache.layout()
        assert f["resident"] == cache.resident_bytes
    # The trap the tp Max closes: a scale over one rank's heads alone
    # differs from the row's over every head.
    pids = cache.cpage_table[0, :2]
    rows = pool_k[:, [0, 1]][..., :kvh, :]
    l, n, pg, hh, dd = rows.shape
    _, local = fp8_quantize(torch.from_numpy(
        rows.reshape(l * n * pg, hh * dd)), axis=0)
    assert not np.array_equal(local.numpy().reshape(l, n, pg),
                              want["kscale"][:, pids])


# ---------------------------------------------------------------------------
# 5-6. The engine at tp 2, rebuild_mesh to tp 1
# ---------------------------------------------------------------------------


def test_engine_at_tp2_streams_match_jax_and_ranks_agree(flax_params,
                                                         worlds):
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import LoadSpec as JLoadSpec
    from horovod_tpu.serving import ServingEngine as JServingEngine
    from horovod_tpu.serving import generate as j_generate
    jeng = JServingEngine(J_SERVE, flax_params, mesh=_jax_mesh(2),
                          **ENGINE_KW)
    jreqs = j_generate(JLoadSpec(**ENGINE_LOAD))
    assert len({r.arrival_s for r in jreqs}) == len(jreqs)  # spread
    jeng.serve(jreqs)
    r0 = worlds[2][0]["engine"]
    assert r0["streams"] == _streams(jreqs)
    assert r0["report"]["completed"] == ENGINE_LOAD["num_requests"]
    assert r0["leaked"] == 0
    for res in worlds[2][1:]:
        e = res["engine"]
        assert e["streams"] == r0["streams"]
        assert e["report"] == r0["report"]      # times included
        assert e["headers"] == r0["headers"] > 0

    # rebuild_mesh(tp 1) + re_prefill + decode, the same calls.
    jeng.rebuild_mesh(_jax_mesh(1))
    req = _resumed(jreqs[0])
    st = {"completed": [], "occ_samples": [], "decode_steps": 0,
          "last_tokens": np.zeros((ENGINE_KW["slots"],), np.int32),
          "adapter_ids": np.zeros((ENGINE_KW["slots"],), np.int32)}
    slot = jeng.scheduler.restore(req)
    st["last_tokens"][slot] = jeng.re_prefill(slot, req)
    while jeng.scheduler.active:
        jeng.decode_once(st, lambda: 0.0)
    for r, res in enumerate(worlds[2]):
        e = res["engine"]
        assert e["rebuilt"] == list(req.tokens)
        assert e["meta"]["resized_from"] == 2 and e["meta"]["tp"] == 1
        assert e["in_mesh"] == (r == 0)
        assert e["heads"] == (CFG.num_kv_heads if r == 0 else 0)


# ---------------------------------------------------------------------------
# 7-8. The control plane at worlds 2 and 4
# ---------------------------------------------------------------------------


def _jax_plane(jp, name):
    import jax
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import Decision as JDecision
    from horovod_tpu.serving import PolicyConfig as JPolicyConfig
    from horovod_tpu.serving import ServingControlPlane as JPlane
    (action, reason, size), drain = PLANE_SCRIPTS[name]
    plane = JPlane(J_SERVE, jp, devices=jax.devices()[:2], initial_tp=2,
                   policy=ScriptedPolicy({2: JDecision(
                       action, reason, target_size=size)}),
                   policy_config=JPolicyConfig(interval_s=0.0,
                                               drain_steps=drain),
                   **PLANE_KW)
    req = _plane_req()
    rep = plane.serve([req])
    return list(req.tokens), _report_fields(rep.as_dict())


@pytest.mark.parametrize("name", sorted(PLANE_SCRIPTS))
def test_control_plane_drills_match_jax_at_world2(flax_params, worlds,
                                                  name):
    tokens, report = _jax_plane(flax_params, name)
    r0 = worlds[2][0]["plane"]
    got = r0[name]
    assert _report_fields(got["report"]) == report
    assert got["report"]["lost_requests"] == 0
    assert got["report"]["drain_leaked_pages"] == 0
    assert got["pages"] == 0 and got["report"]["resizes"] == 1
    if name == "reprefill":
        # The prefix emitted before the shrink is the undisturbed run's;
        # the request runs to completion on the tp 1 mesh.
        assert got["tokens"][:4] == r0["baseline"][:4] == tokens[:4]
        assert len(got["tokens"]) == 12
        assert got["mesh"] == [0]
    else:
        assert got["tokens"] == r0["baseline"] == tokens
    for res in worlds[2][1:]:
        other = res["plane"][name]
        assert other["tokens"] == got["tokens"]
        assert other["report"] == got["report"]     # times included
        assert other["pages"] == 0


def test_control_plane_chaos_drill_at_world4(flax_params, worlds):
    import jax
    from horovod_tpu.models.transformer import LLAMA_SERVE as J_SERVE
    from horovod_tpu.serving import PolicyConfig as JPolicyConfig
    from horovod_tpu.serving import ServingControlPlane as JPlane
    jplane = JPlane(J_SERVE, flax_params, devices=jax.devices()[:4],
                    initial_tp=4, policy_config=JPolicyConfig(**CHAOS_CFG),
                    chaos_spec=CHAOS_SPEC, **CHAOS_KW)
    jrep = jplane.serve(_chaos_reqs())
    r0 = worlds[4][0]["chaos"]
    rep = r0["report"]
    assert rep["lost_requests"] == 0 and rep["drain_leaked_pages"] == 0
    assert rep["serving"]["completed"] == 12 and r0["pages"] == 0
    assert rep["dead_ranks"] == jrep.dead_ranks == [3]
    assert rep["evicted_ranks"] == jrep.evicted_ranks == [1]
    assert rep["resizes"] >= 2 and rep["mesh_size_final"] == 2
    assert 1 not in r0["mesh"] and 3 not in r0["mesh"]
    assert any(d["action"] == "shrink" and d["reason"] == "rank-dead"
               for d in rep["decisions"])
    assert any(d["action"] == "evict" and d["evict_rank"] == 1
               for d in rep["decisions"])
    assert rep["drained_completed"] + rep["drained_reprefilled"] >= 1
    assert r0["families"] == list(CTL_FAMILIES)
    assert {"ctl/fault/kill", "ctl/fault/slow",
            "ctl/shrink/rank-dead"} <= set(r0["legs"])
    assert any(l.startswith("ctl/evict/straggler-lateness")
               for l in r0["legs"])
    for res in worlds[4][1:]:
        c = res["chaos"]
        assert c["report"]["decisions"] == rep["decisions"]
        assert c["report"] == rep
        assert c["streams"] == r0["streams"] and c["mesh"] == r0["mesh"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
