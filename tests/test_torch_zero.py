"""PyTorch/CUDA port: ZeRO-1 (``optim/zero.py``) against the JAX package.

In one process:

* ``plan_arena`` / ``arena_pack`` / ``arena_unpack`` equal to the JAX
  planner's (mixed dtypes, arenas that pad);
* ``zero_report`` equal to the JAX dict for ResNet-50's parameter shapes
  (``jax.eval_shape``; the port's model on the meta device) with
  ``optax.sgd(0.1, momentum=0.9)`` / ``SGD(0.1, momentum=0.9)``, at worlds
  1, 2, 4 and 256, uncompressed, fp16, fp8, topk:0.01 and powersgd:4;
* three ``make_flax_train_step(..., zero_stage=1)`` steps of a one-stage
  ResNet converted with ``resnet_state_from_jax`` against the JAX
  ``make_flax_train_step(..., zero_stage=1)`` on a one-device mesh (the
  JAX step takes BN statistics per device), within ``test_torch_resnet``'s
  tolerances;
* the ``DistributedOptimizer`` refusal and the ``HOROVOD_ZERO`` default.

Gloo worlds of 2 and 4 (this file, run as a script, is each rank):

* three ZeRO-1 steps of a small MLP (53 f32 values: the arenas pad at
  both worlds) with SGD + momentum and with AdamW equal to plain data
  parallel (``DistributedOptimizer``) within 1e-6 of max |parameter|, and
  to the JAX ``make_train_step(..., zero_stage=1)`` on a mesh of as many
  devices within 1e-5 (AdamW: optax and torch order the decoupled decay
  otherwise);
* ``compressed_allgather`` (none, fp16, bf16, fp8): every rank's result
  bitwise equal, and bitwise equal to the JAX op under ``jax.shard_map``;
  a ZeRO-1 step with the fp8 and fp16 gathers leaves every replica
  bitwise equal;
* ``ef_delta_allgather`` (powersgd:2, topk:0.25) against the JAX op:
  top-k bitwise, PowerSGD within 1e-5 of max |value| (the seed matrix's
  cosine is within half an ulp on each side, not bitwise; the products
  sum in another order);
* an error-feedback ZeRO-1 step (topk:0.5): replicas bitwise equal,
  residuals on the shard owner;
* the exchanged bytes the ZeRO-1 counters measure over a step equal to
  ``zero_report``'s, uncompressed and with fp8;
* at world 4 laid out as 2 nodes of 2 (``HOROVOD_HIERARCHICAL=2,2``),
  ZeRO-1 through the per-leg codecs ``ici:none,dcn:none`` and
  ``ici:none,dcn:fp8`` -- the reduce-scatter within the node, then
  across, shard ``ici * n_dcn + dcn`` on each rank -- against the JAX
  ``zero_stage=1`` step on a ``(dcn, ici) = (2, 2)`` mesh: uncompressed
  within 1e-5, with fp8 every value within one e4m3 step (at its
  arena's scale) of JAX's, the replicas bitwise equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu_torch.optim import zero as tzero

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_HIERARCHICAL",
                 "HOROVOD_COMPRESSION", "HOROVOD_ZERO")
WORLDS = (2, 4)
STEPS = 3
BATCH = 8
SHAPES = {"b1": (5,), "b2": (3,), "w1": (6, 5), "w2": (5, 3)}  # flax order
OPTS = {"sgd": (dict(lr=0.1, momentum=0.9),
                lambda: optax.sgd(0.1, momentum=0.9)),
        "adamw": (dict(lr=1e-2, weight_decay=1e-4),
                  lambda: optax.adamw(1e-2, weight_decay=1e-4))}
GATHER_CODECS = ("none", "fp16", "bf16", "fp8")
EF_CODECS = ("powersgd:2", "topk:0.25")
PARAM_ATOL = 1e-5
F32_REL = 1e-6


def _init_params():
    rng = np.random.RandomState(0)
    return {k: (0.5 * rng.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _data(step):
    rng = np.random.RandomState(100 + step)
    return (rng.randn(BATCH, 6).astype(np.float32),
            rng.randn(BATCH, 3).astype(np.float32))


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _init_params().items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v)))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _mlp_loss(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def _jax_loss(p, batch):
    x, y = batch
    pred = jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return jnp.mean((pred - y) ** 2)


def _shard_rows(rank, world):
    n = BATCH // world
    return slice(rank * n, (rank + 1) * n)


def _gather_input(rank):
    return np.random.RandomState(50 + rank).randn(37).astype(np.float32) * 3


def _delta_input(rank):
    return np.random.RandomState(60 + rank).randn(37).astype(np.float32)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


HIER_CODECS = ("ici:none,dcn:none", "ici:none,dcn:fp8")


def _train(rank, world, opt_name, zero, zero_compression=None):
    from horovod_tpu_torch.timeline.metrics import zero_totals
    from horovod_tpu_torch.training import make_train_step
    model = _MLP()
    params = list(model.parameters())
    kw, _ = OPTS[opt_name]
    cls = torch.optim.SGD if opt_name == "sgd" else torch.optim.AdamW
    opt = cls(params, **kw)
    if zero:
        step = make_train_step(model, _mlp_loss, opt, zero_stage=1,
                               zero_compression=zero_compression)
    else:
        step = make_train_step(
            model, _mlp_loss, thvd.DistributedOptimizer(
                opt, named_parameters=model.named_parameters(),
                compression="none"), zero_stage=0)
    losses, bytes_per_step = [], []
    for s in range(STEPS):
        x, y = _data(s)
        rows = _shard_rows(rank, world)
        before = zero_totals()
        losses.append(step((torch.from_numpy(x[rows]),
                            torch.from_numpy(y[rows]))).item())
        after = zero_totals()
        bytes_per_step.append({k: after[k] - before[k] for k in after
                               if k != "opt_state_bytes"})
    out = {"params": {n: p.detach().clone()
                      for n, p in model.named_parameters()},
           "losses": losses, "bytes": bytes_per_step,
           "opt_state_bytes": zero_totals()["opt_state_bytes"]}
    if zero:
        out["report"] = tzero.zero_report(opt, params, world,
                                          compression=zero_compression)
        state = step.zero_state
        out["residuals"] = None if state.residuals is None else \
            [r.clone() for r in state.residuals]
    return out


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {}
    for opt_name in OPTS:
        res["zero", opt_name] = _train(rank, world, opt_name, True)
        res["dp", opt_name] = _train(rank, world, opt_name, False)
    for codec in ("fp16", "fp8", "topk:0.5"):
        res["zero_codec", codec] = _train(rank, world, "sgd", True, codec)
    x = torch.from_numpy(_gather_input(rank))
    for codec in GATHER_CODECS:
        res["gather", codec] = tzero.compressed_allgather(x,
                                                          compression=codec)
    d = torch.from_numpy(_delta_input(rank))
    for codec in EF_CODECS:
        res["ef_delta", codec] = tzero.ef_delta_allgather(
            d, compression=thvd.collectives.compression.parse_compression(
                codec))
    if world == 4:
        import dataclasses
        from horovod_tpu_torch.core.state import global_state
        st = global_state()
        base = st.config
        st.config = dataclasses.replace(base, hierarchical="2,2")
        for codec in HIER_CODECS:
            res["zero_hier", codec] = _train(rank, world, "sgd", True, codec)
        st.config = base
    thvd.barrier()
    torch.save(res, out)
    thvd.shutdown()


def _run_world(tmp, world):
    store = str(tmp / "store")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), store,
         str(tmp / f"r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {r: torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(world)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: _run_world(tmp_path_factory.mktemp(f"zero{w}"), w)
            for w in WORLDS}


def _jax_shard_map(world, fn, inputs_by_rank):
    """``fn`` per device under ``jax.shard_map`` (op by op, as in
    ``tests/test_torch_fp8_topk.py``) on a ``("hvd",)`` mesh."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    stacked = [jnp.asarray(np.stack([inputs_by_rank[r][i]
                                     for r in range(world)]))
               for i in range(len(inputs_by_rank[0]))]
    f = jax.shard_map(
        lambda *xs: jax.tree.map(lambda y: y[None],
                                 fn(*[x[0] for x in xs])),
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False)
    return jax.tree.map(np.asarray, f(*stacked))


def _jax_zero_steps(world, opt_name, zero_compression=None):
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:world])
    try:
        opt = OPTS[opt_name][1]()
        step = hvd.make_train_step(_jax_loss, opt, zero_stage=1,
                                   zero_compression=zero_compression)
        params = {k: jnp.asarray(v) for k, v in _init_params().items()}
        state = hvd.zero_init(opt, params)
        losses = []
        for s in range(STEPS):
            x, y = _data(s)
            batch = (hvd.shard_batch(jnp.asarray(x)),
                     hvd.shard_batch(jnp.asarray(y)))
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        return {k: np.asarray(v) for k, v in params.items()}, losses
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 3, 8])
def test_arena_plan_pack_unpack_match_jax(world):
    from horovod_tpu.optim import zero as jzero
    rng = np.random.RandomState(world)
    arrays = [rng.randn(4, 5).astype(np.float32),
              rng.randn(7).astype(np.float32),
              rng.randint(0, 9, (3,)).astype(np.int32),
              rng.randn(13).astype(np.float32)]
    tleaves = [torch.from_numpy(a) for a in arrays]
    jleaves = [jnp.asarray(a) for a in arrays]
    tspec = tzero.plan_arena(tleaves, world)
    jspec = jzero.plan_arena(jleaves, world)
    assert [(str(b.dtype).replace("torch.", ""), [s.index for s in b.leaves],
             b.size, b.padded, b.shard) for b in tspec.buffers] == \
        [(str(b.dtype), [s.index for s in b.leaves], b.size, b.padded,
          b.shard) for b in jspec.buffers]
    tarenas = tzero.arena_pack(tleaves, tspec)
    for t, j in zip(tarenas, jzero.arena_pack(jleaves, jspec)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, a in zip(tzero.arena_unpack(tarenas, tspec), arrays):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("compression", [None, "fp16", "fp8", "topk:0.01",
                                         "powersgd:4"])
def test_zero_report_matches_jax_for_resnet50(compression):
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu.optim import zero as jzero
    from horovod_tpu_torch.models import ResNet50
    fmodel = jresnet.ResNet50(num_classes=1000, dtype=jnp.bfloat16,
                              space_to_depth=True)
    shapes = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, device="meta")
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    sgd = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    for world in (1, 2, 4, 256):
        want = jzero.zero_report(optax.sgd(0.1, momentum=0.9),
                                 shapes["params"], world,
                                 compression=compression)
        got = tzero.zero_report(sgd, params, world, compression=compression)
        assert got == want, (world, got, want)


def test_zero_flax_steps_match_jax_on_a_one_stage_resnet(monkeypatch):
    import horovod_tpu as hvd
    from horovod_tpu.training import make_flax_train_step as jstep
    from test_torch_resnet import _batch, _tiny_flax, _tiny_port
    from horovod_tpu_torch.models import resnet_state_from_jax
    from horovod_tpu_torch.training import make_flax_train_step
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")   # JAX: interpret kernels
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    model, variables = _tiny_flax(seed=2)
    batch = _batch()
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    try:
        opt = optax.sgd(0.1, momentum=0.9)
        step = jstep(model.apply, opt, zero_stage=1)
        jv = jax.tree.map(jnp.asarray, variables)
        params, stats = jv["params"], jv["batch_stats"]
        state = hvd.zero_init(opt, params)
        data = hvd.shard_batch(tuple(map(jnp.asarray, batch)))
        want_losses = []
        for _ in range(STEPS):
            params, stats, state, loss = step(params, stats, state, data)
            want_losses.append(float(loss))
        want = resnet_state_from_jax(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": jax.tree.map(np.asarray, stats)}, device="cpu")
    finally:
        hvd.shutdown()
    thvd.init(device="cpu")
    try:
        ours = _tiny_port(variables)
        tstep = make_flax_train_step(
            ours, torch.optim.SGD(ours.parameters(), lr=0.1, momentum=0.9),
            zero_stage=1)
        assert isinstance(tstep.zero_state, tzero.ZeroState)
        data = tuple(torch.from_numpy(a) for a in batch)
        losses = [tstep(data).item() for _ in range(STEPS)]
        got = ours.state_dict()
    finally:
        thvd.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), atol=2e-5,
                                   rtol=0, err_msg=name)


def test_zero_refuses_a_distributed_optimizer_and_reads_horovod_zero(
        monkeypatch):
    from horovod_tpu_torch.training import (_resolve_zero_stage,
                                            make_train_step)
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    thvd.init(device="cpu")
    try:
        model = _MLP()
        dopt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        with pytest.raises(ValueError, match="bare optimizer"):
            make_train_step(model, _mlp_loss, dopt, zero_stage=1)
        with pytest.raises(ValueError, match="bare optimizer"):
            tzero.zero_init(dopt, model.parameters())
        with pytest.raises(ValueError, match="0 or 1"):
            make_train_step(model, _mlp_loss, dopt, zero_stage=2)
        assert _resolve_zero_stage(None) == 0
        assert make_train_step(model, _mlp_loss, dopt).zero_state is None
    finally:
        thvd.shutdown()
    monkeypatch.setenv("HOROVOD_ZERO", "1")
    thvd.init(device="cpu")
    try:
        model = _MLP()
        step = make_train_step(model, _mlp_loss, torch.optim.SGD(
            model.parameters(), lr=0.1, momentum=0.9))
        assert _resolve_zero_stage(None) == 1
        assert isinstance(step.zero_state, tzero.ZeroState)
        x, y = _data(0)
        assert np.isfinite(step((torch.from_numpy(x),
                                 torch.from_numpy(y))).item())
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# Gloo worlds
# ---------------------------------------------------------------------------


def _assert_params(got, want, atol):
    for name, w in want.items():
        g = got[name].numpy() if torch.is_tensor(got[name]) else got[name]
        w = w.numpy() if torch.is_tensor(w) else w
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("opt_name", sorted(OPTS))
@pytest.mark.parametrize("world", WORLDS)
def test_zero_steps_match_plain_data_parallel(worlds, world, opt_name):
    dp = worlds[world][0]["dp", opt_name]
    scale = max(float(v.abs().max()) for v in dp["params"].values())
    for r in range(world):
        z = worlds[world][r]["zero", opt_name]
        _assert_params(z["params"], dp["params"], F32_REL * scale)
        np.testing.assert_allclose(z["losses"], dp["losses"], rtol=1e-6)
        # The padded arena: a rank's state is its shard, 1/world of it.
        assert z["opt_state_bytes"] == z["report"][
            "opt_state_bytes_per_chip_zero1"]
    moved = [p for p in dp["params"]]
    assert moved == list(SHAPES)


@pytest.mark.parametrize("opt_name", sorted(OPTS))
@pytest.mark.parametrize("world", WORLDS)
def test_zero_steps_match_jax_zero_stage_1(worlds, world, opt_name):
    want, want_losses = _jax_zero_steps(world, opt_name)
    for r in range(world):
        z = worlds[world][r]["zero", opt_name]
        _assert_params(z["params"], want, PARAM_ATOL)
        np.testing.assert_allclose(z["losses"], want_losses, rtol=1e-5)


@pytest.mark.parametrize("codec", HIER_CODECS)
def test_zero_per_leg_codecs_on_two_levels_match_jax(worlds, monkeypatch,
                                                     codec):
    from horovod_tpu.collectives.compression import fp8_quantize
    monkeypatch.setenv("HOROVOD_HIERARCHICAL", "2,2")
    want, want_losses = _jax_zero_steps(4, "sgd", codec)
    ref = worlds[4][0]["zero_hier", codec]["params"]
    fp8 = codec.endswith("fp8")
    arena = np.concatenate([want[k].reshape(-1) for k in SHAPES])
    step = float(fp8_quantize(jnp.asarray(arena))[1]) * 32 if fp8 else 0.0
    for r in range(4):
        z = worlds[4][r]["zero_hier", codec]
        for name in SHAPES:
            assert torch.equal(z["params"][name], ref[name])
        _assert_params(z["params"], want, step + PARAM_ATOL)
        np.testing.assert_allclose(z["losses"], want_losses,
                                   rtol=1e-2 if fp8 else 1e-5)
    dp = worlds[4][0]["dp", "sgd"]["params"]
    assert fp8 != all(torch.equal(ref[n], dp[n]) or
                      np.allclose(ref[n].numpy(), dp[n].numpy(), rtol=0,
                                  atol=F32_REL) for n in SHAPES)


@pytest.mark.parametrize("codec", GATHER_CODECS)
@pytest.mark.parametrize("world", WORLDS)
def test_compressed_allgather_matches_jax(worlds, world, codec):
    from horovod_tpu.collectives.compression import parse_compression
    from horovod_tpu.optim import zero as jzero
    want = _jax_shard_map(world, lambda x: jzero.compressed_allgather(
        x, axes=("hvd",), compression=parse_compression(codec)),
        {r: (_gather_input(r),) for r in range(world)})
    for r in range(world):
        got = worlds[world][r]["gather", codec]
        assert got.dtype == torch.float32 and got.shape == (37 * world,)
        np.testing.assert_array_equal(got.numpy(), want[r])
        assert torch.equal(got, worlds[world][0]["gather", codec])


@pytest.mark.parametrize("codec", ("fp16", "fp8", "topk:0.5"))
@pytest.mark.parametrize("world", WORLDS)
def test_compressed_zero_steps_keep_replicas_equal(worlds, world, codec):
    ref = worlds[world][0]["zero_codec", codec]
    dp = worlds[world][0]["dp", "sgd"]
    for r in range(world):
        got = worlds[world][r]["zero_codec", codec]
        for name in SHAPES:
            assert torch.equal(got["params"][name], ref["params"][name])
        # Close to the uncompressed run (JAX's test_zero bounds the fp16
        # gather at 2e-2), and never equal to it: the codec was applied.
        _assert_params(got["params"], dp["params"], 0.1)
        assert any(not torch.equal(got["params"][n], dp["params"][n])
                   for n in SHAPES)
    if codec == "topk:0.5":
        shard = ref["report"]["opt_state_bytes_per_chip_zero1"] // 4
        for r in range(world):
            res = worlds[world][r]["zero_codec", codec]["residuals"]
            assert [tuple(t.shape) for t in res] == [(shard,)]
            assert torch.isfinite(res[0]).all() and res[0].any()


@pytest.mark.parametrize("codec", EF_CODECS)
@pytest.mark.parametrize("world", WORLDS)
def test_ef_delta_allgather_matches_jax(worlds, world, codec):
    from horovod_tpu.collectives.compression import parse_compression
    from horovod_tpu.optim import zero as jzero
    want_full, want_own = _jax_shard_map(
        world, lambda d: jzero.ef_delta_allgather(
            d, axes=("hvd",), compression=parse_compression(codec)),
        {r: (_delta_input(r),) for r in range(world)})
    for r in range(world):
        full, own = worlds[world][r]["ef_delta", codec]
        assert full.shape == (world, 37)
        assert torch.equal(own, full[r])
        if codec.startswith("topk"):
            np.testing.assert_array_equal(full.numpy(), want_full[r])
            np.testing.assert_array_equal(own.numpy(), want_own[r])
        else:
            tol = 1e-5 * np.abs(want_full[r]).max()
            assert np.abs(full.numpy() - want_full[r]).max() <= tol
        assert torch.equal(full, worlds[world][0]["ef_delta", codec][0])


@pytest.mark.parametrize("key", [("zero", "sgd"), ("zero", "adamw"),
                                 ("zero_codec", "fp8"),
                                 ("zero_codec", "fp16"),
                                 ("zero_codec", "topk:0.5")])
@pytest.mark.parametrize("world", WORLDS)
def test_measured_zero_bytes_equal_zero_report(worlds, world, key):
    for r in range(world):
        z = worlds[world][r][key]
        rep = z["report"]
        for step in z["bytes"]:
            assert step["steps"] == 1
            assert step["reducescatter_bytes"] == \
                rep["reducescatter_bytes_per_chip"]
            assert step["allgather_bytes"] == rep["allgather_bytes_per_chip"]
            assert step["reducescatter_bytes"] + step["allgather_bytes"] == \
                rep["zero1_exchanged_bytes_per_chip"] > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
