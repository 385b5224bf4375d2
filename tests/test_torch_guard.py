"""PyTorch/CUDA port: the silent-data-corruption guard against the JAX
package.

* ``training._guard_screen_vec`` and ``_guard_verdict`` bitwise the JAX
  functions on f32 and bf16 gradients: clean, with a NaN, with an inf,
  and with a finite value whose square overflows f32.  The clean values
  are multiples of 1/8 (their squares' sums are exact in f32), so the
  comparison does not depend on either side's summation order.
* ``GuardPolicy`` (streaks, the ``horovod_guard_*`` families, the
  ``SustainedAnomalyError``) and ``resolve_mode`` under ``auto`` equal
  the JAX ones on the same inputs.
* Three guarded ``make_flax_train_step`` steps of a small ResNet against
  the JAX guarded step on a one-device mesh (``test_torch_resnet.py``'s
  tolerances), their grad norms, no skip, and one ``guard/screen`` leg a
  step; the guarded clean steps bitwise the unguarded ones.
* A poisoned step keeps the parameters, momentum, BN statistics, the
  error-feedback residuals and a ZeRO-1 state bit for bit (single-shot
  and microbatched, the optimizer's first step included).
* Guarded ``make_train_step`` at gloo world 2 (this file, run as a
  script, is each rank) against a two-device JAX mesh: the same grad
  norm, which is the norm of the raw LOCAL gradients (not of their
  mean).
* The loop's CPU path, guarded, bitwise k eager guarded steps, with a
  poisoned step inside a window skipped and the window's rows observed.
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

import horovod_tpu_torch as thvd
from horovod_tpu_torch import training as ttraining
from horovod_tpu_torch.core import guard as tguard
from horovod_tpu_torch.core.exceptions import SustainedAnomalyError
from horovod_tpu_torch.elastic import chaos as tchaos
from horovod_tpu_torch.models import ResNet, resnet_state_from_jax
from horovod_tpu_torch.models.resnet import BottleneckBlock
from horovod_tpu_torch.timeline import metrics as tmetrics
from horovod_tpu_torch.timeline import spans as tspans

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
STATE_ATOL = 2e-5
NORM_RTOL = 1e-5
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
_GUARD_ENV = ("HOROVOD_GUARD", "HOROVOD_GUARD_STREAK", "HOROVOD_CHAOS",
              "HOROVOD_SNAPSHOT_STEPS", "HOROVOD_CHECK_DESYNC",
              "HOROVOD_DESYNC_CHECK_STEPS", "HOROVOD_GUARD_NORM_LIMIT")


@pytest.fixture(autouse=True)
def _clean():
    """Fresh guard policies and no chaos, in both packages."""
    from horovod_tpu.core import guard as jguard
    from horovod_tpu.elastic import chaos as jchaos
    for mod in (tguard, jguard, tchaos, jchaos):
        mod.reset()
    yield
    thvd.shutdown()
    for mod in (tguard, jguard, tchaos, jchaos):
        mod.reset()


def _port(monkeypatch, **env):
    """The port as a CPU world of one under ``env``."""
    for k in _LAUNCHER_ENV + _GUARD_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    thvd.shutdown()
    tchaos.reset()
    thvd.init(device="cpu")
    tmetrics.reset_metrics()


def _jax(monkeypatch, n, **env):
    """The JAX package on ``n`` CPU devices under ``env``."""
    import horovod_tpu as jhvd
    from horovod_tpu.core import guard as jguard
    from horovod_tpu.elastic import chaos as jchaos
    for k in _GUARD_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    jhvd.shutdown()
    jchaos.reset()
    jhvd.init(devices=jax.devices()[:n])
    jguard.reset()
    return jhvd


def _jmetrics():
    from horovod_tpu.timeline import metrics as jm
    return jm.registry()


# ---------------------------------------------------------------------------
# Screen and verdict
# ---------------------------------------------------------------------------


def _grads(dtype, case, seed=0):
    rng = np.random.RandomState(seed)
    leaves = [rng.randint(-64, 65, size=s).astype(np.float32) / 8
              for s in ((37,), (8, 5), (3, 3, 4, 2))]
    if case == "nan":
        leaves[1][2, 3] = np.nan
    elif case == "inf":
        leaves[2][1, 0, 2, 1] = -np.inf
    elif case == "huge":
        leaves[0][5] = 3e20          # finite; its square overflows f32
    return leaves


def _same(a, b):
    """Equal arrays, NaN where NaN, every other value bit for bit."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert (np.isnan(a) == np.isnan(b)).all(), (a, b)
    ok = ~np.isnan(a)
    assert (a[ok].view(np.uint32) == b[ok].view(np.uint32)).all(), (a, b)


@pytest.mark.parametrize("case", ["clean", "nan", "inf", "huge"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_screen_and_verdict_equal_jax_bitwise(dtype, case):
    from horovod_tpu import training as jtraining
    leaves = _grads(dtype, case)
    jleaves = [jnp.asarray(a).astype(dtype) for a in leaves]
    tleaves = [torch.from_numpy(a).to(getattr(torch, dtype))
               for a in leaves]
    want = np.asarray(jtraining._guard_screen_vec(jleaves))
    got = ttraining._guard_screen_vec(tleaves)
    assert got.dtype == torch.float32 and got.shape == (2,)
    _same(got.numpy(), want)
    for limit in (0.0, 10.0, 1e30):
        jn, jnorm, jbad = jtraining._guard_verdict(jnp.asarray(want), limit)
        tn, tnorm, tbad = ttraining._guard_verdict(got, limit)
        _same(tn.numpy(), jn)
        _same(tnorm.numpy(), jnorm)
        assert bool(tbad) == bool(jbad)
    assert bool(ttraining._guard_verdict(got, 0.0)[2]) == (case != "clean")


def test_guard_select_keeps_old_exactly_and_new_otherwise():
    old = [torch.tensor([1.0, -0.0, 3.0]),
           torch.tensor([7], dtype=torch.int64)]
    new = [torch.tensor([float("nan"), 0.0, float("inf")]),
           torch.tensor([9], dtype=torch.int64)]
    keep = [t.clone() for t in new]
    ttraining._guard_select(torch.tensor(False), old, new)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip(new, keep))
    ttraining._guard_select(torch.tensor(True), old, new)
    for a, b in zip(new, old):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# ---------------------------------------------------------------------------
# Policy and mode
# ---------------------------------------------------------------------------

POLICY_ROWS = ([0.0, 1.5, 0.0], [4.0, np.nan, 1.0],
               [[0.0, 2.0, 0.0], [1.0, np.inf, 1.0]],
               [[1.0, np.nan, 1.0], [1.0, np.nan, 1.0]])


def test_guard_policy_streak_and_metrics_equal_jax():
    from horovod_tpu.core import guard as jguard
    from horovod_tpu.timeline import metrics as jm
    jm.reset_metrics()
    tmetrics.reset_metrics()
    results = []
    for mod, reg in ((jguard, _jmetrics), (tguard, tmetrics.registry)):
        p = mod.GuardPolicy(streak_limit=3)
        seen = []
        for rows in POLICY_ROWS:
            try:
                seen.append(("ok", p.observe(rows), p.streak, p.steps))
            except Exception as e:  # noqa: BLE001
                seen.append((type(e).__name__, e.streak, p.streak, p.steps))
            seen.append((reg().gauge("horovod_guard_grad_norm").value,
                         reg().gauge("horovod_guard_streak").value,
                         reg().counter("horovod_guard_steps_total").value,
                         reg().counter("horovod_guard_skipped_total").value))
        results.append(seen)
    assert results[0] == results[1]
    assert results[1][-2] == ("SustainedAnomalyError", 3, 3, 6)
    assert results[1][-1][3] == 4


class _Cfg:
    def __init__(self, guard="auto", check_desync=False,
                 desync_check_steps=0, snapshot_steps=0):
        self.guard = guard
        self.check_desync = check_desync
        self.desync_check_steps = desync_check_steps
        self.snapshot_steps = snapshot_steps


MODES = [("1", {}, None), ("on", {}, None), ("0", {}, None),
         ("off", {}, None), ("auto", {}, None),
         ("auto", {"snapshot_steps": 5}, None),
         ("auto", {"desync_check_steps": 2}, None),
         ("auto", {"check_desync": True}, None),
         ("auto", {}, "slow@step=99,rank=0,secs=0.1"),
         ("auto", {}, "kill@step=99,rank=0"),
         ("auto", {}, "nan@step=99"),
         ("auto", {}, "bitflip@step=99,rank=0"),
         ("banana", {}, None)]


@pytest.mark.parametrize("mode,knobs,spec", MODES)
def test_resolve_mode_equals_jax(mode, knobs, spec):
    from horovod_tpu.core import guard as jguard
    from horovod_tpu.elastic import chaos as jchaos
    got = []
    for g, ch in ((jguard, jchaos), (tguard, tchaos)):
        if spec:
            ch.install(spec, rank=0, size=1)
        try:
            got.append(g.resolve_mode(_Cfg(mode, **knobs)))
        except ValueError as e:
            got.append(("ValueError", "HOROVOD_GUARD" in str(e)))
    assert got[0] == got[1]


def test_step_guard_reads_the_norm_limit_like_jax(monkeypatch):
    from horovod_tpu.core.config import load_config as jax_config
    from horovod_tpu_torch.core.config import load_config
    monkeypatch.setenv("HOROVOD_GUARD", "1")
    monkeypatch.setenv("HOROVOD_GUARD_NORM_LIMIT", "12.5")
    from horovod_tpu.core import guard as jguard
    assert tguard.step_guard(load_config()) == \
        jguard.step_guard(jax_config()) == (True, 12.5)


# ---------------------------------------------------------------------------
# Guarded steps of a small ResNet against the JAX guarded step
# ---------------------------------------------------------------------------


def _tiny(seed):
    from horovod_tpu.models import resnet as jresnet
    model = jresnet.ResNet(stage_sizes=[1, 1],
                           block_cls=jresnet.BottleneckBlock,
                           num_classes=10, num_filters=8, dtype=jnp.float32,
                           space_to_depth=True)
    x = np.random.RandomState(seed).randn(1, 32, 32, 3).astype(np.float32)
    variables = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                             model.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x), train=True))
    # test_torch_resnet.py's perturbation: every BN scale from N(1, 0.1),
    # bias N(0, 0.1), running mean N(0, 0.1), var 1 + U(0, 0.1).
    rng = np.random.RandomState(seed)

    def walk(tree, stats):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, stats)
            elif stats and key == "mean":
                tree[key] = (0.1 * rng.randn(*val.shape)).astype(np.float32)
            elif stats and key == "var":
                tree[key] = (1 + 0.1 * rng.rand(*val.shape)).astype(
                    np.float32)
            elif not stats and key == "scale":
                tree[key] = (1 + 0.1 * rng.randn(*val.shape)).astype(
                    np.float32)
                tree["bias"] = (0.1 * rng.randn(*val.shape)).astype(
                    np.float32)

    walk(variables["params"], False)
    walk(variables["batch_stats"], True)
    return model, variables


def _tiny_port(variables):
    model = ResNet(stage_sizes=[1, 1], block_cls=BottleneckBlock,
                   num_classes=10, num_filters=8, dtype=torch.float32,
                   space_to_depth=True, device="cpu")
    model.load_state_dict(resnet_state_from_jax(variables, device="cpu"))
    return model


def _batch(n=4, seed=11, poison=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 32, 32, 3).astype(np.float32)
    if poison:
        x[0, 0, 0, 0] = np.nan
    return x, rng.randint(0, 10, n).astype(np.int32)


def _port_opt(model, compression=None, lr=0.1):
    named = list(model.named_parameters())
    return thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=lr, momentum=0.9),
        named_parameters=named, compression=compression)


def _state(model, opt, step=None):
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i, st in enumerate(opt.state.values()):
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt/{i}/{k}"] = v.clone()
    for i, r in enumerate(getattr(opt, "_residuals", None) or ()):
        out[f"residual/{i}"] = r.clone()
    zs = getattr(step, "zero_state", None)
    if zs is not None:
        for i, t in enumerate(list(zs.shards) + list(zs.residuals or ())):
            out[f"zero/{i}"] = t.clone()
        for i, st in enumerate(zs.inner.state.values()):
            for k, v in st.items():
                if torch.is_tensor(v):
                    out[f"zero_opt/{i}/{k}"] = v.clone()
    return out


def _bitwise(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    bad = [k for k in a if a[k].numpy().tobytes() != b[k].numpy().tobytes()]
    assert not bad, bad


def test_guarded_flax_steps_match_jax(monkeypatch):
    """Three guarded steps of each package from the same weights on the
    same batch: losses, parameters and statistics, the grad norms the
    policies saw, no skip, one ``guard/screen`` leg a step."""
    jhvd = _jax(monkeypatch, 1, HOROVOD_GUARD="1", HOROVOD_PALLAS_BN="1")
    from horovod_tpu.training import make_flax_train_step as jstep
    model, variables = _tiny(seed=2)
    batch = _batch()
    jopt = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    step = jstep(model.apply, jopt)
    assert type(step).__name__ == "_GuardedStep"
    jv = jax.tree.map(jnp.asarray, variables)
    params, stats = (jhvd.replicate(jv["params"]),
                     jhvd.replicate(jv["batch_stats"]))
    opt_state = jhvd.replicate(jopt.init(jv["params"]))
    data = jhvd.shard_batch(tuple(map(jnp.asarray, batch)))
    want_losses, want_norms = [], []
    for _ in range(3):
        params, stats, opt_state, loss = step(params, stats, opt_state, data)
        want_losses.append(float(loss))
        want_norms.append(_jmetrics().gauge("horovod_guard_grad_norm").value)
    want = resnet_state_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, stats)}, device="cpu")

    _port(monkeypatch, HOROVOD_GUARD="1")
    pm = _tiny_port(variables)
    tstep = thvd.make_flax_train_step(pm, _port_opt(pm))
    assert isinstance(tstep._fn, ttraining._GuardedStep)
    tb = tuple(torch.from_numpy(a) for a in batch)
    losses, norms = [], []
    for _ in range(3):
        losses.append(tstep(tb).item())
        norms.append(tmetrics.registry().gauge(
            "horovod_guard_grad_norm").value)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, want_norms, rtol=NORM_RTOL)
    got = pm.state_dict()
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                   atol=STATE_ATOL, rtol=0, err_msg=name)
    reg = tmetrics.registry()
    assert reg.counter("horovod_guard_steps_total").value == 3
    assert reg.counter("horovod_guard_skipped_total").value == 0
    assert tspans.recorder().leg_registry()["guard/screen"] == \
        {"nbytes": 24, "buckets": 3}


def test_guarded_clean_steps_are_bitwise_unguarded_steps(monkeypatch):
    _, variables = _tiny(seed=4)
    tb = tuple(torch.from_numpy(a) for a in _batch())
    states = []
    for g in ("0", "1"):
        _port(monkeypatch, HOROVOD_GUARD=g)
        pm = _tiny_port(variables)
        opt = _port_opt(pm)
        step = thvd.make_flax_train_step(pm, opt)
        for _ in range(3):
            step(tb)
        states.append(_state(pm, opt))
    _bitwise(*states)


POISON_CASES = {
    # name: (compression, zero_stage, microbatches, clean steps first)
    "sgd_momentum": (None, 0, 1, 1),
    "first_step": (None, 0, 1, 0),
    "topk_ef": ("topk:0.25", 0, 1, 1),
    "powersgd_ef": ("powersgd:2", 0, 1, 1),
    "zero1": (None, 1, 1, 1),
    "microbatch_ef": ("topk:0.25", 0, 2, 1),
}


@pytest.mark.parametrize("case", sorted(POISON_CASES))
def test_poisoned_step_keeps_state_bitwise(monkeypatch, case):
    comp, zero, micro, warm = POISON_CASES[case]
    _port(monkeypatch, HOROVOD_GUARD="1")
    _, variables = _tiny(seed=5)
    pm = _tiny_port(variables)
    if zero:
        opt = torch.optim.SGD(pm.parameters(), lr=0.1, momentum=0.9)
        step = thvd.make_flax_train_step(pm, opt, zero_stage=1)
    else:
        opt = _port_opt(pm, compression=comp)
        step = thvd.make_flax_train_step(pm, opt, microbatches=micro)
    clean = tuple(torch.from_numpy(a) for a in _batch())
    poisoned = tuple(torch.from_numpy(a) for a in _batch(poison=True))
    for _ in range(warm):
        step(clean)
    before = _state(pm, opt, step)
    loss = step(poisoned)
    assert not torch.isfinite(loss)
    _bitwise(_state(pm, opt, step), before)
    pol = tguard.policy()
    assert pol.streak == 1 and pol.skipped == 1
    if comp is not None and not zero:
        assert opt.residuals and all(bool(torch.isfinite(r).all())
                                     for r in opt.residuals)
    assert torch.isfinite(step(clean))
    assert pol.streak == 0
    after = _state(pm, opt, step)
    assert any(not torch.equal(after[k], before[k]) for k in before)


def test_streak_raises_sustained_anomaly(monkeypatch):
    _port(monkeypatch, HOROVOD_GUARD="1", HOROVOD_GUARD_STREAK="2")
    _, variables = _tiny(seed=6)
    pm = _tiny_port(variables)
    step = thvd.make_flax_train_step(pm, _port_opt(pm))
    poisoned = tuple(torch.from_numpy(a) for a in _batch(poison=True))
    step(poisoned)
    with pytest.raises(SustainedAnomalyError) as ei:
        step(poisoned)
    assert ei.value.streak == 2


def test_guard_off_by_default_and_auto_arms_on_the_ledger(monkeypatch):
    _port(monkeypatch)
    _, variables = _tiny(seed=7)
    pm = _tiny_port(variables)
    step = thvd.make_flax_train_step(pm, _port_opt(pm))
    assert type(step._fn) is ttraining._Step
    _port(monkeypatch, HOROVOD_SNAPSHOT_STEPS="2")
    step = thvd.make_flax_train_step(pm, _port_opt(pm))
    assert isinstance(step._fn, ttraining._GuardedStep)


# ---------------------------------------------------------------------------
# The loop's CPU path
# ---------------------------------------------------------------------------


def test_loop_cpu_path_equals_k_eager_guarded_steps(monkeypatch):
    """Two windows of k = 2 against four guarded eager steps, step 3
    poisoned: bitwise, step 3 skipped, the rows of both windows seen."""
    _, variables = _tiny(seed=8)
    batches = [tuple(torch.from_numpy(a) for a in
                     _batch(seed=20 + i, poison=(i == 2)))
               for i in range(4)]
    runs = []
    for use_loop in (False, True):
        _port(monkeypatch, HOROVOD_GUARD="1")
        pm = _tiny_port(variables)
        opt = _port_opt(pm)
        if use_loop:
            loop = thvd.make_flax_train_loop(pm, opt, steps_per_execution=2)
            losses = torch.cat([loop(ttraining.stack_steps(batches[i:i + 2]))
                                for i in (0, 2)])
        else:
            step = thvd.make_flax_train_step(pm, opt)
            losses = torch.stack([step(b) for b in batches])
        pol = tguard.policy()
        runs.append((_state(pm, opt), losses, pol.steps, pol.skipped))
    (s0, l0, n0, k0), (s1, l1, n1, k1) = runs
    _bitwise(s0, s1)
    assert l0.numpy().tobytes() == l1.numpy().tobytes()
    assert (n0, k0) == (n1, k1) == (4, 1)


# ---------------------------------------------------------------------------
# World of two: the screen is of the LOCAL gradients
# ---------------------------------------------------------------------------


def _mlp_problem(seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(16, 4).astype(np.float32)
    x = rng.randn(64, 16).astype(np.float32)
    params = {"w1": rng.randn(16, 32).astype(np.float32) * 0.3,
              "b1": np.zeros((32,), np.float32),
              "w2": rng.randn(32, 4).astype(np.float32) * 0.3,
              "b2": np.zeros((4,), np.float32)}
    return params, (x, x @ w_true)


class _MLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _mlp_loss(m, batch):
    x, y = batch
    return torch.mean((m(x) - y) ** 2)


def _world2_rank(rank, store_path, out_path):
    import torch.distributed as dist
    os.environ["HOROVOD_GUARD"] = "1"
    thvd.init(device="cpu", store=dist.FileStore(store_path, 2), rank=rank,
              size=2)
    params, (x, y) = _mlp_problem()
    m = _MLP(params)
    named = list(m.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1),
        named_parameters=named)
    step = thvd.make_train_step(m, _mlp_loss, opt)
    half = (torch.from_numpy(x[32 * rank:32 * rank + 32]),
            torch.from_numpy(y[32 * rank:32 * rank + 32]))
    norms, losses = [], []
    for _ in range(2):
        losses.append(step(half).item())
        norms.append(tmetrics.registry().gauge(
            "horovod_guard_grad_norm").value)
    torch.save({"norms": norms, "losses": losses,
                "params": {k: v.detach().clone()
                           for k, v in m.named_parameters()}}, out_path)
    thvd.shutdown()


def test_guarded_train_step_world2_grad_norm_matches_jax(monkeypatch,
                                                        tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "world2", str(r), str(tmp_path / "store"),
         str(tmp_path / f"r{r}.pt")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    jhvd = _jax(monkeypatch, 2, HOROVOD_GUARD="1")
    params, data = _mlp_problem()

    def loss_fn(p, batch):
        bx, by = batch
        return jnp.mean((jnp.tanh(bx @ p["w1"] + p["b1"]) @ p["w2"]
                         + p["b2"] - by) ** 2)

    jopt = jhvd.DistributedOptimizer(optax.sgd(0.1))
    step = jhvd.make_train_step(loss_fn, jopt)
    p = jhvd.replicate(jax.tree.map(jnp.asarray, params))
    st = jopt.init(p)
    batch = jhvd.shard_batch(tuple(map(jnp.asarray, data)))
    want_norms, want_losses = [], []
    for _ in range(2):
        p, st, loss = step(p, st, batch)
        want_losses.append(float(loss))
        want_norms.append(_jmetrics().gauge("horovod_guard_grad_norm").value)
    logs = [pr.communicate(timeout=300)[0] for pr in procs]
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log
    # The norm of the AVERAGED first gradient, which a screen of the
    # exchanged gradients would see instead.
    m = _MLP(params)
    _mlp_loss(m, tuple(map(torch.from_numpy, data))).backward()
    mean_norm = float(torch.sqrt(sum((q.grad ** 2).sum()
                                     for q in m.parameters())))
    for r in range(2):
        res = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        np.testing.assert_allclose(res["norms"], want_norms, rtol=NORM_RTOL)
        np.testing.assert_allclose(res["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        for k, v in res["params"].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(p[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
        assert abs(res["norms"][0] - mean_norm) > 1e-3 * mean_norm


if __name__ == "__main__":
    if sys.argv[1] == "world2":
        _world2_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
