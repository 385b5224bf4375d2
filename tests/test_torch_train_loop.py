"""PyTorch/CUDA port: the steps-per-execution loop
(``make_train_loop`` / ``make_flax_train_loop``), against k calls of the
port's own step and against the JAX package.

On the CPU the loop runs its window eagerly (on the GPU it is one CUDA
graph: ``tests/test_torch_cuda.py``).  Held here:

* one window of k steps equals k step calls from the same start on the
  same batches **bitwise** -- parameters, optimizer state, BN statistics
  and the ``[k]`` losses -- for a bare optimizer, a
  ``DistributedOptimizer``, the flax step, ``zero_stage=1`` and
  ``microbatches=2``;
* against the JAX ``make_train_loop`` (a linear model) and
  ``make_flax_train_loop`` (a one-stage ResNet converted with
  ``resnet_state_from_jax``) on a one-device mesh, within 1e-5 (the
  ResNet within ``test_torch_resnet.py``'s tolerances);
* the host bookkeeping the GPU loop checks before a capture, and the
  error-feedback residuals updated in place (a replay reads them where
  the capture did);
* ``stack_steps`` against the JAX one; ``steps_per_execution < 1`` and a
  batch not stacked ``[k, ...]`` raise; ``HOROVOD_STEPS_PER_EXEC`` is
  picked up, and ``hvd.steps_per_execution()`` returns the resolved
  value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.training import (make_flax_train_loop,
                                        make_flax_train_step,
                                        make_train_loop, make_train_step,
                                        stack_steps)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_MICROBATCHES", "HOROVOD_STEPS_PER_EXEC",
                 "HOROVOD_COMPRESSION", "HOROVOD_ZERO")
K = 3
JAX_ATOL = 1e-5


def _params0():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(6, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


def _batches(n=K, rows=16):
    rng = np.random.RandomState(5)
    return [(rng.randn(rows, 6).astype(np.float32),
             rng.randn(rows, 4).astype(np.float32)) for _ in range(n)]


class _Lin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _params0().items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v)))

    def forward(self, x):
        return x @ self.w + self.b


def _loss(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


@pytest.fixture
def world1(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _tensors(batches):
    return [tuple(torch.from_numpy(a) for a in b) for b in batches]


def _opt(model, kind):
    sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if kind == "wrapped":
        return thvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters())
    return sgd


def _state(model, opt):
    out = {f"p/{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"b/{n}": b.clone() for n, b in model.named_buffers()})
    for i, st in enumerate(opt.state.values()):
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"o/{i}/{k}"] = v.clone()
    return out


CASES = {"bare": dict(opt="bare"), "wrapped": dict(opt="wrapped"),
         "zero1": dict(opt="bare", zero_stage=1),
         "microbatches2": dict(opt="wrapped", microbatches=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_equals_k_step_calls_bitwise(world1, case):
    kw = dict(CASES[case])
    kind = kw.pop("opt")
    batches = _tensors(_batches(2 * K))
    m1 = _Lin()
    o1 = _opt(m1, kind)
    step = make_train_step(m1, _loss, o1, **kw)
    want = torch.stack([step(b) for b in batches])
    m2 = _Lin()
    o2 = _opt(m2, kind)
    loop = make_train_loop(m2, _loss, o2, steps_per_execution=K, **kw)
    got = torch.cat([loop(stack_steps(batches[:K])),
                     loop(stack_steps(batches[K:]))])
    assert got.shape == (2 * K,)
    assert torch.equal(got, want)
    inner = (lambda s: s.zero_state.inner) if case == "zero1" else \
        (lambda s: None)
    s1 = _state(m1, inner(step) or o1)
    s2 = _state(m2, inner(loop) or o2)
    assert s1.keys() == s2.keys() and len(s1) > 2
    for n in s1:
        assert torch.equal(s1[n], s2[n]), n


def test_flax_loop_equals_k_step_calls_bitwise(world1):
    from test_torch_resnet import _tiny_flax, _tiny_port
    _, variables = _tiny_flax(seed=7)
    rng = np.random.RandomState(8)
    data = [(torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, 4))) for _ in range(K)]
    out = []
    for use_loop in (False, True):
        model = _tiny_port(variables)
        opt = _opt(model, "wrapped")
        if use_loop:
            loop = make_flax_train_loop(model, opt, steps_per_execution=K)
            losses = loop(stack_steps(data))
        else:
            step = make_flax_train_step(model, opt)
            losses = torch.stack([step(b) for b in data])
        out.append((losses, _state(model, opt)))
    (l1, s1), (l2, s2) = out
    assert torch.equal(l1, l2)
    assert any(n.startswith("b/") for n in s1)
    for n in s1:
        assert torch.equal(s1[n], s2[n]), n


def test_stack_steps_matches_jax():
    from horovod_tpu.training import stack_steps as jstack
    batches = _batches()
    got = stack_steps(_tensors(batches))
    want = jstack([tuple(map(jnp.asarray, b)) for b in batches])
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (K, 16) + g.shape[2:]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d = stack_steps([{"x": torch.ones(2), "y": [torch.zeros(1)]}] * 2)
    assert d["x"].shape == (2, 2) and d["y"][0].shape == (2, 1)
    with pytest.raises(ValueError, match="at least one"):
        stack_steps([])


def test_loop_refuses_bad_k_and_unstacked_batches(world1):
    model = _Lin()
    with pytest.raises(ValueError, match="steps_per_execution"):
        make_train_loop(model, _loss, _opt(model, "bare"),
                        steps_per_execution=0)
    loop = make_train_loop(model, _loss, _opt(model, "bare"),
                           steps_per_execution=K)
    b = _tensors(_batches(K))
    with pytest.raises(ValueError, match="stacked"):
        loop(b[0])
    with pytest.raises(ValueError, match="stacked"):
        loop(stack_steps(b[:2]))


def test_capture_checks_read_the_host_bookkeeping(world1):
    """What the GPU loop checks before it captures a window, on the
    host's bookkeeping alone: a ``backward_passes_per_step`` that does
    not divide k, a window starting partway through an accumulation and
    (at capture) a ``.grad`` left from before are refused; a param
    group's changed lr shows in the recorded hyperparameters (the loop
    captures again); a rebound state tensor shows in the references the
    loop compares across a capture."""
    from horovod_tpu_torch import training
    model = _Lin()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    with pytest.raises(ValueError, match="backward_passes_per_step=2"):
        training._refuse_uncapturable(model, [opt], 3)
    training._refuse_uncapturable(model, [opt], 4, capture=True)
    x, y = _tensors(_batches(1))[0]
    _loss(model, (x, y)).backward()
    with pytest.raises(ValueError, match="partway"):
        training._refuse_uncapturable(model, [opt], 4)
    _loss(model, (x, y)).backward()
    opt.step()
    training._refuse_uncapturable(model, [opt], 4)
    with pytest.raises(ValueError, match=r"\.grad"):
        training._refuse_uncapturable(model, [opt], 4, capture=True)
    opt.zero_grad(set_to_none=True)
    hyper = training._hyperparameters([opt])
    refs = training._state_refs(model, [opt], None)
    for g in opt.param_groups:
        g["lr"] = 0.05
    assert training._hyperparameters([opt]) != hyper
    st = opt.state[model.w]
    st["momentum_buffer"].mul_(0.5)
    assert training._state_refs(model, [opt], None) == refs
    st["momentum_buffer"] = st["momentum_buffer"] * 0.5
    assert training._state_refs(model, [opt], None) != refs


@pytest.mark.parametrize("path", ["wrap", "microbatches2", "zero1"])
def test_error_feedback_residuals_update_in_place(world1, path):
    """The top-k error-feedback residuals keep their tensors across
    steps -- the wrap's, the microbatched step's one exchange a step and
    ZeRO-1's -- and change in value: a captured window's replays read
    and write them where the capture did."""
    model = _Lin()
    sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    if path == "zero1":
        step = make_train_step(model, _loss, sgd, zero_stage=1,
                               zero_compression="topk:0.25")
        residuals = step.zero_state.residuals
    else:
        opt = thvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(),
            compression="topk:0.25")
        step = make_train_step(model, _loss, opt,
                               microbatches=2 if path == "microbatches2"
                               else 1)
        residuals = opt._residuals
    ids = [id(r) for r in residuals]
    before = [r.clone() for r in residuals]
    for b in _tensors(_batches(2)):
        step(b)
    assert [id(r) for r in residuals] == ids
    assert any(not torch.equal(r, r0) for r, r0 in zip(residuals, before))


def test_env_sets_the_window_and_hvd_reads_it(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert thvd.steps_per_execution() == 1
    assert thvd.steps_per_execution(default=5) == 5
    monkeypatch.setenv("HOROVOD_STEPS_PER_EXEC", "2")
    thvd.init(device="cpu")
    try:
        assert thvd.steps_per_execution() == 2
        model = _Lin()
        loop = make_train_loop(model, _loss, _opt(model, "wrapped"))
        assert loop.steps_per_execution == 2
        losses = loop(stack_steps(_tensors(_batches(2))))
        assert losses.shape == (2,) and torch.isfinite(losses).all()
    finally:
        thvd.shutdown()


@pytest.fixture
def jax1():
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:1])
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loop_matches_jax_make_train_loop(world1, jax1, microbatches):
    hvd = jax1
    batches = _batches(2 * K)
    opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    params = hvd.replicate({k: jnp.asarray(v) for k, v in _params0().items()})
    opt_state = hvd.replicate(opt.init(params))
    jloop = hvd.make_train_loop(
        lambda p, b: jnp.mean((b[0] @ p["w"] + p["b"] - b[1]) ** 2), opt,
        steps_per_execution=K, microbatches=microbatches)
    want = []
    for w in (batches[:K], batches[K:]):
        params, opt_state, losses = jloop(
            params, opt_state,
            hvd.shard_steps(hvd.stack_steps(
                [tuple(map(jnp.asarray, b)) for b in w])))
        want += [float(x) for x in np.asarray(losses)]
    model = _Lin()
    loop = make_train_loop(model, _loss, _opt(model, "wrapped"),
                           steps_per_execution=K, microbatches=microbatches)
    got = []
    for w in (batches[:K], batches[K:]):
        got += loop(stack_steps(_tensors(w))).tolist()
    np.testing.assert_allclose(got, want, rtol=JAX_ATOL)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                   atol=JAX_ATOL, rtol=0, err_msg=n)


def test_flax_loop_matches_jax_make_flax_train_loop(world1, jax1,
                                                    monkeypatch):
    from test_torch_resnet import (LOSS_RTOL, STATE_ATOL, _batch,
                                   _tiny_flax, _tiny_port)
    from horovod_tpu_torch.models import resnet_state_from_jax
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")   # JAX: interpret kernels
    hvd = jax1
    model, variables = _tiny_flax(seed=9)
    x, y = _batch(n=4)
    opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    jloop = hvd.make_flax_train_loop(model.apply, opt, steps_per_execution=K)
    jv = jax.tree.map(jnp.asarray, variables)
    params = hvd.replicate(jv["params"])
    stats = hvd.replicate(jv["batch_stats"])
    state = hvd.replicate(opt.init(jv["params"]))
    stacked = hvd.shard_steps(hvd.stack_steps(
        [(jnp.asarray(x), jnp.asarray(y))] * K))
    params, stats, state, losses = jloop(params, stats, state, stacked)
    want = resnet_state_from_jax(
        {"params": jax.tree.map(np.asarray, params),
         "batch_stats": jax.tree.map(np.asarray, stats)}, device="cpu")
    ours = _tiny_port(variables)
    loop = make_flax_train_loop(ours, _opt(ours, "wrapped"),
                                steps_per_execution=K)
    got_losses = loop(stack_steps([(torch.from_numpy(x),
                                    torch.from_numpy(y))] * K))
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=LOSS_RTOL)
    got = ours.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                   atol=STATE_ATOL, rtol=0, err_msg=name)
