"""PyTorch/CUDA port: LoRA Llama training vs the JAX package.

* The LoRA ``LlamaLM`` forward equals the flax ``LlamaLM(lora_rank=4)`` on
  converted weights, with non-zero ``lora_b`` (else the adapters add 0).
* Three steps of the port's ``make_train_step`` + ``DistributedOptimizer(
  AdamW)`` equal the JAX ``make_train_step`` with ``DistributedOptimizer(
  optax.multi_transform({"lora": adamw, "frozen": set_to_zero}))`` on the
  8-CPU-device mesh: the loss at each step and the updated adapters.  The
  AdamW hyper-parameters are set equal explicitly (optax's default weight
  decay is 1e-4, torch's 1e-2).
* A gloo world of 2 whose ranks each hold half the batch takes the same
  step as a world of 1 on the whole batch; ``backward_passes_per_step=2``
  equals one step on the doubled batch; ``synchronize()`` drains every
  handle and re-raises the first error.

f32 on the CPU throughout.  Tolerances: logits 1e-4 absolute (as the
serving tests); losses 1e-5 relative; adapters 1e-6 absolute after the
steps (each AdamW step moves a weight by about lr = 1e-3, and the two
packages' gradients differ only by summation order).  The world-of-two
and accumulation checks step with SGD: AdamW's normalised step m/sqrt(v)
would turn a summation-order difference in a near-zero gradient into a
visible move, and what they check is the exchange, not the optimizer.
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

from horovod_tpu.models.transformer import LLAMA_TINY as J_TINY
from horovod_tpu.models.transformer import LlamaLM as JLlamaLM
from horovod_tpu.models.transformer import lora_mask
import horovod_tpu_torch as thvd
from horovod_tpu_torch.controller.fusion import plan_buckets
from horovod_tpu_torch.models import (LLAMA_TINY, LlamaLM, freeze_base,
                                      init_llama_params, lora_parameters,
                                      params_from_jax)
from horovod_tpu_torch.models.transformer import param_shapes
from horovod_tpu_torch.timeline.metrics import exchange_totals
from horovod_tpu_torch.training import (causal_lm_loss, make_train_step,
                                        next_token_loss)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
RANK = 4
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")


def _flax_lora_params(seed=0):
    """Flax LoRA params (numpy leaves) with ``lora_b`` drawn non-zero."""
    model = JLlamaLM(J_TINY, dtype=jnp.float32, lora_rank=RANK)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.RandomState(seed + 50)

    def walk(tree):
        for key, val in tree.items():
            if key == "lora_b":
                tree[key] = (0.02 * rng.randn(*val.shape)).astype(np.float32)
            elif isinstance(val, dict):
                walk(val)

    params = jax.tree.map(lambda x: x, params)      # a fresh dict tree
    walk(params["params"])
    return model, params


def _tokens(b=8, t=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(
        np.int32)


def _port_model(params):
    model = LlamaLM.from_params(
        LLAMA_TINY, params_from_jax(params, device="cpu"), lora_rank=RANK)
    return model, freeze_base(model)


def _adamw(named):
    return torch.optim.AdamW(
        [p for _, p in named], lr=ADAMW["lr"], betas=(ADAMW["b1"],
                                                      ADAMW["b2"]),
        eps=ADAMW["eps"], weight_decay=ADAMW["weight_decay"])


@pytest.fixture
def world1():
    """The port initialized as a CPU world of one, torn down after."""
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


# ---------------------------------------------------------------------------
# Model: LoRA forward, conversion, freezing
# ---------------------------------------------------------------------------


def test_lora_llama_forward_matches_flax():
    model, params = _flax_lora_params(seed=1)
    tp = params_from_jax(params, device="cpu")
    # Still a rename: every leaf, LoRA ones included, under its path.
    assert {k: tuple(v.shape) for k, v in tp.items()} == param_shapes(
        LLAMA_TINY, lora_rank=RANK)
    np.testing.assert_array_equal(
        tp["layer_1.mlp.w_up.lora_b"].numpy(),
        params["params"]["layer_1"]["mlp"]["w_up"]["lora_b"])
    assert tp["layer_0.attn.wq.lora_a"].dtype == torch.float32
    lm = LlamaLM.from_params(LLAMA_TINY, tp, lora_rank=RANK)
    toks = _tokens(2, 12, seed=3)
    want = np.asarray(model.apply(params, jnp.asarray(toks)))
    got = lm(torch.from_numpy(toks).long()).detach().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_freeze_base_leaves_only_the_adapters_trainable():
    _, params = _flax_lora_params()
    model, named = _port_model(params)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert trainable == [n for n, _ in named]
    assert len(named) == LLAMA_TINY.num_layers * 7 * 2
    assert all(n.rsplit(".", 1)[1] in ("lora_a", "lora_b") for n in
               trainable)
    causal_lm_loss(model, torch.from_numpy(_tokens(2, 8)).long()).backward()
    for n, p in model.named_parameters():
        assert (p.grad is not None) == (n in trainable)
    assert lora_parameters(model) == named


def test_init_draws_lora_like_flax():
    """``lora_a`` from normal(0.02), ``lora_b`` zero (flax's
    initialisers); without ``lora_rank`` the draw is as before."""
    p = init_llama_params(LLAMA_TINY, generator=torch.Generator(
        ).manual_seed(0), device="cpu", lora_rank=RANK)
    assert set(p) == set(param_shapes(LLAMA_TINY, RANK))
    assert all(p[k].eq(0).all() for k in p if k.endswith("lora_b"))
    a = torch.cat([p[k].flatten() for k in p if k.endswith("lora_a")])
    assert abs(a.std().item() - 0.02) < 2e-3
    plain = init_llama_params(LLAMA_TINY, generator=torch.Generator(
        ).manual_seed(0), device="cpu")
    assert set(plain) == set(param_shapes(LLAMA_TINY))


def test_next_token_loss_matches_optax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 9, 256).astype(np.float32)
    toks = rng.randint(0, 256, (3, 9)).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits[:, :-1]), jnp.asarray(toks[:, 1:])).mean()
    got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Training steps vs the JAX make_train_step
# ---------------------------------------------------------------------------


def _jax_steps(hvd, params, toks, steps):
    """``steps`` JAX steps; ``(losses, final params as numpy)``."""
    model = JLlamaLM(J_TINY, dtype=jnp.float32, lora_rank=RANK)
    mask = lora_mask(params)
    inner = optax.multi_transform(
        {"lora": optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"],
                             eps=ADAMW["eps"],
                             weight_decay=ADAMW["weight_decay"]),
         "frozen": optax.set_to_zero()},
        jax.tree.map(lambda m: "lora" if m else "frozen", mask))
    opt = hvd.DistributedOptimizer(inner, compression=hvd.Compression.none)

    def loss_fn(p, t):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, t)[:, :-1], t[:, 1:]).mean()

    step = hvd.make_train_step(loss_fn, opt)
    p = hvd.replicate(jax.tree.map(jnp.asarray, params))
    state = opt.init(p)
    data = hvd.shard_batch(jnp.asarray(toks))
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, data)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


def _sgd(named):
    return torch.optim.SGD([p for _, p in named], lr=0.5)


def _port_steps(params, batches, inner=_adamw, **opt_kw):
    model, named = _port_model(params)
    opt = thvd.DistributedOptimizer(inner(named), named_parameters=named,
                                    **opt_kw)
    step = make_train_step(model, causal_lm_loss, opt)
    losses = [step(torch.from_numpy(b).long()).item() for b in batches]
    return losses, {n: p.detach().clone() for n, p in named}, opt


def _assert_adapters_equal(got, want_params):
    want = params_from_jax(want_params, device="cpu")
    for n, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_three_steps_match_jax_make_train_step(hvd, world1):
    _, params = _flax_lora_params(seed=2)
    toks = _tokens(8, 16, seed=4)
    want_losses, want_params = _jax_steps(hvd, params, toks, 3)
    losses, got, _ = _port_steps(params, [toks] * 3)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    _assert_adapters_equal(got, want_params)
    # The frozen base stayed where it was in both packages.
    before = params_from_jax(params, device="cpu")
    after = params_from_jax(want_params, device="cpu")
    for n in before:
        if not n.endswith(("lora_a", "lora_b")):
            assert torch.equal(before[n], after[n]), n


def test_backward_passes_per_step_equals_doubled_batch(world1):
    _, params = _flax_lora_params(seed=3)
    toks = _tokens(8, 16, seed=5)
    _, whole, _ = _port_steps(params, [toks], inner=_sgd)
    before = exchange_totals()
    _, halves, opt = _port_steps(params, [toks[:4], toks[4:]], inner=_sgd,
                                 backward_passes_per_step=2)
    for n in whole:
        np.testing.assert_allclose(halves[n].numpy(), whole[n].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)
    # Two backward passes, one exchange.
    sent = exchange_totals()["buckets"] - before["buckets"]
    assert sent == len(opt.bucket_plan.buffers)


def test_step_follows_the_optimizers_pass_count(world1):
    """The step function steps when the optimizer's accumulation is
    complete, even after the caller ran synchronize() outside it."""
    _, params = _flax_lora_params(seed=8)
    toks = _tokens(8, 16, seed=9)
    _, whole, _ = _port_steps(params, [toks], inner=_sgd)
    model, named = _port_model(params)
    opt = thvd.DistributedOptimizer(_sgd(named), named_parameters=named,
                                    backward_passes_per_step=2)
    step = make_train_step(model, causal_lm_loss, opt)
    start = {n: p.detach().clone() for n, p in named}
    step(torch.from_numpy(_tokens(8, 16, seed=10)).long())
    assert not opt.exchange_ready
    opt.synchronize()                     # the caller drops this pass
    opt.zero_grad(set_to_none=True)
    assert not opt.exchange_ready
    step(torch.from_numpy(toks[:4]).long())
    assert not opt.exchange_ready
    for n, p in named:                    # one pass of two: no step yet
        assert torch.equal(p.detach(), start[n]), n
    step(torch.from_numpy(toks[4:]).long())
    assert not opt.exchange_ready
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), whole[n].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_buckets_follow_the_plan_and_count_the_wire(world1):
    _, params = _flax_lora_params(seed=4)
    model, named = _port_model(params)
    opt = thvd.DistributedOptimizer(
        _adamw(named), named_parameters=named,
        compression=thvd.Compression.bf16, fusion_threshold=4096)
    step = make_train_step(model, causal_lm_loss, opt)
    before = exchange_totals()
    step(torch.from_numpy(_tokens(2, 8)).long())
    sent = {k: v - before[k] for k, v in exchange_totals().items()}
    plan = plan_buckets([p for _, p in named], 4096, reverse=True)
    assert opt.bucket_plan.buffers == plan.buffers and len(plan.buffers) > 1
    assert sent["buckets"] == sent["handles"] == len(plan.buffers)
    # bf16 on the wire: 2 bytes per f32 gradient.
    assert sent["wire_bytes"] == sum(p.numel() for _, p in named) * 2
    assert sum(plan.bucket_bytes()) == sum(p.numel() for _, p in named) * 4
    # reverse=True: the first bucket holds the last layer's adapters.
    first = plan.buffers[0][1][0].index
    assert named[first][0].startswith(f"layer_{LLAMA_TINY.num_layers - 1}.")


def test_synchronize_drains_every_handle_and_reraises_the_first(world1):
    _, params = _flax_lora_params(seed=5)
    model, named = _port_model(params)
    opt = thvd.DistributedOptimizer(_adamw(named), named_parameters=named,
                                    fusion_threshold=4096)
    causal_lm_loss(model, torch.from_numpy(_tokens(2, 8)).long()).backward()
    assert len(opt._handles) == len(opt.bucket_plan.buffers) > 2
    want = {n: p.grad.clone() for n, p in named}

    class Failed:
        def wait(self):
            raise RuntimeError("boom")

    bad = sorted(opt._handles)[1]
    opt._handles[bad] = (Failed(), None)
    for _, p in named:
        p.grad.zero_()
    with pytest.raises(RuntimeError, match="boom"):
        opt.synchronize()
    assert not opt._handles
    bad_idx = {s.index for s in opt.bucket_plan.buffers[bad][1]}
    for i, (n, p) in enumerate(named):
        # World of one: the average is the gradient itself, written back
        # for every bucket but the failed one.
        if i not in bad_idx:
            assert torch.equal(p.grad, want[n]), n
    opt.zero_grad()                       # nothing left pending
    causal_lm_loss(model, torch.from_numpy(_tokens(2, 8)).long()).backward()
    opt.step()


def test_optimizer_validation(world1):
    _, params = _flax_lora_params(seed=6)
    _, named = _port_model(params)
    with pytest.raises(ValueError, match="duplicate names"):
        thvd.DistributedOptimizer(_adamw(named), named_parameters=[
            ("a", named[0][1]), ("a", named[1][1])] + named[2:])
    with pytest.raises(ValueError, match="not named"):
        thvd.DistributedOptimizer(_adamw(named),
                                  named_parameters=named[:-1])
    with pytest.raises(ValueError, match="requires op=Average"):
        thvd.DistributedOptimizer(_adamw(named), op=thvd.Sum,
                                  gradient_predivide_factor=2.0)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        thvd.DistributedOptimizer(_adamw(named), backward_passes_per_step=0)


@pytest.mark.parametrize("compression", ["none", "powersgd:2"])
def test_dropped_optimizer_frees_its_model(world1, compression):
    """The gradient hooks hold the optimizer weakly: once the caller
    drops the model and the wrapped optimizer (after a step, with state
    and buffers), nothing of them stays alive.  torch's garbage collector
    does not follow post-accumulate-grad hooks, so a strong reference
    there kept every wrapped model for the life of the process."""
    import gc
    import weakref
    _, params = _flax_lora_params(seed=7)
    model, named = _port_model(params)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=compression)
    make_train_step(model, causal_lm_loss, opt)(
        torch.from_numpy(_tokens(2, 8)).long())
    refs = [weakref.ref(x) for x in (model, opt, named[0][1])]
    del model, named, opt
    gc.collect()
    assert all(r() is None for r in refs)


def _train_worker(rank: int, store_path: str, params_path: str,
                  out: str) -> None:
    """One rank of the two-rank training world: two steps on its half."""
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, 2), rank=rank,
              size=2)
    params = torch.load(params_path, weights_only=False)
    toks = _tokens(8, 16, seed=6)[rank * 4:(rank + 1) * 4]
    losses, got, _ = _port_steps(params, [toks] * 2, inner=_sgd,
                                 gradient_predivide_factor=2.0)
    torch.save({"losses": losses, "params": got}, out)
    thvd.shutdown()


def test_world_of_two_equals_world_of_one(tmp_path, world1):
    _, params = _flax_lora_params(seed=7)
    torch.save(params, tmp_path / "params.pt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path / "store"),
         str(tmp_path / "params.pt"), str(tmp_path / f"r{r}.pt")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    losses, whole, _ = _port_steps(params, [_tokens(8, 16, seed=6)] * 2,
                                   inner=_sgd)
    for r in range(2):
        res = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
        for n in whole:
            np.testing.assert_allclose(res["params"][n].numpy(),
                                       whole[n].numpy(), atol=PARAM_ATOL,
                                       rtol=0, err_msg=n)


if __name__ == "__main__":
    _train_worker(int(sys.argv[1]), *sys.argv[2:5])
