"""PyTorch/CUDA port: Adasum against the JAX package.

* ``adasum_pair`` / ``adasum_local_tree`` against the JAX package's NumPy
  oracle (``horovod_tpu/adasum/reference.py``), and the port's own copy
  of that oracle against it: orthogonal vectors (they add), parallel ones
  (they average), a zero vector (the ``_TOL`` branch keeps the other),
  in f32 and fp16.
* ``allreduce(op=Adasum)`` in gloo worlds of 2 and 4 on the CPU: two or
  four worker processes (this file, run as a script) rendezvous through a
  ``FileStore`` under pytest's temporary directory.  Sizes 1, 7 (padded
  to the world), 1000 and a (3, 5) tensor, f32 and fp16, with and without
  a pre- and postscale, and a case whose rank 0 holds zeros.  Each is held
  against the JAX ``allreduce(op=Adasum)`` (``adasum_allreduce``) under
  ``jax.shard_map`` on as many of the conftest's CPU devices, run op by
  op as the port runs it, and against the oracle.  A world of 3 raises
  ``ValueError``; a world of 1 returns the input.
* In a gloo world of 2 on ``BERT_TINY``, a different batch a rank: the
  ranks' gradients through ``allreduce_gradients(op=Adasum,
  compression=fp16)`` against the JAX function on the same gradients,
  and two steps of ``DistributedAdasumOptimizer(SGD)`` against the JAX
  ``DistributedAdasumOptimizer`` on a two-device mesh; each once with one
  fusion bucket and once at a threshold that splits the parameters into
  two.  The buckets hold the same leaves as the JAX plan, and the two
  plans give different results: the mixing coefficients are per bucket.
  The steps use SGD: AdamW's normalised step m/sqrt(v) turns a gradient
  that is roundoff -- ``wk.bias``'s, zero in exact arithmetic, since a key
  bias shifts every logit of a query alike -- into a move of the size of
  the learning rate.  (AdamW with fp16 at world 1:
  ``tests/test_torch_bert.py``.)

Tolerances: f32 within 1e-6 of max |value| (f32 dot products summed in
another order).  fp16 within 1e-3 of max |value| against the JAX
exchange run op by op, which rounds as the port does (a coefficient one
fp16 ulp apart moves every element by 2**-11 of itself).  Against the
float64 oracle and the compiled JAX exchange fp16 gets 1e-3 of max
|value| for each of the log2(world) levels: the port rounds every
level's coefficients and mix to fp16, where the oracle rounds once and
XLA's CPU compiler may keep a fused mix in f32.
After two SGD steps (lr 0.1, no compression) the weights agree within
1e-5 absolute and the losses within 1e-5 relative.
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

from horovod_tpu.adasum import reference as jref
from horovod_tpu.collectives import ops as jops
from horovod_tpu.collectives.reduce_op import Adasum as JAdasum
from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
from horovod_tpu.models.transformer import Bert as JBert
import horovod_tpu_torch as thvd
from horovod_tpu_torch.adasum import reference as tref
from horovod_tpu_torch.adasum.vhdd import (adasum_allreduce,
                                           adasum_allreduce_hierarchical,
                                           adasum_local_tree, adasum_pair)
from horovod_tpu_torch.optim import allreduce_gradients
from horovod_tpu_torch.training import bert_pretrain_loss, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-6
FP16_REL = 1e-3
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
SGD_LR = 0.1
# BERT_TINY holds 100,482 f32 values (401,928 bytes): 256 KiB splits its
# flax-ordered leaves into two buckets.
TWO_BUCKETS = 256 * 1024
BUCKETS = {"one": None, "two": TWO_BUCKETS}
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")

SHAPES = {"1": (1,), "7": (7,), "1000": (1000,), "3x5": (3, 5)}
SCALINGS = {"plain": (1.0, 1.0), "scaled": (0.5, 3.0)}
CASES = [(s, dt, sc) for s in SHAPES for dt in ("float32", "float16")
         for sc in SCALINGS] + [("zero_rank0", "float32", "plain")]


def _case_input(shape_key, dtype, rank, seed):
    """Rank ``rank``'s tensor: a shared direction plus noise of its own,
    so the vectors are neither orthogonal nor parallel; the zero case's
    rank 0 sends zeros."""
    shape = SHAPES.get(shape_key, (7,))
    common = np.random.RandomState(seed).randn(*shape)
    own = np.random.RandomState(seed + 1 + rank).randn(*shape)
    x = (common + 0.7 * own).astype(np.float32)
    if shape_key == "zero_rank0" and rank == 0:
        x = np.zeros_like(x)
    return x.astype(dtype)


def _inputs(world, case_id):
    shape_key, dtype, _ = CASES[case_id]
    return [_case_input(shape_key, dtype, r, 1000 * case_id)
            for r in range(world)]


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# Pairs and the local tree, in this process
# ---------------------------------------------------------------------------

PAIRS = {
    "orthogonal": ([1.0, 0.0, 0.0], [0.0, 2.0, 0.0]),
    "parallel": ([2.0, 0.0, 1.0], [2.0, 0.0, 1.0]),
    "zero": ([0.0, 0.0, 0.0], [0.5, -1.5, 2.0]),
    "random": (None, None),
}


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_adasum_pair_matches_the_oracle(kind, dtype):
    a, b = PAIRS[kind]
    if a is None:
        rng = np.random.RandomState(5)
        a, b = rng.randn(2, 300)
    a, b = np.asarray(a, dtype), np.asarray(b, dtype)
    want = jref.adasum_pair(a, b)
    np.testing.assert_array_equal(tref.adasum_pair(a, b), want)
    got = adasum_pair(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype
    tol = F32_REL if dtype == "float32" else FP16_REL
    assert _rel_err(got, want) <= tol
    if kind == "orthogonal":
        np.testing.assert_allclose(got, a + b, rtol=0, atol=0)
    elif kind == "parallel":
        np.testing.assert_allclose(got, a, rtol=0, atol=0)
    elif kind == "zero":
        np.testing.assert_array_equal(got, b)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_adasum_local_tree_matches_the_oracle(n):
    rng = np.random.RandomState(n)
    vecs = [(rng.randn(50) + 0.5 * rng.randn(50)).astype(np.float32)
            for _ in range(n)]
    want = jref.adasum_reference(vecs)
    np.testing.assert_array_equal(tref.adasum_reference(vecs), want)
    got = adasum_local_tree([torch.from_numpy(v) for v in vecs]).numpy()
    assert _rel_err(got, want) <= F32_REL
    with pytest.raises(ValueError, match="power-of-two"):
        adasum_local_tree([torch.zeros(3)] * 3)


# ---------------------------------------------------------------------------
# Gloo worlds: the worker
# ---------------------------------------------------------------------------


def _bert_named(params):
    from horovod_tpu_torch.models import BERT_TINY, Bert, params_from_jax
    model = Bert.from_params(BERT_TINY, params_from_jax(params,
                                                        device="cpu"))
    return model, list(model.named_parameters())


def _bert_batch():
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, J_BERT_TINY.vocab_size, (4, 16)).astype(np.int32)
    nsp = rng.randint(0, 2, (4,)).astype(np.int32)
    return tokens, nsp


def _port_adasum_steps(params, tokens, nsp, steps, fusion_threshold):
    """``steps`` port steps of ``DistributedAdasumOptimizer(SGD)`` on one
    rank's batch: ``(losses, params, bucket plan as names)``."""
    model, named = _bert_named(params)
    opt = thvd.DistributedAdasumOptimizer(
        torch.optim.SGD([p for _, p in named], lr=SGD_LR),
        named_parameters=named, compression=thvd.Compression.none,
        fusion_threshold=fusion_threshold)
    step = make_train_step(model, bert_pretrain_loss, opt)
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(nsp).long())
    losses = [step(batch).item() for _ in range(steps)]
    plan = [[opt._names[s.index] for s in lspecs]
            for _, lspecs in opt.bucket_plan.buffers]
    return (losses, {n: p.detach().clone() for n, p in named}, plan)


def _local_grads(params, tokens, nsp):
    """One rank's own BERT gradients, in flax leaf order."""
    model, named = _bert_named(params)
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(nsp).long())
    bert_pretrain_loss(model, batch).backward()
    grads = {n: p.grad for n, p in named}
    return [grads[n] for n in _flax_names(params)]


def _worker(rank: int, world: int, store_path: str, out: str,
            params_path: str) -> None:
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {}
    if world & (world - 1):
        try:
            thvd.allreduce(torch.ones(4), thvd.Adasum)
            res["raised"] = None
        except ValueError as e:
            res["raised"] = str(e)
    else:
        for i, (_, _, scaling) in enumerate(CASES):
            pre, post = SCALINGS[scaling]
            x = torch.from_numpy(_inputs(world, i)[rank])
            x_copy = x.clone()
            res[i] = thvd.allreduce(x, thvd.Adasum, prescale_factor=pre,
                                    postscale_factor=post)
            assert torch.equal(x, x_copy)
    if world == 2:
        params = torch.load(params_path, weights_only=False)
        tokens, nsp = _bert_batch()
        half = (tokens[2 * rank:2 * rank + 2], nsp[2 * rank:2 * rank + 2])
        res["local_grads"] = _local_grads(params, *half)
        for name, thr in BUCKETS.items():
            res["exchange", name] = allreduce_gradients(
                res["local_grads"], thvd.Adasum,
                compression=thvd.Compression.fp16, fusion_threshold=thr)
            res["steps", name] = _port_adasum_steps(params, *half, 2, thr)
    thvd.barrier()
    torch.save(res, out)
    thvd.shutdown()


def _run_world(tmp, world, params_path=""):
    store = str(tmp / "store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), store,
         str(tmp / f"r{r}.pt"), params_path],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {r: torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(world)}


def _flax_names(params):
    return [".".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_leaves_with_path(params["params"])]


def _flax_bert_params():
    model = JBert(J_BERT_TINY, dtype=jnp.float32)
    tokens, _ = _bert_batch()
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3),
                                               jnp.asarray(tokens[:1])))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Gloo worlds of 2, 3 and 4, each run once: ``{world: {rank:
    results}}``; the world of 2 also trains ``BERT_TINY``."""
    tmp = tmp_path_factory.mktemp("adasum")
    params_path = tmp / "bert_params.pt"
    torch.save(_flax_bert_params(), params_path)
    out = {}
    for world in (2, 3, 4):
        d = tmp / f"w{world}"
        d.mkdir()
        out[world] = _run_world(d, world, str(params_path))
    return out


def _jax_adasum(stacked, pre, post, jit=True):
    """The JAX ``allreduce(op=Adasum)`` of each row of ``stacked`` under
    ``jax.shard_map`` on ``len(stacked)`` CPU devices; ``jit=False`` runs
    it op by op, each fp16 product and sum rounded as the port rounds it
    (compiled, XLA's CPU backend may keep a fused fp16 mix in f32)."""
    n = stacked.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("a",))

    def f(x):
        return jops.allreduce(x[0], JAdasum, axes="a", prescale_factor=pre,
                              postscale_factor=post)[None]

    fn = jax.shard_map(f, mesh=mesh, in_specs=P("a"), out_specs=P("a"))
    return np.asarray((jax.jit(fn) if jit else fn)(jnp.asarray(stacked)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(c) for c in CASES])
def test_adasum_allreduce_matches_jax_and_the_oracle(worlds, world, case):
    _, dtype, scaling = CASES[case]
    pre, post = SCALINGS[scaling]
    vecs = _inputs(world, case)
    want_jax = _jax_adasum(np.stack(vecs), pre, post)
    scaled = [(v * np.asarray(pre, v.dtype)) for v in vecs]
    want_ref = jref.adasum_reference(scaled) * np.asarray(post, vecs[0].dtype)
    levels = world.bit_length() - 1
    tol = F32_REL if dtype == "float32" else FP16_REL * levels
    for r in range(world):
        got = worlds[world][r][case]
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == vecs[0].shape
        got = got.numpy()
        assert _rel_err(got, want_jax[r]) <= tol, (r, got, want_jax[r])
        assert _rel_err(got, want_ref) <= tol, (r, got, want_ref)
    # Every rank holds the same result.
    for r in range(1, world):
        np.testing.assert_array_equal(worlds[world][r][case].numpy(),
                                      worlds[world][0][case].numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_adasum_fp16_matches_jax_op_by_op(worlds, world):
    """fp16 against the JAX exchange run op by op: within 1e-3 of max
    |value| at any world size."""
    case = CASES.index(("1000", "float16", "scaled"))
    vecs = _inputs(world, case)
    want = _jax_adasum(np.stack(vecs), *SCALINGS["scaled"], jit=False)
    for r in range(world):
        assert _rel_err(worlds[world][r][case].numpy(), want[r]) <= FP16_REL


def test_adasum_world_of_three_raises(worlds):
    for r in range(3):
        assert "power-of-two" in (worlds[3][r]["raised"] or "")


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def test_adasum_world_of_one_returns_the_input(world1):
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5).astype(
        np.float32))
    assert adasum_allreduce(x) is x
    np.testing.assert_array_equal(thvd.allreduce(x, thvd.Adasum).numpy(),
                                  x.numpy())
    half = x.half()
    np.testing.assert_array_equal(
        thvd.allreduce(half, thvd.Adasum, prescale_factor=0.5,
                       postscale_factor=3.0).numpy(),
        (half * 0.5 * 3.0).numpy())
    # The process-set and hierarchical variants over one rank: the input.
    assert adasum_allreduce(x, members=(0,)) is x
    assert adasum_allreduce_hierarchical(x) is x
    # The fp8 wire runs; over one rank nothing is exchanged.
    assert adasum_allreduce(x, wire_codec="fp8") is x
    assert adasum_allreduce_hierarchical(x, wire_codec="fp8") is x


def test_adasum_optimizer_rejects_what_jax_rejects(world1):
    from horovod_tpu_torch.models import BERT_TINY, Bert
    named = list(Bert(BERT_TINY, device="cpu").named_parameters())
    sgd = torch.optim.SGD([p for _, p in named], lr=0.1)
    with pytest.raises(NotImplementedError, match="Sum/Average"):
        thvd.DistributedAdasumOptimizer(sgd, named_parameters=named,
                                        compression="powersgd:2")
    with pytest.raises(ValueError, match="op=Average"):
        thvd.DistributedAdasumOptimizer(sgd, named_parameters=named,
                                        gradient_predivide_factor=2.0)


# ---------------------------------------------------------------------------
# DistributedAdasumOptimizer at world 2 vs the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture
def jax2():
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:2])
    yield hvd
    hvd.shutdown()


def _jax_adasum_steps(hvd, params, steps, fusion_threshold):
    model = JBert(J_BERT_TINY, dtype=jnp.float32)

    def loss_fn(p, batch):
        toks, nsp_y = batch
        mlm, nsp = model.apply(p, toks)
        return (optax.softmax_cross_entropy_with_integer_labels(
            mlm, toks).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                nsp, nsp_y).mean())

    opt = hvd.DistributedAdasumOptimizer(
        optax.sgd(SGD_LR), compression=hvd.Compression.none,
        fusion_threshold=fusion_threshold)
    step = hvd.make_train_step(loss_fn, opt)
    p = hvd.replicate(jax.tree.map(jnp.asarray, params))
    state = opt.init(p)
    tokens, nsp = _bert_batch()
    data = hvd.shard_batch((jnp.asarray(tokens), jnp.asarray(nsp)))
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, data)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


def _jax_plan_names(params, threshold):
    from horovod_tpu.controller.fusion import plan_buckets
    spec = plan_buckets(jax.tree.leaves(params["params"]), threshold)
    names = _flax_names(params)
    return [[names[s.index] for s in lspecs] for _, lspecs in spec.buffers]


@pytest.mark.parametrize("buckets", sorted(BUCKETS))
def test_adasum_fp16_exchange_matches_jax(worlds, jax2, buckets):
    """Both ranks' BERT gradients through ``allreduce_gradients(Adasum,
    fp16)`` against the JAX function under ``jax.shard_map`` on the same
    gradients: every leaf within 1e-3 of its max |value|."""
    from horovod_tpu.optim.distributed import \
        allreduce_gradients as jax_allreduce_gradients
    mesh = Mesh(np.array(jax.devices()[:2]), ("a",))
    stacked = [jnp.asarray(np.stack([worlds[2][r]["local_grads"][i].numpy()
                                     for r in range(2)]))
               for i in range(len(worlds[2][0]["local_grads"]))]

    def f(grads):
        out = jax_allreduce_gradients(
            [g[0] for g in grads], JAdasum, compression=jax2.Compression.fp16,
            fusion_threshold=BUCKETS[buckets], axes="a")
        return [g[None] for g in out]

    want = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("a"),
                                 out_specs=P("a")))(stacked)
    for r in range(2):
        got = worlds[2][r]["exchange", buckets]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert _rel_err(g.numpy(), np.asarray(w[r])) <= FP16_REL


@pytest.mark.parametrize("buckets", sorted(BUCKETS))
def test_adasum_optimizer_world_of_two_matches_jax(worlds, jax2, buckets):
    from horovod_tpu_torch.models import params_from_jax
    params = _flax_bert_params()
    thr = BUCKETS[buckets]
    want_losses, want = _jax_adasum_steps(jax2, params, 2, thr)
    want = params_from_jax(want, device="cpu")
    plan = _jax_plan_names(params, thr if thr else 64 * 1024 * 1024)
    assert len(plan) == (2 if buckets == "two" else 1)
    for r in range(2):
        losses, got, got_plan = worlds[2][r]["steps", buckets]
        assert got_plan == plan
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_adasum_bucket_membership_changes_the_result(worlds):
    """The two plans mix with different coefficients: their exchanged
    gradients, and their weights after two steps, differ by far more than
    the packages differ."""
    one, two = (worlds[2][0]["exchange", b] for b in ("one", "two"))
    assert max(_rel_err(a.numpy(), b.numpy()) for a, b in zip(one, two)) \
        > 10 * FP16_REL
    one, two = (worlds[2][0]["steps", b][1] for b in ("one", "two"))
    moved = max((one[n] - two[n]).abs().max().item() for n in one)
    assert moved > 10 * PARAM_ATOL, moved


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
