"""PyTorch/CUDA port: PowerSGD rank-r error-feedback compression vs the
JAX package.

* The codec surface -- ``parse_compression``, the matricization, factor
  widths and ``wire_payload_bytes`` -- equals the JAX package's, and the
  same environment (``HOROVOD_COMPRESSION``, ``HOROVOD_EF_RESIDUAL``)
  gives the same codec to a ``DistributedOptimizer`` built without
  ``compression`` in both packages.
* The three ``fused_update`` stages' plain versions (what the CPU runs)
  against the JAX Pallas kernels in interpret mode, each stage fed the
  same inputs, at the JAX cases ``(size, rank)`` = (50, 3), (64, 2) and
  (37, 1), with f32 and bf16 buckets.
* ``powersgd_allreduce`` at world 1 against a one-device JAX mesh, and
  at world 2 (a gloo ``FileStore`` world; this file runs itself as the
  worker) against a two-device mesh: Sum, Average, pre/postscale, with
  and without a residual; both ranks' outputs bitwise equal.  The EF
  invariant ``acc == P_orth Q_local^T + residual``.
* The error-feedback optimizer: ResNet-50's EF plan at full width (the
  meta device) equals JAX's ``ef_bucket_plan`` -- 2 buckets, 227,888
  wire bytes a step; three ``make_flax_train_step`` steps of a tiny
  ResNet with ``powersgd:4`` equal the JAX step on a one-device mesh
  (losses, parameters, residuals), and two steps in a world of two equal
  a two-device mesh; ``HOROVOD_EF_RESIDUAL=0`` keeps the residuals at 0;
  the counters; a failed exchange leaves its residual alone.

Tolerances: ``acc`` bitwise (one f32 multiply and one add on both
sides); the seed matrix Q0 within one f32 ulp (the argument is bitwise
the same, the two CPU ``cos`` round differently); every other exchange
output within 1e-5 of its largest |value| (sums in another order, then a
Gram-Schmidt round); training as ``test_torch_resnet.py``: losses 1e-5
relative, parameters, statistics and residuals 2e-5 absolute.
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
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu_torch.collectives import compression as tcomp
from horovod_tpu_torch.collectives import ops as tops
from horovod_tpu_torch.core.config import load_config as t_load_config
from horovod_tpu_torch.models import ResNet50, flax_leaf_order
from horovod_tpu_torch.ops import fused_update as tfu
from horovod_tpu_torch.ops import registry
from horovod_tpu_torch.optim import distributed as tdist
from horovod_tpu_torch.timeline import metrics as tmetrics
from horovod_tpu_torch.training import make_flax_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_resnet import (_batch, _numpy_tree,  # noqa: E402
                               _tiny_flax, _tiny_port)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5                 # exchange outputs: of max |reference|
Q0_ULP = 6e-8              # one f32 ulp of cos's [-1, 1]
LOSS_RTOL = 1e-5
STATE_ATOL = 2e-5
CASES = [(50, 3), (64, 2), (37, 1)]
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
_CODEC_ENV = ("HOROVOD_COMPRESSION", "HVD_TPU_COMPRESSION",
              "HOROVOD_EF_RESIDUAL", "HVD_TPU_EF_RESIDUAL")


def _close(got, want, rel=REL, msg=""):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


@pytest.fixture
def world1():
    """The port as a CPU world of one, torn down after."""
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def _jax_world(n):
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init(devices=jax.devices()[:n])
    return hvd


@pytest.fixture
def jax1():
    yield _jax_world(1)
    import horovod_tpu as hvd
    hvd.shutdown()


@pytest.fixture
def jax2():
    yield _jax_world(2)
    import horovod_tpu as hvd
    hvd.shutdown()


# ---------------------------------------------------------------------------
# The codec surface and the environment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["none", "fp16", "bf16", "powersgd:1",
                                  "powersgd:4", " PowerSGD:2 ", None])
def test_parse_compression_matches_jax(spec):
    from horovod_tpu.collectives import compression as jcomp
    got, want = tcomp.parse_compression(spec), jcomp.parse_compression(spec)
    assert got.__name__ == want.__name__
    assert tcomp.is_error_feedback(got) == jcomp.is_error_feedback(want)
    assert tcomp.is_powersgd(got) == jcomp.is_powersgd(want)
    assert tcomp.parse_compression(got) is got
    if tcomp.is_powersgd(got):
        assert got.rank == want.rank
        assert getattr(tcomp.Compression, got.__name__) is got
        assert tcomp.Compression.powersgd(got.rank) is got


@pytest.mark.parametrize("spec", ["fp8", "topk:0.1", "ici:none,dcn:fp8"])
def test_unported_codecs_raise_naming_the_roadmap_item(spec):
    with pytest.raises(NotImplementedError, match="1.9"):
        tcomp.parse_compression(spec)


@pytest.mark.parametrize("spec", ["powersgd:0", "powersgd:x", "gzip"])
def test_bad_specs_raise_value_error_as_jax(spec):
    from horovod_tpu.collectives import compression as jcomp
    with pytest.raises(ValueError):
        jcomp.parse_compression(spec)
    with pytest.raises(ValueError):
        tcomp.parse_compression(spec)


@pytest.mark.parametrize("size", [1, 2, 37, 50, 64, 1000, 15053824,
                                  10506088])
@pytest.mark.parametrize("rank", [1, 4, 64])
def test_matricization_and_wire_bytes_match_jax(size, rank):
    from horovod_tpu.collectives import compression as jcomp
    assert tcomp.powersgd_matrix_shape(size) == \
        jcomp.powersgd_matrix_shape(size)
    assert tcomp.powersgd_effective_rank(size, rank) == \
        jcomp.powersgd_effective_rank(size, rank)
    assert tcomp.powersgd_factor_widths(size, rank) == \
        jcomp.powersgd_factor_widths(size, rank)
    for name in ("none", "fp16", "bf16", f"powersgd:{rank}"):
        for itemsize in (2, 4):
            assert tcomp.wire_payload_bytes(
                tcomp.parse_compression(name), size, itemsize) == \
                jcomp.wire_payload_bytes(jcomp.parse_compression(name),
                                         size, itemsize), (name, itemsize)


@pytest.mark.parametrize("env", [{}, {"HOROVOD_COMPRESSION": "bf16"},
                                 {"HOROVOD_COMPRESSION": "powersgd:3"},
                                 {"HOROVOD_COMPRESSION": "powersgd:2",
                                  "HOROVOD_EF_RESIDUAL": "0"},
                                 {"HVD_TPU_COMPRESSION": "fp16",
                                  "HOROVOD_COMPRESSION": "powersgd:2"}])
def test_optimizer_default_codec_follows_the_environment_as_jax(
        monkeypatch, env):
    """The repaired default: ``DistributedOptimizer()`` without
    ``compression`` takes ``HOROVOD_COMPRESSION`` (``HVD_TPU_*`` first)
    and ``HOROVOD_EF_RESIDUAL`` as the JAX wrap does."""
    from horovod_tpu.core.config import load_config as j_load_config
    from horovod_tpu.optim import distributed as jdist
    for k in _CODEC_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tcfg, jcfg = t_load_config(), j_load_config()
    assert (tcfg.compression, tcfg.ef_residual) == \
        (jcfg.compression, jcfg.ef_residual)
    hvd = _jax_world(1)
    try:
        want = jdist._resolve_compression(None)
        want_feed = jdist._ef_enabled()
    finally:
        hvd.shutdown()
    thvd.init(device="cpu")
    try:
        lin = torch.nn.Linear(3, 2)
        opt = thvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(),
                                                        lr=0.1))
        assert opt._compression.__name__ == want.__name__
        assert tdist._ef_enabled() == want_feed
        assert tdist.is_ef_optimizer(opt) == \
            tcomp.is_error_feedback(want)
        # An explicit codec wins over the environment, in both packages.
        explicit = thvd.DistributedOptimizer(
            torch.optim.SGD(torch.nn.Linear(3, 2).parameters(), lr=0.1),
            compression=thvd.Compression.none)
        assert explicit._compression is tcomp.Compression.none
    finally:
        thvd.shutdown()


def test_ef_optimizer_rejects_what_jax_rejects():
    lin = torch.nn.Linear(3, 2)
    with pytest.raises(NotImplementedError,
                       match="backward_passes_per_step"):
        thvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                  compression="powersgd:2",
                                  backward_passes_per_step=2)
    with pytest.raises(NotImplementedError, match="Sum/Average"):
        thvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                  compression="powersgd:2", op=thvd.Max)


# ---------------------------------------------------------------------------
# The three stages vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols,rank", [(3880, 4), (3241, 4), (8, 3),
                                       (7, 1)])
def test_seed_matrix_matches_jax(cols, rank):
    from horovod_tpu.collectives.ops import _powersgd_seed_matrix as jq0
    got = tops._powersgd_seed_matrix(cols, rank)
    assert got.dtype == torch.float32 and tuple(got.shape) == (cols, rank)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq0(cols, rank)),
                               rtol=0, atol=Q0_ULP)
    assert tops._powersgd_seed_matrix(cols, rank) is got      # cached


def _stage_inputs(size, rank, seed):
    from horovod_tpu.collectives import compression as jcomp
    m, c = jcomp.powersgd_matrix_shape(size)
    r = jcomp.powersgd_effective_rank(size, rank)
    rng = np.random.RandomState(seed)
    x = rng.randn(size).astype(np.float32)
    res = rng.randn(size).astype(np.float32)
    return m, c, r, x, res


def _padded(a, m, c):
    return np.concatenate([a, np.zeros(m * c - a.size, a.dtype)]).reshape(
        m, c)


@pytest.mark.parametrize("size,rank", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stages_match_jax_kernels(size, rank, dtype):
    """Each stage's plain version against the JAX Pallas kernel of the
    same stage (interpret mode), both fed the same inputs."""
    from horovod_tpu.collectives.ops import _powersgd_seed_matrix as jq0
    from horovod_tpu.ops import fused_update as jfu
    m, c, r, x, res = _stage_inputs(size, rank, seed=size)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    x_np = np.array(xj.astype(jnp.float32))
    xt = torch.from_numpy(x_np).to(getattr(torch, dtype))
    q0 = np.asarray(jq0(c, r))
    for residual in (res, None):
        acc_j, p_j = jfu.matricize_p(
            jnp.asarray(_padded(x_np, m, c)).astype(jdt),
            None if residual is None else jnp.asarray(_padded(residual, m,
                                                              c)),
            jnp.asarray(q0), prescale=0.5)
        acc_t, p_t = tfu.matricize_p(
            xt, None if residual is None else torch.from_numpy(residual),
            torch.from_numpy(q0), rows=m, prescale=0.5)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
        _close(p_t, p_j, msg="p")
    # Stage 2 on the JAX stage 1's outputs (p as the world-1 mean).
    po_j, ql_j = jfu.orthonormalize_q(acc_j, p_j)
    po_t, ql_t = tfu.orthonormalize_q(torch.from_numpy(np.asarray(acc_j)),
                                      torch.from_numpy(np.asarray(p_j)))
    _close(po_t, po_j, msg="p_orth")
    _close(ql_t, ql_j, msg="q_local")
    # Stage 3 with a mean Q unlike Q_local, and Sum's n with a postscale.
    q_mean = np.asarray(ql_j) * 0.75 + 0.01
    out_j, res_j = jfu.reconstruct_residual(
        acc_j, po_j, jnp.asarray(q_mean), ql_j, n_scale=2.0, postscale=0.25)
    out_t, res_t = tfu.reconstruct_residual(
        *(torch.from_numpy(np.asarray(a)) for a in
          (acc_j, po_j, q_mean, ql_j)), size=size, n_scale=2.0,
        postscale=0.25)
    assert out_t.shape == res_t.shape == (size,)
    _close(out_t, np.asarray(out_j).ravel()[:size], msg="out")
    _close(res_t, np.asarray(res_j).ravel()[:size], msg="residual")
    assert not any(registry.launch_counts().values())


@pytest.mark.parametrize("size,rank", CASES)
def test_stages_hold_the_error_feedback_invariant(size, rank):
    """``acc == P_orth Q_local^T + residual``: the residual holds exactly
    the mass the factors did not carry (to one f32 rounding)."""
    m, c, r, x, res = _stage_inputs(size, rank, seed=7 + size)
    q0 = tops._powersgd_seed_matrix(c, r)
    acc, p = tfu.matricize_p(torch.from_numpy(x), torch.from_numpy(res),
                             q0, rows=m)
    po, ql = tfu.orthonormalize_q(acc, p)
    _, new_res = tfu.reconstruct_residual(acc, po, ql, ql, size=size)
    own = (po @ ql.T).reshape(-1)[:size]
    _close(own + new_res, acc.reshape(-1)[:size], rel=1e-6)
    np.testing.assert_array_equal(acc.reshape(-1)[size:].numpy(), 0.0)
    # P_orth is orthonormal.
    np.testing.assert_allclose((po.T @ po).numpy(), np.eye(r), atol=1e-5)


def test_stage_wrappers_refuse_a_device_they_cannot_run_on():
    x = torch.zeros(10, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfu.matricize_p(x, None, torch.zeros(4, 2, device="meta"), rows=3)


# ---------------------------------------------------------------------------
# powersgd_allreduce: world 1 vs a one-device mesh
# ---------------------------------------------------------------------------


def _jax_powersgd(xs, residuals, op_name, rank, pre, post, fused=False,
                  monkeypatch=None):
    """JAX ``powersgd_allreduce`` over the current mesh, one row a device;
    returns numpy ``(out [n, size], residual [n, size])``."""
    import horovod_tpu as hv
    from horovod_tpu.collectives import ops as jops
    from horovod_tpu.core.state import global_state
    mesh = global_state().mesh
    axes = tuple(mesh.axis_names)
    op = hv.Sum if op_name == "sum" else hv.Average

    def spmd(row, res_row):
        out, new_res = jops.powersgd_allreduce(
            row[0], op, rank=rank, axes=axes,
            residual=None if residuals is None else res_row[0],
            prescale_factor=pre, postscale_factor=post)
        return out[None], new_res[None]

    res_in = np.zeros_like(xs) if residuals is None else residuals
    run = jax.jit(jax.shard_map(spmd, mesh=mesh, in_specs=P(*axes),
                                out_specs=P(*axes), check_vma=False))
    out, new_res = run(jnp.asarray(xs), jnp.asarray(res_in))
    return np.asarray(out.astype(jnp.float32)), np.asarray(new_res)


POWERSGD_CASES = [
    dict(size=50, rank=3, op="average", pre=1.0, post=1.0, res=True),
    dict(size=64, rank=2, op="sum", pre=1.0, post=1.0, res=False),
    dict(size=37, rank=1, op="average", pre=0.5, post=3.0, res=True),
    dict(size=1000, rank=4, op="sum", pre=2.0, post=0.25, res=True),
]


def _case_inputs(case, world):
    rng = np.random.RandomState(case["size"] + 31 * case["rank"])
    xs = rng.randn(world, case["size"]).astype(np.float32)
    res = rng.randn(world, case["size"]).astype(np.float32) \
        if case["res"] else None
    return xs, res


def _port_powersgd(case, x, res):
    op = thvd.Sum if case["op"] == "sum" else thvd.Average
    return tops.powersgd_allreduce(
        torch.from_numpy(x), op, rank=case["rank"],
        residual=None if res is None else torch.from_numpy(res),
        prescale_factor=case["pre"], postscale_factor=case["post"])


@pytest.mark.parametrize("case", POWERSGD_CASES,
                         ids=lambda c: f"{c['size']}-r{c['rank']}-{c['op']}")
def test_powersgd_allreduce_world_one_matches_jax(world1, jax1, case):
    xs, res = _case_inputs(case, 1)
    want_out, want_res = _jax_powersgd(xs, res, case["op"], case["rank"],
                                       case["pre"], case["post"])
    out, new_res = _port_powersgd(case, xs[0], None if res is None
                                  else res[0])
    assert out.dtype == torch.float32 and out.shape == (case["size"],)
    _close(out, want_out[0], msg="out")
    _close(new_res, want_res[0], msg="residual")
    # At world 1 the mean factors are this rank's own: what was sent plus
    # what stays behind is the accumulated gradient.
    acc = xs[0] * np.float32(case["pre"]) + (0 if res is None else res[0])
    sent = out.numpy() / np.float32(case["post"])
    _close(sent + new_res.numpy(), acc, rel=1e-5)


def test_powersgd_allreduce_matches_jax_fused_path(world1, jax1,
                                                   monkeypatch):
    """Against the JAX exchange with its kernels on (interpret mode)."""
    monkeypatch.setenv("HOROVOD_PALLAS_FUSED_UPDATE", "1")
    case = POWERSGD_CASES[0]
    xs, res = _case_inputs(case, 1)
    want_out, want_res = _jax_powersgd(xs, res, case["op"], case["rank"],
                                       case["pre"], case["post"])
    out, new_res = _port_powersgd(case, xs[0], res[0])
    _close(out, want_out[0], msg="out")
    _close(new_res, want_res[0], msg="residual")


def test_powersgd_allreduce_bf16_bucket(world1, jax1):
    """A bf16 bucket: f32 arithmetic, the output cast back to bf16."""
    case = dict(size=40, rank=2, op="average", pre=1.0, post=1.0, res=True)
    xs, res = _case_inputs(case, 1)
    xs = np.asarray(jnp.asarray(xs).astype(jnp.bfloat16).astype(
        jnp.float32))
    import horovod_tpu as hv
    from horovod_tpu.collectives import ops as jops
    from horovod_tpu.core.state import global_state
    axes = tuple(global_state().mesh.axis_names)
    out_j, res_j = jax.jit(jax.shard_map(
        lambda r, q: tuple(t[None] for t in jops.powersgd_allreduce(
            r[0].astype(jnp.bfloat16), hv.Average, rank=2, axes=axes,
            residual=q[0])),
        mesh=global_state().mesh, in_specs=P(*axes), out_specs=P(*axes),
        check_vma=False))(jnp.asarray(xs), jnp.asarray(res))
    out, new_res = tops.powersgd_allreduce(
        torch.from_numpy(xs[0]).to(torch.bfloat16), thvd.Average, rank=2,
        residual=torch.from_numpy(res[0]))
    assert out.dtype == torch.bfloat16
    # One bf16 rounding of the output on each side.
    _close(out.float(), np.asarray(out_j.astype(jnp.float32))[0], rel=1e-2)
    _close(new_res, np.asarray(res_j)[0], msg="residual")


# ---------------------------------------------------------------------------
# The error-feedback optimizer
# ---------------------------------------------------------------------------


def _flax_dotted(tree, prefix=""):
    out = []
    for k in sorted(tree):
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out += _flax_dotted(tree[k], name)
        else:
            out.append((name, tree[k]))
    return out


def test_resnet50_ef_plan_matches_jax_at_full_width():
    """ResNet-50 (1000 classes, s2d) at full width: the port's EF plan
    over its meta-device parameters, in flax order and layout, equals the
    JAX ``ef_bucket_plan`` of the flax parameters' shapes -- bucket for
    bucket, leaf for leaf -- and puts 227,888 bytes a step on the wire
    (448.6x less than the 102,239,648 uncompressed)."""
    from horovod_tpu.collectives.compression import powersgd_compressor
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu.optim import distributed as jdist
    fmodel = jresnet.ResNet50(num_classes=1000, dtype=jnp.bfloat16,
                              space_to_depth=True)
    shapes = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    jleaves = jax.tree.leaves(shapes["params"])
    want = jdist.ef_bucket_plan(jleaves, None, powersgd_compressor(4))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, device="meta")
    named = list(model.named_parameters())
    # The port's names are flax's dotted paths; sorted, they are JAX's
    # leaf order.
    flax_names = [n for n, _ in _flax_dotted(
        jax.tree.map(lambda s: s.shape, shapes["params"],
                     is_leaf=lambda s: hasattr(s, "shape")))]
    names = [n for n, _ in named]
    assert [names[i] for i in flax_leaf_order(names)] == flax_names
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression="powersgd:4")
    got = opt.bucket_plan
    assert len(got.buffers) == len(want.buffers) == 2
    for (gdt, gl), (wdt, wl) in zip(got.buffers, want.buffers):
        assert str(gdt).replace("torch.", "") == str(wdt)
        assert [(s.index, s.shape) for s in gl] == \
            [(s.index, s.shape) for s in wl]
    sizes = [sum(s.size for s in lspecs) for _, lspecs in got.buffers]
    assert sizes == [15053824, 10506088]
    assert [len(lspecs) for _, lspecs in got.buffers] == [76, 85]
    assert [tuple(r.shape) for r in opt.residuals] == [(n,) for n in sizes]
    assert all(r.dtype == torch.float32 for r in opt.residuals)
    wire = sum(tcomp.wire_payload_bytes(opt._compression, n) for n in sizes)
    assert wire == 227888 == 124160 + 103728
    assert sum(sizes) * 4 == 102239648
    assert tmetrics.registry().gauge("horovod_wire_bytes_per_step").value \
        == wire
    assert round(tmetrics.registry().gauge(
        "horovod_compression_ratio").value, 1) == 448.6


def _jax_ef_steps(hvd, model, variables, batch, steps, spec="powersgd:4"):
    """``steps`` JAX EF steps; ``(losses, state dict, residuals [n,
    size] per bucket)``."""
    from horovod_tpu.training import make_flax_train_step as jstep
    from horovod_tpu_torch.models import resnet_state_from_jax
    opt = hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                   compression=spec)
    step = jstep(model.apply, opt)
    jv = jax.tree.map(jnp.asarray, variables)
    params = hvd.replicate(jv["params"])
    stats = hvd.replicate(jv["batch_stats"])
    opt_state = hvd.replicate(opt.init(jv["params"]))
    data = hvd.shard_batch(tuple(map(jnp.asarray, batch)))
    losses = []
    for _ in range(steps):
        params, stats, opt_state, loss = step(params, stats, opt_state, data)
        losses.append(float(loss))
    final = {"params": _numpy_tree(params),
             "batch_stats": _numpy_tree(stats)}
    residuals = [np.asarray(r) for r in opt_state.residuals]
    return losses, resnet_state_from_jax(final, device="cpu"), residuals


def _port_ef_steps(variables, batch, steps, spec="powersgd:4"):
    model = _tiny_port(variables)
    named = list(model.named_parameters())
    thvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1, momentum=0.9),
        named_parameters=named, compression=spec)
    step = make_flax_train_step(model, opt)
    data = tuple(torch.from_numpy(a) for a in batch)
    losses = [step(data).item() for _ in range(steps)]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return losses, state, [r.clone() for r in opt.residuals]


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                   atol=STATE_ATOL, rtol=0, err_msg=name)


def test_three_ef_steps_match_jax_make_flax_train_step(monkeypatch, jax1,
                                                       world1):
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")  # JAX: interpret kernels
    model, variables = _tiny_flax(seed=4)
    batch = _batch()
    want_losses, want_state, want_res = _jax_ef_steps(jax1, model,
                                                      variables, batch, 3)
    before = tmetrics.exchange_totals()
    losses, state, residuals = _port_ef_steps(variables, batch, 3)
    after = tmetrics.exchange_totals()
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    _assert_states_equal(state, want_state)
    assert len(residuals) == len(want_res)
    for got, want in zip(residuals, want_res):
        assert want.shape == (1,) + tuple(got.shape)
        np.testing.assert_allclose(got.numpy(), want[0], atol=STATE_ATOL,
                                   rtol=0)
        assert got.abs().max().item() > 0
    # Per step and bucket: one bucket, two handles, 4 r (m + c) bytes.
    nb = len(residuals)
    sizes = [r.numel() for r in residuals]
    wire = sum(tcomp.wire_payload_bytes(tcomp.powersgd_compressor(4), n)
               for n in sizes)
    assert after["buckets"] - before["buckets"] == 3 * nb
    assert after["handles"] - before["handles"] == 3 * 2 * nb
    assert after["wire_bytes"] - before["wire_bytes"] == 3 * wire


def test_ef_residual_off_keeps_residuals_at_zero(monkeypatch):
    """``HOROVOD_EF_RESIDUAL=0``: the codec runs, nothing is fed back and
    the residuals stay exactly at their zero init."""
    for k in _LAUNCHER_ENV + _CODEC_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_EF_RESIDUAL", "0")
    monkeypatch.setenv("HOROVOD_COMPRESSION", "powersgd:2")
    _, variables = _tiny_flax(seed=5)
    thvd.init(device="cpu")
    try:
        model = _tiny_port(variables)
        named = list(model.named_parameters())
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=0.1),
            named_parameters=named)
        assert opt._compression.__name__ == "PowerSGD2Compressor"
        step = make_flax_train_step(model, opt)
        data = tuple(torch.from_numpy(a) for a in _batch())
        losses = [step(data).item() for _ in range(2)]
        assert np.isfinite(losses).all()
        assert all(r.abs().max().item() == 0.0 for r in opt.residuals)
        grads = [torch.randn(5, 3), torch.randn(4)]
        res = tdist.ef_init_residuals(grads, None, opt._compression)
        _, new = tdist.ef_exchange(grads, res, compression="powersgd:2")
        assert all(a is b for a, b in zip(new, res))
    finally:
        thvd.shutdown()


def test_ef_exchange_feeds_residuals_and_checks_their_count(world1):
    rng = np.random.RandomState(9)
    grads = [torch.from_numpy(rng.randn(6, 4).astype(np.float32)),
             torch.from_numpy(rng.randn(9).astype(np.float32))]
    codec = tcomp.powersgd_compressor(2)
    res = tdist.ef_init_residuals(grads, None, codec)
    assert [tuple(r.shape) for r in res] == [(33,)]
    out, new = tdist.ef_exchange(grads, res, compression=codec)
    assert [tuple(o.shape) for o in out] == [(6, 4), (9,)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    sent = torch.cat([o.reshape(-1) for o in out])
    _close(sent + new[0], flat, rel=1e-5)
    with pytest.raises(ValueError, match="2 buckets but the plan has 1"):
        tdist.ef_exchange(grads, res * 2, compression=codec)
    # The stateless surface drops the error.
    stateless = tdist.allreduce_gradients(grads, compression=codec)
    for a, b in zip(stateless, out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_failed_exchange_leaves_the_residual_alone(world1, monkeypatch):
    """The residual is replaced only once its bucket's exchange has come
    back whole: a failing stage 3 surfaces from ``synchronize()`` and the
    residual keeps the value of the step before."""
    _, variables = _tiny_flax(seed=6)
    model = _tiny_port(variables)
    named = list(model.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1),
        named_parameters=named, compression="powersgd:2")
    step = make_flax_train_step(model, opt)
    data = tuple(torch.from_numpy(a) for a in _batch())
    step(data)
    kept = [r.clone() for r in opt.residuals]
    assert all(r.abs().max().item() > 0 for r in kept)

    def boom(*args, **kwargs):
        raise RuntimeError("stage 3 failed")

    monkeypatch.setattr(tfu, "reconstruct_residual", boom)
    with pytest.raises(RuntimeError, match="stage 3 failed"):
        step(data)
    for a, b in zip(opt.residuals, kept):
        assert torch.equal(a, b)
    assert not opt._handles


# ---------------------------------------------------------------------------
# A world of two (gloo) vs a two-device JAX mesh
# ---------------------------------------------------------------------------


def _grads_inputs(rank):
    rng = np.random.RandomState(200 + rank)
    return [rng.randn(7, 5).astype(np.float32),
            rng.randn(11).astype(np.float32)]


def _world2_worker(rank: int, store_path: str, vars_path: str,
                   out: str) -> None:
    """One rank: every PowerSGD case, the stateless gradient exchange and
    two EF training steps on its half batch, results saved."""
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, 2), rank=rank,
              size=2)
    res = {"cases": []}
    for case in POWERSGD_CASES:
        xs, rs = _case_inputs(case, 2)
        o, r = _port_powersgd(case, xs[rank], None if rs is None
                              else rs[rank])
        res["cases"].append((o, r))
    res["grads"] = tdist.allreduce_gradients(
        [torch.from_numpy(g) for g in _grads_inputs(rank)],
        compression="powersgd:2")
    variables = torch.load(vars_path, weights_only=False)
    x, y = _batch()
    half = (x[2 * rank:2 * rank + 2], y[2 * rank:2 * rank + 2])
    res["train"] = _port_ef_steps(variables, half, 2)
    torch.save(res, out)
    thvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Run the two-rank world once for the module; yields ``(results of
    rank 0, results of rank 1, the flax model and variables)``."""
    tmp = tmp_path_factory.mktemp("powersgd_world2")
    model, variables = _tiny_flax(seed=8)
    torch.save(variables, tmp / "vars.pt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in _CODEC_ENV:
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp / "store"),
         str(tmp / "vars.pt"), str(tmp / f"r{r}.pt")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    yield tuple(torch.load(tmp / f"r{r}.pt", weights_only=False)
                for r in range(2)) + ((model, variables),)


@pytest.mark.parametrize("i", range(len(POWERSGD_CASES)),
                         ids=[f"{c['size']}-r{c['rank']}-{c['op']}"
                              for c in POWERSGD_CASES])
def test_powersgd_allreduce_world_two_matches_two_device_mesh(world2, jax2,
                                                              i):
    case = POWERSGD_CASES[i]
    xs, res = _case_inputs(case, 2)
    want_out, want_res = _jax_powersgd(xs, res, case["op"], case["rank"],
                                       case["pre"], case["post"])
    (o0, r0), (o1, r1) = world2[0]["cases"][i], world2[1]["cases"][i]
    assert torch.equal(o0, o1)          # every rank rebuilds the same out
    for rank, (o, r) in enumerate(((o0, r0), (o1, r1))):
        _close(o, want_out[rank], msg=f"out rank {rank}")
        _close(r, want_res[rank], msg=f"residual rank {rank}")


def test_stateless_gradient_exchange_world_two_matches_jax(world2, jax2):
    from horovod_tpu.core.state import global_state
    from horovod_tpu.optim import distributed as jdist
    mesh = global_state().mesh
    axes = tuple(mesh.axis_names)
    stacked = [np.stack(g) for g in zip(*(_grads_inputs(r)
                                          for r in range(2)))]

    def spmd(*rows):
        out = jdist.allreduce_gradients([r[0] for r in rows],
                                        compression="powersgd:2")
        return tuple(o[None] for o in out)

    want = jax.jit(jax.shard_map(spmd, mesh=mesh, in_specs=P(*axes),
                                 out_specs=P(*axes), check_vma=False))(
        *map(jnp.asarray, stacked))
    for rank in range(2):
        for got, w in zip(world2[rank]["grads"], want):
            _close(got, np.asarray(w)[rank])
    for a, b in zip(world2[0]["grads"], world2[1]["grads"]):
        assert torch.equal(a, b)


def test_two_ef_steps_world_two_match_two_device_mesh(world2, jax2,
                                                      monkeypatch):
    monkeypatch.setenv("HOROVOD_PALLAS_BN", "1")
    model, variables = world2[2]
    want_losses, want_state, want_res = _jax_ef_steps(jax2, model,
                                                      variables, _batch(), 2)
    for rank in range(2):
        losses, state, residuals = world2[rank]["train"]
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        _assert_states_equal(state, want_state)
        for got, want in zip(residuals, want_res):
            assert want.shape == (2,) + tuple(got.shape)
            np.testing.assert_allclose(got.numpy(), want[rank],
                                       atol=STATE_ATOL, rtol=0)
    # The replicas stay in step bitwise; their residuals differ.
    s0, s1 = world2[0]["train"][1], world2[1]["train"][1]
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert not torch.equal(world2[0]["train"][2][0], world2[1]["train"][2][0])


if __name__ == "__main__":
    _world2_worker(int(sys.argv[1]), *sys.argv[2:5])
