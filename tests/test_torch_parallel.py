"""PyTorch/CUDA port: model parallelism (``horovod_tpu_torch.parallel``)
and the 3-D step, against the JAX package.

Gloo worlds of 2 and 4 (this file, run as a script, is each rank; they
meet through a ``FileStore`` under pytest's temporary directory; rank
``r`` is the JAX mesh's device ``r``), the JAX side under
``jax.shard_map`` on as many of the conftest's CPU devices.  Inputs come
from numpy seeds (BERT_TINY's weights from the flax init, handed to the
workers).  f32 throughout, within 1e-5 of the largest |value| unless a
case says otherwise:

* the rank meshes (``build_3d_mesh``, ``build_parallel_mesh``,
  ``build_mesh``) for a table of extents: axis names, shape, the rank
  grid, ``data_axes`` / ``model_axes`` and each rank's line on every
  axis and on the data axes, against the JAX meshes' device grids;
* ``ppermute`` and ``alltoall(split_axis=, concat_axis=)`` against the
  JAX ops;
* the column/row pair and ``tp_mlp`` (SwiGLU) at tp 2 and 4, forward
  and every gradient; the trap pinned: without ``copy_to_tp`` the input
  gradient is a per-rank partial (the partials sum to it), and a closing
  allreduce whose backward is another allreduce multiplies the kernel
  gradients by tp;
* ``tp_param_specs`` and ``shard_tp_params`` against JAX's leaf for
  leaf on BERT_TINY, and ``shard_params`` / ``gather_tp_params`` as
  inverses;
* ``bert_tp_apply`` (``BertTP``) against JAX's under ``shard_map`` and
  against the port's ``Bert`` (2e-4: the two layer norms compute the
  variance two ways, as the JAX package's own test holds flax's);
* three SGD steps of the 3-D step at (data 2, model 2) against the JAX
  3-D step, the full tree gathered (``wk.bias`` -- zero gradient in exact
  arithmetic -- at its layer's ``wk.kernel`` scale); five AdamW steps
  against pure DP at world 4 within JAX's own 2e-3; ZeRO-1 and
  ``microbatches=2`` over the data set against the plain 3-D step; the
  two refusals of ``_check_model_parallel_exchange``;
* ring attention (causal or not, segment ids, every gradient) and
  Ulysses at sp 2 and 4 against the JAX functions;
* the pipeline at 2 and 4 stages against the JAX ``pipeline_apply``
  and against the sequential model (outputs and every stage's
  gradients), and one that trains;
* MoE against the JAX layer: identical experts (and the dense FFN),
  capacity drops, top-2 and each wire codec (bf16 within 2^-8, fp16
  within 2^-11 of the largest |value|: a slot rounded on the wire may
  round the other way), and ``plan_moe_alltoall`` / ``explain_plan``'s
  MoE rows equal to JAX's;
* ``sync_batch_norm(axes=("data",))`` over the 2-rank data sets of a
  world of 4 against one process on the two members' batches and the
  JAX ``sync_batch_norm`` on the same sub-mesh;
* the two-level DP leg on ``dcn_size=2`` meshes at world 4: the data
  set's ``(dcn, inner)`` pair against the JAX mesh's lines; two SGD
  steps of the 3-D step on ``data=2, dcn_size=2`` and ``model=2,
  dcn_size=2`` under ``HOROVOD_HIERARCHICAL_ALLREDUCE`` (within ``REL``)
  and under the per-leg codec ``ici:none,dcn:fp16`` (within fp16's
  ``CODEC_REL``) against the JAX 3-D step on the same 4-device mesh,
  the exchanged bytes by leg equal to the JAX ``plan_hier_legs`` of the
  step's buckets; ``zero_init(mesh=, param_specs=)`` on ``model=2,
  dcn_size=2`` with the per-leg codec: each rank's arena shard the JAX
  arena's at the ``(ici, dcn)``-major index, and after one ZeRO-1 step
  (SGD, momentum 0.9) each rank's momentum shard the JAX state's row of
  its device and the parameters the JAX step's; a user's process set
  with a per-leg error-feedback codec refused as by the JAX optimizer.
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
from horovod_tpu_torch import parallel as tpar  # noqa: E402
from horovod_tpu_torch.models import BERT_TINY  # noqa: E402

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_TP", "HOROVOD_PIPELINE_STAGES",
                 "HOROVOD_MOE_COMPRESSION", "HOROVOD_COMPRESSION")
REL = 1e-5
BERT_REL = 2e-4
TRAJ_TOL = 2e-3
WORLDS = (2, 4)
MESHES = {
    2: [("3d", dict(data=2)), ("3d", dict(model=2)), ("3d", dict(pipe=2)),
        ("3d", dict(data=1, dcn_size=2)), ("par", dict(dp=2)),
        ("par", dict(tp=2)), ("par", dict(sp=2)), ("par", dict(pp=2)),
        ("par", dict(ep=2)), ("flat", {})],
    4: [("3d", dict(data=4)), ("3d", dict(data=2, model=2)),
        ("3d", dict(model=4)), ("3d", dict(pipe=2, model=2)),
        ("3d", dict(data=2, dcn_size=2)), ("3d", dict(model=2, dcn_size=2)),
        ("3d", dict(data=2, pipe=2)), ("par", dict(dp=2, sp=2)),
        ("par", dict(dp=2, tp=2)), ("par", dict(pp=2, ep=2)),
        ("par", dict(sp=4)), ("par", dict(dp=4)), ("flat", {}),
        ("hier", dict(dcn_size=2))],
}
RING = {"plain": (False, False), "causal": (True, False),
        "seg": (False, True), "seg_causal": (True, True)}
MOE = {   # name: (capacity_factor, top_k, compression, identical, forced)
    "identical": (8.0, 1, "none", True, False),
    "drops": (1.0, 1, "none", False, True),
    "top2": (2.0, 2, "none", False, False),
    "none": (1.25, 1, "none", False, False),
    "bf16": (1.25, 1, "bf16", False, False),
    "fp16": (1.25, 1, "fp16", False, False),
}
CODEC_REL = {"none": REL, "bf16": 2.0 ** -8, "fp16": 2.0 ** -11}
SGD_LR = 0.1
SGD_STEPS = 3
ADAM_STEPS = 5
# The two-level DP leg: name -> (3-D mesh extents, DP codec,
# HOROVOD_HIERARCHICAL_ALLREDUCE).
DCN_CASES = {
    "dp_hier": (dict(data=2, dcn_size=2), "none", True),
    "tp_hier": (dict(model=2, dcn_size=2), "none", True),
    "dp_codec": (dict(data=2, dcn_size=2), "ici:none,dcn:fp16", False),
    "tp_codec": (dict(model=2, dcn_size=2), "ici:none,dcn:fp16", False),
}
DCN_STEPS = 2
# ZeRO-1 under the per-leg codec: name -> (3-D mesh extents, codec);
# n_ici = 2 on the first, so the (ici, dcn)-major index differs from the
# row-major one on ranks 1 and 2.
DCN_ZERO = {"zero_dp": (dict(data=2, dcn_size=2), "ici:none,dcn:fp16"),
            "zero_tp": (dict(model=2, dcn_size=2), "ici:none,dcn:fp16")}
DCN_MOMENTUM = 0.9
HIER_LEGS = ("hier/ici_rs", "hier/dcn_ar", "hier/ici_ag")


# ---------------------------------------------------------------------------
# Inputs (the same numpy streams on both sides)
# ---------------------------------------------------------------------------


def _tp_inputs():
    rng = np.random.RandomState(1)
    return [rng.randn(*s).astype(np.float32)
            for s in ((4, 16), (16, 32), (16, 32), (32, 16))]


def _attn_inputs(h):
    rng = np.random.RandomState(5)
    b, t, d = 2, 64, 16
    q, k = (0.3 * rng.randn(b, h, t, d).astype(np.float32) for _ in (0, 1))
    v = rng.randn(b, h, t, d).astype(np.float32)
    seg = np.concatenate([np.zeros((b, 28)), np.ones((b, 28)),
                          np.full((b, 8), 7)], axis=1).astype(np.int32)
    return q, k, v, seg


def _stage_inputs(n_stages, n_micro=8, mb=4, dim=16, seed=5):
    rng = np.random.RandomState(seed)
    ws = [(0.3 * rng.randn(dim, dim)).astype(np.float32)
          for _ in range(n_stages)]
    batch = rng.randn(n_micro * mb, dim).astype(np.float32)
    return ws, batch


def _moe_inputs(name):
    cap, top_k, codec, identical, forced = MOE[name]
    rng = np.random.RandomState(7)
    d, f, e = 16, 32, 8
    router = (rng.randn(d, e) * d ** -0.5).astype(np.float32)
    w_up = (rng.randn(e, d, f) * d ** -0.5).astype(np.float32)
    w_down = (rng.randn(e, f, d) * f ** -0.5).astype(np.float32)
    if identical:
        w_up = np.broadcast_to(w_up[:1], w_up.shape).copy()
        w_down = np.broadcast_to(w_down[:1], w_down.shape).copy()
    if forced:
        router = np.zeros_like(router)
        router[:, 0] = 10.0
    x = rng.randn(64, d).astype(np.float32)
    return x, router, w_up, w_down


def _bn_inputs(rank):
    rng = np.random.RandomState(20 + rank)
    x = (1.5 * rng.randn(2, 7, 5, 16) + 0.7).astype(np.float32)
    dy = rng.randn(2, 7, 5, 16).astype(np.float32)
    return x, dy


BN_PARAMS = {"scale": np.linspace(0.8, 1.2, 16).astype(np.float32),
             "bias": np.linspace(-0.1, 0.1, 16).astype(np.float32),
             "mean": np.zeros(16, np.float32),
             "var": np.ones(16, np.float32)}


def _bert_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, BERT_TINY.vocab_size, (8, 16)),
            rng.randint(0, 2, (8,)))


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(True) if grad else t


def _cut(a, pos, n, dim=0):
    w = a.shape[dim] // n
    return np.take(a, range(pos * w, (pos + 1) * w), axis=dim)


# ---------------------------------------------------------------------------
# The worker (one rank)
# ---------------------------------------------------------------------------


class _AllreduceBoth(torch.autograd.Function):
    """A closing allreduce whose backward is another allreduce: the raw
    psum's transpose, which the trap case runs instead of the "g"
    operator."""

    @staticmethod
    def forward(ctx, x, ps):
        ctx.ps = ps
        return thvd.allreduce(x, op=thvd.Sum, process_set=ps)

    @staticmethod
    def backward(ctx, g):
        return thvd.allreduce(g, op=thvd.Sum, process_set=ctx.ps), None


def _mesh_record(kind, ext):
    mesh = {"3d": tpar.build_3d_mesh, "par": tpar.build_parallel_mesh,
            "flat": tpar.build_mesh,
            "hier": lambda **kw: tpar.build_mesh(hierarchical=True, **kw)
            }[kind](**ext)
    lines = {a: mesh.members(a) for a in mesh.axis_names}
    lines["data_axes"] = mesh.members(tpar.data_axes(mesh))
    pair = mesh.group(tpar.data_axes(mesh)).hier
    return {"axis_names": mesh.axis_names, "shape": dict(mesh.shape),
            "ranks": mesh.ranks.tolist(), "data_axes": tpar.data_axes(mesh),
            "model_axes": tpar.model_axes(mesh), "lines": lines,
            "group": mesh.group(tpar.data_axes(mesh)).ranks,
            "hier": None if pair is None else (
                pair.n_dcn, pair.n_ici, pair.ici.ranks, pair.dcn.ranks)}


def _tp_rank(world):
    from horovod_tpu_torch.parallel.tp import (column_parallel, copy_to_tp,
                                               row_parallel, tp_mlp)
    mesh = tpar.build_parallel_mesh(tp=world)
    pos = mesh.axis_index("tp")
    x, wg, wu, wd = _tp_inputs()
    out = {}

    def shards():
        return (_t(x, True), _t(_cut(wg, pos, world, 1), True),
                _t(_cut(wu, pos, world, 1), True),
                _t(_cut(wd, pos, world, 0), True))

    xt, g, u, dn = shards()
    y = row_parallel(torch.relu(column_parallel(copy_to_tp(xt), u)), dn)
    y.sum().backward()
    out["pair"] = (y.detach(), xt.grad, u.grad, dn.grad)
    xt, g, u, dn = shards()
    loss = tp_mlp(xt, u, dn, w_gate=g).sum()
    loss.backward()
    out["mlp"] = (loss.detach(), xt.grad, g.grad, u.grad, dn.grad)
    # The trap: no copy_to_tp (a partial input gradient), and a closing
    # allreduce that allreduces its gradient too (kernels x tp).
    xt, g, u, dn = shards()
    h = torch.nn.functional.silu(xt @ g) * (xt @ u)
    tpar.reduce_from_tp(h @ dn).sum().backward()
    out["no_f"] = xt.grad
    xt, g, u, dn = shards()
    h = torch.nn.functional.silu(copy_to_tp(xt) @ g) * (copy_to_tp(xt) @ u)
    _AllreduceBoth.apply(h @ dn, mesh.group("tp")).sum().backward()
    out["g_twice"] = (u.grad, dn.grad)
    # ppermute (a ring shift) and the alltoall axis form.
    ring = [(i, (i + 1) % world) for i in range(world)]
    a = torch.arange(6.0).reshape(2, 3) + 10 * thvd.rank()
    out["ppermute"] = thvd.collective_ops.ppermute(
        a, ring, process_set=mesh.group("tp"))
    out["ppermute_partial"] = thvd.collective_ops.ppermute(
        a, [(0, world - 1)], process_set=mesh.group("tp"))
    b = torch.arange(2.0 * 4 * world * 3).reshape(2, 4 * world, 3) \
        + 1000 * thvd.rank()
    out["alltoall"] = thvd.alltoall(b, process_set=mesh.group("tp"),
                                    split_axis=1, concat_axis=2)
    return out


def _seq_rank(world):
    mesh = tpar.build_parallel_mesh(sp=world)
    pos = mesh.axis_index("sp")
    out = {}
    for mode, fn, h in (("ring", tpar.ring_attention, 2),
                        ("ulysses", tpar.ulysses_attention, 8)):
        q, k, v, seg = _attn_inputs(h)
        for name, (causal, use_seg) in RING.items():
            qt, kt, vt = (_t(_cut(a, pos, world, 2), True) for a in (q, k, v))
            s = _t(_cut(seg, pos, world, 1)) if use_seg else None
            o = fn(qt, kt, vt, causal=causal, segment_ids=s)
            o.sum().backward()
            out[mode, name] = (o.detach(), qt.grad, kt.grad, vt.grad)
    return out


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pipe_rank(world):
    mesh = tpar.build_parallel_mesh(pp=world)
    pos = mesh.axis_index("pp")
    ws, batch = _stage_inputs(world)
    p = {"w": _t(ws[pos], True), "b": torch.zeros(16, requires_grad=True)}
    micro = tpar.split_microbatches(_t(batch), 8)
    y = tpar.pipeline_apply(_stage_fn, p, micro)
    (y ** 2).sum().backward()
    out = {"apply": (y.detach(), p["w"].grad, p["b"].grad)}
    # Training: a small regression through the pipeline.
    ws, x = _stage_inputs(world, n_micro=4, mb=8, dim=8, seed=6)
    ys = np.random.RandomState(16).randn(32, 8).astype(np.float32) * 0.1
    p = {"w": _t(ws[pos], True), "b": torch.zeros(8, requires_grad=True)}
    opt = torch.optim.Adam(p.values(), lr=1e-2)
    mx, my = (tpar.split_microbatches(_t(a), 4) for a in (x, ys))
    losses = []
    for _ in range(31):
        loss = ((tpar.pipeline_apply(_stage_fn, p, mx) - my) ** 2).mean()
        losses.append(loss.item())
        opt.zero_grad()
        loss.backward()
        opt.step()
    out["train"] = losses
    return out


def _moe_rank(world):
    mesh = tpar.build_parallel_mesh(ep=world)
    pos = mesh.axis_index("ep")
    out = {}
    for name, (cap, top_k, codec, _, _) in MOE.items():
        x, router, w_up, w_down = _moe_inputs(name)
        y, aux = tpar.moe_ffn(_t(_cut(x, pos, world)), _t(router),
                              _t(_cut(w_up, pos, world)),
                              _t(_cut(w_down, pos, world)),
                              capacity_factor=cap, top_k=top_k,
                              compression=codec)
        out[name] = (y, aux)
    return out


def _bert_loss(model, batch):
    from horovod_tpu_torch.training import mlm_nsp_loss
    return mlm_nsp_loss(*model(batch[0]), *batch)


def _bert_3d(params, mesh, opt_cls, steps, **kw):
    """``steps`` of the 3-D step from ``params``: (losses, full tree)."""
    from horovod_tpu_torch.models import BertTP
    from horovod_tpu_torch.training import make_train_step, shard_batch
    specs = tpar.tp_param_specs(params, axis="model")
    tp = mesh.axis_size("model")
    local = tpar.shard_params({k: v.clone() for k, v in params.items()},
                              specs, mesh.axis_index("model"), tp)
    model = BertTP(BERT_TINY, local, axis="model")
    opt_kw = kw.pop("opt_kw", {})
    inner = opt_cls(model.parameters(), **opt_kw)
    if kw.get("zero_stage"):
        opt = inner
    else:
        opt = thvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(),
            compression=thvd.Compression.none,
            process_set=mesh.group(tpar.data_axes(mesh)))
    step = make_train_step(model, _bert_loss, opt, tp=tp, param_specs=specs,
                           **kw)
    batch = shard_batch(tuple(_t(a) for a in _bert_batch()))
    losses = [step(batch).item() for _ in range(steps)]
    full = tpar.gather_tp_params(dict(model.named_parameters()), specs,
                                 axis="model")
    return losses, {k: v.detach().clone() for k, v in full.items()}


def _bert_rank(world, params):
    from horovod_tpu_torch.models import Bert, BertTP
    from horovod_tpu_torch.training import make_train_step, shard_batch
    out = {}
    mesh = tpar.build_3d_mesh(data=world // 2, model=2)
    specs = tpar.tp_param_specs(params, axis="model")
    local = tpar.shard_params(params, specs, mesh.axis_index("model"), 2)
    toks, _ = shard_batch(tuple(_t(a) for a in _bert_batch()))
    with torch.no_grad():
        out["forward"] = BertTP(BERT_TINY, dict(local))(toks)
    out["gathered"] = tpar.gather_tp_params(local, specs, axis="model")
    if world != 4:
        return out
    out["sgd"] = _bert_3d(params, mesh, torch.optim.SGD, SGD_STEPS,
                          opt_kw=dict(lr=SGD_LR))
    out["zero"] = _bert_3d(params, mesh, torch.optim.SGD, 2,
                           opt_kw=dict(lr=SGD_LR), zero_stage=1)
    out["micro"] = _bert_3d(params, mesh, torch.optim.SGD, 2,
                            opt_kw=dict(lr=SGD_LR), microbatches=2)
    out["plain2"] = _bert_3d(params, mesh, torch.optim.SGD, 2,
                             opt_kw=dict(lr=SGD_LR))
    out["adamw_3d"] = _bert_3d(params, mesh, torch.optim.AdamW, ADAM_STEPS,
                               opt_kw=dict(lr=1e-3))[0]
    # The two refusals on the (2, 2) mesh.
    model = BertTP(BERT_TINY, dict(local))
    refusals = {}
    for name, kw in (("ef", dict(compression="powersgd:2",
                                 process_set=mesh.group("data"))),
                     ("world", dict(compression=thvd.Compression.none))):
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), **kw)
        try:
            make_train_step(model, _bert_loss, opt, tp=2, param_specs=specs)
            refusals[name] = None
        except Exception as e:       # noqa: BLE001 - recorded, checked
            refusals[name] = (type(e).__name__, str(e))
    out["refusals"] = refusals
    # Pure DP over the same four ranks.
    tpar.build_3d_mesh(data=4)
    dp = Bert.from_params(BERT_TINY, {k: v.clone() for k, v in
                                      params.items()})
    opt = thvd.DistributedOptimizer(
        torch.optim.AdamW(dp.parameters(), lr=1e-3),
        named_parameters=dp.named_parameters(),
        compression=thvd.Compression.none)
    step = make_train_step(dp, _bert_loss, opt)
    batch = shard_batch(tuple(_t(a) for a in _bert_batch()))
    out["adamw_dp"] = [step(batch).item() for _ in range(ADAM_STEPS)]
    return out


def _dcn_3d(params, mesh_kw, comp, hier, zero=False):
    """``DCN_STEPS`` (ZeRO-1: one) SGD steps of the 3-D step on a
    ``dcn_size=2`` mesh: losses, the full tree, the exchange's bytes by
    leg and its buckets (ZeRO-1: the arena shards before the step and
    the momentum shards after it)."""
    import dataclasses
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import Bert, BertTP
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    from horovod_tpu_torch.training import make_train_step, shard_batch
    st = global_state()
    base = st.config
    st.config = dataclasses.replace(base, hierarchical_allreduce=hier)
    try:
        mesh = tpar.build_3d_mesh(**mesh_kw)
        tp = mesh.axis_size("model")
        fresh = {k: v.clone() for k, v in params.items()}
        specs = tpar.tp_param_specs(params, axis="model")
        if tp > 1:
            model = BertTP(BERT_TINY, tpar.shard_params(
                fresh, specs, mesh.axis_index("model"), tp), axis="model")
        else:
            model = Bert.from_params(BERT_TINY, fresh)
        inner = torch.optim.SGD(model.parameters(), lr=SGD_LR,
                                momentum=DCN_MOMENTUM if zero else 0.0)
        # ZeRO-1's arena in the JAX leaf order: zero_init(param_specs=).
        kw = dict(tp=tp, param_specs=specs if tp > 1 or zero else None)
        if zero:
            opt = inner
            kw.update(zero_stage=1, zero_compression=comp)
        else:
            opt = thvd.DistributedOptimizer(
                inner, named_parameters=model.named_parameters(),
                compression=comp, process_set=(
                    mesh.group(tpar.data_axes(mesh)) if tp > 1 else None))
        step = make_train_step(model, _bert_loss, opt, **kw)
        out = {}
        if zero:
            out["shards0"] = [t.clone() for t in step.zero_state.shards]
        batch = shard_batch(tuple(_t(a) for a in _bert_batch()))
        before = exchange_totals(legs=True)
        out["losses"] = [step(batch).item()
                         for _ in range(1 if zero else DCN_STEPS)]
        after = exchange_totals(legs=True)
        out["legs"] = {k: after[k] - before[k] for k in HIER_LEGS}
        if zero:
            zs = step.zero_state
            out["momentum"] = [zs.inner.state[t]["momentum_buffer"].clone()
                               for t in zs.shards]
        else:
            out["buckets"] = [(str(dt).replace("torch.", ""),
                               sum(x.size for x in lspecs))
                              for dt, lspecs in opt.bucket_plan.buffers]
            out["set_pair"] = opt._process_set.hier.shape
        tree = dict(model.named_parameters())
        if tp > 1:
            tree = tpar.gather_tp_params(tree, specs, axis="model")
        out["full"] = {k: v.detach().clone() for k, v in tree.items()}
        return out
    finally:
        st.config = base


def _dcn_refusal():
    """A user's process set with a per-leg error-feedback codec."""
    tpar.build_3d_mesh(data=4)
    user = thvd.add_process_set([0, 1, 2, 3], name="user_dcn")
    model = torch.nn.Linear(4, 4)
    try:
        thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            compression="ici:none,dcn:topk:0.5", process_set=user)
        return None
    except Exception as e:       # noqa: BLE001 - recorded, checked
        return type(e).__name__, str(e)


def _dcn_rank(params):
    out = {name: _dcn_3d(params, *case) for name, case in DCN_CASES.items()}
    for name, case in DCN_ZERO.items():
        out[name] = _dcn_3d(params, *case, hier=False, zero=True)
    out["refusal"] = _dcn_refusal()
    return out


def _bn_rank(rank):
    from horovod_tpu_torch.training import sync_batch_norm
    tpar.build_3d_mesh(data=2, model=2)
    m = sync_batch_norm(axes=("data",), features=16, momentum=0.9,
                        epsilon=1e-5, device="cpu")
    m.load_state_dict({k: _t(v) for k, v in BN_PARAMS.items()})
    x, dy = _bn_inputs(rank)
    xt = _t(x, True)
    y = m(xt)
    y.backward(_t(dy))
    return (y.detach(), xt.grad, m.scale.grad, m.bias.grad, m.mean, m.var)


def _worker(rank, world, store_path, in_path, out_path):
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    params = {k: _t(v) for k, v in
              torch.load(in_path, weights_only=False).items()}
    res = {"meshes": [_mesh_record(kind, ext) for kind, ext in
                      MESHES[world]]}
    res["tp"] = _tp_rank(world)
    res["seq"] = _seq_rank(world)
    res["pipe"] = _pipe_rank(world)
    res["moe"] = _moe_rank(world)
    res["bert"] = _bert_rank(world, params)
    if world == 4:
        res["bn"] = _bn_rank(rank)
        res["dcn"] = _dcn_rank(params)
    thvd.barrier()
    torch.save(res, out_path)
    thvd.shutdown()


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


def _flax_bert():
    import jax
    import jax.numpy as jnp
    from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
    from horovod_tpu.models.transformer import Bert as JBert
    model = JBert(J_BERT_TINY, dtype=jnp.float32)
    toks, _ = _bert_batch()
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(toks[:1]))
    return model, jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def flax_bert():
    return _flax_bert()


@pytest.fixture(scope="module")
def port_params(flax_bert):
    from horovod_tpu_torch.models import params_from_jax
    return params_from_jax(flax_bert[1], device="cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, port_params):
    tmp = tmp_path_factory.mktemp("parallel")
    torch.save({k: v.numpy() for k, v in port_params.items()},
               tmp / "in.pt")
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


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _cat(ranks, dim=0):
    return np.concatenate([r.detach().numpy() for r in ranks], axis=dim)


def _mesh_1d(axis, n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:n], dtype=object).reshape(n),
                (axis,))


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

MESH_IDS = [(w, i) for w in WORLDS for i in range(len(MESHES[w]))]


def _jax_mesh(kind, ext, n):
    import jax
    from horovod_tpu.parallel import mesh as jm
    devs = jax.devices()[:n]
    if kind == "3d":
        return jm.build_3d_mesh(devs, **ext)
    if kind == "par":
        return jm.build_parallel_mesh(devs, **ext)
    if kind == "hier":
        return jm.build_mesh(devs, hierarchical=True, **ext)
    return jm.build_mesh(devs)


def _jax_line(grid, names, rank, axes):
    """The ranks sharing every coordinate but ``axes`` with ``rank``."""
    where = dict(zip(names, np.argwhere(grid == rank)[0]))
    idx = tuple(slice(None) if a in axes else int(where[a]) for a in names)
    return tuple(sorted(int(r) for r in np.asarray(grid[idx]).ravel()))


@pytest.mark.parametrize("world,i", MESH_IDS,
                         ids=[f"w{w}-{MESHES[w][i][0]}-"
                              + "-".join(f"{k}{v}" for k, v in
                                         MESHES[w][i][1].items())
                              for w, i in MESH_IDS])
def test_meshes_match_jax(worlds, world, i):
    from horovod_tpu.parallel import mesh as jm
    kind, ext = MESHES[world][i]
    jmesh = _jax_mesh(kind, ext, world)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, res in enumerate(worlds[world]):
        rec = res["meshes"][i]
        assert rec["axis_names"] == tuple(jmesh.axis_names)
        assert rec["shape"] == dict(jmesh.shape)
        assert rec["ranks"] == grid.tolist()
        assert rec["data_axes"] == jm.data_axes(jmesh)
        assert rec["model_axes"] == jm.model_axes(jmesh)
        for axes, line in rec["lines"].items():
            want_axes = jm.data_axes(jmesh) if axes == "data_axes" \
                else (axes,)
            live = tuple(a for a in want_axes if jmesh.shape[a] > 1)
            assert line == _jax_line(grid, jmesh.axis_names, rank, live)
        assert rec["group"] == rec["lines"]["data_axes"]


def test_mesh_refuses_what_jax_refuses():
    from horovod_tpu.parallel import mesh as jm
    import jax
    for fn, kw in ((jm.build_3d_mesh, dict(data=4, model=4)),
                   (jm.build_parallel_mesh, dict(dp=3))):
        with pytest.raises(ValueError):
            fn(jax.devices()[:8], **kw)
    thvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="!= 1 devices"):
            tpar.build_3d_mesh(data=2)
        with pytest.raises(ValueError, match="!= 1 devices"):
            tpar.build_parallel_mesh(dp=3)
        mesh = tpar.build_3d_mesh()
        assert mesh.group("model").ranks == (0,)     # a dropped axis
        with pytest.raises(ValueError, match="unknown mesh axis"):
            mesh.group("modle")
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def _jax_tp(world):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import (column_parallel, copy_to_tp,
                                      row_parallel, tp_mlp)
    x, wg, wu, wd = (np.asarray(a) for a in _tp_inputs())
    mesh = _mesh_1d("tp", world)
    specs = (P(), P(None, "tp"), P(None, "tp"), P("tp", None))

    def pair(x, u, d):
        return row_parallel(jax.nn.relu(column_parallel(copy_to_tp(x), u)),
                            d)

    def pair_grads(x, u, d):
        y, vjp = jax.vjp(pair, x, u, d)
        return (y,) + vjp(jax.numpy.ones_like(y))

    def mlp(x, g, u, d):
        return jax.value_and_grad(
            lambda x, g, u, d: tp_mlp(x, u, d, w_gate=g).sum(),
            argnums=(0, 1, 2, 3))(x, g, u, d)

    got_pair = jax.jit(jax.shard_map(
        pair_grads, mesh=mesh, in_specs=(P(), specs[2], specs[3]),
        out_specs=(P(), P(), specs[2], specs[3]), check_vma=False))(
            x, wu, wd)
    loss, grads = jax.jit(jax.shard_map(
        mlp, mesh=mesh, in_specs=specs,
        out_specs=(P(), specs), check_vma=False))(x, wg, wu, wd)
    return ([np.asarray(a) for a in got_pair],
            (np.asarray(loss), [np.asarray(g) for g in grads]))


@pytest.mark.parametrize("world", WORLDS)
def test_column_row_pair_and_tp_mlp_match_jax(worlds, world):
    ranks = [r["tp"] for r in worlds[world]]
    pair, (loss, grads) = _jax_tp(world)
    for r in ranks:
        _close(r["pair"][0], pair[0], what="pair y")
        _close(r["pair"][1], pair[1], what="pair dx")
        _close(r["mlp"][0], loss, what="mlp loss")
        _close(r["mlp"][1], grads[0], what="mlp dx")
    _close(_cat([r["pair"][2] for r in ranks], 1), pair[2], what="pair du")
    _close(_cat([r["pair"][3] for r in ranks], 0), pair[3], what="pair dd")
    for j, dim in ((2, 1), (3, 1), (4, 0)):
        _close(_cat([r["mlp"][j] for r in ranks], dim), grads[j - 1],
               what=f"mlp grad {j}")


@pytest.mark.parametrize("world", WORLDS)
def test_tp_trap_is_pinned(worlds, world):
    """Without ``copy_to_tp`` each rank's input gradient is a partial
    whose sum over the ranks is the full one; a closing allreduce that
    allreduces its gradient multiplies every kernel gradient by tp."""
    ranks = [r["tp"] for r in worlds[world]]
    full = ranks[0]["mlp"][1].numpy()
    partial = [r["no_f"].numpy() for r in ranks]
    _close(sum(partial), full, what="partials sum")
    for p in partial:
        assert np.abs(p - full).max() > 1e-2 * np.abs(full).max()
    for r in ranks:
        for got, want in zip(r["g_twice"], (r["mlp"][3], r["mlp"][4])):
            _close(got, world * want, what="x tp")


@pytest.mark.parametrize("world", WORLDS)
def test_ppermute_and_alltoall_axes_match_jax(worlds, world):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.collectives import ops as jops
    mesh = _mesh_1d("tp", world)
    ring = [(i, (i + 1) % world) for i in range(world)]
    a = np.stack([np.arange(6.0, dtype=np.float32).reshape(2, 3) + 10 * r
                  for r in range(world)])
    b = np.stack([np.arange(2.0 * 4 * world * 3, dtype=np.float32)
                  .reshape(2, 4 * world, 3) + 1000 * r
                  for r in range(world)])

    def f(a, b):
        a, b = a[0], b[0]
        return (jops.ppermute(a, ring, axes="tp")[None],
                jops.ppermute(a, [(0, world - 1)], axes="tp")[None],
                jops.alltoall(b, axes="tp", split_axis=1,
                              concat_axis=2)[None])

    want = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("tp"), P("tp")),
                                 out_specs=(P("tp"),) * 3,
                                 check_vma=False))(a, b)
    for r, res in enumerate(worlds[world]):
        for key, w in zip(("ppermute", "ppermute_partial", "alltoall"),
                          want):
            np.testing.assert_array_equal(res["tp"][key].numpy(),
                                          np.asarray(w)[r])


def test_tp_param_specs_and_shards_match_jax(flax_bert, port_params):
    from horovod_tpu.parallel import shard_tp_params as jshard
    from horovod_tpu.parallel import tp_param_specs as jspecs
    import jax
    _, variables = flax_bert
    jspec = jspecs(variables, axis="model")
    flat = {".".join(k.key for k in path[1:]): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                jspec, is_leaf=lambda s: not isinstance(s, dict))}
    got = tpar.tp_param_specs(port_params, axis="model")
    assert got == flat
    assert got["layer_0.wq.bias"] == ("model",)
    assert got["layer_0.wo.kernel"] == ("model", None)
    for size in (2, 4):
        for rank in range(size):
            want = jshard(variables, rank, size)["params"]
            shards = tpar.shard_tp_params(port_params, rank, size)
            for name, t in shards.items():
                leaf = want
                for part in name.split("."):
                    leaf = leaf[part]
                np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
            local = tpar.shard_params(port_params, got, rank, size)
            for name, t in local.items():
                spec = got[name]
                d = [i for i, a in enumerate(spec) if a is not None]
                want_t = port_params[name].numpy()
                if d:
                    want_t = _cut(want_t, rank, size, d[0])
                np.testing.assert_array_equal(t.numpy(), want_t)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_tp_params_inverts_shard_params(worlds, port_params, world):
    for res in worlds[world]:
        got = res["bert"]["gathered"]
        assert list(got) == list(port_params)
        for name, t in got.items():
            assert torch.equal(t, port_params[name]), name


# ---------------------------------------------------------------------------
# BERT under tensor parallelism and the 3-D step
# ---------------------------------------------------------------------------


def _jax_bert_tp(variables, world):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.models.transformer import bert_tp_apply as jbert_tp
    from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
    from horovod_tpu.parallel import build_3d_mesh, tp_param_specs
    mesh = build_3d_mesh(jax.devices()[:world], data=world // 2, model=2)
    specs = tp_param_specs(variables, axis="model")
    f = jax.shard_map(lambda p, t: jbert_tp(p, J_BERT_TINY, t,
                                            axis="model"),
                      mesh=mesh, in_specs=(specs, P("data")),
                      out_specs=(P("data"), P("data")), check_vma=False)
    mlm, nsp = jax.jit(f)(variables, _bert_batch()[0])
    return np.asarray(mlm), np.asarray(nsp)


@pytest.mark.parametrize("world", WORLDS)
def test_bert_tp_apply_matches_jax_and_bert(worlds, flax_bert, port_params,
                                            world):
    from horovod_tpu_torch.models import Bert
    _, variables = flax_bert
    mlm, nsp = _jax_bert_tp(variables, world)
    with torch.no_grad():
        ref = Bert.from_params(BERT_TINY, port_params)(_t(_bert_batch()[0]))
    data = world // 2
    for rank, res in enumerate(worlds[world]):
        got = res["bert"]["forward"]
        d = rank // 2                        # the (data, model) grid
        rows = slice(d * 8 // data, (d + 1) * 8 // data)
        _close(got[0], mlm[rows], what="mlm vs jax")
        _close(got[1], nsp[rows], what="nsp vs jax")
        _close(got[0], ref[0][rows].numpy(), rel=BERT_REL, what="mlm")
        _close(got[1], ref[1][rows].numpy(), rel=BERT_REL, what="nsp")


def _jax_3d_sgd(variables):
    import jax
    import optax
    import horovod_tpu as hvd
    from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
    from horovod_tpu.models.transformer import bert_tp_apply as jbert_tp
    from horovod_tpu.parallel import build_3d_mesh, data_axes, tp_param_specs
    hvd.shutdown()
    hvd.init(mesh=build_3d_mesh(jax.devices()[:4], data=2, model=2))
    try:
        mesh = hvd.mesh()
        specs = tp_param_specs(variables, axis="model")

        def loss_fn(p, b):
            toks, y = b
            mlm, nsp = jbert_tp(p, J_BERT_TINY, toks, axis="model")
            return (optax.softmax_cross_entropy_with_integer_labels(
                mlm, toks).mean()
                + optax.softmax_cross_entropy_with_integer_labels(
                    nsp, y).mean())

        opt = hvd.DistributedOptimizer(optax.sgd(SGD_LR),
                                       compression=hvd.Compression.none,
                                       axes=data_axes(mesh))
        step = hvd.make_train_step(
            loss_fn, opt, mesh=mesh, tp=2, param_specs=specs,
            opt_state_specs=hvd.mirror_opt_state_specs(opt, variables,
                                                       specs))
        p = jax.tree.map(np.array, variables)
        st = opt.init(p)
        batch = hvd.shard_batch(_bert_batch())
        losses = []
        for _ in range(SGD_STEPS):
            p, st, loss = step(p, st, batch)
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, p)
    finally:
        hvd.shutdown()


def _param_close(got, want, name, rel=REL):
    """Within ``rel`` of the leaf's max; ``wk.bias`` (zero gradient in
    exact arithmetic: roundoff in both packages) at its layer's
    ``wk.kernel`` scale."""
    scale_of = name[:-len("bias")] + "kernel" if name.endswith(".wk.bias") \
        else name
    scale = max(float(np.abs(want[scale_of]).max()), 1e-30)
    err = float(np.abs(np.asarray(got[name]) - want[name]).max())
    assert err <= rel * scale, (name, err, scale)


def test_3d_sgd_steps_match_jax(worlds, flax_bert):
    from horovod_tpu_torch.models import params_from_jax
    losses, p = _jax_3d_sgd(flax_bert[1])
    want = {k: v.numpy() for k, v in
            params_from_jax(p, device="cpu").items()}
    for res in worlds[4]:
        got_losses, got = res["bert"]["sgd"]
        np.testing.assert_allclose(got_losses, losses, rtol=REL)
        assert set(got) == set(want)
        for name in want:
            _param_close({k: v.numpy() for k, v in got.items()}, want, name)


def test_3d_adamw_trajectory_matches_pure_dp(worlds):
    for res in worlds[4]:
        td, dp = res["bert"]["adamw_3d"], res["bert"]["adamw_dp"]
        assert td[-1] < td[0]
        np.testing.assert_allclose(td, dp, rtol=TRAJ_TOL, atol=TRAJ_TOL)


@pytest.mark.parametrize("variant", ["zero", "micro"])
def test_3d_zero_and_microbatches_match_the_plain_step(worlds, variant):
    """ZeRO-1 (the arena sharded over the data set) and
    ``microbatches=2`` (the overlap exchange over the data set) against
    the plain 3-D step's two SGD steps."""
    for res in worlds[4]:
        losses, got = res["bert"][variant]
        want_losses, want = res["bert"]["plain2"]
        np.testing.assert_allclose(losses, want_losses, rtol=REL)
        want = {k: v.numpy() for k, v in want.items()}
        for name in want:
            _param_close({k: v.numpy() for k, v in got.items()}, want, name)


def test_3d_step_refusals_match_jax(worlds):
    import horovod_tpu.training as jtraining
    for res in worlds[4]:
        ref = res["bert"]["refusals"]
        assert ref["ef"][0] == "NotImplementedError"
        assert ref["world"][0] == "ValueError"
        assert "data axes" in ref["world"][1]
    # The EF refusal's first sentence is the JAX package's.
    import optax
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init()
    try:
        opt = hvd.DistributedOptimizer(optax.sgd(0.1),
                                       compression="powersgd:2")
        with pytest.raises(NotImplementedError) as e:
            jtraining._check_model_parallel_exchange(opt, ("data",),
                                                     ("model",))
        got = worlds[4][0]["bert"]["refusals"]["ef"][1]
        assert got.split(".")[0] == str(e.value).split(".")[0]
    finally:
        hvd.shutdown()


def test_3d_step_needs_a_mesh_for_tp():
    from horovod_tpu_torch.training import make_train_step
    thvd.init(device="cpu")
    try:
        model = torch.nn.Linear(2, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        with pytest.raises(ValueError, match="need a mesh"):
            make_train_step(model, lambda m, b: m(b).sum(), opt, tp=2)
        tpar.build_3d_mesh()
        with pytest.raises(ValueError, match="'model' axis of extent 2"):
            make_train_step(model, lambda m, b: m(b).sum(), opt, tp=2)
    finally:
        thvd.shutdown()


def test_mirror_opt_state_specs_and_batch_sharding(port_params):
    """At world 1 on ``build_3d_mesh()``: AdamW's moments take their
    parameter's spec and its step count ``()``, as the JAX
    ``mirror_opt_state_specs`` places them; the batch is this rank's
    whole (one data shard)."""
    from horovod_tpu_torch.models import BertTP
    from horovod_tpu_torch.training import (batch_sharding,
                                            make_train_step,
                                            mirror_opt_state_specs,
                                            shard_batch)
    thvd.init(device="cpu")
    try:
        tpar.build_3d_mesh()
        specs = tpar.tp_param_specs(port_params, axis="model")
        model = BertTP(BERT_TINY, {k: v.clone() for k, v in
                                   port_params.items()})
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        step = make_train_step(model, _bert_loss, opt, tp=1,
                               param_specs=specs)
        assert step.param_specs is specs and step.tp == 1
        assert step.data_set.ranks == (0,)
        batch = tuple(_t(a) for a in _bert_batch())
        assert batch_sharding() == (0, 1)
        assert all(torch.equal(a, b) for a, b in
                   zip(shard_batch(batch), batch))
        step(batch)
        got = mirror_opt_state_specs(opt, model, specs)
        assert set(got) == set(specs)
        for name, entry in got.items():
            assert entry == {"step": (), "exp_avg": specs[name],
                             "exp_avg_sq": specs[name]}
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------

SEQ_IDS = [(w, mode, name) for w in WORLDS for mode in ("ring", "ulysses")
           for name in RING]


def _jax_attention(mode, world, causal, use_seg):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import ring_attention, ulysses_attention
    fn = ring_attention if mode == "ring" else ulysses_attention
    q, k, v, seg = _attn_inputs(2 if mode == "ring" else 8)
    mesh = _mesh_1d("sp", world)
    spec = P(None, None, "sp")
    sm = jax.shard_map(
        lambda q, k, v, s: fn(q, k, v, causal=causal,
                              segment_ids=s if use_seg else None),
        mesh=mesh, in_specs=(spec,) * 3 + (P(None, "sp"),),
        out_specs=spec, check_vma=False)

    def run(q, k, v, s):
        out, vjp = jax.vjp(lambda q, k, v: sm(q, k, v, s), q, k, v)
        return (out,) + vjp(jnp.ones_like(out))

    return [np.asarray(a) for a in jax.jit(run)(q, k, v, seg)]


@pytest.mark.parametrize("world,mode,name", SEQ_IDS,
                         ids=[f"w{w}-{m}-{n}" for w, m, n in SEQ_IDS])
def test_sequence_parallel_attention_matches_jax(worlds, world, mode, name):
    causal, use_seg = RING[name]
    want = _jax_attention(mode, world, causal, use_seg)
    ranks = [r["seq"][mode, name] for r in worlds[world]]
    for j, what in enumerate(("out", "dq", "dk", "dv")):
        _close(_cat([r[j] for r in ranks], 2), want[j], what=what)


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_the_sequential_model(worlds, world):
    ws, batch = _stage_inputs(world)
    params = [{"w": _t(w, True), "b": torch.zeros(16, requires_grad=True)}
              for w in ws]
    x = _t(batch)
    for p in params:
        x = _stage_fn(p, x)
    (x ** 2).sum().backward()
    for r, res in enumerate(worlds[world]):
        y, dw, db = res["pipe"]["apply"]
        _close(y.reshape(-1, 16), x.detach().numpy(), what="outputs")
        _close(dw, params[r]["w"].grad.numpy(), what=f"stage {r} dw")
        _close(db, params[r]["b"].grad.numpy(), what=f"stage {r} db")


def _jax_pipeline(world):
    """The JAX ``pipeline_apply`` under ``shard_map`` on ``world`` CPU
    devices, on ``_pipe_rank``'s stages and microbatches: the outputs
    and the stacked per-stage gradients of ``sum(y ** 2)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import (pipeline_apply, split_microbatches,
                                      stack_stage_params)
    ws, batch = _stage_inputs(world)
    stacked = stack_stage_params([{"w": jnp.asarray(w),
                                   "b": jnp.zeros(16, jnp.float32)}
                                  for w in ws])
    micro = split_microbatches(jnp.asarray(batch), 8)
    fwd = jax.shard_map(
        lambda p, xs: pipeline_apply(
            lambda q, x: jnp.tanh(x @ q["w"] + q["b"]), p, xs),
        mesh=_mesh_1d("pp", world), in_specs=(P("pp"), P()), out_specs=P(),
        check_vma=False)

    def loss(p):
        y = fwd(p, micro)
        return (y ** 2).sum(), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_jax(worlds, world):
    """Each rank's outputs and its stage's gradients against the JAX
    ``pipeline_apply`` on the same stages and microbatches."""
    y_want, g_want = _jax_pipeline(world)
    for r, res in enumerate(worlds[world]):
        y, dw, db = res["pipe"]["apply"]
        _close(y, y_want, what=f"rank {r} outputs")
        _close(dw, g_want["w"][r], what=f"stage {r} dw")
        _close(db, g_want["b"][r], what=f"stage {r} db")


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_trains(worlds, world):
    for res in worlds[world]:
        losses = res["pipe"]["train"]
        assert losses[-1] < 0.5 * losses[0], losses
        assert losses == worlds[world][0]["pipe"]["train"]


def test_pipeline_helpers_match_jax():
    from horovod_tpu.parallel import split_microbatches as jsplit
    from horovod_tpu.parallel import stack_stage_params as jstack
    ws, batch = _stage_inputs(2)
    per = [{"w": w, "b": np.zeros(16, np.float32)} for w in ws]
    got = tpar.stack_stage_params([{k: _t(v) for k, v in p.items()}
                                   for p in per])
    want = jstack(per)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        tpar.split_microbatches(_t(batch), 4).numpy(),
        np.asarray(jsplit(batch, 4)))
    with pytest.raises(ValueError):
        tpar.split_microbatches(_t(batch), 5)


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

MOE_IDS = [(w, n) for w in WORLDS for n in MOE]


def _jax_moe(name, world):
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.parallel import moe_ffn
    cap, top_k, codec, _, _ = MOE[name]
    x, router, w_up, w_down = _moe_inputs(name)
    mesh = _mesh_1d("ep", world)
    y, aux = jax.jit(jax.shard_map(
        lambda x, r, wu, wd: moe_ffn(x, r, wu, wd, capacity_factor=cap,
                                     top_k=top_k, compression=codec),
        mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P()), check_vma=False))(x, router, w_up, w_down)
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("world,name", MOE_IDS,
                         ids=[f"w{w}-{n}" for w, n in MOE_IDS])
def test_moe_matches_jax(worlds, world, name):
    import jax
    codec = MOE[name][2]
    y, aux = _jax_moe(name, world)
    got = _cat([r["moe"][name][0] for r in worlds[world]])
    _close(got, y, rel=CODEC_REL[codec], what="y")
    # JAX returns device 0's aux loss (each rank's is its own tokens').
    _close(worlds[world][0]["moe"][name][1], aux, what="aux")
    if name == "identical":
        x, router, w_up, w_down = _moe_inputs(name)
        probs = np.asarray(jax.nn.softmax(x @ router, axis=-1))
        dense = np.asarray(jax.nn.gelu(x @ w_up[0])) @ w_down[0]
        _close(got, dense * probs.max(-1, keepdims=True), rel=2e-5,
               what="dense")
    if name == "drops":
        norms = np.linalg.norm(got, axis=-1)
        assert np.isfinite(got).all()
        assert (norms > 0).sum() > 0 and (norms == 0).sum() > 0


@pytest.mark.parametrize("codec", ["none", "bf16", "fp16"])
def test_plan_moe_alltoall_matches_jax(codec):
    from horovod_tpu.controller import fusion as jfusion
    from horovod_tpu_torch.controller import fusion as tfusion
    fields = ("tag", "axis", "collective", "codec", "wire_dtype",
              "elements", "nbytes", "kind", "audit")
    for e, c, d in ((8, 4, 16), (64, 160, 4096)):
        got = tfusion.plan_moe_alltoall(e, c, d, compression=codec,
                                        axis="ep")
        want = jfusion.plan_moe_alltoall(e, c, d, compression=codec,
                                         axis="ep")
        assert [tuple(getattr(g, f) for f in fields) for g in got] == \
            [tuple(getattr(w, f) for f in fields) for w in want]
    moe = dict(n_experts=8, capacity=4, d_model=16, layers=3,
               compression=codec)
    leaves = [torch.zeros(10, 3), torch.zeros(7)]
    jrow = jfusion.explain_plan([np.zeros((10, 3), np.float32),
                                 np.zeros(7, np.float32)], register=False,
                                moe=moe)[-1]
    trow = tfusion.explain_plan(leaves, register=False, moe=moe)[-1]
    for key in ("dtype", "leaves", "elements", "bytes", "wire_bytes",
                "codec", "fuse_key"):
        assert trow[key] == jrow[key], key
    assert [{f: leg[f] for f in fields if f != "audit"}
            for leg in trow["legs"]] == \
        [{f: leg[f] for f in fields if f != "audit"} for leg in jrow["legs"]]


def test_moe_compression_resolves_as_jax(monkeypatch):
    from horovod_tpu.parallel import resolve_moe_compression as jresolve
    for name in (None, "none", "bf16", "FP16"):
        assert tpar.resolve_moe_compression(name) == jresolve(name)
    with pytest.raises(ValueError):
        tpar.resolve_moe_compression("fp8")
    monkeypatch.setenv("HOROVOD_MOE_COMPRESSION", "bf16")
    thvd.init(device="cpu")
    try:
        assert tpar.resolve_moe_compression() == "bf16"
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# sync_batch_norm over a sub-mesh
# ---------------------------------------------------------------------------


def _jax_sub_mesh_bn(xs, dys):
    """The JAX ``sync_batch_norm(axes=("data",))`` under ``shard_map`` on
    a (data 2, model 2) mesh of four devices: y, dx, batch_stats."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import horovod_tpu as hvd
    from horovod_tpu.parallel import build_3d_mesh
    mesh = build_3d_mesh(jax.devices()[:4], data=2, model=2)
    hvd.shutdown()
    hvd.init(mesh=mesh)
    try:
        class Sync(fnn.Module):
            @fnn.compact
            def __call__(self, a):
                return hvd.sync_batch_norm(
                    axes=("data",), use_running_average=False, momentum=0.9,
                    epsilon=1e-5)(a)

        model = Sync()
        params = {"BatchNorm_0": {k: BN_PARAMS[k] for k in ("scale", "bias")}}
        stats = {"BatchNorm_0": {k: BN_PARAMS[k] for k in ("mean", "var")}}

        def body(xs, dys):
            def f(a):
                return model.apply({"params": params, "batch_stats": stats},
                                   a[0], mutable=["batch_stats"])
            y, vjp, mut = jax.vjp(f, xs, has_aux=True)
            (dx,) = vjp(dys[0])
            st = mut["batch_stats"]["BatchNorm_0"]
            return y[None], dx, st["mean"][None], st["var"][None]

        spec = P(("data", "model"))
        run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                    out_specs=(spec,) * 4, check_vma=False))
        return [np.asarray(a) for a in run(jnp.asarray(xs),
                                           jnp.asarray(dys))]
    finally:
        hvd.shutdown()


def test_sync_batch_norm_over_a_sub_mesh(worlds):
    from horovod_tpu_torch.ops import bn as tbn
    ins = [_bn_inputs(r) for r in range(4)]
    xs = np.stack([a for a, _ in ins])
    dys = np.stack([b for _, b in ins])
    jy, jdx, jmean, jvar = _jax_sub_mesh_bn(xs, dys)
    for rank, res in enumerate(worlds[4]):
        got = res["bn"]
        pair = (rank % 2, 2 + rank % 2)          # the rank's data set
        m = tbn.BatchNorm(16, momentum=0.9, epsilon=1e-5, device="cpu")
        m.load_state_dict({k: _t(v) for k, v in BN_PARAMS.items()})
        xt = _t(np.concatenate([xs[r] for r in pair]), True)
        y = m(xt)
        y.backward(_t(np.concatenate([dys[r] for r in pair])))
        me = slice(0, 2) if rank < 2 else slice(2, 4)
        _close(got[0], y.detach()[me].numpy(), what="y")
        _close(got[1], xt.grad[me].numpy(), what="dx")
        _close(got[4], m.mean.numpy(), what="mean")
        _close(got[5], m.var.numpy(), what="var")
        _close(got[0], jy[rank], what="y (JAX)")
        _close(got[1], jdx[rank], what="dx (JAX)")
        _close(got[4], jmean[rank], what="mean (JAX)")
        _close(got[5], jvar[rank], what="var (JAX)")
    # The two members' local parameter sums add up to the plain layer's.
    for pair in ((0, 2), (1, 3)):
        m = tbn.BatchNorm(16, momentum=0.9, epsilon=1e-5, device="cpu")
        m.load_state_dict({k: _t(v) for k, v in BN_PARAMS.items()})
        xt = _t(np.concatenate([xs[r] for r in pair]))
        m(xt).backward(_t(np.concatenate([dys[r] for r in pair])))
        _close(sum(worlds[4][r]["bn"][2] for r in pair),
               m.scale.grad.numpy(), what="dscale")
        _close(sum(worlds[4][r]["bn"][3] for r in pair),
               m.bias.grad.numpy(), what="dbias")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])


# ---------------------------------------------------------------------------
# The two-level DP leg (dcn_size=2)
# ---------------------------------------------------------------------------


def test_dcn_data_set_pair_is_the_mesh_lines(worlds):
    """A mesh whose data axes are ``(dcn, inner)`` gives its data set the
    pair: ``n_dcn x n_ici`` and this rank's lines along each (the JAX
    mesh's, as ``test_meshes_match_jax`` holds the lines); every other
    mesh's data set is one level."""
    for world, records in worlds.items():
        for r, res in enumerate(records):
            for (kind, ext), rec in zip(MESHES[world], res["meshes"]):
                d_ax = rec["data_axes"]
                if len(d_ax) != 2:
                    assert rec["hier"] is None, (kind, ext)
                    continue
                assert d_ax[0] == "dcn"
                shape = rec["shape"]
                assert rec["hier"] == (
                    shape["dcn"], shape[d_ax[1]], rec["lines"][d_ax[1]],
                    rec["lines"]["dcn"]), (kind, ext, r)


def _jax_local(variables, specs, pos):
    """The JAX 3-D step's local tree at ``model`` index ``pos`` (what
    ``shard_map`` hands a device: each split leaf's block)."""
    import jax

    def cut(leaf, spec):
        d = [i for i, a in enumerate(spec) if a is not None]
        return _cut(np.asarray(leaf), pos, 2, d[0]) if d else \
            np.asarray(leaf)
    return jax.tree.map(cut, variables, specs,
                        is_leaf=lambda x: not isinstance(x, dict))


def _jax_dcn(variables, mesh_kw, comp, hier, zero=False):
    """The JAX 3-D step on the same 4-device mesh: ``(losses, tree,
    zero rows)`` (the ZeRO-1 momentum, one row a device)."""
    import dataclasses
    import jax
    import optax
    import horovod_tpu as hvd
    from horovod_tpu.core.state import global_state as j_state
    from horovod_tpu.models.transformer import BERT_TINY as J_BERT_TINY
    from horovod_tpu.models.transformer import Bert as JBert
    from horovod_tpu.models.transformer import bert_tp_apply as jbert_tp
    from horovod_tpu.parallel import build_3d_mesh, data_axes, tp_param_specs
    hvd.shutdown()
    hvd.init(mesh=build_3d_mesh(jax.devices()[:4], **mesh_kw))
    st = j_state()
    st.config = dataclasses.replace(st.config, hierarchical_allreduce=hier)
    try:
        mesh = hvd.mesh()
        tp = int(mesh.shape.get("model", 1))
        specs = tp_param_specs(variables, axis="model") if tp > 1 else None
        import jax.numpy as jnp
        model = JBert(J_BERT_TINY, dtype=jnp.float32)

        def loss_fn(p, b):
            toks, y = b
            if tp > 1:
                mlm, nsp = jbert_tp(p, J_BERT_TINY, toks, axis="model")
            else:
                mlm, nsp = model.apply(p, toks)
            return (optax.softmax_cross_entropy_with_integer_labels(
                mlm, toks).mean()
                + optax.softmax_cross_entropy_with_integer_labels(
                    nsp, y).mean())

        p = jax.tree.map(np.array, variables)
        if zero:
            opt = optax.sgd(SGD_LR, momentum=DCN_MOMENTUM)
            step = hvd.make_train_step(loss_fn, opt, mesh=mesh, tp=tp,
                                       param_specs=specs, zero_stage=1,
                                       zero_compression=comp)
            state = hvd.zero_init(opt, p, mesh, compression=comp,
                                  param_specs=specs)
        else:
            opt = hvd.DistributedOptimizer(optax.sgd(SGD_LR),
                                           compression=comp,
                                           axes=data_axes(mesh))
            kw = {}
            if tp > 1:
                kw = dict(param_specs=specs,
                          opt_state_specs=hvd.mirror_opt_state_specs(
                              opt, variables, specs))
            step = hvd.make_train_step(loss_fn, opt, mesh=mesh, tp=tp,
                                       **kw)
            state = opt.init(p)
        batch = hvd.shard_batch(_bert_batch())
        losses = []
        for _ in range(1 if zero else DCN_STEPS):
            p, state, loss = step(p, state, batch)
            losses.append(float(loss))
        rows = None
        if zero:
            rows = [np.asarray(leaf) for leaf in jax.tree.leaves(state)]
        return losses, jax.tree.map(np.asarray, p), rows
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("name", sorted(DCN_CASES))
def test_dcn_3d_steps_match_jax(worlds, flax_bert, name):
    """Two SGD steps of the 3-D step on a ``dcn_size=2`` mesh: the
    two-level exchange over the data set, against the JAX step on the
    same mesh, and its bytes by leg against the JAX plan of its
    buckets."""
    from horovod_tpu.controller.fusion import plan_hier_legs as j_legs
    from horovod_tpu_torch.models import params_from_jax
    mesh_kw, comp, hier = DCN_CASES[name]
    losses, p, _ = _jax_dcn(flax_bert[1], mesh_kw, comp, hier)
    want = {k: v.numpy() for k, v in
            params_from_jax(p, device="cpu").items()}
    rel = CODEC_REL["fp16"] if "fp16" in comp else REL
    n_dcn, n_ici = 2, mesh_kw.get("data", 1)
    for res in worlds[4]:
        got = res["dcn"][name]
        assert got["set_pair"] == (n_dcn, n_ici)
        np.testing.assert_allclose(got["losses"], losses, rtol=rel)
        assert set(got["full"]) == set(want)
        for leaf in want:
            _param_close({k: v.numpy() for k, v in got["full"].items()},
                         want, leaf, rel=rel)
        plan = {k: 0 for k in HIER_LEGS}
        for dtype, size in got["buckets"]:
            for leg in j_legs(size, dtype, n_dcn=n_dcn, n_ici=n_ici,
                              compression=comp if "dcn" in comp else None):
                plan[leg.tag] += leg.nbytes * DCN_STEPS
        assert got["legs"] == plan and plan["hier/dcn_ar"] > 0, name


@pytest.mark.parametrize("name", sorted(DCN_ZERO))
def test_dcn_zero_init_param_specs_matches_jax(worlds, flax_bert, name):
    """``zero_init(mesh=, param_specs=)`` (through the 3-D step's ZeRO-1)
    on ``data=2, dcn_size=2`` and ``model=2, dcn_size=2`` under the
    per-leg codec: rank ``r``'s arena shard is the JAX arena's at index
    ``ici * n_dcn + dcn`` of its data set (the ``(ici, dcn)``-major
    bijection), its momentum after one ZeRO-1 step the JAX state's row of
    device ``r``, and the parameters the JAX step's."""
    import jax
    from horovod_tpu.optim.zero import arena_pack, plan_arena
    from horovod_tpu.parallel import tp_param_specs as jspecs
    from horovod_tpu_torch.models import params_from_jax
    mesh_kw, comp = DCN_ZERO[name]
    variables = flax_bert[1]
    losses, p, rows = _jax_dcn(variables, mesh_kw, comp, False, zero=True)
    want = {k: v.numpy() for k, v in
            params_from_jax(p, device="cpu").items()}
    specs = jspecs(variables, axis="model")
    n_dcn, n_ici = 2, mesh_kw.get("data", 1)
    for r, res in enumerate(worlds[4]):
        got = res["dcn"][name]
        dcn, inner = divmod(r, 2)          # mesh (dcn, data|model)
        if "model" in mesh_kw:
            ici = 0
            local = jax.tree.leaves(_jax_local(variables, specs, inner))
        else:
            ici = inner
            local = jax.tree.leaves(variables)
        spec = plan_arena(local, n_dcn * n_ici)
        idx = ici * n_dcn + dcn
        for arena, buf, shard in zip(arena_pack(local, spec), spec.buffers,
                                     got["shards0"]):
            np.testing.assert_array_equal(
                shard.numpy(),
                np.asarray(arena)[idx * buf.shard:(idx + 1) * buf.shard])
        for row, mom in zip(rows, got["momentum"]):
            _close(mom, row[r], what=f"momentum r{r}")
        np.testing.assert_allclose(got["losses"], losses, rtol=REL)
        for leaf in want:
            _param_close({k: v.numpy() for k, v in got["full"].items()},
                         want, leaf, rel=CODEC_REL["fp16"])


def test_dcn_user_set_per_leg_refusal_matches_jax(worlds):
    """A user's process set stays one level: a per-leg error-feedback
    codec on it is refused, as the JAX ``DistributedOptimizer`` refuses
    it (its first sentence)."""
    import optax
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init()
    try:
        with pytest.raises(NotImplementedError) as e:
            hvd.DistributedOptimizer(optax.sgd(0.1),
                                     compression="ici:none,dcn:topk:0.5",
                                     process_set=hvd.add_process_set(
                                         [0, 1, 2, 3]))
    finally:
        hvd.shutdown()
    for res in worlds[4]:
        kind, msg = res["dcn"]["refusal"]
        assert kind == "NotImplementedError"
        assert "process-set reductions" in msg and \
            "process-set reductions" in str(e.value)
