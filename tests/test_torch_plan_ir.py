"""PyTorch/CUDA port: the exchange-plan IR (``controller/fusion.py``)
against the JAX package's.

In one process:

* every family in scope (``flat``, ``hier``, ``chunked``, ``powersgd``,
  ``topk``, ``fp8``, ``ef``, ``zero``, ``microbatch``, ``kernel``): the
  port's rows equal ``horovod_tpu.controller.fusion.plan_exchange``'s
  field by field but ``fence`` (not ported: ``""``), over f32 / bf16 /
  f16 (and int32), sizes that do and do not divide, worlds 1, 2, 4, 8
  and 256, and the codecs none, fp16, bf16, fp8, topk:0.01, powersgd:4
  and ``ici:none,dcn:fp8``;
* the memo: the same spec gives the same object, counted as a hit;
* ``schedule_legs``, ``overlap_phases`` and ``simulate_issue`` equal to
  the JAX ones on the same legs with V5E's two link rates handed to both;
  without ``links`` the port prices on ``utils.scaling.H100_SXM``'s
  rates, as the JAX ones do on a ``ChipSpec`` of the same figures;
* the registry drill (JAX ``tests/test_plan_ir.py::
  test_new_leg_kind_needs_zero_consumer_code``): a leg kind and a family
  added through the two calls are priced, scheduled and span-recorded
  with no new consumer code;
* ``explain_plan`` rows equal to JAX's for ResNet-50's parameter shapes
  (the port's model on the meta device in flax leaf order, against
  ``jax.eval_shape``).

Gloo worlds of 2 and 4 (this file, run as a script, is each rank):
executed equals planned -- one step's leg registry equals its plan's
rows and the collective counters' bytes equal the collective rows'
``nbytes``, for the flat exchange (none, fp16), chunked, powersgd:2,
topk:0.25, fp8, ZeRO-1 and ``microbatches=2`` at world 2, and the
two-level exchange at world 4 as 2 x 2.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.controller import fusion as tfusion
from horovod_tpu_torch.timeline import metrics as tmetrics
from horovod_tpu_torch.timeline import spans as tspans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_HIERARCHICAL",
                 "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_COMPRESSION",
                 "HOROVOD_EXCHANGE_CHUNK_MB", "HOROVOD_ZERO",
                 "HOROVOD_MICROBATCHES", "HOROVOD_PLAN_CACHE")
SIZES = (1, 300, 4096, 25_557_032)      # 300 divides neither 8 nor 256
DTYPES = ("float32", "bfloat16", "float16")
WORLDS = (1, 2, 4, 8, 256)
CODECS = (None, "none", "fp16", "bf16", "fp8", "topk:0.01", "powersgd:4",
          "ici:none,dcn:fp8")
CAST_CODECS = (None, "none", "fp16", "bf16")
EF_CODECS = ("topk:0.01", "powersgd:4")
THRESHOLD = 64 * 1024 * 1024


def _jfusion():
    from horovod_tpu.controller import fusion
    return fusion


def _jcomp(spec):
    from horovod_tpu.collectives.compression import parse_compression
    return parse_compression(spec) if spec is not None else None


def _rows(legs):
    return [{k: v for k, v in dataclasses.asdict(leg).items()
             if k != "fence"} for leg in legs]


def _both(family, jspec=None, **spec):
    """The port's rows and the JAX package's for one spec (``jspec``
    overrides the JAX side's arguments, e.g. its codec objects)."""
    got = tfusion.plan_exchange(family, **spec).legs
    want = _jfusion().plan_exchange(family, **dict(spec, **(jspec or {})))
    return _rows(got), _rows(want.legs)


def _grid(family):
    """``(port spec, JAX overrides)`` pairs of one family's grid."""
    if family == "flat":
        for size in SIZES:
            for dt in DTYPES + ("int32",):
                for c in CAST_CODECS:
                    yield dict(size=size, dtype=dt, compression=c), \
                        dict(compression=_jcomp(c))
    elif family == "hier":
        for size in SIZES:
            for dt in DTYPES + ("int32",):
                for n_dcn, n_ici in ((1, 4), (2, 1), (2, 2), (4, 2),
                                     (64, 4)):
                    for c in CAST_CODECS + ("ici:none,dcn:fp8",
                                            "ici:bf16,dcn:topk:0.01",
                                            "ici:none,dcn:powersgd:4"):
                        yield dict(size=size, dtype=dt, n_dcn=n_dcn,
                                   n_ici=n_ici, compression=c), \
                            dict(compression=_jcomp(c))
    elif family == "chunked":
        for size in SIZES[:3]:
            for dt in DTYPES:
                for chunk in (100, 1024, 1 << 20):
                    for world in WORLDS:
                        for c in CAST_CODECS:
                            yield dict(size=size, dtype=dt, chunk_bytes=chunk,
                                       world=world, compression=c), \
                                dict(compression=_jcomp(c))
    elif family == "powersgd":
        for size in SIZES:
            for rank in (1, 4):
                yield dict(size=size, rank=rank), None
    elif family == "topk":
        for size in SIZES:
            for fraction in (0.01, 0.25):
                yield dict(size=size, fraction=fraction), None
    elif family == "fp8":
        for size in SIZES:
            for world in WORLDS:
                yield dict(size=size, world=world), None
    elif family == "ef":
        for size in SIZES:
            for dt in DTYPES + ("int32",):
                for c in EF_CODECS:
                    yield dict(size=size, dtype=dt, compression=c), \
                        dict(compression=_jcomp(c))
    elif family == "zero":
        for world in WORLDS:
            bufs = tuple((dt, size, -(-size // world) * world,
                          -(-size // world))
                         for dt, size in (("float32", 300), ("bfloat16", 4096),
                                          ("float16", 0), ("int32", 7)))
            for c in CODECS:
                for two in ((None, ()), ((2, world // 2), ("dcn", "ici"))):
                    if two[0] is not None and world < 2:
                        continue
                    for use_rs in (True, False):
                        yield dict(buffers=bufs, world=world, compression=c,
                                   axes_shape=two[0], axes=two[1],
                                   use_rs=use_rs), \
                            dict(compression=_jcomp(c))
    elif family == "microbatch":
        for world in WORLDS:
            for k in (1, 2, 4):
                for c in CAST_CODECS:
                    yield dict(buffers=(("float32", 300), ("bfloat16", 4096),
                                        ("float16", 25_557_032)),
                               k=k, world=world, compression=c), \
                        dict(compression=_jcomp(c))
    elif family == "guard":
        yield {}, None
    elif family == "kernel":
        for kernel, nbytes in (("flash_decode", 1 << 20),
                               ("fused_update", 4 * 300)):
            yield dict(kernel=kernel, nbytes=nbytes), None


FAMILIES = ("flat", "hier", "chunked", "powersgd", "topk", "fp8", "ef",
            "zero", "microbatch", "guard", "kernel")


@pytest.mark.parametrize("family", FAMILIES)
def test_family_rows_match_jax(family):
    n = 0
    for spec, jspec in _grid(family):
        got, want = _both(family, jspec, **spec)
        assert got == want, (family, spec)
        n += 1
    assert n > 0


def test_hier_front_end_and_refusals_match_jax():
    for c in ("fp8", "topk:0.5", "powersgd:2"):
        with pytest.raises(ValueError, match="per leg"):
            tfusion.plan_exchange("hier", size=100, dtype="float32",
                                  n_dcn=2, n_ici=2, compression=c)
        with pytest.raises(ValueError):
            _jfusion().plan_exchange("hier", size=100, dtype="float32",
                                     n_dcn=2, n_ici=2,
                                     compression=_jcomp(c))
    assert tfusion.plan_hier_legs(300, torch.bfloat16, n_dcn=2, n_ici=2) \
        == list(tfusion.plan_exchange("hier", size=300, dtype="bfloat16",
                                      n_dcn=2, n_ici=2).legs)
    with pytest.raises(ValueError, match="unknown exchange-plan family"):
        tfusion.plan_exchange("no_such_family", layers=1)


def test_plan_exchange_memoizes_one_object_per_spec(monkeypatch):
    monkeypatch.delenv("HOROVOD_PLAN_CACHE", raising=False)
    tfusion.clear_plan_cache()
    a = tfusion.plan_exchange("flat", size=300, dtype=torch.float32,
                              compression="none")
    before = tfusion.plan_cache_stats()
    b = tfusion.plan_exchange("flat", size=300, dtype="float32")
    after = tfusion.plan_cache_stats()
    assert a is b
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    tmetrics.install_default_metrics()       # init()'s collectors
    snap = tmetrics.registry().snapshot()
    assert snap["horovod_plan_cache_hits_total"]["value"] == after["hits"]
    monkeypatch.setenv("HOROVOD_PLAN_CACHE", "0")
    c = tfusion.plan_exchange("flat", size=300, dtype="float32")
    assert c == a and c is not a


def _links():
    from horovod_tpu.utils.scaling import V5E
    return {"ici": V5E.ici_allreduce_bytes_per_s,
            "dcn": V5E.dcn_allreduce_bytes_per_s}


def _mixed_legs(fusion):
    """A flat leg, two two-level buckets and a chunked leg, the same on
    either side."""
    legs = []
    flat = fusion.plan_exchange("flat", size=64, dtype="float32",
                                compression=None).legs[0]
    legs.append(dataclasses.replace(flat, bucket=7))
    for b, size in enumerate((4096, 25_557_032)):
        legs += [dataclasses.replace(leg, bucket=b) for leg in
                 fusion.plan_exchange("hier", size=size, dtype="float32",
                                      n_dcn=2, n_ici=4, compression=None,
                                      dcn_axis="dcn", ici_axis="ici").legs]
    chunk = fusion.plan_exchange("chunked", size=1 << 20, dtype="float32",
                                 chunk_bytes=1 << 18, world=8,
                                 compression=None).legs[0]
    legs.append(dataclasses.replace(chunk, bucket=9))
    return legs


def _key(legs):
    return [(leg.tag, leg.bucket) for leg in legs]


@pytest.mark.parametrize("mode", ["bandwidth", "program"])
def test_schedule_overlap_and_simulate_match_jax(mode):
    from horovod_tpu.utils.scaling import V5E
    jf = _jfusion()
    tlegs, jlegs = _mixed_legs(tfusion), _mixed_legs(jf)
    assert _rows(tlegs) == _rows(jlegs)
    links = _links()
    got = tfusion.schedule_legs(tlegs, mode=mode, links=links)
    want = jf.schedule_legs(jlegs, mode=mode, chip=V5E)
    assert _key(got) == _key(want)
    for k in (1, 2, 3):
        assert [_key(p) for p in tfusion.overlap_phases(
            tlegs, k, mode=mode, links=links)] == \
            [_key(p) for p in jf.overlap_phases(jlegs, k, mode=mode,
                                                chip=V5E)]
    for t, j in ((tlegs, jlegs), (got, want)):
        assert tfusion.simulate_issue(t, links=links) == \
            jf.simulate_issue(j, chip=V5E)
    assert [tfusion.leg_cost_seconds(leg, links) for leg in tlegs] == \
        [jf.leg_cost_seconds(leg, V5E) for leg in jlegs]
    assert [tfusion.leg_bandwidth(leg) for leg in tlegs] == \
        [jf.leg_bandwidth(leg) for leg in jlegs]


def test_bandwidth_mode_needs_links():
    from horovod_tpu.utils.scaling import ChipSpec

    from horovod_tpu_torch.utils.scaling import H100_SXM
    jf = _jfusion()
    legs, jlegs = _mixed_legs(tfusion), _mixed_legs(jf)
    h100 = H100_SXM.links()
    jchip = ChipSpec(**dataclasses.asdict(H100_SXM))
    # No links: H100_SXM's NVLink and NIC rates, as the JAX functions
    # price them on a ChipSpec of the same figures.
    for port, given, want in (
            (lambda: _key(tfusion.schedule_legs(legs, mode="bandwidth")),
             lambda: _key(tfusion.schedule_legs(legs, mode="bandwidth",
                                                links=h100)),
             lambda: _key(jf.schedule_legs(jlegs, mode="bandwidth",
                                           chip=jchip))),
            (lambda: [_key(p) for p in tfusion.overlap_phases(
                legs, 2, mode="bandwidth")],
             lambda: [_key(p) for p in tfusion.overlap_phases(
                 legs, 2, mode="bandwidth", links=h100)],
             lambda: [_key(p) for p in jf.overlap_phases(
                 jlegs, 2, mode="bandwidth", chip=jchip)]),
            (lambda: tfusion.simulate_issue(legs),
             lambda: tfusion.simulate_issue(legs, links=h100),
             lambda: jf.simulate_issue(jlegs, chip=jchip)),
            (lambda: tfusion.leg_cost_seconds(legs[1]),
             lambda: tfusion.leg_cost_seconds(legs[1], h100),
             lambda: jf.leg_cost_seconds(jlegs[1], jchip))):
        assert port() == given() == want()
    # Program order, the default, prices nothing.
    assert tfusion.schedule_legs(legs) == legs
    assert tfusion.schedule_legs(legs, mode="program") == legs
    with pytest.raises(ValueError, match="schedule mode"):
        tfusion.schedule_legs(legs, mode="fastest", links=_links())
    kernel = tfusion.plan_exchange("kernel", kernel="flash_decode",
                                   nbytes=64).legs[0]
    assert tfusion.leg_cost_seconds(kernel) == 0.0


def _syn_build(spec):
    return [tfusion.ExchangeLeg(
        tag="syn/probe", axis="dcn", collective="psum", codec="none",
        wire_dtype="float32", elements=spec["n"], nbytes=spec["n"] * 4,
        kind="syn_probe",
        audit=(("psum", "float32", spec["n"], "probe"),))]


def test_new_leg_kind_needs_zero_consumer_code():
    tfusion.register_leg_kind("syn_probe", bandwidth="dcn",
                              doc="synthetic drill kind (tests only)")
    tfusion.register_plan_family("syn", _syn_build,
                                 lambda s: {"n": int(s["n"])})
    try:
        plan = tfusion.plan_exchange("syn", n=32)
        leg = plan.legs[0]
        links = _links()
        # Priced and classed from the kind registry alone.
        assert tfusion.leg_bandwidth(leg) == "dcn"
        assert tfusion.leg_cost_seconds(leg, links) > 0.0
        assert tfusion.ops_from_legs(plan.legs) == \
            [("psum", "float32", 32, "syn/probe/probe")]
        # The span registry books the row as it is.
        rec = tspans.recorder()
        rec.reset()
        tspans.note_leg(leg)
        assert rec.leg_registry()["syn/probe"] == {"nbytes": 128,
                                                   "buckets": 1}
        # Memoized like every family.
        before = tfusion.plan_cache_stats()
        assert tfusion.plan_exchange("syn", n=32) is plan
        after = tfusion.plan_cache_stats()
        assert after["hits"] == before["hits"] + 1
        assert after["misses"] == before["misses"]
        # Scheduled ahead of an independent ICI leg.
        ici = dataclasses.replace(tfusion.plan_exchange(
            "flat", size=64, dtype="float32").legs[0], bucket=1)
        assert tfusion.schedule_legs([ici, leg], mode="bandwidth",
                                     links=links)[0] is leg
    finally:
        tfusion.LEG_KINDS.pop("syn_probe", None)
        tfusion._XPLAN_BUILDERS.pop("syn", None)
        tfusion._XPLAN_CANON.pop("syn", None)


@pytest.mark.parametrize("compression", [None, "fp16", "topk:0.01",
                                         "powersgd:4"])
@pytest.mark.parametrize("reverse", [False, True])
def test_explain_plan_rows_match_jax_for_resnet50(compression, reverse):
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.models.convert import (flax_leaf_order,
                                                  to_flax_layout)
    fmodel = jresnet.ResNet50(num_classes=1000, dtype=jnp.bfloat16,
                              space_to_depth=True)
    shapes = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=True))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, device="meta")
    named = list(model.named_parameters())
    leaves = [to_flax_layout(named[i][0], named[i][1])
              for i in flax_leaf_order([n for n, _ in named])]
    jleaves = jax.tree.leaves(shapes["params"])
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(s.shape) for s in jleaves]
    got = tfusion.explain_plan(leaves, THRESHOLD, compression=compression,
                               reverse=reverse)
    want = _jfusion().explain_plan(shapes["params"], THRESHOLD,
                                   compression=compression, reverse=reverse,
                                   register=False)
    assert [{k: v for k, v in r.items() if k != "fence"} for r in got] == \
        [{k: v for k, v in r.items() if k != "fence"} for r in want]
    assert len(got) >= 1 and all(r["fence"] == "" for r in got)
    text = tfusion.render_plan(got)
    assert f"total: {len(got)} bucket(s)" in text
    snap = tmetrics.registry().snapshot()
    assert snap["horovod_plan_buckets"]["samples"][0]["value"] == len(got)


# ---------------------------------------------------------------------------
# Executed equals planned (gloo worlds)
# ---------------------------------------------------------------------------


SHAPES = {"b1": (5,), "b2": (3,), "w1": (6, 5), "w2": (5, 3)}
BATCH = 8
BUCKET_BYTES = 100          # two or three buckets of the 53 f32 values


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(0)
        for k, s in SHAPES.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
                (0.5 * rng.randn(*s)).astype(np.float32))))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def _mlp_loss(model, batch):
    x, y = batch
    return ((model(x) - y) ** 2).mean()


def _batch(rank, world):
    rng = np.random.RandomState(7)
    x = rng.randn(BATCH, 6).astype(np.float32)
    y = rng.randn(BATCH, 3).astype(np.float32)
    n = BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    return torch.from_numpy(x[rows]), torch.from_numpy(y[rows])


def _one_step(rank, world, compression=None, zero=False, microbatches=1):
    """One step of ``config``: ``(leg registry, collective bytes by op,
    planned rows)``."""
    from horovod_tpu_torch.optim.zero import zero_plan
    from horovod_tpu_torch.training import make_train_step
    model = _MLP()
    sgd = torch.optim.SGD(model.parameters(), lr=0.1)
    if zero:
        step = make_train_step(model, _mlp_loss, sgd, zero_stage=1)
        opt = None
    else:
        opt = thvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(),
            compression=compression, fusion_threshold=BUCKET_BYTES)
        step = make_train_step(model, _mlp_loss, opt,
                               microbatches=microbatches)
    tspans.recorder().reset()
    tmetrics.reset_metrics()
    step(_batch(rank, world))
    reg = tspans.recorder().leg_registry()
    coll = {op: v["bytes"] for (op, _), v in
            tmetrics.collective_totals().items()}
    if zero:
        rs, ag = zero_plan(step.zero_state.spec)
        planned = list(rs) + list(ag)
    elif microbatches > 1:
        planned = _microbatch_rows(opt, microbatches, world)
    else:
        planned = _optimizer_rows(opt, world)
    return reg, coll, planned


def _bucket_sizes(spec):
    return [(dt, sum(s.size for s in lspecs)) for dt, lspecs in spec.buffers]


def _microbatch_rows(opt, k, world):
    from horovod_tpu_torch.models.convert import flax_leaf_order
    names = [n for n, _ in _MLP().named_parameters()]
    params = opt._trainable
    leaves = [params[i] for i in flax_leaf_order(names)]
    spec = tfusion.plan_buckets(leaves, BUCKET_BYTES, reverse=True)
    legs = tfusion.plan_exchange("microbatch", buffers=_bucket_sizes(spec),
                                 k=k, world=world).legs
    nb = len(spec.buffers)
    return list(legs[:nb]) * k + list(legs[nb:])


def _optimizer_rows(opt, world):
    """The rows a step of ``opt`` plans, one bucket at a time."""
    from horovod_tpu_torch.collectives.compression import (
        is_error_feedback, is_fp8, is_hier_legs, is_powersgd)
    from horovod_tpu_torch.core.topology import hier_mesh_shape
    from horovod_tpu_torch.optim.distributed import exchange_chunk_bytes
    comp = opt._compression
    rows = []
    for dt, size in _bucket_sizes(opt.bucket_plan):
        if is_error_feedback(comp):
            rows += tfusion.plan_exchange("ef", size=size, dtype=dt,
                                          compression=comp).legs
            if is_powersgd(comp):
                rows += tfusion.plan_exchange(
                    "kernel", kernel="fused_update", nbytes=4 * size).legs
        elif is_fp8(comp):
            rows += tfusion.plan_exchange("fp8", size=size,
                                          world=world).legs
        elif hier_mesh_shape() is not None and (
                is_hier_legs(comp) or tfusion.hier_requested(comp)):
            n_dcn, n_ici = hier_mesh_shape()
            rows += tfusion.plan_hier_legs(size, dt, n_dcn=n_dcn,
                                           n_ici=n_ici, compression=comp)
        elif exchange_chunk_bytes() > 0:
            wire = comp.wire_dtype if getattr(comp, "wire_dtype", None) \
                else dt
            rows += tfusion.plan_exchange(
                "chunked", size=size, dtype=wire,
                chunk_bytes=exchange_chunk_bytes(), world=world).legs
        else:
            rows += tfusion.plan_exchange("flat", size=size, dtype=dt,
                                          compression=comp).legs
    return rows


CONFIGS = {2: {"flat_none": dict(compression="none"),
               "flat_fp16": dict(compression="fp16"),
               "chunked": dict(compression="none", chunk=64),
               "powersgd": dict(compression="powersgd:2"),
               "topk": dict(compression="topk:0.25"),
               "fp8": dict(compression="fp8"),
               "zero1": dict(zero=True),
               "microbatch2": dict(compression="none", microbatches=2)},
           4: {"hier": dict(compression="none", hierarchical="2,2"),
               "hier_fp8": dict(compression="ici:none,dcn:fp8",
                                hierarchical="2,2")}}


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    from horovod_tpu_torch.core.state import global_state
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    st = global_state()
    base = st.config
    res = {}
    for name, cfg in CONFIGS[world].items():
        cfg = dict(cfg)
        st.config = dataclasses.replace(
            base, hierarchical=cfg.pop("hierarchical", None),
            exchange_chunk_bytes=cfg.pop("chunk", 0))
        res[name] = _one_step(rank, world, **cfg)
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
    return {w: _run_world(tmp_path_factory.mktemp(f"plan{w}"), w)
            for w in CONFIGS}


_COLLECTIVE_OPS = {"flat_ar": "allreduce", "chunked_rs_ag":
                   "chunked_allreduce", "powersgd_allreduce":
                   "powersgd_allreduce", "topk_allreduce": "topk_allreduce",
                   "fp8_allreduce": "fp8_allreduce",
                   "hier/ici_rs": "hierarchical_allreduce",
                   "hier/dcn_ar": "hierarchical_allreduce",
                   "hier/ici_ag": "hierarchical_allreduce",
                   "zero_rs": "reducescatter", "zero_ag": "allgather",
                   "microbatch_rs": "reducescatter",
                   "microbatch_ag": "allgather"}
LOSS_BYTES = 4              # the step's f32 loss average, an allreduce


@pytest.mark.parametrize("world,name", [(w, n) for w in CONFIGS
                                        for n in CONFIGS[w]])
def test_executed_exchange_equals_its_plan(worlds, world, name):
    for r in range(world):
        reg, coll, planned = worlds[world][r][name]
        assert planned, name
        want = {}
        for leg in planned:
            w = want.setdefault(leg.tag, {"nbytes": 0, "buckets": 0})
            w["nbytes"] += leg.nbytes
            w["buckets"] += 1
        assert reg == want, (name, r)
        by_op = {}
        for leg in planned:
            if leg.collective in ("ledger", "none"):
                continue
            op = _COLLECTIVE_OPS[leg.tag]
            by_op[op] = by_op.get(op, 0) + leg.nbytes
        by_op["allreduce"] = by_op.get("allreduce", 0) + LOSS_BYTES
        assert coll == by_op, (name, r)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
