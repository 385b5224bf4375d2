"""PyTorch/CUDA port: the two-level and chunked allreduce, against the
JAX package.

In one process: ``parse_topology_spec`` (every spec, the errors too) and
``plan_hier_legs`` (every codec, dtype and topology) equal to the JAX
package's.

Gloo worlds of 2 and 4 (this file, run as a script, is each rank; they
meet through a ``FileStore`` under pytest's temporary directory), against
the JAX op under ``jax.shard_map`` -- on a ``(dcn, ici)`` mesh for the
two-level op, rank ``r = dcn * n_ici + ici`` being the mesh's row-major
device ``r``:

* ``hierarchical_allreduce`` at world 4 as 2 x 2 and at world 2 as
  1 x 2 (one node: the flat allreduce) and 2 x 1, uncompressed (with a
  prescale and a postscale), with ``ici:none,dcn:fp8`` and with
  ``ici:bf16,dcn:topk:0.25`` and a DCN residual; a bucket that pads.
  Outputs within 1e-6 of max |value| (the reduce-scatter's sum may be
  ordered otherwise than XLA's), the DCN residual bitwise;
* ``chunked_allreduce`` with the chunk below, equal to and above the
  bucket, within 1e-6 of max |value|;
* a ``DistributedOptimizer`` step under ``HOROVOD_HIERARCHICAL=2,2`` and
  under ``HOROVOD_EXCHANGE_CHUNK_MB`` equal to the flat step within f32
  reordering (1e-6 of max |parameter|), the exchange counters pricing
  the legs as ``plan_hier_legs`` does; and a per-leg error-feedback step
  whose residual is ``[2, shard]`` with the ICI row zero.
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
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu_torch.collectives import ops as tops
from horovod_tpu_torch.controller import fusion as tfusion
from horovod_tpu_torch.core import topology as ttopo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_HIERARCHICAL",
                 "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_COMPRESSION",
                 "HOROVOD_EXCHANGE_CHUNK_MB")
TOPOLOGIES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
HIER_CASES = {         # name: (ici, dcn, op, prescale, postscale, ef)
    "plain": ("none", "none", "Average", 0.5, 2.0, False),
    "fp8": ("none", "fp8", "Average", 1.0, 1.0, False),
    "bf16_topk": ("bf16", "topk:0.25", "Sum", 1.0, 1.0, True),
}
HIER_SIZE = 300        # pads to 512 (quantum 256 at n_ici 1 and 2)
CHUNKS = {"below": 1024, "equal": 4000, "above": 8192}   # a 4000-byte bucket
F32_REL = 1e-6


def _x(seed, size):
    return np.random.RandomState(seed).randn(size).astype(np.float32)


def _shard(topo):
    """The DCN hop's width: the bucket padded to lcm(n_ici, 256), over
    n_ici."""
    padded = HIER_SIZE + (-HIER_SIZE) % tops.microbatch_pad_quantum(topo[1])
    return padded // topo[1]


def _hier_inputs(rank, name):
    """The bucket and a DCN residual long enough for every layout."""
    return _x(10 + rank + len(name), HIER_SIZE), _x(50 + rank, 512)


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 3))


def _opt_step(comp, rank, world, steps=2):
    """``steps`` DistributedOptimizer(SGD) steps of the small model on this
    rank's rows; returns (parameters, exchange counters moved)."""
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    model = _model()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), compression=comp)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(steps, 4 * world, 6).astype(np.float32))
    y = torch.from_numpy(rng.randn(steps, 4 * world, 3).astype(np.float32))
    before = exchange_totals(legs=True)
    for s in range(steps):
        rows = slice(4 * rank, 4 * rank + 4)
        loss = ((model(x[s, rows]) - y[s, rows]) ** 2).mean()
        loss.backward()
        opt.step()
        opt.zero_grad()
    moved = {k: v - before[k] for k, v in exchange_totals(legs=True).items()}
    return ([p.detach().clone() for p in model.parameters()], moved,
            [r.clone() for r in opt.residuals])


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    from horovod_tpu_torch.core.state import global_state
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {}
    for topo in TOPOLOGIES[world]:
        for name, (ici, dcn, op, pre, post, ef) in HIER_CASES.items():
            x, r = (torch.from_numpy(a) for a in _hier_inputs(rank, name))
            res["hier", topo, name] = tops.hierarchical_allreduce(
                x, getattr(thvd, op), ici_codec=ici, dcn_codec=dcn,
                dcn_residual=r[:_shard(topo)] if ef and topo[0] > 1
                else None, prescale_factor=pre, postscale_factor=post,
                topology=topo)
    for name, nbytes in CHUNKS.items():
        x = torch.from_numpy(_x(90 + rank, 1000))
        res["chunked", name] = tops.chunked_allreduce(
            x, thvd.Average, chunk_bytes=nbytes)
        res["chunked_sum", name] = tops.chunked_allreduce(
            x, thvd.Sum, chunk_bytes=nbytes, prescale_factor=2.0,
            postscale_factor=0.25)
    st = global_state()
    base = st.config
    res["step", "flat"] = _opt_step("none", rank, world)
    if world == 4:
        st.config = dataclasses.replace(base, hierarchical="2,2")
        res["step", "hier"] = _opt_step("none", rank, world)
        res["step", "hier_fp8"] = _opt_step("ici:none,dcn:fp8", rank, world)
        res["step", "hier_ef"] = _opt_step("ici:bf16,dcn:topk:0.25", rank,
                                           world)
    st.config = dataclasses.replace(base, exchange_chunk_bytes=1 << 20)
    res["step", "chunked"] = _opt_step("none", rank, world)
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
    return {w: _run_world(tmp_path_factory.mktemp(f"hier{w}"), w)
            for w in TOPOLOGIES}


@pytest.fixture(scope="module")
def jax_hvd():
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init()
    yield hvd
    hvd.shutdown()


def _jax_run(shape, axes, fn, inputs_by_rank):
    """``fn`` per device under ``jax.shard_map`` (op by op, as in
    ``tests/test_torch_fp8_topk.py``) on a mesh of ``shape``."""
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    stacked = [jnp.asarray(np.stack([inputs_by_rank[r][i] for r in range(n)]))
               for i in range(len(inputs_by_rank[0]))]
    f = jax.shard_map(
        lambda *xs: jax.tree.map(lambda y: y[None],
                                 fn(*[x[0] for x in xs])),
        mesh=mesh, in_specs=P(axes), out_specs=P(axes), check_vma=False)
    return jax.tree.map(np.asarray, f(*stacked))


def _close(got, want, rel=F32_REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------

TOPO_SPECS = [None, "", "off", "0", "false", "no", "auto", "on", "1",
              "true", "yes", "2,2", " 4 , 1 ", "1,4"]
BAD_TOPO_SPECS = ["0,4", "2,3", "x", "2,2,2", "-1,4", "2;2"]


@pytest.mark.parametrize("spec", TOPO_SPECS)
def test_parse_topology_spec_matches_jax(spec):
    from horovod_tpu.parallel.mesh import parse_topology_spec as jparse
    assert ttopo.parse_topology_spec(spec) == jparse(spec)
    assert ttopo.parse_topology_spec(spec, 4) == jparse(spec, 4)


@pytest.mark.parametrize("spec", BAD_TOPO_SPECS)
def test_bad_topology_specs_raise_as_jax(spec):
    from horovod_tpu.parallel.mesh import parse_topology_spec as jparse
    with pytest.raises(ValueError) as want:
        jparse(spec, 4)
    with pytest.raises(ValueError) as got:
        ttopo.parse_topology_spec(spec, 4)
    assert str(got.value) == str(want.value)


LEG_CODECS = [None, "none", "bf16", "fp16", "ici:none,dcn:fp8",
              "ici:bf16,dcn:topk:0.25", "ici:none,dcn:powersgd:4",
              "dcn:bf16", "ici:fp16,dcn:fp16"]


@pytest.mark.parametrize("compression", LEG_CODECS)
def test_plan_hier_legs_matches_jax(compression):
    from horovod_tpu.collectives.compression import parse_compression
    from horovod_tpu.controller.fusion import plan_hier_legs as jplan
    jcomp = parse_compression(compression) if compression else None
    for size in (1, 300, 4096, 25_557_032):
        for dtype in ("float32", "bfloat16", "int32"):
            for n_dcn, n_ici in ((1, 4), (2, 1), (2, 2), (4, 2), (64, 4)):
                got = tfusion.plan_hier_legs(size, dtype, n_dcn=n_dcn,
                                             n_ici=n_ici,
                                             compression=compression)
                want = jplan(size, dtype, n_dcn=n_dcn, n_ici=n_ici,
                             compression=jcomp)
                assert [(g.tag, g.collective, g.codec, g.wire_dtype,
                         g.elements, g.nbytes) for g in got] == \
                    [(w.tag, w.collective, w.codec, w.wire_dtype,
                      w.elements, w.nbytes) for w in want]


def test_plan_hier_legs_refuses_exchange_level_codecs_as_jax():
    from horovod_tpu.collectives.compression import parse_compression
    from horovod_tpu.controller.fusion import plan_hier_legs as jplan
    for spec in ("fp8", "topk:0.5", "powersgd:2"):
        with pytest.raises(ValueError):
            jplan(100, "float32", n_dcn=2, n_ici=2,
                  compression=parse_compression(spec))
        with pytest.raises(ValueError, match="per leg"):
            tfusion.plan_hier_legs(100, "float32", n_dcn=2, n_ici=2,
                                   compression=spec)


def test_hier_mesh_shape_and_config(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    thvd.init(device="cpu")
    try:
        assert ttopo.hier_mesh_shape() is None
        assert not tfusion.hier_requested()
        assert tfusion.hier_requested(
            thvd.Compression.hier("none", "fp8"))
        assert tfusion.exchange_chunk_bytes() == 0
    finally:
        thvd.shutdown()
    monkeypatch.setenv("HOROVOD_HIERARCHICAL", "auto")
    monkeypatch.setenv("HOROVOD_EXCHANGE_CHUNK_MB", "3")
    thvd.init(device="cpu")
    try:
        assert ttopo.hier_mesh_shape() == (1, 1)
        assert tfusion.hier_requested()
        assert tfusion.exchange_chunk_bytes() == 3 << 20
        x = torch.arange(5.0)
        # One node: the flat allreduce, statically.
        assert torch.equal(tops.hierarchical_allreduce(x), x)
        assert torch.equal(tops.chunked_allreduce(x, chunk_bytes=8), x)
    finally:
        thvd.shutdown()


def test_hierarchical_allreduce_refuses_what_jax_refuses():
    thvd.init(device="cpu")
    try:
        x = torch.ones(4)
        with pytest.raises(ValueError, match="Sum/Average"):
            tops.hierarchical_allreduce(x, thvd.Max, topology=(1, 1))
        with pytest.raises(ValueError, match="psum-compatible"):
            tops.hierarchical_allreduce(x, ici_codec="fp8", topology=(1, 1))
        with pytest.raises(ValueError, match="two-level"):
            tops.hierarchical_allreduce(x)
        with pytest.raises(ValueError, match="Sum/Average"):
            tops.chunked_allreduce(x, thvd.Min, chunk_bytes=4)
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# Gloo worlds against the JAX ops
# ---------------------------------------------------------------------------

HIER_IDS = [(w, t, n) for w in TOPOLOGIES for t in TOPOLOGIES[w]
            for n in HIER_CASES]


@pytest.mark.parametrize("world,topo,name", HIER_IDS,
                         ids=[f"w{w}-{t[0]}x{t[1]}-{n}"
                              for w, t, n in HIER_IDS])
def test_hierarchical_allreduce_matches_jax(worlds, jax_hvd, world, topo,
                                            name):
    from horovod_tpu.collectives import ops as jops
    from horovod_tpu.collectives.compression import parse_compression
    ici, dcn, op, pre, post, ef = HIER_CASES[name]
    shard = _shard(topo)
    feed = ef and topo[0] > 1

    def fn(x, r):
        return jops.hierarchical_allreduce(
            x, getattr(jax_hvd, op), dcn_axis="dcn", ici_axis="ici",
            dcn_codec=parse_compression(dcn), ici_codec=parse_compression(ici),
            dcn_residual=r[:shard] if feed else None, prescale_factor=pre,
            postscale_factor=post)

    want = _jax_run(topo, ("dcn", "ici"), fn,
                    {r: _hier_inputs(r, name) for r in range(world)})
    for r in range(world):
        got = worlds[world][r]["hier", topo, name]
        if ef:
            (got, got_res), (w_out, w_res) = got, (want[0][r], want[1][r])
            assert got_res.shape == (shard,)
            np.testing.assert_array_equal(got_res.numpy(), w_res)
        else:
            w_out = want[r]
        _close(got, w_out)
        if name == "fp8" and topo[0] > 1:
            plain = worlds[world][r]["hier", topo, "plain"]
            assert not torch.equal(got, plain * 4.0)  # fp8 touched the wire


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("world", sorted(TOPOLOGIES))
def test_chunked_allreduce_matches_jax(worlds, jax_hvd, world, chunk):
    from horovod_tpu.collectives import ops as jops
    for key, op, pre, post in (("chunked", "Average", 1.0, 1.0),
                               ("chunked_sum", "Sum", 2.0, 0.25)):
        want = _jax_run((world,), ("hvd",),
                        lambda x: jops.chunked_allreduce(
                            x, getattr(jax_hvd, op), chunk_bytes=CHUNKS[chunk],
                            axes=("hvd",), prescale_factor=pre,
                            postscale_factor=post),
                        {r: (_x(90 + r, 1000),) for r in range(world)})
        for r in range(world):
            _close(worlds[world][r][key, chunk], want[r])


@pytest.mark.parametrize("world,variant", [(2, "chunked"), (4, "chunked"),
                                           (4, "hier")])
def test_optimizer_step_matches_the_flat_step(worlds, world, variant):
    flat, flat_moved, _ = worlds[world][0]["step", "flat"]
    for r in range(world):
        got, moved, _ = worlds[world][r]["step", variant]
        for g, w in zip(got, flat):
            _close(g, w.numpy())
    values = sum(p.numel() for p in flat)
    assert flat_moved["buckets"] == 2 and flat_moved["wire_bytes"] == \
        2 * 4 * values
    if variant == "hier":
        legs = tfusion.plan_hier_legs(values, torch.float32, n_dcn=2,
                                      n_ici=2)
        assert moved["wire_bytes"] == 2 * sum(leg.nbytes for leg in legs)
        assert moved["handles"] == 2 * 3
        for leg in legs:
            assert moved[leg.tag] == 2 * leg.nbytes
    else:
        assert moved["wire_bytes"] == 2 * 4 * values
        assert moved["handles"] == 2 * 2          # one chunk: RS + AG


def test_per_leg_codecs_step_on_the_two_level_layout(worlds):
    flat = worlds[4][0]["step", "flat"][0]
    values = sum(p.numel() for p in flat)
    for r in range(4):
        got, moved, res = worlds[4][r]["step", "hier_fp8"]
        for g, w in zip(got, flat):
            assert torch.isfinite(g).all()
            # e4m3 on the cross-node hop: close to the flat step, not equal.
            assert (g - w).abs().max() <= 0.1 * w.abs().max()
        legs = tfusion.plan_hier_legs(values, torch.float32, n_dcn=2,
                                      n_ici=2, compression="ici:none,dcn:fp8")
        assert moved["wire_bytes"] == 2 * sum(leg.nbytes for leg in legs)
        assert res == []
        got, moved, res = worlds[4][r]["step", "hier_ef"]
        shard = (values + (-values) % 256) // 2
        assert [tuple(t.shape) for t in res] == [(2, shard)]
        assert not res[0][0].any()
        # The bucket's 53 values fill the first shard of the padded 256:
        # the ranks at ici 0 hold what top-k left unsent, the others
        # padding.
        assert bool(res[0][1].any()) == (r % 2 == 0)
        assert all(torch.isfinite(g).all() for g in got)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
