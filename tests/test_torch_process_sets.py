"""PyTorch/CUDA port: process sets and the collectives on them, against
the JAX package.

* The registry's rules, in one process at world 1 and beside the JAX
  registry: duplicate ranks, ranks out of range, a name registered again
  with other ranks, an unknown name and removing the global set raise
  (``ProcessSetError`` in both packages); the same name with the same
  ranks returns the registered set; ``init()`` installs the global set
  and ``shutdown()`` forgets every set.
* Gloo worlds of 2 and 4 on the CPU: the ranks (this file, run as a
  script) rendezvous through a ``FileStore`` under pytest's temporary
  directory.  Every rank registers every set, in the same order -- the
  collective-registration rule (``dist.new_group`` is collective over
  the world); non-members hold the set too and raise ``ValueError``
  when they call its ops.  Sets: the global set and ``{1}`` at world 2;
  the global set, ``{0, 2}`` and ``{1, 2, 3}`` at world 4.  Each member
  runs allreduce (Sum, Average, Min, Max, Product, and a pre- and
  postscaled Average), grouped_allreduce, allgather (equal and ragged
  first dims), broadcast, reducescatter (every op, and along dim 1),
  alltoall and barrier, in f32, bf16 and int32, on inputs made with
  numpy from a seed.  Each result is held against the JAX op with
  ``process_set=`` under ``jax.shard_map`` on the conftest's 8-device
  CPU mesh, the same inputs on the member devices (a port rank ``r`` is
  JAX device ``r``).
* Adasum over a process set at world 4 (``{0, 1}`` and ``{0, 1, 2,
  3}``) against the JAX ``allreduce(op=Adasum, process_set=)`` and the
  port's NumPy oracle; ``{1, 2, 3}`` raises (not a power of two).
  Hierarchical Adasum at world 4 with ``local_size`` 2 against
  ``horovod_tpu.adasum.xla.adasum_allreduce_hierarchical`` on a ``(dcn,
  ici) = (2, 2)`` mesh.

Tolerances: exact for integers, Min, Max and the gather-type ops
(allgather, broadcast, alltoall); f32 Sum, Average and Product within
1e-6 of max |value| (sums of up to four terms in another order); bf16
within 2**-7 of max |value| (a bf16 rounding of each partial result in
either package); Adasum within 1e-5 of max |value|.
"""

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
from horovod_tpu_torch.adasum import reference as tref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_LOCAL_SIZE", "HVD_TPU_LOCAL_SIZE")
F32_REL = 1e-6
BF16_REL = 2.0 ** -7
ADASUM_REL = 1e-5

SETS = {2: {"global": None, "r1": (1,)},
        4: {"global": None, "r02": (0, 2), "r123": (1, 2, 3)}}
COMBOS = [(w, s) for w in SETS for s in SETS[w]]
DTYPES = ("float32", "bfloat16", "int32")
REDUCE_OPS = ("Sum", "Average", "Min", "Max", "Product")
# (result key, op) pairs a member computes, per dtype.
CASES = ([("allreduce", op) for op in REDUCE_OPS]
         + [("allreduce_scaled", "Average"), ("grouped_allreduce", "Sum"),
            ("allgather", None), ("allgather_ragged", None),
            ("broadcast", None)]
         + [("reducescatter", op) for op in REDUCE_OPS]
         + [("reducescatter_axis1", "Sum"), ("alltoall", None)])
ADASUM_SETS = {"a01": (0, 1), "a0123": (0, 1, 2, 3)}
PRE, POST = 0.5, 3.0


def _members(world, set_name):
    ranks = SETS[world][set_name]
    return tuple(range(world)) if ranks is None else ranks


def _input(world, set_name, dtype, kind, rank):
    """Rank ``rank``'s numpy input for result ``kind`` (f32 or int32
    values; bf16 is cast from the f32 values on both sides)."""
    m = len(_members(world, set_name))
    seed = (COMBOS.index((world, set_name)) * 1000 + DTYPES.index(dtype) * 100
            + [k for k, _ in CASES].index(kind) * 5 + rank)
    rng = np.random.RandomState(seed)
    shape = {"reducescatter": (2 * m, 3), "reducescatter_axis1": (3, 2 * m),
             "alltoall": (2 * m, 3), "allgather_ragged": (1 + rank, 3),
             "grouped_allreduce": (5,)}.get(kind, (4, 3))
    if dtype == "int32":
        return rng.randint(-20, 20, size=shape).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


def _grouped_second(world, set_name, dtype, rank):
    x = _input(world, set_name, dtype, "grouped_allreduce", rank)
    return (x[:3] * 2).reshape(3, 1)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _member_results(world, set_name, ps, rank):
    res = {}
    members = _members(world, set_name)
    for dtype in DTYPES:
        def inp(kind):
            return _to_torch(_input(world, set_name, dtype, kind, rank),
                             dtype)
        for kind, op in CASES:
            x = inp(kind)
            x_copy = x.clone()
            hop = getattr(thvd, op) if op else None
            if kind in ("allreduce", "reducescatter"):
                fn = thvd.allreduce if kind == "allreduce" else \
                    thvd.reducescatter
                y = fn(x, op=hop, process_set=ps)
            elif kind == "allreduce_scaled":
                if dtype == "int32":
                    continue
                y = thvd.allreduce(x, op=hop, prescale_factor=PRE,
                                   postscale_factor=POST, process_set=ps)
            elif kind == "grouped_allreduce":
                y = thvd.grouped_allreduce(
                    [x, _to_torch(_grouped_second(world, set_name, dtype,
                                                  rank), dtype)],
                    op=hop, process_set=ps)
            elif kind.startswith("allgather"):
                y = thvd.allgather(x, process_set=ps)
            elif kind == "broadcast":
                y = thvd.broadcast(x, root_rank=members[-1], process_set=ps)
            elif kind == "reducescatter_axis1":
                y = thvd.reducescatter(x, op=hop, process_set=ps,
                                       scatter_axis=1)
            else:
                y = thvd.alltoall(x, process_set=ps)
            assert torch.equal(x, x_copy), kind
            res[dtype, kind, op] = y
    thvd.barrier(process_set=ps)
    return res


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    from horovod_tpu_torch.adasum.vhdd import adasum_allreduce_hierarchical
    os.environ.pop("HOROVOD_LOCAL_SIZE", None)
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {"names_before": thvd.process_set_names()}
    sets = {name: (thvd.get_process_set() if ranks is None
                   else thvd.add_process_set(ranks, name=name))
            for name, ranks in SETS[world].items()}
    if world == 4:
        sets.update({name: thvd.add_process_set(ranks, name=name)
                     for name, ranks in ADASUM_SETS.items()})
    res["names"] = thvd.process_set_names()
    res["again_is_same"] = all(
        thvd.add_process_set(ps.ranks, name=name) is ps
        for name, ps in sets.items() if not ps.is_global())
    for name in SETS[world]:
        ps = sets[name]
        if not ps.included():
            for call in (lambda: thvd.allreduce(torch.ones(2),
                                                process_set=ps),
                         lambda: thvd.reducescatter(torch.ones(4),
                                                    process_set=ps),
                         lambda: thvd.alltoall(torch.ones(4),
                                               process_set=ps),
                         lambda: thvd.barrier(process_set=ps)):
                try:
                    call()
                    res["nonmember", name] = "no error"
                except ValueError as e:
                    res["nonmember", name] = str(e)
            continue
        res[name] = _member_results(world, name, ps, rank)
    if world == 4:
        x = torch.from_numpy(_adasum_input(rank))
        for name in ADASUM_SETS:
            if sets[name].included():
                res["adasum", name] = thvd.allreduce(
                    x, op=thvd.Adasum, process_set=sets[name])
        if sets["r123"].included():
            try:
                thvd.allreduce(x, op=thvd.Adasum, process_set=sets["r123"])
                res["adasum_r123"] = "no error"
            except ValueError as e:
                res["adasum_r123"] = str(e)
        res["hierarchical"] = adasum_allreduce_hierarchical(x, local_size=2)
    # Removal is collective too: every rank, the same order.
    for name, ps in sets.items():
        if not ps.is_global():
            thvd.remove_process_set(ps)
    res["names_after"] = thvd.process_set_names()
    thvd.barrier()
    torch.save(res, out)
    thvd.shutdown()


def _adasum_input(rank):
    common = np.random.RandomState(7).randn(37)
    return (common + 0.7 * np.random.RandomState(8 + rank).randn(37)
            ).astype(np.float32)


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
    out = {}
    for world in SETS:
        d = tmp_path_factory.mktemp(f"ps{world}")
        out[world] = _run_world(d, world)
    return out


# ---------------------------------------------------------------------------
# The JAX side: every case of one (world, set, dtype) in one program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_hvd():
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init()
    yield hvd
    hvd.shutdown()


_JAX_CACHE = {}


def _jax_results(hvd, world, set_name, dtype):
    key = (world, set_name, dtype)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    from horovod_tpu.collectives import ops as jops
    members = _members(world, set_name)
    mesh = hvd.mesh()
    axes = tuple(mesh.axis_names)
    n = mesh.devices.size
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.dtype(dtype)
    kinds = [(k, op) for k, op in CASES if k != "allgather_ragged"
             and not (k == "allreduce_scaled" and dtype == "int32")]

    def stacked(kind, maker=_input):
        rows = [maker(world, set_name, dtype, kind, r) if r in members
                else None for r in range(n)]
        like = next(r for r in rows if r is not None)
        return jnp.asarray(np.stack([np.zeros_like(like) if r is None
                                     else r for r in rows]), jdt)

    inputs = [stacked(k) for k, _ in kinds] + [
        stacked("grouped_allreduce",
                lambda w, s, d, k, r: _grouped_second(w, s, d, r))]
    ps = hvd.add_process_set(members, name=f"t_{world}_{set_name}")
    try:
        def f(*xs):
            out = []
            for (kind, op), x in zip(kinds, xs):
                x = x[0]
                jop = getattr(hvd, op) if op else None
                kw = dict(axes=axes, process_set=ps)
                if kind == "allreduce":
                    y = jops.allreduce(x, jop, **kw)
                elif kind == "allreduce_scaled":
                    y = jops.allreduce(x, jop, prescale_factor=PRE,
                                       postscale_factor=POST, **kw)
                elif kind == "grouped_allreduce":
                    y = jops.grouped_allreduce([x, xs[-1][0]], jop, **kw)
                elif kind == "allgather":
                    y = jops.allgather(x, **kw)
                elif kind == "broadcast":
                    y = jops.broadcast(x, members[-1], **kw)
                elif kind == "reducescatter":
                    y = jops.reducescatter(x, jop, **kw)
                elif kind == "reducescatter_axis1":
                    y = jops.reducescatter(x, jop, scatter_axis=1, **kw)
                else:
                    y = jops.alltoall(x, **kw)
                out.append([t[None] for t in y] if isinstance(y, list)
                           else y[None])
            return out

        fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P(axes),
                                   out_specs=P(axes)))
        got = fn(*inputs)
    finally:
        hvd.remove_process_set(ps)
    res = {kind_op: jax.tree.map(lambda a: np.asarray(a, np.float64), y)
           for kind_op, y in zip(kinds, got)}
    _JAX_CACHE[key] = res
    return res


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _tol(dtype, op, want):
    scale = max(np.abs(np.asarray(want)).max(), 1e-30)
    if dtype == "int32" or op in ("Min", "Max", None):
        return 0.0
    return (F32_REL if dtype == "float32" else BF16_REL) * scale


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


# Pre- and postscale are float factors: no int32 case.
DTYPE_CASES = [(d, c) for d in DTYPES for c in CASES
               if not (d == "int32" and c[0] == "allreduce_scaled")]


@pytest.mark.parametrize("dtype,case", DTYPE_CASES,
                         ids=[f"{d}-{k}-{o}" for d, (k, o) in DTYPE_CASES])
@pytest.mark.parametrize("world,set_name", COMBOS,
                         ids=[f"w{w}-{s}" for w, s in COMBOS])
def test_process_set_op_matches_jax(worlds, jax_hvd, world, set_name,
                                    dtype, case):
    kind, op = case
    members = _members(world, set_name)
    if kind == "allgather_ragged":
        want = np.concatenate([
            _to_torch(_input(world, set_name, dtype, kind, r), dtype)
            .to(torch.float64).numpy() for r in members])
        for r in members:
            got = worlds[world][r][set_name][dtype, kind, op]
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_np(got), want)
        return
    want_all = _jax_results(jax_hvd, world, set_name, dtype)[kind, op]
    for r in members:
        got = worlds[world][r][set_name][dtype, kind, op]
        if kind == "grouped_allreduce":
            assert len(got) == 2
            pairs = [(g, w[r]) for g, w in zip(got, want_all)]
        else:
            pairs = [(got, want_all[r])]
        for g, w in pairs:
            assert g.dtype == getattr(torch, dtype), (kind, g.dtype)
            assert tuple(g.shape) == w.shape, (kind, g.shape, w.shape)
            err = np.abs(_np(g) - w).max() if w.size else 0.0
            assert err <= _tol(dtype, op, w), (r, kind, op, err)


def test_every_rank_holds_every_set(worlds):
    """Registration is collective: every rank, members or not, registered
    every set and removed it again, and the names agree."""
    for world, ranks in worlds.items():
        for r, res in ranks.items():
            assert res["names_before"] == ["global"]
            want = ["global"] + sorted(n for n in SETS[world]
                                       if n != "global")
            if world == 4:
                want = sorted(want + list(ADASUM_SETS))
            assert res["names"] == sorted(want)
            assert res["again_is_same"]
            assert res["names_after"] == ["global"]


@pytest.mark.parametrize("world,set_name",
                         [c for c in COMBOS if c[1] != "global"])
def test_non_members_raise(worlds, world, set_name):
    members = _members(world, set_name)
    outside = [r for r in range(world) if r not in members]
    assert outside
    for r in outside:
        msg = worlds[world][r]["nonmember", set_name]
        assert "not a member" in msg, msg
        assert set_name not in worlds[world][r]


@pytest.mark.parametrize("set_name", sorted(ADASUM_SETS))
def test_process_set_adasum_matches_jax_and_the_oracle(worlds, jax_hvd,
                                                       set_name):
    from horovod_tpu.collectives import ops as jops
    members = ADASUM_SETS[set_name]
    vecs = [_adasum_input(r) for r in range(8)]
    mesh = jax_hvd.mesh()
    axes = tuple(mesh.axis_names)
    ps = jax_hvd.add_process_set(members, name=f"adasum_{set_name}")
    try:
        fn = jax.jit(jax.shard_map(
            lambda x: jops.allreduce(x[0], jax_hvd.Adasum, axes=axes,
                                     process_set=ps)[None],
            mesh=mesh, in_specs=P(axes), out_specs=P(axes)))
        want_jax = np.asarray(fn(jnp.asarray(np.stack(vecs))))
    finally:
        jax_hvd.remove_process_set(ps)
    want_ref = tref.adasum_reference([vecs[r] for r in members])
    for r in members:
        got = worlds[4][r]["adasum", set_name].numpy()
        scale = np.abs(want_ref).max()
        assert np.abs(got - want_jax[r]).max() <= ADASUM_REL * scale
        assert np.abs(got - want_ref).max() <= ADASUM_REL * scale


def test_process_set_adasum_needs_a_power_of_two(worlds):
    for r in (1, 2, 3):
        assert "power-of-two" in worlds[4][r]["adasum_r123"]


def test_hierarchical_adasum_matches_jax(worlds):
    """Nodes of two ranks: the JAX function on a ``(dcn, ici) = (2, 2)``
    mesh, device ``2 * node + local rank`` holding that rank's vector."""
    from horovod_tpu.adasum.xla import adasum_allreduce_hierarchical
    vecs = np.stack([_adasum_input(r) for r in range(4)])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    fn = jax.jit(jax.shard_map(
        lambda x: adasum_allreduce_hierarchical(x[0, 0])[None, None],
        mesh=mesh, in_specs=P("dcn", "ici"), out_specs=P("dcn", "ici")))
    want = np.asarray(fn(jnp.asarray(vecs.reshape(2, 2, -1))))
    want = want.reshape(4, -1)
    for r in range(4):
        got = worlds[4][r]["hierarchical"].numpy()
        assert got.shape == want[r].shape
        scale = np.abs(want[r]).max()
        assert np.abs(got - want[r]).max() <= ADASUM_REL * scale


# ---------------------------------------------------------------------------
# The registry in one process, beside the JAX registry
# ---------------------------------------------------------------------------


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


REGISTRY_ERRORS = {
    "duplicate": lambda hvd, n: hvd.add_process_set([0, 0]),
    "out_of_range": lambda hvd, n: hvd.add_process_set([0, n]),
    "negative": lambda hvd, n: hvd.add_process_set([-1]),
    "empty": lambda hvd, n: hvd.add_process_set([]),
    "remove_global": lambda hvd, n: hvd.remove_process_set("global"),
    "unknown": lambda hvd, n: hvd.get_process_set("nope"),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_ERRORS))
def test_registry_errors_match_jax(world1, jax_hvd, case):
    from horovod_tpu.core.exceptions import ProcessSetError as JError
    with pytest.raises(JError):
        REGISTRY_ERRORS[case](jax_hvd, jax_hvd.size())
    with pytest.raises(thvd.ProcessSetError):
        REGISTRY_ERRORS[case](thvd, thvd.size())


def test_registry_rules(world1, jax_hvd):
    from horovod_tpu.core.process_sets import process_set_names as jax_names
    for hvd in (jax_hvd, world1):
        g = hvd.get_process_set()
        assert g.is_global() and g.ranks == tuple(range(hvd.size()))
        ps = hvd.add_process_set([0], name="zero")
        assert hvd.add_process_set([0], name="zero") is ps
        assert hvd.get_process_set("zero") is ps
        assert ps.size() == 1 and ps.included(0) and not ps.is_global()
        names = jax_names() if hvd is jax_hvd else hvd.process_set_names()
        assert "zero" in names
        if hvd.size() > 1:
            with pytest.raises(Exception, match="already exists"):
                hvd.add_process_set([0, 1], name="zero")
        hvd.remove_process_set(ps)
        with pytest.raises(Exception):
            hvd.get_process_set("zero")
    assert world1.add_process_set([0]).name == "ps_0"
    world1.shutdown()
    with pytest.raises(thvd.ProcessSetError):
        world1.get_process_set()
    world1.init(device="cpu")
    assert world1.process_set_names() == ["global"]


def test_world_of_one_ops_on_a_one_member_set(world1):
    """At world 1 every op over ``{0}`` is an identity or a slice."""
    ps = world1.add_process_set([0])
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    for op in (thvd.Sum, thvd.Average, thvd.Min, thvd.Max, thvd.Product):
        assert torch.equal(thvd.allreduce(x, op=op, process_set=ps), x)
        assert torch.equal(thvd.reducescatter(x, op=op, process_set=ps), x)
    assert torch.equal(thvd.alltoall(x, process_set=ps), x)
    got, splits = thvd.alltoall(x, splits=[4], process_set=ps)
    assert torch.equal(got, x) and splits.tolist() == [4]
    assert torch.equal(thvd.allgather(x, process_set=ps), x)
    assert torch.equal(thvd.broadcast(x, 0, process_set=ps), x)
    with pytest.raises(ValueError, match="not a member"):
        thvd.broadcast(x, 1, process_set=ps)
    with pytest.raises(NotImplementedError, match="Adasum"):
        thvd.reducescatter(x, op=thvd.Adasum, process_set=ps)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
