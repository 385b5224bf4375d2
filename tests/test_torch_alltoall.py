"""PyTorch/CUDA port: alltoall(v), the grouped gathers and scatters,
sparse and object collectives, and Horovod's integer handles, against
the JAX package.

Gloo worlds of 2 and 4 on the CPU (this file, run as a script, is each
rank; they rendezvous through a ``FileStore`` under pytest's temporary
directory), on the global set and, at world 4, on the set ``{1, 2,
3}``:

* ``alltoall`` with even splits against the JAX ``alltoall``, and with
  ``splits`` (rank ``r`` sends ``(r + i) % 3`` rows to member ``i``, so
  some splits are empty) against the JAX ``alltoallv`` with
  ``max_count`` at least the largest split, so nothing truncates: the
  received rows are the JAX receive buffer's valid rows in member order,
  and the received splits its counts;
* ``grouped_allgather`` (ragged first dims) and
  ``grouped_reducescatter`` (Sum and Average, f32 and int32) against the
  JAX ``allgather`` / ``reducescatter`` of each tensor;
* ``sparse_allreduce_async`` (Sum and Average, duplicate coordinates
  across ranks, a rank with no entries, values with a trailing dim)
  against the port's dense allreduce of the densified tensor;
* ``allgather_object`` (objects of different pickled sizes);
* integer handles: ``poll`` turns true, ``synchronize`` returns the
  result (a list for grouped handles; the in-place variants write the
  input), and an unknown or spent handle raises ``ValueError``.

Tolerances: exact for the exchanges, gathers and integer sums; f32 sums
within 1e-6 of max |value|; the sparse result within 1e-6 of the dense
one's max |value| (float64 on the wire, one cast at the end).
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as thvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
F32_REL = 1e-6
SETS = {2: {"global": None}, 4: {"global": None, "r123": (1, 2, 3)}}
COMBOS = [(w, s) for w in SETS for s in SETS[w]]
DTYPES = ("float32", "int32")


def _members(world, set_name):
    ranks = SETS[world][set_name]
    return tuple(range(world)) if ranks is None else ranks


def _rows(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(-30, 30, size=shape).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


def _splits(pos, m):
    return [(pos + i) % 3 for i in range(m)]


def _even_input(world, set_name, dtype, rank):
    m = len(_members(world, set_name))
    return _rows(100 * world + 10 * rank + DTYPES.index(dtype), (2 * m, 3),
                 dtype)


def _uneven_input(world, set_name, dtype, rank):
    members = _members(world, set_name)
    total = sum(_splits(members.index(rank), len(members)))
    return _rows(200 * world + 10 * rank + DTYPES.index(dtype), (total, 2),
                 dtype)


def _grouped_inputs(world, set_name, dtype, rank):
    m = len(_members(world, set_name))
    base = 300 * world + 10 * rank + DTYPES.index(dtype)
    return [_rows(base, (1 + rank % 2, 3), dtype),
            _rows(base + 1, (2 * m, 2), dtype),
            _rows(base + 2, (m, 4), dtype)]


def _sparse_input(rank, with_tail):
    """Rank ``rank``'s COO tensor of shape [6] or [6, 2]: rank 1 holds no
    entries; the others share coordinate 2."""
    if rank == 1:
        idx = np.zeros((1, 0), np.int64)
    else:
        idx = np.array([[2, (rank + 3) % 6]], np.int64)
    shape = (6, 2) if with_tail else (6,)
    vals = np.random.RandomState(400 + rank).randn(
        idx.shape[1], *shape[1:]).astype(np.float32)
    return torch.sparse_coo_tensor(torch.from_numpy(idx),
                                   torch.from_numpy(vals), shape)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _member_results(world, set_name, ps, rank):
    res = {}
    for dtype in DTYPES:
        t = getattr(torch, dtype)
        x = torch.from_numpy(_even_input(world, set_name, dtype, rank))
        res[dtype, "even"] = thvd.alltoall(x, process_set=ps)
        members = ps.ranks
        u = torch.from_numpy(_uneven_input(world, set_name, dtype, rank))
        sp = torch.tensor(_splits(members.index(rank), len(members)))
        res[dtype, "uneven"] = thvd.alltoall(u, splits=sp, process_set=ps)
        res[dtype, "uneven_async"] = thvd.synchronize(
            thvd.alltoall_async(u, splits=sp, process_set=ps))
        gs = [torch.from_numpy(a) for a in
              _grouped_inputs(world, set_name, dtype, rank)]
        res[dtype, "grouped_allgather"] = thvd.grouped_allgather(
            gs, process_set=ps)
        for op in ("Sum", "Average"):
            res[dtype, "grouped_reducescatter", op] = \
                thvd.grouped_reducescatter(gs[1:], op=getattr(thvd, op),
                                           process_set=ps)
        assert x.dtype == t
    for tail in (False, True):
        sp = _sparse_input(rank, tail)
        for op in ("Sum", "Average"):
            h = thvd.sparse_allreduce_async(sp, op=getattr(thvd, op),
                                            process_set=ps)
            res["sparse", tail, op] = thvd.synchronize(h)
            res["dense", tail, op] = thvd.allreduce(
                sp.to_dense(), op=getattr(thvd, op), process_set=ps)
    res["objects"] = thvd.allgather_object(
        {"rank": rank, "pad": "x" * (7 * rank)}, process_set=ps)
    res["handles"] = _handles(world, ps, rank)
    return res


def _handles(world, ps, rank):
    """The integer-handle surface, each result next to what it should
    be."""
    out = {}
    x = torch.arange(6, dtype=torch.float32) + rank
    h = thvd.allreduce_async(x, op=thvd.Sum, process_set=ps)
    deadline = time.monotonic() + 60
    while not thvd.poll(h):
        assert time.monotonic() < deadline, "poll never turned true"
        time.sleep(0.001)
    out["polled_true"] = True
    out["sum"] = thvd.synchronize(h)
    for call in (thvd.poll, thvd.synchronize):
        try:
            call(h)
            out["spent", call.__name__] = "no error"
        except ValueError as e:
            out["spent", call.__name__] = str(e)
    try:
        thvd.poll(10 ** 9)
        out["unknown"] = "no error"
    except ValueError as e:
        out["unknown"] = str(e)
    y = x.clone()
    out["inplace_is_input"] = thvd.synchronize(
        thvd.allreduce_async_(y, op=thvd.Sum, process_set=ps)) is y
    out["inplace"] = y
    ts = [x.clone(), x[:2].clone() * 3]
    out["grouped"] = thvd.synchronize(
        thvd.grouped_allreduce_async(ts, op=thvd.Sum, process_set=ps))
    thvd.synchronize(thvd.grouped_allreduce_async_(ts, op=thvd.Sum,
                                                   process_set=ps))
    out["grouped_inplace"] = ts
    out["bcast"] = thvd.synchronize(
        thvd.broadcast_async(x, ps.ranks[0], process_set=ps))
    out["gather"] = thvd.synchronize(thvd.allgather_async(x,
                                                          process_set=ps))
    m = ps.size()
    out["scatter"] = thvd.synchronize(thvd.reducescatter_async(
        torch.arange(2 * m, dtype=torch.float32) + rank, op=thvd.Sum,
        process_set=ps))
    return out


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {}
    for name, ranks in SETS[world].items():
        ps = thvd.get_process_set() if ranks is None else \
            thvd.add_process_set(ranks, name=name)
        if ps.included():
            res[name] = _member_results(world, name, ps, rank)
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
    return {w: _run_world(tmp_path_factory.mktemp(f"a2a{w}"), w)
            for w in SETS}


@pytest.fixture(scope="module")
def jax_hvd():
    import horovod_tpu as hvd
    hvd.shutdown()
    hvd.init()
    yield hvd
    hvd.shutdown()


def _jax_run(hvd, members, fn, stacked_inputs):
    """``fn(x, ps, axes)`` per device under ``jax.shard_map`` on the
    8-device mesh, ``members`` a JAX process set; rows by device."""
    mesh = hvd.mesh()
    axes = tuple(mesh.axis_names)
    ps = hvd.add_process_set(members, name="t_" + "_".join(map(str,
                                                              members)))
    try:
        f = jax.jit(jax.shard_map(
            lambda *xs: jax.tree.map(lambda y: y[None],
                                     fn(*[x[0] for x in xs], ps, axes)),
            mesh=mesh, in_specs=P(axes), out_specs=P(axes)))
        got = f(*stacked_inputs)
    finally:
        hvd.remove_process_set(ps)
    return jax.tree.map(np.asarray, got)


def _stack(rows_by_rank, n=8):
    like = next(iter(rows_by_rank.values()))
    return jnp.asarray(np.stack([rows_by_rank.get(r, np.zeros_like(like))
                                 for r in range(n)]))


def _close(got, want, dtype):
    got = got.detach().to(torch.float64).numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "int32" or want.size == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= F32_REL * max(
            np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

IDS = [f"w{w}-{s}" for w, s in COMBOS]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_alltoall_even_matches_jax(worlds, jax_hvd, world, set_name, dtype):
    from horovod_tpu.collectives import ops as jops
    members = _members(world, set_name)
    want = _jax_run(jax_hvd, members,
                    lambda x, ps, axes: jops.alltoall(x, axes=axes,
                                                      process_set=ps),
                    [_stack({r: _even_input(world, set_name, dtype, r)
                             for r in members})])
    for r in members:
        got = worlds[world][r][set_name][dtype, "even"]
        assert got.dtype == getattr(torch, dtype)
        _close(got, want[r], "int32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_alltoall_with_splits_matches_jax_alltoallv(worlds, jax_hvd, world,
                                                    set_name, dtype):
    from horovod_tpu.collectives import ops as jops
    members = _members(world, set_name)
    m = len(members)
    max_count = 3
    counts = {r: np.asarray(_splits(members.index(r), m), np.int32)
              for r in members}
    assert max(max(c) for c in counts.values()) <= max_count
    data = {}
    for r in members:
        x = _uneven_input(world, set_name, dtype, r)
        data[r] = np.concatenate([x, np.zeros((3 * m - len(x), 2), x.dtype)])
    recv, rcounts = _jax_run(
        jax_hvd, members,
        lambda x, c, ps, axes: jops.alltoallv(x, c, axes=axes,
                                              process_set=ps,
                                              max_count=max_count),
        [_stack(data), _stack(counts)])
    for r in members:
        rc = rcounts[r]
        want = np.concatenate([recv[r][i, :rc[i]] for i in range(m)])
        for key in ("uneven", "uneven_async"):
            got, got_splits = worlds[world][r][set_name][dtype, key]
            assert got_splits.dtype == torch.int64
            assert got_splits.tolist() == rc.tolist()
            _close(got, want, "int32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_grouped_allgather_matches_jax(worlds, jax_hvd, world, set_name,
                                       dtype):
    """Each tensor against the concatenation in member order (the JAX
    in-step allgather needs equal dims: the equal-dim tensors against
    it too)."""
    from horovod_tpu.collectives import ops as jops
    members = _members(world, set_name)
    ins = {r: _grouped_inputs(world, set_name, dtype, r) for r in members}
    want_jax = _jax_run(
        jax_hvd, members,
        lambda a, b, ps, axes: [jops.allgather(a, axes=axes, process_set=ps),
                                jops.allgather(b, axes=axes,
                                               process_set=ps)],
        [_stack({r: ins[r][1] for r in members}),
         _stack({r: ins[r][2] for r in members})])
    for r in members:
        got = worlds[world][r][set_name][dtype, "grouped_allgather"]
        assert len(got) == 3
        _close(got[0], np.concatenate([ins[q][0] for q in members]),
               "int32")
        _close(got[1], want_jax[0][r], "int32")
        _close(got[2], want_jax[1][r], "int32")


@pytest.mark.parametrize("op", ["Sum", "Average"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_grouped_reducescatter_matches_jax(worlds, jax_hvd, world, set_name,
                                           dtype, op):
    from horovod_tpu.collectives import ops as jops
    members = _members(world, set_name)
    ins = {r: _grouped_inputs(world, set_name, dtype, r) for r in members}
    jop = getattr(jax_hvd, op)
    want = _jax_run(
        jax_hvd, members,
        lambda a, b, ps, axes: [
            jops.reducescatter(a, jop, axes=axes, process_set=ps),
            jops.reducescatter(b, jop, axes=axes, process_set=ps)],
        [_stack({r: ins[r][1] for r in members}),
         _stack({r: ins[r][2] for r in members})])
    for r in members:
        got = worlds[world][r][set_name][dtype, "grouped_reducescatter", op]
        assert len(got) == 2
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            _close(g, w[r], dtype)


@pytest.mark.parametrize("op", ["Sum", "Average"])
@pytest.mark.parametrize("tail", [False, True], ids=["1d", "trailing_dim"])
@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_sparse_allreduce_matches_dense(worlds, world, set_name, tail, op):
    for r in _members(world, set_name):
        res = worlds[world][r][set_name]
        got, dense = res["sparse", tail, op], res["dense", tail, op]
        assert got.is_sparse and got.is_coalesced()
        assert got.dtype == torch.float32
        _close(got.to_dense(), dense, "float32")
    # Every member holds the same coordinates.
    first = worlds[world][_members(world, set_name)[0]][set_name]
    for r in _members(world, set_name):
        assert torch.equal(
            worlds[world][r][set_name]["sparse", tail, op].indices(),
            first["sparse", tail, op].indices())


@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_allgather_object(worlds, world, set_name):
    members = _members(world, set_name)
    want = [{"rank": r, "pad": "x" * (7 * r)} for r in members]
    for r in members:
        assert worlds[world][r][set_name]["objects"] == want


@pytest.mark.parametrize("world,set_name", COMBOS, ids=IDS)
def test_integer_handles(worlds, world, set_name):
    members = _members(world, set_name)
    xs = {r: torch.arange(6, dtype=torch.float32) + r for r in members}
    total = sum(xs.values())
    m = len(members)
    for r in members:
        h = worlds[world][r][set_name]["handles"]
        assert h["polled_true"]
        assert torch.equal(h["sum"], total)
        for name in ("poll", "synchronize"):
            assert "has been synchronized" in h["spent", name]
        assert "was not created" in h["unknown"]
        assert h["inplace_is_input"] and torch.equal(h["inplace"], total)
        want_grouped = [total, total[:2] * 3]
        for got in (h["grouped"], h["grouped_inplace"]):
            assert isinstance(got, list)
            for g, w in zip(got, want_grouped):
                assert torch.equal(g, w)
        assert torch.equal(h["bcast"], xs[members[0]])
        assert torch.equal(h["gather"], torch.cat([xs[q] for q in members]))
        pos = members.index(r)
        full = sum(torch.arange(2 * m, dtype=torch.float32) + q
                   for q in members)
        assert torch.equal(h["scatter"], full[2 * pos:2 * pos + 2])


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def test_shapes_the_jax_package_refuses(world1):
    """The JAX package's shape rules: a dim that does not divide by the
    set size raises (upstream Horovod pads the low ranks instead), and
    splits must cover dim 0."""
    ps = world1.add_process_set([0])
    x = torch.ones(5, 2)
    assert torch.equal(thvd.reducescatter(x, process_set=ps), x)
    with pytest.raises(ValueError, match="splits"):
        thvd.alltoall(x, splits=[4], process_set=ps)
    with pytest.raises(ValueError, match="splits"):
        thvd.alltoall(x, splits=[5, 0], process_set=ps)
    with pytest.raises(ValueError, match="sparse"):
        thvd.sparse_allreduce_async(x)
    with pytest.raises(ValueError, match="Average/Sum"):
        thvd.sparse_allreduce_async(x.to_sparse(), op=thvd.Max)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
