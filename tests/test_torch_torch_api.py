"""PyTorch/CUDA port: the ``horovod.torch`` call surface, against the JAX
package's shim ``horovod_tpu.torch_api``.

* The shim's public names are a subset of the port's top level, and the
  names of its ``elastic`` module a subset of ``hvd.elastic``'s; ``join``
  returns -1 at world 1 (the drain: ``tests/test_torch_join.py``);
  ``start_timeline`` /
  ``stop_timeline`` write and close a timeline (``steps_per_execution``
  returns the resolved value: ``tests/test_torch_train_loop.py``).
* Horovod's keywords and the second positional parameter of
  ``allreduce`` (Horovod's ``average``; a ReduceOp there is ``op``),
  ``name=``, ``compression=``, the build probes.
* The per-op, per-set collective counters (calls, bytes, integer
  handles) across a registry reset and ``HOROVOD_METRICS=0``.
* Every module of the port imports in a fresh interpreter without
  ``jax`` or ``horovod_tpu`` in ``sys.modules``.
* In a gloo world of 2 (this file, run as a script, is each rank):
  ``DistributedOptimizer(process_set=, sparse_as_dense=True)`` on a model
  with ``nn.Embedding(sparse=True)`` equals one process training on the
  two ranks' batches concatenated, within 1e-6 (three SGD steps); a
  sparse gradient without ``sparse_as_dense`` raises.
* In a gloo world of 4: ``SyncBatchNorm(process_set={0, 1})`` (ranks 2
  and 3 on ``{2, 3}``) equals a world-2 run of the same two ranks' data
  (output, dx, weight and bias gradients, running statistics), within
  1e-5 of max |value|; and each pair equals one process's
  ``nn.BatchNorm2d`` on the pair's batches concatenated.
* Against the JAX package's shim, in both worlds: every member of a
  two-member set, on rank 0's data, trains
  ``DistributedOptimizer(process_set=, sparse_as_dense=True)`` with
  ``op=Sum`` and ``op=Average`` to the shim's weights within 1e-6, and
  its ``SyncBatchNorm(process_set=)`` step gives the shim's output, dx,
  weight and bias gradients and running statistics within 1e-5 of max
  |value| (the shim, one controller, replicates a tensor to each rank of
  a set that spans its two-device world; see ``shim_pair``).
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE")
OPT_ATOL = 1e-6
BN_REL = 1e-5
LATER_ITEMS = set()                 # names later ROADMAP items own
RAISING = {}                        # names that raise naming their item
TIMELINE_CALLS = ("start_timeline", "stop_timeline")
VOCAB, DIM, CLASSES, STEPS = 12, 4, 3, 3
SHIM_OPS = ("Sum", "Average")
BN_C = 5


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------


def _public_api(module):
    """Names a user calls: public, not a module, not typing's."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", "") not in ("typing", "__future__")
            and n != "annotations"}


def test_shim_names_are_a_subset_of_the_port():
    import horovod_tpu.torch_api as shim
    missing = _public_api(shim) - set(dir(thvd)) - LATER_ITEMS
    assert not missing, sorted(missing)


def test_shim_elastic_names_are_a_subset_of_the_port():
    import horovod_tpu.torch_api as shim
    assert inspect.ismodule(thvd.elastic)
    missing = _public_api(shim.elastic) - set(dir(thvd.elastic))
    assert not missing, sorted(missing)
    assert {"run", "State", "ObjectState", "TorchState", "ElasticSampler",
            "HostDiscoveryScript", "chaos", "ChaosCommError",
            "ChaosInjector"} <= set(dir(thvd.elastic))
    assert thvd.HostsUpdatedInterrupt is \
        thvd.core.exceptions.HostsUpdatedInterrupt


@pytest.mark.parametrize("name", ["join"] + sorted(RAISING)
                         + list(TIMELINE_CALLS))
def test_later_items_raise_naming_their_item(name, tmp_path):
    """``join`` (ROADMAP item 1.8, ported) is a barrier returning -1 at
    world 1, after ``init()``.  ``start_timeline`` needs ``init()``
    first (as the reference's), then writes a Chrome trace;
    ``stop_timeline`` closes it (twice is a no-op)."""
    if name in RAISING:
        with pytest.raises(NotImplementedError, match=RAISING[name]):
            getattr(thvd, name)()
        return
    if name == "join":
        with pytest.raises(thvd.core.exceptions.NotInitializedError):
            thvd.join()
        thvd.init(device="cpu")
        try:
            assert thvd.join() == -1
        finally:
            thvd.shutdown()
        return
    path = tmp_path / "timeline.json"
    if name == "start_timeline":
        with pytest.raises(thvd.core.exceptions.NotInitializedError):
            thvd.start_timeline(str(path))
    thvd.init(device="cpu")
    try:
        thvd.start_timeline(str(path))
        if name == "stop_timeline":
            thvd.stop_timeline()
            thvd.stop_timeline()
    finally:
        thvd.shutdown()
    with open(path) as f:
        events = json.load(f)
    assert events[0]["name"] == "clock_anchor"


def test_no_module_imports_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    ``jax`` and ``horovod_tpu`` out of ``sys.modules``.  The TensorFlow
    and Keras shims are imported last, after ``tensorflow`` and
    ``keras`` (TensorFlow imports JAX where JAX is installed), and may
    add no module of either to what those loaded."""
    code = (
        "import importlib, importlib.util, os, pkgutil, sys\n"
        "import horovod_tpu_torch as p\n"
        "tf_bound = ('horovod_tpu_torch.tensorflow', "
        "'horovod_tpu_torch.keras')\n"
        "def walk(path, prefix):\n"   # walk_packages imports each package
        "    for m in pkgutil.iter_modules([path], prefix):\n"
        "        yield m.name\n"
        "        if m.ispkg:\n"
        "            yield from walk(os.path.join(path, m.name.rsplit("
        "'.', 1)[1]), m.name + '.')\n"
        "def bad(mods):\n"
        "    return sorted(m for m in mods if m == 'jax' or "
        "m.startswith('jax.') or m == 'horovod_tpu' or "
        "m.startswith('horovod_tpu.'))\n"
        "every = list(walk(p.__path__[0], 'horovod_tpu_torch.'))\n"
        "names = [n for n in every if not n.startswith(tf_bound)]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "found = bad(sys.modules)\n"
        "if importlib.util.find_spec('tensorflow'):\n"
        "    import tensorflow, keras\n"
        "    before = set(sys.modules)\n"
        "    shims = [n for n in every if n.startswith(tf_bound)]\n"
        "    for n in shims:\n"
        "        importlib.import_module(n)\n"
        "    found += bad(set(sys.modules) - before)\n"
        "    names += shims\n"
        "print(len(names), found)\n"
        "sys.exit(1 if found or len(names) < 40 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def world1():
    env = {k: os.environ.pop(k) for k in _LAUNCHER_ENV if k in os.environ}
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    os.environ.update(env)


def test_second_positional_is_average_or_an_op(world1):
    x = torch.tensor([1.0, 2.0, 3.0])
    for arg in (None, True, False, thvd.Sum, thvd.Average, thvd.Max):
        np.testing.assert_array_equal(thvd.allreduce(x, arg).numpy(),
                                      x.numpy())
    assert torch.equal(thvd.allreduce(x, average=False, name="loss"), x)
    assert torch.equal(thvd.allreduce(x, op=thvd.Min, name="m"), x)
    with pytest.raises(ValueError, match="not both"):
        thvd.allreduce(x, average=True, op=thvd.Sum)
    with pytest.raises(ValueError, match="twice"):
        thvd.allreduce(x, thvd.Sum, op=thvd.Sum)
    i = torch.tensor([7, -7], dtype=torch.int32)
    assert torch.equal(thvd.allreduce(i, True), i)
    half = thvd.allreduce(x, compression=thvd.Compression.fp16)
    assert half.dtype == torch.float32 and torch.equal(half, x)
    with pytest.raises(ValueError, match="exchange codec"):
        thvd.allreduce(x, compression="powersgd:2")
    y = x.clone()
    assert thvd.allreduce_(y, op=thvd.Sum, name="y") is y
    ts = [x.clone(), torch.ones(2, dtype=torch.bfloat16)]
    assert thvd.grouped_allreduce_(ts, False) == ts
    out = thvd.grouped_allreduce(ts, compression=thvd.Compression.bf16)
    assert [t.dtype for t in out] == [torch.float32, torch.bfloat16]


def test_build_probes_and_identity(world1):
    assert thvd.is_homogeneous()
    assert thvd.gloo_built() and not thvd.mpi_built()
    assert not thvd.mpi_threads_supported() and not thvd.tpu_built()
    assert thvd.rocm_built() == (torch.version.hip is not None)
    assert thvd.get_process_set().ranks == (0,)


def test_collective_counters_per_op_and_set(world1, monkeypatch):
    """Calls, input bytes and integer handles per op kind and set; the
    cached counters follow a new registry and ``HOROVOD_METRICS=0``."""
    from horovod_tpu_torch.timeline import metrics
    x = torch.ones(4)
    one = thvd.add_process_set([0])
    for _ in range(2):
        metrics.reset_metrics()
        thvd.allreduce(x)
        thvd.synchronize(thvd.allreduce_async(x, process_set=one))
        thvd.allgather(x[:3], process_set=one)
        assert metrics.collective_totals() == {
            ("allreduce", "global"): {"calls": 1, "bytes": 16,
                                      "handles": 0},
            ("allreduce", one.name): {"calls": 1, "bytes": 16,
                                      "handles": 1},
            ("allgather", one.name): {"calls": 1, "bytes": 12,
                                      "handles": 0}}
    monkeypatch.setenv("HOROVOD_METRICS", "0")
    thvd.allreduce(x)
    assert metrics.collective_counters("allreduce", "global")[
        "calls"].value == 0
    monkeypatch.delenv("HOROVOD_METRICS")
    assert metrics.collective_totals()[("allreduce", "global")][
        "calls"] == 1


def test_optimizer_refuses_before_changing_the_optimizer(world1):
    lin = torch.nn.Linear(2, 2)
    sgd = torch.optim.SGD(lin.parameters(), lr=0.1)
    with pytest.raises(thvd.ProcessSetError):
        thvd.DistributedOptimizer(sgd, process_set="nope")
    assert type(sgd) is torch.optim.SGD
    opt = thvd.DistributedOptimizer(sgd, num_groups=4,
                                    process_set=thvd.add_process_set([0]))
    assert opt._process_set.ranks == (0,)


def test_skip_synchronize_steps_on_the_synchronized_gradients(world1):
    """Upstream's clipping idiom: ``synchronize()``, clip, then ``step()``
    inside ``skip_synchronize()`` exchanges nothing more."""
    from horovod_tpu_torch.timeline.metrics import exchange_totals
    lin = torch.nn.Linear(3, 2)
    opt = thvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(),
                                                    lr=0.1))
    lin(torch.ones(4, 3)).sum().backward()
    opt.synchronize()
    torch.nn.utils.clip_grad_norm_(lin.parameters(), 0.5)
    before = exchange_totals()["buckets"]
    w = lin.weight.detach().clone()
    with opt.skip_synchronize():
        opt.step()
    assert exchange_totals()["buckets"] == before
    assert not torch.equal(lin.weight, w)
    lin(torch.ones(4, 3)).sum().backward()
    opt.step()                            # outside: synchronizes again
    assert exchange_totals()["buckets"] == before + 1


# ---------------------------------------------------------------------------
# Gloo worlds
# ---------------------------------------------------------------------------


class _Tagger(torch.nn.Module):
    def __init__(self, sparse):
        super().__init__()
        self.emb = torch.nn.Embedding(VOCAB, DIM, sparse=sparse)
        self.out = torch.nn.Linear(DIM, CLASSES)

    def forward(self, tokens):
        return self.out(self.emb(tokens))


def _tagger(sparse):
    torch.manual_seed(5)
    return _Tagger(sparse)


def _tag_batch(rank, step):
    rng = np.random.RandomState(50 + 10 * step + rank)
    return (torch.from_numpy(rng.randint(0, VOCAB, (4, 3))),
            torch.from_numpy(rng.randint(0, CLASSES, (4, 3))))


def _tag_loss(model, batch):
    tokens, labels = batch
    return torch.nn.functional.cross_entropy(
        model(tokens).reshape(-1, CLASSES), labels.reshape(-1))


def _train_tagger(api, ps, data_rank, op):
    """Three SGD steps of ``api.DistributedOptimizer(process_set=ps,
    sparse_as_dense=True, op=op)`` on ``data_rank``'s batches; ``api`` is
    the port or the JAX package's shim, which share the call."""
    model = _tagger(sparse=True)
    opt = api.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        named_parameters=model.named_parameters(), process_set=ps,
        sparse_as_dense=True, op=op)
    for step in range(STEPS):
        opt.zero_grad()
        _tag_loss(model, _tag_batch(data_rank, step)).backward()
        opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _strict_refusal(rank):
    """A sparse gradient without ``sparse_as_dense``: the message."""
    model2 = _tagger(sparse=True)
    strict = thvd.DistributedOptimizer(
        torch.optim.SGD(model2.parameters(), lr=0.5))
    try:
        # The bucket's last gradient launches it from its hook, so the
        # refusal comes out of backward().
        _tag_loss(model2, _tag_batch(rank, 0)).backward()
        strict.step()
        raised = "no error"
    except ValueError as e:
        raised = str(e)
    return raised


def _bn_data(rank):
    rng = np.random.RandomState(70 + rank)
    x = (2 * rng.randn(3, BN_C, 4, 4) + 0.5).astype(np.float32)
    dy = rng.randn(3, BN_C, 4, 4).astype(np.float32)
    return x, dy


def _bn_layer(process_set=None, api=thvd):
    m = api.SyncBatchNorm(BN_C, momentum=0.3, device="cpu",
                          process_set=process_set)
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, BN_C))
        m.bias.copy_(torch.linspace(-0.2, 0.2, BN_C))
    return m


def _bn_step(m, x, dy):
    cl = dict(memory_format=torch.channels_last)
    xt = torch.from_numpy(x).contiguous(**cl).requires_grad_(True)
    y = m(xt)
    y.backward(torch.from_numpy(dy).contiguous(**cl))
    return {"y": y.detach(), "dx": xt.grad, "dw": m.weight.grad,
            "db": m.bias.grad, "mean": m.running_mean.clone(),
            "var": m.running_var.clone()}


def _worker(rank: int, world: int, store_path: str, out: str) -> None:
    import torch.distributed as dist
    thvd.init(device="cpu", store=dist.FileStore(store_path, world),
              rank=rank, size=world)
    res = {}
    if world == 2:
        pair = thvd.add_process_set([0, 1], name="pair")
        res["tagger"] = _train_tagger(thvd, pair, rank, thvd.Average)
        res["strict"] = _strict_refusal(rank)
        res["bn"] = _bn_step(_bn_layer(), *_bn_data(rank))
    else:
        pairs = [thvd.add_process_set([0, 1]), thvd.add_process_set([2, 3])]
        pair = pairs[rank // 2]
        res["bn"] = _bn_step(_bn_layer(pair), *_bn_data(rank))
    # Against the shim: every member of a two-member set on rank 0's data.
    res["shim_opt"] = {op: _train_tagger(thvd, pair, 0, getattr(thvd, op))
                       for op in SHIM_OPS}
    res["shim_bn"] = _bn_step(_bn_layer(pair), *_bn_data(0))
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
    return {w: _run_world(tmp_path_factory.mktemp(f"api{w}"), w)
            for w in (2, 4)}


def test_sparse_as_dense_optimizer_equals_one_process(worlds):
    model = _tagger(sparse=False)
    sgd = torch.optim.SGD(model.parameters(), lr=0.5)
    for step in range(STEPS):
        sgd.zero_grad()
        batches = [_tag_batch(r, step) for r in range(2)]
        both = tuple(torch.cat(parts) for parts in zip(*batches))
        _tag_loss(model, both).backward()
        sgd.step()
    want = model.state_dict()
    for r in range(2):
        got = worlds[2][r]["tagger"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=OPT_ATOL, err_msg=k)
        assert "sparse_as_dense=True" in worlds[2][r]["strict"]


@pytest.fixture(scope="module")
def shim_pair():
    """The same layer and optimizer through the JAX package's shim
    (``horovod_tpu.torch_api``) on a set of two ranks.  The shim is one
    controller: it hands a torch tensor to every rank of its world, and
    its collectives refuse a rank stack of another length than the set's
    (``horovod_tpu/collectives/eager.py::_to_global``), so its set is
    ``[0, 1]`` of a two-device JAX world, fed rank 0's data as the port's
    members are."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu.torch_api as shim
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        ps = shim.add_process_set([0, 1])
        return {"opt": {op: _train_tagger(shim, ps, 0, getattr(shim, op))
                        for op in SHIM_OPS},
                "bn": _bn_step(_bn_layer(ps, api=shim), *_bn_data(0))}
    finally:
        jhvd.shutdown()


@pytest.mark.parametrize("op", SHIM_OPS)
@pytest.mark.parametrize("world", [2, 4])
def test_sparse_as_dense_process_set_optimizer_matches_the_shim(
        worlds, shim_pair, world, op):
    want = shim_pair["opt"][op]
    for r in range(world):
        got = worlds[world][r]["shim_opt"][op]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=OPT_ATOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("key", ["y", "dx", "dw", "db", "mean", "var"])
@pytest.mark.parametrize("world", [2, 4])
def test_sync_batch_norm_process_set_matches_the_shim(
        worlds, shim_pair, world, key):
    for r in range(world):
        got = worlds[world][r]["shim_bn"][key]
        assert _rel(got, shim_pair["bn"][key]) <= BN_REL, (r, key)


def _rel(got, want):
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


@pytest.mark.parametrize("key", ["y", "dx", "dw", "db", "mean", "var"])
def test_sync_batch_norm_process_set_equals_a_world_of_two(worlds, key):
    for r in (0, 1):
        got = worlds[4][r]["bn"][key]
        want = worlds[2][r]["bn"][key]
        assert _rel(got, want) <= BN_REL, (r, key)


@pytest.mark.parametrize("pair", [(0, 1), (2, 3)])
def test_sync_batch_norm_pairs_equal_one_process(worlds, pair):
    xs, dys = zip(*[_bn_data(r) for r in pair])
    m = torch.nn.BatchNorm2d(BN_C, momentum=0.3)
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, BN_C))
        m.bias.copy_(torch.linspace(-0.2, 0.2, BN_C))
    x = torch.from_numpy(np.concatenate(xs)).requires_grad_(True)
    y = m(x)
    y.backward(torch.from_numpy(np.concatenate(dys)))
    for i, r in enumerate(pair):
        got = worlds[4][r]["bn"]
        rows = slice(3 * i, 3 * i + 3)
        assert _rel(got["y"], y.detach()[rows]) <= BN_REL
        assert _rel(got["dx"], x.grad[rows]) <= BN_REL
        assert _rel(got["mean"], m.running_mean) <= BN_REL
        assert _rel(got["var"], m.running_var) <= BN_REL
    # weight / bias gradients: each rank's LOCAL sums, which add up to the
    # one process's.
    for key, want in (("dw", m.weight.grad), ("db", m.bias.grad)):
        total = sum(worlds[4][r]["bn"][key] for r in pair)
        assert _rel(total, want) <= BN_REL


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
