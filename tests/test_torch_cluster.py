"""PyTorch/CUDA port: the launchers -- ``run(func, np=)``, ``ray/`` and
``spark/`` with its estimators -- against the JAX package's.

On the CPU (``HVD_TPU_FORCE_CPU=1``, gloo), the same seeded numpy inputs
go through both packages:

* the estimators' data plumbing writes the same shard files with equal
  arrays (the driver path, the streamed path, the fake-Spark streaming
  and executor paths, the validation stripe), and each package reads
  the other's shards alike;
* ``run(f, np=2, cpu=True)`` returns what the JAX ``run`` returns for
  the identity worker; a failing rank is named; a worker asked for the
  GPU where there is none raises, and the executor surfaces it;
* ``ElasticRayExecutor`` over a host file runs an elastic torch
  function at two workers (``tests/test_cluster_integrations.py``'s
  case);
* ``TorchEstimator`` and ``LightningEstimator`` at ``num_proc=2`` from
  the same torch weights as the JAX estimators: histories within 1e-5
  relative, predictions equal; the port's ``JaxEstimator`` (a port MLP
  holding the flax MLP's ``init(PRNGKey(0))`` weights, carried across
  by ``models/convert.py``) against the JAX one: history within 1e-4
  relative, argmax equal on at least 98 % of rows;
* ``make_flax_train_step(loss_fn=mse)`` one step and
  ``make_flax_train_loop(loss_fn=mse)`` two steps against the JAX
  package's within 1e-5.

The estimator fits run once a module, three at a time (each is a pair
of spawned workers); worker functions live at module level and this file
imports nothing heavy at its top, because every spawned worker imports
it.
"""

import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HVD_TPU_RENDEZVOUS_FILE", "HOROVOD_CHAOS",
                 "HVD_TPU_CHAOS")
HIST_TORCH_RTOL = 1e-5    # torch estimators: the same torch math
HIST_JAX_RTOL = 1e-4      # flax vs the port's MLP: roundoff only
ARGMAX_AGREE = 0.98
STEP_TOL = 1e-5


@pytest.fixture
def cpu_env(monkeypatch):
    """The launcher's identity env cleared and the CPU asked for."""
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_TPU_FORCE_CPU", "1")


def _blobs(n=64, d=4, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    centers = rng.randn(classes, d) * 3
    x = centers[y] + rng.randn(n, d) * 0.3
    return x.astype(np.float32), y.astype(np.int64)


# ---------------------------------------------------------------------------
# The import rule and the Spark / Store surface
# ---------------------------------------------------------------------------

def test_launcher_modules_import_no_optional_dependency():
    code = ("import sys\n"
            "import horovod_tpu_torch, horovod_tpu_torch.run, "
            "horovod_tpu_torch.ray, horovod_tpu_torch.spark, "
            "horovod_tpu_torch.mxnet\n"
            "from horovod_tpu_torch.run import run\n"
            "from horovod_tpu_torch.spark import TorchEstimator, JaxEstimator\n"
            "bad = [m for m in ('tensorflow', 'keras', 'pandas', 'pyarrow', "
            "'pyspark', 'ray', 'mxnet', 'jax', 'flax', 'optax', "
            "'horovod_tpu') if m in sys.modules]\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_spark_run_requires_pyspark():
    import horovod_tpu_torch.spark as s
    with pytest.raises(ImportError, match="pyspark"):
        s.run(lambda: None)


def test_spark_task_env_equals_jax():
    from horovod_tpu.spark import task_env as jtask_env
    from horovod_tpu_torch.spark import task_env
    env = task_env(rank=3, size=8, coordinator="10.0.0.5", port=1234)
    jenv = jtask_env(rank=3, size=8, coordinator="10.0.0.5", port=1234)
    assert {k: env[k] for k in jenv} == jenv
    assert env["MASTER_ADDR"] == "10.0.0.5" and env["MASTER_PORT"] == "1234"
    assert "HVD_TPU_FORCE_CPU" not in env     # the GPU unless asked


def test_store_layout_and_io_equal_jax(tmp_path):
    from horovod_tpu.spark import Store as JStore
    from horovod_tpu_torch.spark import LocalStore, Store
    store = Store.create(str(tmp_path))
    jstore = JStore.create(str(tmp_path))
    assert isinstance(store, LocalStore) and store.executor_writable
    for f in ("get_run_path", "get_checkpoint_path", "get_logs_path"):
        assert getattr(store, f)("run1") == getattr(jstore, f)("run1")
    for idx in (None, 0, 2):
        assert store.get_train_data_path(idx) == \
            jstore.get_train_data_path(idx)
        assert store.get_val_data_path(idx) == jstore.get_val_data_path(idx)
    ckpt = store.get_checkpoint_path("run1")
    store.write(os.path.join(ckpt, "model.bin"), b"abc")
    assert jstore.read(os.path.join(ckpt, "model.bin")) == b"abc"
    assert store.list_prefix(ckpt) == jstore.list_prefix(ckpt)
    store.delete(store.get_run_path("run1"))
    assert not store.exists(ckpt)
    with pytest.raises(ImportError, match="hdfs"):
        Store.create("hdfs://namenode/path")
    with pytest.raises(ValueError, match="mount"):
        Store.create("s3://bucket/path")


# ---------------------------------------------------------------------------
# Shards: the same files with equal arrays as the JAX package's
# ---------------------------------------------------------------------------

class _FakeRow:
    def __init__(self, d):
        self._d = d

    def asDict(self):
        return dict(self._d)


class _FakeCollected:
    def __init__(self, items):
        self._items = items

    def collect(self):
        return self._items


class _FakeRDD:
    """pyspark's ``RDD.mapPartitionsWithIndex().collect()``, each
    partition task run in turn."""

    def __init__(self, parts):
        self.parts = parts

    def mapPartitionsWithIndex(self, fn):
        out = []
        for i, part in enumerate(self.parts):
            out.extend(fn(i, iter(part)))
        return _FakeCollected(out)


class _FakeSparkDF:
    """A Spark DataFrame with partitioned rows behind ``.rdd``; streaming
    through the driver is refused."""

    def __init__(self, parts):
        self.rdd = _FakeRDD(parts)
        self.sparkSession = object()

    def toLocalIterator(self):
        raise AssertionError("driver streaming must not be used when the "
                             "executor path is available")


class _FakeStreamingDF:
    """A Spark DataFrame seen through ``toLocalIterator`` only."""

    def __init__(self, rows):
        self._rows = rows
        self.sparkSession = object()

    def toLocalIterator(self):
        yield from self._rows


def _spark_rows(n, seed=0):
    x, y = _blobs(n=n, d=2, seed=seed)
    order = np.random.RandomState(seed).permutation(n)
    return [_FakeRow({"x0": float(x[i, 0]), "x1": float(x[i, 1]),
                      "label": int(y[i])}) for i in order]


def _spark_parts(n, n_parts, seed=0):
    rows = _spark_rows(n, seed)
    rng = np.random.RandomState(seed + 1)
    cuts = sorted(rng.choice(range(1, n), n_parts - 1, replace=False))
    return [[rows[i] for i in p] for p in np.split(np.arange(n), cuts)]


def _shards_driver_dict(est, store):
    x, y = _blobs(n=11)
    return est._write_shards(store, est._iter_chunks(
        {"features": x, "labels": y}, None, None), 2, 0.0)


def _shards_tuple_val(est, store):
    x = np.arange(2000, dtype=np.float32)[:, None]
    y = np.arange(2000, dtype=np.int32)
    return est._write_shards(store, est._iter_chunks((x, y), None, None),
                             2, 0.1)


def _shards_streamed(est, store):
    def source():
        for c in range(13):
            base = c * 7
            feats = np.arange(base, base + 7,
                              dtype=np.float32)[:, None] * [1.0, 10.0]
            yield {"features": feats,
                   "labels": np.arange(base, base + 7, dtype=np.int32)}

    w = est._ShardWriter(store, 3, val_fraction=0.05, flush_rows=10)
    for chunk in est._iter_chunks(source(), None, None):
        w.add(chunk)
    return w.finish()


def _shards_pandas(est, store):
    import pandas as pd
    x, y = _blobs(n=37)
    df = pd.DataFrame({"f0": x[:, 0], "f1": x[:, 1], "f2": x[:, 2],
                       "f3": x[:, 3], "label": y})
    return est._write_shards(store, est._iter_chunks(
        df, ["f0", "f1", "f2", "f3"], ["label"]), 3, 0.2)


def _shards_spark_streaming(est, store):
    df = _FakeStreamingDF(_spark_rows(23))
    return est._write_shards(store, est._iter_chunks(
        df, ["x0", "x1"], ["label"], chunk_rows=10), 2, 0.0)


def _shards_spark_executors(est, store):
    df = _FakeSparkDF(_spark_parts(97, 6))
    return est._write_shards_on_executors(store, df, ["x0", "x1"],
                                          ["label"], 3, val_fraction=0.1)


SHARD_CASES = {"driver_dict": (_shards_driver_dict, 2),
               "tuple_val_stripe": (_shards_tuple_val, 2),
               "streamed_chunks": (_shards_streamed, 3),
               "pandas": (_shards_pandas, 3),
               "spark_streaming": (_shards_spark_streaming, 2),
               "spark_executors": (_shards_spark_executors, 3)}


def _read_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with np.load(path, allow_pickle=False) as z:
                out[os.path.relpath(path, root)] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shards_equal_jax(case, tmp_path):
    from horovod_tpu.spark import LocalStore as JStore
    from horovod_tpu.spark import estimator as jest
    from horovod_tpu_torch.spark import LocalStore
    from horovod_tpu_torch.spark import estimator as test_

    fn, num_proc = SHARD_CASES[case]
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    jval = fn(jest, JStore(str(jroot)))
    tval = fn(test_, LocalStore(str(troot)))
    assert tval == jval
    jfiles, tfiles = _read_tree(jroot), _read_tree(troot)
    assert jfiles and sorted(tfiles) == sorted(jfiles)
    for name, arrays in jfiles.items():
        assert sorted(tfiles[name]) == sorted(arrays) == ["features",
                                                          "labels"]
        for k, a in arrays.items():
            b = tfiles[name][k]
            assert b.dtype == a.dtype and np.array_equal(b, a), (name, k)
    # Each package reads the other's shards alike.
    store, jstore = LocalStore(str(jroot)), JStore(str(jroot))
    for r in range(num_proc):
        base = store.get_train_data_path(r)
        mine = test_._load_shard(store, base)
        theirs = jest._load_shard(jstore, base)
        assert all(np.array_equal(mine[k], theirs[k]) for k in mine)
        assert test_._shard_row_count(store, base) == \
            jest._shard_row_count(jstore, base)
        for (a, b), (c, d) in zip(test_._iter_shard_batches(store, base, 4),
                                  jest._iter_shard_batches(jstore, base, 4)):
            assert np.array_equal(a, c) and np.array_equal(b, d)


def test_executor_shards_reject_empty_rank(tmp_path):
    from horovod_tpu_torch.spark import LocalStore
    from horovod_tpu_torch.spark.estimator import _write_shards_on_executors
    rows = [_FakeRow({"x0": 1.0, "x1": 2.0, "label": 0}) for _ in range(3)]
    with pytest.raises(ValueError, match="zero rows"):
        _write_shards_on_executors(LocalStore(str(tmp_path)),
                                   _FakeSparkDF([rows[:2], rows[2:]]),
                                   ["x0", "x1"], ["label"], 3, 0.0)
    store = LocalStore(str(tmp_path))
    store.executor_writable = False
    assert _write_shards_on_executors(store, _FakeSparkDF([rows]),
                                      ["x0", "x1"], ["label"], 2,
                                      0.0) is None


# ---------------------------------------------------------------------------
# run(func, np=) and RayExecutor
# ---------------------------------------------------------------------------

def _identity_worker():
    return (os.environ["HOROVOD_RANK"], os.environ["HOROVOD_SIZE"])


def _failing_worker():
    if os.environ["HOROVOD_RANK"] == "1":
        raise ValueError("rank one fails")
    return 0


def _init_worker():
    import horovod_tpu_torch as hvd
    hvd.init()
    return str(hvd.core.state.global_state().device)


def test_run_identity_equals_jax(cpu_env):
    from horovod_tpu.run import run as jrun
    from horovod_tpu_torch.run import run
    want = [("0", "2"), ("1", "2")]
    assert jrun(_identity_worker, np=2, cpu=True) == want
    assert run(_identity_worker, np=2, cpu=True) == want


def test_run_names_the_failing_rank(cpu_env):
    from horovod_tpu_torch.run import run
    with pytest.raises(RuntimeError,
                       match=r"worker 1: ValueError: rank one fails"):
        run(_failing_worker, np=2, cpu=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU")
def test_run_refuses_to_fall_back_to_the_cpu(cpu_env, monkeypatch):
    """Without ``cpu=True`` or ``HVD_TPU_FORCE_CPU`` a worker's ``init()``
    asks for the GPU and raises; the executor names it."""
    from horovod_tpu_torch.run import run
    monkeypatch.delenv("HVD_TPU_FORCE_CPU")
    with pytest.raises(RuntimeError, match="worker 0: RuntimeError: no CUDA"):
        run(_init_worker, np=1)


def test_ray_executor_contract():
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=2, use_ray=None)
    assert ex.use_ray is False        # ray is not installed
    with pytest.raises(RuntimeError, match="start"):
        ex.run(_identity_worker)
    ex.start()
    with pytest.raises(RuntimeError, match="already started"):
        ex.start()
    ex.shutdown()


# ---------------------------------------------------------------------------
# ElasticRayExecutor
# ---------------------------------------------------------------------------

def _elastic_fn(target):
    """Elastic payload: ``target`` SGD steps on a 4 x 4 linear map, a
    commit each batch (``tests/test_cluster_integrations.py``'s
    ``_elastic_fn`` on the port)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    hvd.init()
    model = torch.nn.Linear(4, 4, bias=False)
    torch.nn.init.zeros_(model.weight)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())

    @elastic.run
    def train(state):
        while state.batch < target:
            opt.zero_grad()
            loss = ((model(torch.ones(2, 4)) - 1.0) ** 2).mean()
            loss.backward()
            opt.step()
            state.batch += 1
            state.commit()
        return state.batch

    done = train(elastic.TorchState(model=model, optimizer=opt, batch=0))
    return {"rank": hvd.rank(), "size": hvd.size(), "batches": done,
            "w": model.weight.detach().numpy().copy()}


def test_elastic_ray_executor_requires_source_without_ray():
    from horovod_tpu_torch.ray import ElasticRayExecutor
    with ElasticRayExecutor(min_workers=1) as ex:
        with pytest.raises(ImportError, match="host_file"):
            ex.run(_elastic_fn, args=(1,))


def test_elastic_ray_executor_runs_function(tmp_path, cpu_env):
    from horovod_tpu_torch.ray import ElasticRayExecutor
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("a\nb\n")
    with ElasticRayExecutor(min_workers=2, cpu=True,
                            host_file=str(hosts)) as ex:
        results = ex.run(_elastic_fn, args=(6,))
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["batches"] == 6 and r["size"] == 2 for r in results)
    # Six averaged steps: every rank holds the same weights, and they moved.
    assert np.array_equal(results[0]["w"], results[1]["w"])
    assert np.abs(results[0]["w"]).min() > 0


# ---------------------------------------------------------------------------
# Estimators against the JAX package's
# ---------------------------------------------------------------------------

class _TorchMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Linear(4, 16), torch.nn.ReLU(), torch.nn.Linear(16, 3))

    def forward(self, x):
        return self.net(x)


class _LightningMLP(_TorchMLP):
    """The LightningModule protocol without pytorch_lightning."""

    def training_step(self, batch, batch_idx):
        x, y = batch
        return {"loss": torch.nn.functional.cross_entropy(self(x), y)}

    def configure_optimizers(self):
        return torch.optim.Adam(self.parameters(), lr=0.05)


class _PortMLP(torch.nn.Module):
    """The flax ``Dense(16) -> relu -> Dense(3)`` MLP on the port's
    ``Dense`` (flax's names and ``[in, out]`` kernels)."""

    def __init__(self):
        super().__init__()
        from horovod_tpu_torch.models.layers import Dense
        self.Dense_0 = Dense(4, 16, device="cpu")
        self.Dense_1 = Dense(16, 3, device="cpu")

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


_LAZY = {}


def _make_flax_mlp():
    import flax.linen as nn

    class _FlaxMLP(nn.Module):
        """``tests/test_cluster_integrations.py``'s flax MLP."""

        @nn.compact
        def __call__(self, x, train: bool = True):
            x = nn.relu(nn.Dense(16)(x))
            return nn.Dense(3)(x)

    _FlaxMLP.__qualname__ = "_FlaxMLP"
    return _FlaxMLP


def __getattr__(name):
    """``_FlaxMLP``, built on first use: the JAX estimator pickles the
    module by reference, and a spawned worker that unpickles it imports
    flax only then (the port's workers never do)."""
    if name == "_FlaxMLP":
        if name not in _LAZY:
            _LAZY[name] = _make_flax_mlp()
        return _LAZY[name]
    raise AttributeError(name)


def _jax_init_params(module):
    import jax
    import jax.numpy as jnp
    v = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.float32),
                    train=False)
    return jax.tree.map(np.asarray, v["params"])


def _port_mlp_from(params):
    from horovod_tpu_torch.models.convert import params_from_jax
    model = _PortMLP()
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


FIT_KW = dict(num_proc=2, batch_size=8, epochs=3)
FIT_THREADS = 3      # fits at once: six spawned workers, not twelve


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Every estimator fit of the module, JAX and port, three at a
    time."""
    import horovod_tpu.spark as jspark
    import horovod_tpu_torch.spark as tspark

    x, y = _blobs(n=64)
    data = {"features": x, "labels": y}
    torch.manual_seed(0)
    torch_mlp, light_mlp = _TorchMLP(), _LightningMLP()
    flax_mod = getattr(sys.modules[__name__], "_FlaxMLP")
    port_mlp = _port_mlp_from(_jax_init_params(flax_mod()))

    def job(pkg, name, cls, **kw):
        store = pkg.LocalStore(str(tmp_path_factory.mktemp(name)))
        return lambda: cls(store=store, **FIT_KW, **kw).fit(data)

    jobs = {
        "jax_torch": job(jspark, "jt", jspark.TorchEstimator,
                         model=torch_mlp, lr=0.05),
        "port_torch": job(tspark, "pt", tspark.TorchEstimator,
                          model=torch_mlp, lr=0.05),
        "jax_lightning": job(jspark, "jl", jspark.LightningEstimator,
                             model=light_mlp),
        "port_lightning": job(tspark, "pl", tspark.LightningEstimator,
                              model=light_mlp),
        "jax_jax": job(jspark, "jj", jspark.JaxEstimator,
                       model=flax_mod(), lr=0.05),
        "port_jax": job(tspark, "pj", tspark.JaxEstimator,
                        model=port_mlp, lr=0.05),
    }
    with pytest.MonkeyPatch.context() as mp:
        for k in _LAUNCHER_ENV:
            mp.delenv(k, raising=False)
        mp.setenv("HVD_TPU_FORCE_CPU", "1")
        with concurrent.futures.ThreadPoolExecutor(FIT_THREADS) as pool:
            futs = {k: pool.submit(fn) for k, fn in jobs.items()}
            out = {k: f.result() for k, f in futs.items()}
        out["x"], out["y"] = x, y
        yield out


@pytest.mark.parametrize("kind", ["torch", "lightning"])
def test_torch_estimators_equal_jax(fits, kind):
    jfit, tfit = fits[f"jax_{kind}"], fits[f"port_{kind}"]
    assert len(tfit.history) == FIT_KW["epochs"]
    np.testing.assert_allclose(tfit.history, jfit.history,
                               rtol=HIST_TORCH_RTOL)
    assert tfit.history[-1] < tfit.history[0]
    assert np.array_equal(tfit.transform(fits["x"]),
                          jfit.transform(fits["x"]))
    assert (tfit.transform(fits["x"]).argmax(-1) == fits["y"]).mean() > 0.8


def test_jax_estimator_equals_jax(fits):
    jfit, tfit = fits["jax_jax"], fits["port_jax"]
    np.testing.assert_allclose(tfit.history, jfit.history,
                               rtol=HIST_JAX_RTOL)
    assert tfit.history[-1] < tfit.history[0]
    agree = (tfit.transform(fits["x"]).argmax(-1)
             == jfit.transform(fits["x"]).argmax(-1)).mean()
    assert agree >= ARGMAX_AGREE
    assert (tfit.transform(fits["x"]).argmax(-1) == fits["y"]).mean() > 0.8


def test_torch_model_reads_checkpoint_on_the_callers_device(fits):
    tfit = fits["port_torch"]
    assert next(tfit.model.parameters()).device.type == "cpu"
    assert not tfit.model.training
    assert next(fits["port_jax"].module.parameters()).device.type == "cpu"


def test_lightning_estimator_rejects_plain_module():
    from horovod_tpu_torch.spark import LightningEstimator
    with pytest.raises(TypeError, match="training_step"):
        LightningEstimator(model=_TorchMLP())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU")
def test_estimator_fit_refuses_to_fall_back_to_the_cpu(tmp_path, cpu_env,
                                                       monkeypatch):
    """``fit`` passes the caller's switch: with ``HVD_TPU_FORCE_CPU``
    unset its workers ask for the GPU, and their failure surfaces."""
    from horovod_tpu_torch.spark import LocalStore, TorchEstimator
    monkeypatch.delenv("HVD_TPU_FORCE_CPU")
    x, y = _blobs(n=16)
    est = TorchEstimator(model=_TorchMLP(), num_proc=1, batch_size=8,
                         store=LocalStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="worker 0: RuntimeError: no CUDA"):
        est.fit({"features": x, "labels": y})


# ---------------------------------------------------------------------------
# make_flax_train_step / make_flax_train_loop with loss_fn=
# ---------------------------------------------------------------------------

@pytest.fixture
def worlds(cpu_env):
    """The port as a CPU world of one and the JAX package on a one-device
    mesh."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    yield jhvd, thvd
    jhvd.shutdown()
    thvd.shutdown()


def _mse_data(k):
    rng = np.random.RandomState(3)
    x = rng.randn(k, 8, 4).astype(np.float32)
    y = rng.randn(k, 8).astype(np.float32)
    return x, y


@pytest.mark.parametrize("k", [1, 2])
def test_flax_step_loss_fn_equals_jax(worlds, k):
    """``loss_fn(logits, y)``: mse on one output, k steps of SGD(0.1,
    momentum 0.9) -- one ``make_flax_train_step`` call (k = 1) or one
    ``make_flax_train_loop`` window (k = 2) -- in both packages."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.training import (make_flax_train_loop as jloop,
                                      make_flax_train_step as jstep)
    from horovod_tpu_torch.training import (make_flax_train_loop,
                                            make_flax_train_step)
    jhvd, thvd = worlds

    import flax.linen as nn

    class One(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = True):
            x = nn.relu(nn.Dense(16)(x))
            return nn.Dense(1)(x)

    def jmse(logits, y):
        return jnp.mean((jnp.squeeze(logits, -1) - y) ** 2)

    def tmse(logits, y):
        return ((logits.squeeze(-1) - y) ** 2).mean()

    x, y = _mse_data(k)
    module = One()
    params = jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4)), train=False)["params"])
    jopt = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    jp = jhvd.replicate(jax.tree.map(jnp.asarray, params))
    js = jhvd.replicate({})
    jo = jhvd.replicate(jopt.init(jax.tree.map(jnp.asarray, params)))
    if k == 1:
        jp, js, jo, jl = jstep(module.apply, jopt, loss_fn=jmse)(
            jp, js, jo, jhvd.shard_batch((jnp.asarray(x[0]),
                                          jnp.asarray(y[0]))))
        jlosses = [float(jl)]
    else:
        jp, js, jo, jl = jloop(module.apply, jopt, loss_fn=jmse,
                               steps_per_execution=k)(
            jp, js, jo, jhvd.shard_steps(jhvd.stack_steps(
                [(jnp.asarray(x[i]), jnp.asarray(y[i])) for i in range(k)])))
        jlosses = [float(v) for v in np.asarray(jl).reshape(-1)]

    model = _port_mlp_one(params)
    topt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    if k == 1:
        tlosses = [float(make_flax_train_step(model, topt, loss_fn=tmse)(
            (torch.tensor(x[0]), torch.tensor(y[0]))))]
    else:
        out = make_flax_train_loop(model, topt, loss_fn=tmse,
                                   steps_per_execution=k)(
            (torch.tensor(x), torch.tensor(y)))
        tlosses = [float(v) for v in out]
    np.testing.assert_allclose(tlosses, jlosses, rtol=STEP_TOL)
    want = jax.tree.map(np.asarray, jax.device_get(jp))
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for layer, leaves in want.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(got[f"{layer}.{leaf}"],
                                       np.asarray(v).reshape(
                                           got[f"{layer}.{leaf}"].shape),
                                       atol=STEP_TOL)


def _port_mlp_one(params):
    from horovod_tpu_torch.models.convert import params_from_jax
    from horovod_tpu_torch.models.layers import Dense

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(4, 16, device="cpu")
            self.Dense_1 = Dense(16, 1, device="cpu")

        def forward(self, x):
            return self.Dense_1(torch.relu(self.Dense_0(x)))

    model = One()
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model
