"""PyTorch/CUDA port: the MXNet shim (``horovod_tpu_torch.mxnet``) against
the JAX package's, with a fake ``mxnet`` module.

MXNet is EOL and installed nowhere, so -- as ``tests/test_mxnet_api.py``
does for the JAX shim -- a minimal fake (NDArray with ``asnumpy`` /
``__setitem__``, ``mx.nd.array``, ``mx.optimizer.Optimizer``,
``mx.gluon.Trainer``) is put in ``sys.modules`` and every public shim
function runs.  Each of that file's cases runs through the port at a CPU
world of one and through the JAX shim on a one-device mesh; the outputs
(values, dtypes, contexts, the optimizer's recorded updates, the
trainer's scale) must be equal.  Without ``mxnet`` the tensor APIs raise
with guidance and the identity functions still work.
"""

import sys
import types

import numpy as np
import pytest

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HVD_TPU_RENDEZVOUS_FILE")


class FakeNDArray:
    def __init__(self, data, ctx="cpu(0)", dtype=None):
        self._a = np.array(data, dtype=dtype)
        self.context = ctx

    def asnumpy(self):
        return self._a.copy()

    @property
    def shape(self):
        return self._a.shape

    def __setitem__(self, key, value):
        if isinstance(value, FakeNDArray):
            value = value._a
        self._a[key] = np.asarray(value, self._a.dtype)


class FakeParameter:
    def __init__(self, value, grad_req="write"):
        self._data = FakeNDArray(value)
        self._grad = FakeNDArray(np.ones_like(np.asarray(value)))
        self.grad_req = grad_req

    def data(self):
        return self._data

    def list_grad(self):
        return [self._grad]


class FakeOptimizer:
    """Stands in for ``mx.optimizer.Optimizer``: records update calls."""

    def __init__(self):
        self.rescale_grad = 1.0
        self.updates = []

    def update(self, index, weight, grad, state):
        self.updates.append(("update", index))

    def update_multi_precision(self, index, weight, grad, state):
        self.updates.append(("ump", index))


def _build_fake_mxnet():
    mx = types.ModuleType("mxnet")
    nd = types.ModuleType("mxnet.nd")
    nd.array = FakeNDArray
    optimizer = types.ModuleType("mxnet.optimizer")
    optimizer.Optimizer = FakeOptimizer
    gluon = types.ModuleType("mxnet.gluon")

    class Trainer:
        def __init__(self, params, optimizer, optimizer_params=None,
                     kvstore=None):
            vals = params.values() if hasattr(params, "values") else params
            self._params = list(vals)
            self._scale = (optimizer_params or {}).get("rescale_grad", 1.0)

    gluon.Trainer = Trainer
    mx.nd, mx.optimizer, mx.gluon = nd, optimizer, gluon
    return mx


@pytest.fixture
def shims(monkeypatch):
    """The fake ``mxnet``; the port at a CPU world of one and the JAX
    package on a one-device mesh."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu.mxnet as jmx
    import horovod_tpu_torch.mxnet as tmx
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setitem(sys.modules, "mxnet", _build_fake_mxnet())
    tmx.init(device="cpu")
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    yield jmx, tmx
    jhvd.shutdown()
    tmx.shutdown()


def _nd(out):
    """An NDArray (or a list/tuple of them) as comparable values."""
    if isinstance(out, (list, tuple)):
        return [_nd(o) for o in out]
    return (out.asnumpy(), str(out.asnumpy().dtype), out.context)


def _case_allreduce(h):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = FakeNDArray(x)
    ret = h.allreduce_(t, op=h.Sum, name="mx.ar_")
    return [_nd(h.allreduce(FakeNDArray(x), name="mx.ar")),
            _nd(h.allreduce(FakeNDArray(x), average=False,
                            name="mx.ar_sum")),
            _nd(h.allreduce(FakeNDArray(x), op=h.Average,
                            prescale_factor=2.0, postscale_factor=0.5)),
            ret is t, _nd(t)]


def _case_grouped(h):
    xs = [np.arange(4, dtype=np.float32),
          np.arange(8, dtype=np.float32).reshape(1, -1)]
    rs_in = np.arange(2, dtype=np.float32).reshape(1, 2)
    return [_nd(h.grouped_allreduce([FakeNDArray(a) for a in xs],
                                    name="mx.gar")),
            _nd(h.grouped_allreduce([FakeNDArray(a) for a in xs],
                                    average=False)),
            _nd(h.grouped_allgather([FakeNDArray(a) for a in xs],
                                    name="mx.gag")),
            _nd(h.grouped_reducescatter([FakeNDArray(rs_in)],
                                        name="mx.grs"))]


def _case_gather_broadcast(h):
    x = np.arange(3, dtype=np.float32)
    t = FakeNDArray(x * 0 + 5)
    ret = h.broadcast_(t, 0, name="mx.bc_")
    rs_in = np.arange(2, dtype=np.float32).reshape(1, 2)
    return [_nd(h.allgather(FakeNDArray(x), name="mx.ag")),
            _nd(h.broadcast(FakeNDArray(x), root_rank=0, name="mx.bc")),
            ret is t, _nd(t),
            _nd(h.reducescatter(FakeNDArray(rs_in), op=h.Sum,
                                name="mx.rs"))]


def _case_alltoall(h):
    x = np.arange(2, dtype=np.float32).reshape(1, 2)
    splits = np.array([3], np.int32)
    data = np.arange(3, dtype=np.float64)[:, None]
    recv, rsplits = h.alltoall(FakeNDArray(data, dtype=np.float64),
                               splits=FakeNDArray(splits), name="mx.a2av")
    return [_nd(h.alltoall(FakeNDArray(x), name="mx.a2a")), _nd(recv),
            _nd(rsplits)]


def _case_broadcast_parameters(h):
    p = FakeParameter(np.arange(4.0))
    raw = FakeNDArray(np.arange(3.0))
    h.broadcast_parameters({"w": p, "b": raw}, root_rank=0)
    with pytest.raises(ValueError, match="dict-like"):
        h.broadcast_parameters([p])
    got = h.broadcast_object({"step": 3, "arr": np.arange(2.0)},
                             root_rank=0)
    return [_nd(p.data()), _nd(raw), got["step"], got["arr"],
            h.allgather_object({"r": 0}, name="mx.ago"), h.size()]


def _case_distributed_optimizer(h):
    opt = h.DistributedOptimizer(FakeOptimizer(), op=h.Sum)
    g = FakeNDArray(np.ones(4, np.float32))
    opt.update(0, FakeNDArray(np.zeros(4)), g, None)
    gs = [FakeNDArray(np.ones(2, np.float32)),
          FakeNDArray(np.full(2, 2.0, np.float32))]
    opt.update_multi_precision((1, 2), [None, None], gs, None)
    return [_nd(g), _nd(gs), opt.updates]


def _case_distributed_trainer(h):
    params = {"w": FakeParameter(np.arange(4.0).astype(np.float32)),
              "frozen": FakeParameter(np.zeros(2, np.float32),
                                      grad_req="null")}
    trainer = h.DistributedTrainer(params, "sgd", {"rescale_grad": 1.0})
    trainer._allreduce_grads()
    return [trainer._scale, _nd(params["w"].list_grad()[0]),
            _nd(params["frozen"].list_grad()[0])]


CASES = {"allreduce": _case_allreduce, "grouped": _case_grouped,
         "gather_broadcast": _case_gather_broadcast,
         "alltoall": _case_alltoall,
         "broadcast_parameters": _case_broadcast_parameters,
         "distributed_optimizer": _case_distributed_optimizer,
         "distributed_trainer": _case_distributed_trainer}


def _assert_equal(got, want, path="out"):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mxnet_shim_equals_jax(shims, case):
    jmx, tmx = shims
    _assert_equal(CASES[case](tmx), CASES[case](jmx), case)


def test_mxnet_identity_works_without_mxnet(monkeypatch):
    import horovod_tpu.mxnet as jmx
    import horovod_tpu_torch.mxnet as tmx
    monkeypatch.delitem(sys.modules, "mxnet", raising=False)
    assert tmx.nccl_built() == jmx.nccl_built() is False
    assert tmx.tpu_built() is False and tmx.gloo_built() is True
    assert callable(tmx.allreduce) and tmx.Sum is not None
    with pytest.raises(AttributeError):
        tmx.not_a_real_api


@pytest.mark.parametrize("call", [
    lambda m: m.allreduce(FakeNDArray([1.0])),
    lambda m: m.grouped_allreduce([FakeNDArray([1.0])]),
    lambda m: m.allgather(FakeNDArray([1.0])),
    lambda m: m.broadcast(FakeNDArray([1.0])),
    lambda m: m.alltoall(FakeNDArray([1.0])),
    lambda m: m.reducescatter(FakeNDArray([1.0])),
    lambda m: m.broadcast_parameters({}),
    lambda m: m.DistributedOptimizer(object()),
    lambda m: m.DistributedTrainer({}, "sgd"),
])
def test_mxnet_tensor_apis_raise_with_guidance(monkeypatch, call):
    import horovod_tpu_torch.mxnet as tmx
    monkeypatch.delitem(sys.modules, "mxnet", raising=False)
    with pytest.raises(ImportError, match="mxnet"):
        call(tmx)
