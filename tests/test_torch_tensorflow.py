"""PyTorch/CUDA port: the TensorFlow and Keras shims
(``horovod_tpu_torch.tensorflow``, ``.keras``, ``.tensorflow.keras``) and
``KerasEstimator`` against the JAX package's.

TF stays on the host in both packages; the port's collectives bridge
through numpy to torch tensors on the rank's device (here the CPU,
gloo).  Held:

* at world 1, in this process: every shim surface -- the collectives
  (allreduce with each op, pre/postscale and bf16 compression, the
  grouped ops, allgather, broadcast, alltoall even and with splits,
  reducescatter), ``DistributedGradientTape`` (predivide, compression,
  densified ``IndexedSlices``), ``broadcast_variables``, Keras's
  ``DistributedOptimizer`` through ``fit`` (and
  ``backward_passes_per_step``), the four callbacks, ``compile_args``,
  ``SyncBatchNormalization``, ``TensorFlowKerasState`` and the TF1
  broadcast op and hook -- against the JAX shim on a one-device mesh;
* at world 2 (one spawn through the port's ``run``, gloo): the same
  tensor on both ranks against the JAX shim on a two-device mesh, and
  tensors that differ by rank against a numpy oracle;
* ``KerasEstimator`` at world 1 against the JAX one: history within
  1e-4 relative.

Tolerance: exact where the JAX result is integer-valued f32, else 1e-6
of the result's largest magnitude.
"""

import concurrent.futures

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HVD_TPU_RENDEZVOUS_FILE", "HOROVOD_CHAOS",
                 "HVD_TPU_CHAOS")
REL_TOL = 1e-6
HIST_RTOL = 1e-4


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f" and not np.all(want == np.round(want)):
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=REL_TOL,
                                   atol=REL_TOL * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _flat(outs):
    """Nested lists/tuples/dicts of tensors -> a flat list of arrays."""
    if isinstance(outs, dict):
        return [a for k in sorted(outs) for a in _flat(outs[k])]
    if isinstance(outs, (list, tuple)):
        return [a for o in outs for a in _flat(o)]
    return [np.asarray(outs)]


def _inputs(rank=0):
    """Seeded inputs; ``rank`` shifts the rank-dependent ones."""
    rng = np.random.RandomState(7)
    a = rng.randn(4, 3).astype(np.float32)
    ints = np.arange(12, dtype=np.float32).reshape(4, 3)
    return {"a": a, "ints": ints, "b": rng.randn(6).astype(np.float32),
            "mine": ints + 100.0 * rank,
            "x_bn": rng.randn(8, 5).astype(np.float32) + rank,
            "w0": rng.randn(4, 2).astype(np.float32),
            "x": rng.randn(16, 4).astype(np.float32),
            "y": rng.randn(16, 2).astype(np.float32)}


# ---------------------------------------------------------------------------
# The shim cases, each run by both packages' shims
# ---------------------------------------------------------------------------

def _case_allreduce(h, k):
    t = tf.constant(_inputs()["a"])
    i = tf.constant(_inputs()["ints"])
    return [h.allreduce(t, op=h.Sum), h.allreduce(t),
            h.allreduce(i, average=False), h.allreduce(i, op=h.Min),
            h.allreduce(i, op=h.Max),
            h.allreduce(t, op=h.Average, prescale_factor=0.5,
                        postscale_factor=3.0),
            h.allreduce(t, compression=h.Compression.bf16)]


def _case_grouped(h, k):
    d = _inputs()
    ts = [tf.constant(d["a"]), tf.constant(d["b"])]
    return [h.grouped_allreduce(ts, op=h.Sum), h.grouped_allreduce(ts),
            h.grouped_allgather(ts),
            h.grouped_reducescatter([tf.constant(d["ints"])], op=h.Sum)]


def _case_gather_broadcast(h, k):
    d = _inputs()
    return [h.allgather(tf.constant(d["a"])),
            h.broadcast(tf.constant(d["b"]), root_rank=0),
            h.reducescatter(tf.constant(d["ints"]), op=h.Sum),
            h.reducescatter(tf.constant(d["ints"]))]


def _case_alltoall(h, k):
    t = tf.constant(np.arange(4 * k * 2, dtype=np.float32).reshape(4 * k, 2))
    sp = tf.constant([(i % 3) + 1 for i in range(k)], tf.int32)
    tot = int(tf.reduce_sum(sp))
    u = tf.reshape(tf.range(tot * 2, dtype=tf.float32), (tot, 2))
    data, rsp = h.alltoall(u, splits=sp)
    return [h.alltoall(t), data, rsp]


def _case_tape(h, k):
    v = tf.Variable(_inputs()["a"])

    def grads(**kw):
        tape = tf.GradientTape()
        with tape:
            loss = tf.reduce_sum(v * v * v)
        return h.DistributedGradientTape(tape, **kw).gradient(loss, [v])[0]

    emb = tf.Variable(tf.ones((8, 4)))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(tf.gather(emb, [1, 2, 2]))
    (dense,) = h.DistributedGradientTape(
        tape, sparse_as_dense=True).gradient(loss, [emb])
    return [grads(), grads(gradient_predivide_factor=2.0),
            grads(compression=h.Compression.bf16), grads(op=h.Sum), dense]


def _case_broadcast_variables(h, k):
    vs = [tf.Variable(_inputs()["a"]), tf.Variable([1, 2, 3]),
          tf.Variable(2.5)]
    h.broadcast_variables(vs, root_rank=0)
    return [v.numpy() for v in vs]


def _model():
    model = keras.Sequential([keras.Input((4,)), keras.layers.Dense(2)])
    model.set_weights([_inputs()["w0"], np.zeros(2, np.float32)])
    return model


def _case_optimizer_fit(h, k):
    d = _inputs()
    out = []
    for bpps in (1, 2):
        model = _model()
        opt = h.DistributedOptimizer(keras.optimizers.SGD(0.1),
                                     backward_passes_per_step=bpps)
        model.compile(optimizer=opt, loss="mse")
        hist = model.fit(d["x"], d["y"], epochs=3, batch_size=4,
                         shuffle=False, verbose=0)
        out += [hist.history["loss"], model.get_weights()]
    return out


def _case_bpps_eager(h, k):
    v = tf.Variable([10.0])
    opt = h.DistributedOptimizer(keras.optimizers.SGD(1.0),
                                 backward_passes_per_step=2)
    seen = []
    for g in (1.0, 3.0, 2.0, 6.0):
        opt.apply_gradients([(tf.constant([g]), v)])
        seen.append(v.numpy().copy())
    return seen


def _case_callbacks(h, k, kh):
    d = _inputs()
    model = _model()
    model.compile(optimizer=keras.optimizers.SGD(0.2), loss="mse",
                  **kh.compile_args())
    cbs = [kh.BroadcastGlobalVariablesCallback(0),
           kh.MetricAverageCallback(),
           kh.LearningRateWarmupCallback(initial_lr=0.2, warmup_epochs=1,
                                         steps_per_epoch=2),
           kh.callbacks.LearningRateScheduleCallback(
               initial_lr=0.2, multiplier=0.5, start_epoch=1)]
    hist = model.fit(d["x"], d["y"], epochs=3, batch_size=8, shuffle=False,
                     verbose=0, callbacks=cbs)
    return [hist.history["loss"], model.get_weights(),
            float(model.optimizer.learning_rate.numpy()),
            kh.compile_args(steps_per_execution=3)["steps_per_execution"]]


def _case_sync_bn(h, k):
    x = tf.constant(_inputs()["x_bn"])
    sbn = h.SyncBatchNormalization(momentum=0.9)
    y = sbn(x, training=True)
    clone = h.SyncBatchNormalization.from_config(sbn.get_config())
    return [y, sbn.moving_mean, sbn.moving_variance,
            float(clone.momentum)]


def _case_keras_state(h, k):
    model = _model()
    opt = keras.optimizers.SGD(0.1)
    state = h.elastic.TensorFlowKerasState(model, optimizer=opt, epoch=1)
    w0 = [np.copy(w) for w in model.get_weights()]
    model.set_weights([w + 1.0 for w in w0])
    state.epoch = 9
    state.restore()
    restored = [model.get_weights(), state.epoch]
    model.set_weights([w + 2.0 for w in w0])
    state.epoch = 2
    state.commit()
    state.sync()
    return restored + [model.get_weights(), state.epoch]


def _case_tf1(h, k):
    v1 = tf.compat.v1
    with tf.Graph().as_default():
        a = v1.get_variable("a", initializer=tf.constant([1.0, 2.0]))
        b = v1.get_variable("b", initializer=tf.constant([[3]]))
        op = h.broadcast_global_variables(0)
        with v1.Session() as sess:
            sess.run(v1.global_variables_initializer())
            sess.run(a.assign([5.0, 6.0]))
            sess.run(op)
            sess.run(op)                      # re-runnable
            out = sess.run([a, b])
    with tf.Graph().as_default():
        v = v1.get_variable("hook_v", initializer=tf.constant([7.0, 8.0]))
        hook = h.BroadcastGlobalVariablesHook(root_rank=0)
        with v1.train.MonitoredTrainingSession(hooks=[hook]) as sess:
            out.append(sess.run(v))
    return out


CASES = {"allreduce": _case_allreduce, "grouped": _case_grouped,
         "gather_broadcast": _case_gather_broadcast,
         "alltoall": _case_alltoall, "tape": _case_tape,
         "broadcast_variables": _case_broadcast_variables,
         "optimizer_fit": _case_optimizer_fit, "bpps_eager": _case_bpps_eager,
         "callbacks": _case_callbacks, "sync_bn": _case_sync_bn,
         "keras_state": _case_keras_state, "tf1": _case_tf1}


def _run_case(name, h, kh, k):
    fn = CASES[name]
    outs = fn(h, k, kh) if name == "callbacks" else fn(h, k)
    return _flat(outs)


@pytest.fixture
def shims(monkeypatch):
    """The port's shims at world 1 (CPU) and the JAX shims on a
    one-device mesh."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu.keras as jk
    import horovod_tpu.tensorflow as jt
    import horovod_tpu_torch.keras as tk
    import horovod_tpu_torch.tensorflow as tt
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    tt.init(device="cpu")
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    yield (jt, jk), (tt, tk)
    jhvd.shutdown()
    tt.shutdown()


@pytest.mark.parametrize("case", sorted(CASES))
def test_shim_equals_jax_at_world_1(shims, case):
    (jt, jk), (tt, tk) = shims
    want = _run_case(case, jt, jk, 1)
    got = _run_case(case, tt, tk, 1)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{case}[{i}]")


def test_shim_refusals_and_aliases(shims):
    _, (tt, tk) = shims
    with pytest.raises(RuntimeError, match="does not support eager"):
        tt.broadcast_global_variables(0)
    with pytest.raises(ValueError, match="requires op=Average"):
        tt.DistributedGradientTape(tf.GradientTape(), op=tt.Sum,
                                   gradient_predivide_factor=2.0)
    emb = tf.Variable(tf.ones((4, 2)))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(tf.gather(emb, [0]))
    with pytest.raises(ValueError, match="sparse_as_dense"):
        tt.DistributedGradientTape(tape).gradient(loss, [emb])
    import horovod_tpu_torch.tensorflow.keras as tkk
    assert tkk.DistributedOptimizer is tk.DistributedOptimizer
    assert callable(tkk.callbacks.MetricAverageCallback)
    assert tkk.size() == tt.size() == 1
    assert not hasattr(tkk, "np")
    ps = tt.add_process_set([0], name="sbn_cfg_port")
    try:
        sbn = tt.SyncBatchNormalization(process_set=ps)
        clone = tt.SyncBatchNormalization.from_config(sbn.get_config())
        assert clone._hvd_process_set.name == "sbn_cfg_port"
    finally:
        tt.remove_process_set(ps)


# ---------------------------------------------------------------------------
# World 2: one spawn through the port's run(), every check in it
# ---------------------------------------------------------------------------

SAME_CASES = ("allreduce", "grouped", "gather_broadcast", "tape",
              "broadcast_variables", "optimizer_fit", "sync_bn", "tf1")


def _tf_world2_checks():
    """One rank of the world-2 battery: the shared-input cases and the
    rank-dependent ones; every output as numpy."""
    import horovod_tpu_torch.keras as kh
    import horovod_tpu_torch.tensorflow as h
    h.init()
    r = h.rank()
    out = {f"same/{c}": _run_case(c, h, kh, 2) for c in SAME_CASES}
    d = _inputs(r)
    mine = tf.constant(d["mine"])
    ragged = tf.constant(np.full((r + 1, 3), r + 1.0, np.float32))
    sp = tf.constant([1, 2] if r == 0 else [3, 0], tf.int32)
    u = tf.constant(np.arange(3 * 2, dtype=np.float32).reshape(3, 2)
                    + 10 * r)
    data, rsp = h.alltoall(u, splits=sp)
    v = tf.Variable(d["mine"])
    h.broadcast_variables([v], root_rank=1)
    w = tf.Variable(d["w0"] + r)
    x = tf.constant(d["x"] + r)
    with tf.GradientTape() as tape:
        loss = tf.reduce_mean((tf.matmul(x, w) - d["y"]) ** 2)
    (g,) = h.DistributedGradientTape(tape).gradient(loss, [w])
    sbn = h.SyncBatchNormalization(momentum=0.9)
    ybn = sbn(tf.constant(d["x_bn"]), training=True)
    v1 = tf.compat.v1
    with tf.Graph().as_default():
        gv = v1.get_variable("gv", initializer=tf.constant(
            np.full(3, 5.0 + r, np.float32)))
        op = h.broadcast_global_variables(0)
        with v1.Session() as sess:
            sess.run(v1.global_variables_initializer())
            sess.run(op)
            gv_out = sess.run(gv)
    out["rank"] = {
        "sum": h.allreduce(mine, op=h.Sum).numpy(),
        "avg": h.allreduce(mine).numpy(),
        "max": h.allreduce(mine, op=h.Max).numpy(),
        "gather": h.allgather(ragged).numpy(),
        "bcast1": h.broadcast(mine, root_rank=1).numpy(),
        "a2a": h.alltoall(mine).numpy(),
        "a2av": data.numpy(), "a2av_splits": rsp.numpy(),
        "rs": h.reducescatter(mine, op=h.Sum).numpy(),
        "grs": [t.numpy() for t in h.grouped_reducescatter(
            [mine, mine * 2.0], op=h.Sum)],
        "bvars": v.numpy(), "tape": g.numpy(), "sync_bn": ybn.numpy(),
        "sync_bn_mean": sbn.moving_mean.numpy(), "tf1": gv_out,
        "obj": h.broadcast_object({"r": r}, root_rank=1),
        "objs": h.allgather_object(r)}
    h.shutdown()
    return out


@pytest.fixture(scope="module")
def world2():
    """The battery's two ranks (gloo), and the JAX shims' answers on a
    two-device mesh to the shared-input cases."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu.keras as jk
    import horovod_tpu.tensorflow as jt
    from horovod_tpu_torch.run import run
    with pytest.MonkeyPatch.context() as mp:
        for k in _LAUNCHER_ENV:
            mp.delenv(k, raising=False)
        ranks = run(_tf_world2_checks, np=2, cpu=True)
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        want = {c: _run_case(c, jt, jk, 2) for c in SAME_CASES}
    finally:
        jhvd.shutdown()
    return ranks, want


# The reducescatter outputs of the shared-input cases (flat index -> the
# reduced tensor): the JAX shim returns rank 0's shard, so rank 1's is
# held to the second half of the reduced tensor.
_SCATTERED = {"gather_broadcast": {2: 2.0, 3: 1.0}, "grouped": {6: 2.0}}


@pytest.mark.parametrize("case", SAME_CASES)
def test_shim_world_2_same_inputs_equal_jax(world2, case):
    ranks, want = world2
    ints = _inputs()["ints"]
    for r in (0, 1):
        got = ranks[r][f"same/{case}"]
        assert len(got) == len(want[case])
        for i, (g, w) in enumerate(zip(got, want[case])):
            scale = _SCATTERED.get(case, {}).get(i)
            if scale is not None and r == 1:
                w = scale * ints[2:]
            _same(g, w, f"{case}[{i}] rank {r}")


def _bn_oracle(xs, eps=1e-3):
    x = np.concatenate(xs).astype(np.float64)
    mean, var = x.mean(0), x.var(0)
    return [(xi - mean) / np.sqrt(var + eps) for xi in xs], mean


def test_shim_world_2_rank_inputs_equal_numpy(world2):
    ranks, _ = world2
    ins = [_inputs(r) for r in (0, 1)]
    mines = [d["mine"] for d in ins]
    bn, bn_mean = _bn_oracle([d["x_bn"] for d in ins])
    grads = []
    for r, d in enumerate(ins):
        x, w = d["x"] + r, d["w0"] + r
        grads.append(2.0 * x.T.astype(np.float64) @ (x @ w - d["y"])
                     / d["y"].size)
    for r in (0, 1):
        got = ranks[r]["rank"]
        _same(got["sum"], mines[0] + mines[1], "sum")
        _same(got["avg"], (mines[0] + mines[1]) / 2, "avg")
        _same(got["max"], np.maximum(*mines), "max")
        _same(got["gather"], np.concatenate(
            [np.full((q + 1, 3), q + 1.0, np.float32) for q in (0, 1)]))
        _same(got["bcast1"], mines[1], "bcast1")
        _same(got["a2a"], np.concatenate([m[2 * r:2 * r + 2]
                                          for m in mines]), "a2a")
        us = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * q
              for q in (0, 1)]
        want_a2av = [np.concatenate([us[0][:1], us[1][:3]]),
                     np.concatenate([us[0][1:3], us[1][3:]])][r]
        _same(got["a2av"], want_a2av, "a2av")
        _same(got["a2av_splits"], [[1, 3], [2, 0]][r], "a2av_splits")
        total = mines[0] + mines[1]
        _same(got["rs"], total[2 * r:2 * r + 2], "rs")
        _same(got["grs"][0], total[2 * r:2 * r + 2], "grs0")
        _same(got["grs"][1], 2 * total[2 * r:2 * r + 2], "grs1")
        _same(got["bvars"], mines[1], "bvars")
        np.testing.assert_allclose(got["tape"], (grads[0] + grads[1]) / 2,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["sync_bn"], bn[r], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["sync_bn_mean"], 0.1 * bn_mean,
                                   rtol=1e-5, atol=1e-6)
        _same(got["tf1"], np.full(3, 5.0, np.float32), "tf1")
        assert got["obj"] == {"r": 1} and got["objs"] == [0, 1]


# ---------------------------------------------------------------------------
# KerasEstimator at world 1
# ---------------------------------------------------------------------------

def _blobs(n=64, d=4, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    centers = rng.randn(classes, d) * 3
    x = centers[y] + rng.randn(n, d) * 0.3
    return x.astype(np.float32), y.astype(np.int64)


def test_keras_estimator_equals_jax(tmp_path, monkeypatch):
    """One batch an epoch (the whole shard), so the workers' shuffling
    reorders only a sum; both fits run at once."""
    import horovod_tpu.spark as jspark
    import horovod_tpu_torch.spark as tspark
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVD_TPU_FORCE_CPU", "1")
    x, y = _blobs()
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.Input((4,)),
                              keras.layers.Dense(16, activation="relu"),
                              keras.layers.Dense(3, activation="softmax")])

    def fit(pkg, name):
        est = pkg.KerasEstimator(model=model, lr=0.05, num_proc=1,
                                 batch_size=64, epochs=4,
                                 store=pkg.LocalStore(str(tmp_path / name)))
        return est.fit({"features": x, "labels": y})

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jf = pool.submit(fit, jspark, "jax")
        tf_ = pool.submit(fit, tspark, "port")
        jfit, tfit = jf.result(), tf_.result()
    assert len(tfit.history) == 4
    np.testing.assert_allclose(tfit.history, jfit.history, rtol=HIST_RTOL)
    assert tfit.history[-1] < tfit.history[0]
    np.testing.assert_allclose(tfit.transform(x), jfit.transform(x),
                               rtol=1e-3, atol=1e-4)
