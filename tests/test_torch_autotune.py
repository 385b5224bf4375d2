"""PyTorch/CUDA port: the autotuner (``autotune/``) against the JAX
package's, and its wiring into the exchange knobs and the train steps.

In one process (the JAX tuners get ``cycle_candidates=[]``, so no
resident torch-shim module opens their cycle axis):

* ``GaussianProcess``, ``expected_improvement`` and
  ``BayesianOptimizer.suggest`` bitwise the JAX ones on the same
  observations, the strided warmup included;
* both tuners fed one scripted ``record_step`` sequence (timings from a
  numpy seed) under every opt-in axis: the same grid, the same sampled
  configurations in the same order, the same best and a byte-equal log;
* ``tests/test_autotune.py``'s cases against the port: each opt-in axis
  and its accessors, warm starts from every historical log format (3, 5,
  6, 8, 9, 10 and 11 columns), unusable rows skipped with one warning,
  a warm start covering the budget, ``HOROVOD_AUTOTUNE_MOE`` refused
  naming item 1.12, the cycle axis pinned;
* the config fields against the JAX ``load_config``; ``init()`` building
  the tuner under ``HOROVOD_AUTOTUNE=1`` and a re-init a new one that
  warm-starts; the resolvers (threshold, chunk, hierarchical, steps,
  microbatches, the codec with its escape hatches, the ZeRO exchange);
* a tuned ``make_flax_train_step`` on a small ResNet re-planning its
  buckets at every sampled threshold, bitwise an untuned run; a tuned
  ``make_flax_train_loop`` on the CPU, the microbatched step and a
  ZeRO-1 step whose zero axis samples the allreduce exchange, each
  bitwise untuned.

Gloo worlds (this file, run as a script, is each rank): at world 2 both
ranks, timed differently, follow rank 0's sampling sequence and cut the
same buckets, and a ZeRO-1 step through the zero axis's allreduce
exchange equals the reduce-scatter's bitwise; at world 4 laid out 2 x 2
(``HOROVOD_HIERARCHICAL=2,2``)
the hierarchical axis opens, at world 2 without a layout it stays shut.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.autotune import Autotuner as JTuner
from horovod_tpu.autotune import gp as jgp
from horovod_tpu.core.config import Config as JConfig
from horovod_tpu_torch.autotune import Autotuner
from horovod_tpu_torch.autotune import gp as tgp
from horovod_tpu_torch.core.config import Config
from horovod_tpu_torch.core.state import global_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MiB = 1 << 20
_AXIS_ENV = ("HOROVOD_AUTOTUNE_COMPRESSION", "HOROVOD_AUTOTUNE_CODEC",
             "HOROVOD_AUTOTUNE_ZERO", "HOROVOD_AUTOTUNE_CHUNK",
             "HOROVOD_AUTOTUNE_STEPS_PER_EXEC",
             "HOROVOD_AUTOTUNE_MICROBATCH", "HOROVOD_AUTOTUNE_HIER",
             "HOROVOD_AUTOTUNE_MOE", "HOROVOD_AUTOTUNE",
             "HOROVOD_AUTOTUNE_LOG")
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HVD_TPU_RANK", "HVD_TPU_SIZE",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_HIERARCHICAL",
                 "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_COMPRESSION",
                 "HOROVOD_ZERO", "HOROVOD_MICROBATCHES",
                 "HOROVOD_STEPS_PER_EXEC", "HOROVOD_FUSION_THRESHOLD",
                 "HOROVOD_EXCHANGE_CHUNK_MB") + _AXIS_ENV
# Thresholds that cut a small model into different bucket counts.
SMALL = [4096, 16384, 65536]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in _LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
        monkeypatch.delenv(k.replace("HOROVOD_", "HVD_TPU_"), raising=False)


@pytest.fixture
def world1():
    thvd.init(device="cpu")
    yield global_state()
    thvd.shutdown()


# ---------------------------------------------------------------------------
# The GP
# ---------------------------------------------------------------------------


def test_gp_and_expected_improvement_bitwise_jax():
    rng = np.random.RandomState(0)
    X = rng.rand(7, 3)
    y = rng.randn(7)
    Xs = rng.rand(11, 3)
    outs = []
    for mod in (jgp, tgp):
        gp = mod.GaussianProcess(length_scale=0.3, noise=1e-6)
        gp.fit(X, y)
        mu, sigma = gp.predict(Xs)
        outs.append((mu, sigma, mod.expected_improvement(mu, sigma, 0.4)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_bayesian_optimizer_suggests_the_jax_index(seed):
    rng = np.random.RandomState(seed)
    grid = rng.rand(40, 4) * [128, 1, 4, 16]
    grid[:, 1] = 1.0                      # a constant column
    jopt, topt = jgp.BayesianOptimizer(grid), tgp.BayesianOptimizer(grid)
    truth = rng.randn(len(grid))
    picked = []
    while True:
        j, t = jopt.suggest(), topt.suggest()
        assert j == t
        if j is None or len(picked) == 15:
            break
        picked.append(j)
        jopt.observe(j, truth[j])
        topt.observe(t, truth[t])
    assert len(set(picked[:4])) == 4      # the strided warmup
    assert jopt.best_index == topt.best_index


def test_bayesian_optimizer_finds_peak_on_grid():
    opt = tgp.BayesianOptimizer([[float(i)] for i in range(12)], warmup=4)
    for _ in range(9):
        i = opt.suggest()
        opt.observe(i, -(i - 7.0) ** 2)
    assert abs(opt.best_index - 7) <= 1


# ---------------------------------------------------------------------------
# The tuners, scripted
# ---------------------------------------------------------------------------


def _drive(tuner, seed: int, nbytes: int = 100 * _MiB):
    """Feed ``tuner`` steps timed from a seeded table over its grid; the
    configurations it sampled, in order."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0.5, 2.0, size=len(tuner.grid))
    seq = []
    while not tuner.done:
        cur = tuner.grid[tuner._idx]
        if not seq or seq[-1] != cur:
            seq.append(cur)
        tuner.record_step(0.01 * base[tuner._idx] * (1 + 0.05 * rng.rand()),
                          nbytes)
        assert len(seq) <= len(tuner.grid)
    return seq


AXES = {
    "threshold": ({}, {}),
    "chunk": ({"HOROVOD_AUTOTUNE_CHUNK": "1"}, {}),
    "chunk_configured": ({"HOROVOD_AUTOTUNE_CHUNK": "1"},
                         {"exchange_chunk_bytes": 8 * _MiB}),
    "compression": ({"HOROVOD_AUTOTUNE_COMPRESSION": "1"}, {}),
    "codec": ({"HOROVOD_AUTOTUNE_COMPRESSION": "1",
               "HOROVOD_AUTOTUNE_CODEC": "powersgd:4,topk:0.25"}, {}),
    "zero": ({"HOROVOD_AUTOTUNE_ZERO": "1"}, {"zero_stage": 1}),
    "steps": ({"HOROVOD_AUTOTUNE_STEPS_PER_EXEC": "1"},
              {"steps_per_exec": 8}),
    "microbatch": ({"HOROVOD_AUTOTUNE_MICROBATCH": "1"}, {}),
    "all": ({"HOROVOD_AUTOTUNE_CHUNK": "1",
             "HOROVOD_AUTOTUNE_COMPRESSION": "1",
             "HOROVOD_AUTOTUNE_STEPS_PER_EXEC": "1",
             "HOROVOD_AUTOTUNE_MICROBATCH": "1"},
            {"fusion_threshold": 16 * _MiB}),
}


@pytest.mark.parametrize("axes", sorted(AXES))
def test_tuner_follows_the_jax_tuner(axes, monkeypatch, tmp_path):
    env, fields = AXES[axes]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jlog, tlog = tmp_path / "j.csv", tmp_path / "t.csv"
    jt = JTuner(JConfig(autotune=True, autotune_log=str(jlog), **fields),
                steps_per_sample=2, cycle_candidates=[])
    tt = Autotuner(Config(autotune=True, autotune_log=str(tlog), **fields),
                   steps_per_sample=2)
    assert tt.grid == jt.grid and len(tt.grid) > 1
    assert _drive(tt, 3) == _drive(jt, 3)
    assert tt._best == jt._best and tt.done and jt.done
    assert tt.trace_key() == jt.trace_key()
    assert tlog.read_bytes() == jlog.read_bytes()
    assert tlog.read_text().count("\n") == len(tt._samples) + 2


def test_first_step_of_each_sample_and_warmup_calls_are_not_scored():
    t = Autotuner(Config(autotune=True), steps_per_sample=2,
                  candidates=SMALL, max_samples=3)
    first = t.trace_key()
    assert t.record_step(9.0, 1) is False          # the switch's step
    assert t.record_step(1.0, 1) and t.record_step(1.0, 1)
    assert t.trace_key() != first and t._samples[0][-1] == 1.0
    # A loop's eager and capture windows: both unscored.
    assert t.record_step(9.0, 1, warmup=True) is False
    assert t.record_step(9.0, 1, warmup=True) is False
    assert t.record_step(2.0, 4) and t.record_step(2.0, 4)
    assert t._samples[1][-1] == 2.0


def test_converges_to_best_throughput(tmp_path):
    log = tmp_path / "at.csv"
    t = Autotuner(Config(autotune=True, autotune_log=str(log)),
                  steps_per_sample=1)
    peak = 32 * _MiB
    while not t.done:
        d = abs(np.log2(t.fusion_threshold() / peak))
        t.record_step(0.01 * (1.0 + 0.3 * d), nbytes=100 * _MiB)
    assert peak / 4 <= t.fusion_threshold() <= peak * 4
    text = log.read_text()
    assert text.startswith("fusion_threshold_bytes,cycle_time_ms,")
    assert "# best," in text


def test_cycle_axis_pinned_to_the_configured_cycle_time():
    t = Autotuner(Config(autotune=True, cycle_time=5.0), steps_per_sample=1)
    j = JTuner(JConfig(autotune=True, cycle_time=5.0), steps_per_sample=1,
               cycle_candidates=[])
    assert t.grid == j.grid and {c for _, c, *_ in t.grid} == {5.0}
    # Without the native batcher nothing reads the axis; given
    # candidates, it opens as the JAX tuner's where the batcher would cut
    # by the clock (the CPU at world 1; pinned where it is deterministic:
    # tests/test_torch_join.py).
    t2 = Autotuner(Config(autotune=True), cycle_candidates=[0.5, 1.0])
    j2 = JTuner(JConfig(autotune=True), cycle_candidates=[0.5, 1.0])
    assert t2.grid == j2.grid and {c for _, c, *_ in t2.grid} == {0.5, 1.0}


def test_compression_axis_is_opt_in(monkeypatch):
    from horovod_tpu_torch.collectives.compression import Compression
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert {cfg[3] for cfg in t.grid} == {0}
    assert t.compression_override(Compression.none) is Compression.none
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_CODEC", "topk:0.25")
    t2 = Autotuner(Config(autotune=True), steps_per_sample=1)
    j2 = JTuner(JConfig(autotune=True), steps_per_sample=1,
                cycle_candidates=[])
    assert {cfg[3] for cfg in t2.grid} == {0, 1, 2, 3, 4}
    for want in (1, 2, 3, 4):
        i = next(i for i, cfg in enumerate(t2.grid) if cfg[3] == want)
        t2._idx = j2._idx = i
        got = t2.compression_override(Compression.none)
        assert got.__name__ == j2.compression_override(None).__name__
        assert t2.trace_key()[2] == want


def test_zero_axis_is_opt_in(monkeypatch):
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert not t.tunes_zero and {cfg[4] for cfg in t.grid} == {0}
    monkeypatch.setenv("HOROVOD_AUTOTUNE_ZERO", "1")
    t2 = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert not t2.tunes_zero and {cfg[4] for cfg in t2.grid} == {0}
    t3 = Autotuner(Config(autotune=True, zero_stage=1), steps_per_sample=1)
    assert t3.tunes_zero and {cfg[4] for cfg in t3.grid} == {0, 1}
    for want in (0, 1):
        t3._idx = next(i for i, c in enumerate(t3.grid) if c[4] == want)
        assert t3.zero_stage() == want and t3.trace_key()[3] == want
    monkeypatch.delenv("HOROVOD_AUTOTUNE_ZERO")
    t4 = Autotuner(Config(autotune=True, zero_stage=1), steps_per_sample=1)
    assert not t4.tunes_zero and {cfg[4] for cfg in t4.grid} == {1}


def test_chunk_steps_and_microbatch_axes(monkeypatch):
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert {c[5] for c in t.grid} == {0} and {c[6] for c in t.grid} == {1}
    assert {c[7] for c in t.grid} == {1}
    for k in ("CHUNK", "STEPS_PER_EXEC", "MICROBATCH"):
        monkeypatch.setenv(f"HOROVOD_AUTOTUNE_{k}", "1")
    t2 = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert {c[5] for c in t2.grid} == {0, 4 * _MiB, 16 * _MiB}
    assert {c[6] for c in t2.grid} == {1, 4, 16}
    assert {c[7] for c in t2.grid} == {1, 2, 4}
    assert len(t2.trace_key()) == 7
    for col, get in ((5, t2.exchange_chunk_bytes), (6, t2.steps_per_exec),
                     (7, t2.microbatches)):
        for want in sorted({c[col] for c in t2.grid}):
            t2._idx = next(i for i, c in enumerate(t2.grid)
                           if c[col] == want)
            assert get() == want
    # Closed on zero runs: the two exchanges exclude each other.
    t3 = Autotuner(Config(autotune=True, zero_stage=1), steps_per_sample=1)
    assert {c[7] for c in t3.grid} == {1}


def test_moe_axis_refused_naming_its_item(monkeypatch):
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert {c[9] for c in t.grid} == {0}
    assert not t.tunes_moe
    monkeypatch.setenv("HOROVOD_AUTOTUNE_MOE", "1")
    with pytest.raises(NotImplementedError, match="1.12"):
        Autotuner(Config(autotune=True), steps_per_sample=1)


def test_hier_axes_shut_without_a_two_level_layout(monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE_HIER", "1")
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    assert not t.tunes_hier and not t.tunes_hier_codec
    assert {(c[2], c[8]) for c in t.grid} == {(0, 0)}
    assert t.hier_dcn_codec() is None
    t2 = Autotuner(Config(autotune=True, hierarchical_allreduce=True),
                   steps_per_sample=1)
    assert {c[2] for c in t2.grid} == {1} and t2.hierarchical_explicit()


_ROWS = {3: "33554432,1.0,123.0", 5: "33554432,1.0,0,0,234.0",
         6: "33554432,1.0,0,0,0,456.0",
         8: "33554432,1.0,0,0,0,0,1,345.0",
         9: "33554432,1.0,0,0,0,0,1,1,567.0",
         10: "33554432,1.0,0,0,0,0,1,1,0,321.0",
         11: "33554432,1.0,0,0,0,0,1,1,0,0,789.0"}


@pytest.mark.parametrize("cols", sorted(_ROWS))
def test_warm_start_reads_every_log_format_as_jax(cols, tmp_path):
    log = tmp_path / f"c{cols}.csv"
    log.write_text("fusion_threshold_bytes,cycle_time_ms,...\n"
                   + _ROWS[cols] + "\n8388608,1.0,0,0,0,0,1,1,0,0,99.5\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        t = Autotuner(Config(autotune=True, autotune_log=str(log)),
                      steps_per_sample=1)
        j = JTuner(JConfig(autotune=True, autotune_log=str(log)),
                   steps_per_sample=1, cycle_candidates=[])
    score = float(_ROWS[cols].split(",")[-1])
    assert (32 * _MiB, 1.0, 0, 0, 0, 0, 1, 1, 0, 0, score) in t._samples
    assert t._samples == j._samples and t._opt._X == j._opt._X
    assert t._idx == j._idx and t.warm_start_skipped == 0


def test_warm_start_skips_unusable_rows_as_jax(tmp_path):
    log = tmp_path / "bad.csv"
    thr = 32 * _MiB
    log.write_text(
        "fusion_threshold_bytes,cycle_time_ms,score\n"
        f"{thr},1.0,nan\n{thr},1.0,inf\n1,2,3,4\n{thr},1.0,oops\n"
        f"{thr},1.0,123.0\n")
    with pytest.warns(RuntimeWarning, match="skipped 4 unusable row"):
        t = Autotuner(Config(autotune=True, autotune_log=str(log)),
                      steps_per_sample=1)
    with pytest.warns(RuntimeWarning, match="skipped 4 unusable row"):
        j = JTuner(JConfig(autotune=True, autotune_log=str(log)),
                   steps_per_sample=1, cycle_candidates=[])
    assert t.warm_start_skipped == j.warm_start_skipped == 4
    assert t._samples == j._samples
    assert (thr, 1.0, 0, 0, 0, 0, 1, 1, 0, 0, 123.0) in t._samples


def test_warm_start_covering_the_budget_is_done_at_construction(tmp_path):
    log = tmp_path / "warm.csv"
    cfg = Config(autotune=True, autotune_log=str(log))
    t1 = Autotuner(cfg, steps_per_sample=1)
    while not t1.done:
        t1.record_step(0.01 if t1.fusion_threshold() == 32 * _MiB
                       else 0.02, nbytes=_MiB)
    rows = log.read_text()
    t2 = Autotuner(cfg, steps_per_sample=1)
    assert t2.done and t2._best == t1._best
    assert log.read_text() == rows          # the log survives the restart
    j2 = JTuner(JConfig(autotune=True, autotune_log=str(log)),
                steps_per_sample=1, cycle_candidates=[])
    assert j2.done and j2._best == t2._best


# ---------------------------------------------------------------------------
# Configuration, init() and the resolvers
# ---------------------------------------------------------------------------


def test_config_fields_equal_jax(monkeypatch, tmp_path):
    from horovod_tpu.core.config import load_config as jload
    from horovod_tpu_torch.core.config import load_config as tload
    for env in ({}, {"HOROVOD_AUTOTUNE": "1", "HOROVOD_CYCLE_TIME": "2.5",
                     "HOROVOD_AUTOTUNE_LOG": str(tmp_path / "l.csv")}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        j, t = jload(), tload()
        assert (t.autotune, t.autotune_log, t.cycle_time) == \
            (j.autotune, j.autotune_log, j.cycle_time)


def test_init_builds_the_tuner_and_a_reinit_warm_starts(monkeypatch,
                                                         tmp_path):
    from horovod_tpu_torch.timeline import metrics
    thvd.init(device="cpu")
    assert global_state().autotuner is None
    thvd.shutdown()
    log = tmp_path / "run.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    thvd.init(device="cpu")
    try:
        t = global_state().autotuner
        assert isinstance(t, Autotuner) and t.log_path == str(log)
        before = metrics.registry().counter(
            "horovod_autotune_samples_total").value
        while not t.done:
            t.record_step(0.01, _MiB)
        assert metrics.registry().counter(
            "horovod_autotune_samples_total").value - before == \
            len(t._samples) == t.max_samples
        assert "# TYPE horovod_autotune_samples_total counter" in \
            metrics.render_prometheus()
        best = t._best
    finally:
        thvd.shutdown()
    assert global_state().autotuner is None
    thvd.init(device="cpu")
    try:
        t2 = global_state().autotuner
        assert t2 is not t and t2.done and t2._best == best
    finally:
        thvd.shutdown()


def test_resolvers_take_the_tuners_value(world1, monkeypatch):
    from horovod_tpu_torch import training
    from horovod_tpu_torch.controller import fusion
    for k in ("CHUNK", "STEPS_PER_EXEC", "MICROBATCH"):
        monkeypatch.setenv(f"HOROVOD_AUTOTUNE_{k}", "1")
    assert fusion.fusion_threshold() == 64 * _MiB
    assert fusion.exchange_chunk_bytes() == 0
    t = world1.autotuner = Autotuner(world1.config, steps_per_sample=1)
    for i, cfg in enumerate(t.grid):
        t._idx = i
        assert fusion.fusion_threshold() == cfg[0]
        assert fusion.exchange_chunk_bytes() == cfg[5]
        assert training.steps_per_execution() == cfg[6]
        assert training.microbatches() == cfg[7]
        assert fusion.hier_requested() is False
    t._best = t.grid[0]
    assert training.steps_per_execution(99) == 1


def test_compression_resolver_and_its_escape_hatches(world1, monkeypatch):
    from horovod_tpu_torch.collectives.compression import Compression
    from horovod_tpu_torch.collectives.reduce_op import Adasum
    from horovod_tpu_torch.optim import distributed as dist_mod
    from horovod_tpu_torch.optim import zero as zero_mod
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_CODEC", "topk:0.25")
    t = world1.autotuner = Autotuner(world1.config, steps_per_sample=1)
    ps = thvd.add_process_set([0])

    def at(code):
        t._idx = next(i for i, c in enumerate(t.grid) if c[3] == code)

    at(3)
    assert dist_mod._resolve_compression(None) is Compression.fp8
    assert dist_mod._resolve_compression(None, process_set=ps) is \
        Compression.none
    assert dist_mod._resolve_compression(None, process_set="global") is \
        Compression.fp8                    # the global set
    at(4)
    assert dist_mod._resolve_compression(None).__name__ == \
        "TopK0p25Compressor"
    assert dist_mod._resolve_compression(None, op=Adasum) is \
        Compression.none
    # ZeRO keeps error-feedback as the state was laid out.
    assert zero_mod._resolve_compression(None) is Compression.none
    assert zero_mod._resolve_compression("topk:0.5").__name__ == \
        "TopK0p25Compressor"
    at(1)
    assert zero_mod._resolve_compression(None) is Compression.bf16
    assert zero_mod._resolve_compression("topk:0.5").__name__ == \
        "TopK0p5Compressor"
    thvd.remove_process_set(ps)


_CODEC_NAMES = {0: "NoneCompressor", 1: "BF16Compressor",
                2: "FP16Compressor", 3: "FP8Compressor",
                4: "TopK0p25Compressor"}
# What each exchange runs for each code of the compression axis (None:
# it cannot, and raises).
_CODEC_TABLE = {"wrap": {0: 0, 1: 1, 2: 2, 3: 3, 4: 4},
                "zero": {0: 0, 1: 1, 2: 2, 3: 3, 4: 0},
                "microbatch": {0: 0, 1: 1, 2: 2, 3: None, 4: None}}


@pytest.mark.parametrize("code", range(5))
@pytest.mark.parametrize("exchange", sorted(_CODEC_TABLE))
def test_codec_for_each_exchange(monkeypatch, exchange, code):
    from horovod_tpu_torch.collectives.compression import Compression
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_CODEC", "topk:0.25")
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    t._idx = next(i for i, c in enumerate(t.grid) if c[3] == code)
    want = _CODEC_TABLE[exchange][code]
    if want is None:
        with pytest.raises(ValueError, match="microbatch exchange"):
            t.codec_for(Compression.none, exchange)
    else:
        got = t.codec_for(Compression.none, exchange)
        assert got.__name__ == _CODEC_NAMES[want]
    # The escape hatches of the wrap's exchange.
    if exchange == "wrap" and code in (3, 4):
        assert t.codec_for(Compression.none, "wrap", subset=True) is \
            Compression.none


@pytest.mark.parametrize("code", range(5))
def test_codec_for_an_error_feedback_wrap_is_its_own(monkeypatch, code):
    from horovod_tpu_torch.collectives.compression import parse_compression
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_CODEC", "topk:0.25")
    t = Autotuner(Config(autotune=True), steps_per_sample=1)
    t._idx = next(i for i, c in enumerate(t.grid) if c[3] == code)
    own = parse_compression("topk:0.5")
    if code == 0:
        assert t.codec_for(own, "ef") is own
    else:
        with pytest.raises(ValueError, match="ef exchange"):
            t.codec_for(own, "ef")
    with pytest.raises(ValueError, match="ef exchange"):
        t.check_exchange(own, "ef")
    with pytest.raises(ValueError, match="unknown exchange"):
        t.codec_for(own, "scatter")


def test_use_reducescatter_follows_the_zero_axis(world1, monkeypatch):
    from horovod_tpu_torch.optim.zero import _use_reducescatter
    assert _use_reducescatter()
    monkeypatch.setenv("HOROVOD_AUTOTUNE_ZERO", "1")
    t = world1.autotuner = Autotuner(
        Config(autotune=True, zero_stage=1), steps_per_sample=1)
    for want in (0, 1):
        t._idx = next(i for i, c in enumerate(t.grid) if c[4] == want)
        assert _use_reducescatter() is bool(want)
    world1.autotuner = Autotuner(Config(autotune=True),
                                 steps_per_sample=1)
    assert _use_reducescatter()


# ---------------------------------------------------------------------------
# The tuned steps
# ---------------------------------------------------------------------------


def _resnet(seed=0):
    from horovod_tpu_torch.models.resnet import BasicBlock, ResNet
    torch.manual_seed(seed)
    return ResNet(stage_sizes=[1, 1], block_cls=BasicBlock, num_classes=10,
                  num_filters=8, dtype=torch.float32, device="cpu")


def _data(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, 4))) for _ in range(n)]


def _state(model, opt):
    out = {f"p/{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"b/{n}": b.clone() for n, b in model.named_buffers()})
    for i, st in enumerate(opt.state.values()):
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"o/{i}/{k}"] = v.clone()
    return out


def _wrapped(model):
    return thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())


def _run(st, build, n, tuner=None, wrap=True, loop_k=0):
    """``n`` steps of a fresh small ResNet through ``build(model, opt)``
    (a step, or a loop of ``loop_k``), with ``tuner`` installed first."""
    from horovod_tpu_torch.training import stack_steps
    st.autotuner = tuner
    model = _resnet()
    opt = _wrapped(model) if wrap else \
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    fn = build(model, opt)
    data = _data(n)
    losses, planned = [], []
    if loop_k:
        for w in range(n // loop_k):
            losses.append(fn(stack_steps(data[w * loop_k:(w + 1) * loop_k])))
        losses = torch.cat(losses)
    else:
        for b in data:
            # The key a call runs under is the tuner's as the call starts.
            thr = tuner.fusion_threshold() if tuner is not None else None
            losses.append(fn(b))
            if tuner is not None and wrap:
                planned.append((thr, opt.bucket_plan))
        losses = torch.stack(losses)
    st.autotuner = None
    return losses, _state(model, opt), fn, planned


def _small_tuner(**kw):
    return Autotuner(Config(autotune=True, **kw), steps_per_sample=2,
                     candidates=SMALL, max_samples=4)


def _assert_bitwise(a, b):
    (la, sa), (lb, sb) = a, b
    assert torch.equal(la, lb)
    assert sa.keys() == sb.keys() and len(sa) > 10
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_tuned_flax_step_replans_and_is_bitwise_untuned(world1):
    from horovod_tpu_torch.controller.fusion import plan_buckets
    from horovod_tpu_torch.training import make_flax_train_step
    base = _run(world1, make_flax_train_step, 14)
    tuner = _small_tuner()
    got = _run(world1, make_flax_train_step, 14, tuner)
    _assert_bitwise(base[:2], got[:2])
    assert tuner.done and len(tuner._samples) == 4
    fn, planned = got[2], got[3]
    params = [p for p in _resnet().parameters()]
    counts = {}
    for thr, spec in planned:
        assert spec == plan_buckets(params, thr, reverse=True)
        counts[thr] = len(spec.buffers)
    assert len(counts) == 4 and len(set(counts.values())) >= 3
    # Every sample's first step unscored, the others scored; no trail
    # once done.
    keys = [k for k, _, _ in fn.trail]
    assert len(fn.trail) == 4 * 3
    for i, (key, kind, scored) in enumerate(fn.trail):
        assert kind == "step" and scored == (i % 3 != 0)
    assert len(set(keys)) == 4


def test_tuned_flax_loop_is_bitwise_untuned_on_cpu(world1):
    from horovod_tpu_torch.training import make_flax_train_loop

    def build(model, opt):
        return make_flax_train_loop(model, opt, steps_per_execution=2)

    base = _run(world1, build, 28, loop_k=2)
    tuner = _small_tuner()
    got = _run(world1, build, 28, tuner, loop_k=2)
    _assert_bitwise(base[:2], got[:2])
    assert tuner.done
    assert {kind for _, kind, _ in got[2].trail} == {"cpu"}


def test_tuned_microbatched_step_is_bitwise_untuned(world1):
    from horovod_tpu_torch.training import make_flax_train_step

    def build(model, opt):
        return make_flax_train_step(model, opt, microbatches=2)

    base = _run(world1, build, 12)
    tuner = _small_tuner()
    got = _run(world1, build, 12, tuner)
    _assert_bitwise(base[:2], got[:2])
    assert tuner.done


def test_tuned_zero_step_samples_the_allreduce_exchange(world1, monkeypatch):
    from horovod_tpu_torch.timeline.spans import recorder
    from horovod_tpu_torch.training import make_flax_train_step

    def build(model, opt):
        return make_flax_train_step(model, opt, zero_stage=1)

    base = _run(world1, build, 10, wrap=False)
    monkeypatch.setenv("HOROVOD_AUTOTUNE_ZERO", "1")
    tuner = _small_tuner(zero_stage=1)
    assert tuner.tunes_zero
    recorder().reset()
    got = _run(world1, build, 10, tuner, wrap=False)
    _assert_bitwise(base[:2], got[:2])
    tags = set(recorder().leg_registry())
    assert {"zero_rs", "zero_allreduce"} <= tags, tags


def test_tuned_step_replans_at_the_end_of_an_accumulation(world1):
    """``backward_passes_per_step=2`` with samples of three calls: a
    sample boundary falls partway through an accumulation, and the step
    keeps the wrap's buckets until its end, bitwise untuned."""
    from horovod_tpu_torch.training import make_flax_train_step

    def run(tuner):
        world1.autotuner = tuner
        try:
            model = _resnet()
            opt = thvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
                named_parameters=model.named_parameters(),
                backward_passes_per_step=2)
            step = make_flax_train_step(model, opt)
            plans = []
            for b in _data(14):
                step(b)
                plans.append((len(opt.bucket_plan.buffers),
                              any(opt._counter)))
            return _state(model, opt), step, plans
        finally:
            world1.autotuner = None

    base, _, _ = run(None)
    tuner = _small_tuner()
    got, step, plans = run(tuner)
    assert tuner.done and len({k for k, _, _ in step.trail}) == 4
    for n in base:
        assert torch.equal(base[n], got[n]), n
    # The plan only changes on a call that starts an accumulation.
    changed = [i for i in range(1, len(plans))
               if plans[i][0] != plans[i - 1][0]]
    assert changed and all(plans[i][1] for i in changed)


def test_tuned_codec_axis_reaches_the_wrap(world1, monkeypatch):
    """The compression axis with an error-feedback candidate on a wrap
    configured without one: each sample's codec is the wrap's (top-k in
    its stateless form), and the steps stay finite."""
    from horovod_tpu_torch.training import make_flax_train_step
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_CODEC", "topk:0.5")
    tuner = world1.autotuner = Autotuner(
        world1.config, steps_per_sample=1, candidates=SMALL,
        max_samples=20)                  # the whole grid: every codec
    assert len(tuner.grid) == 20
    try:
        model = _resnet()
        opt = _wrapped(model)
        step = make_flax_train_step(model, opt)
        seen, losses = set(), []
        for b in _data(44):
            if tuner.done:
                break
            losses.append(float(step(b)))
            code = step.trail[-1][0][2]
            seen.add((code, opt._compression.__name__))
    finally:
        world1.autotuner = None
    assert tuner.done and all(np.isfinite(losses))
    names = dict(seen)
    assert names[0] == "NoneCompressor"
    assert names[4] == "TopK0p5Compressor"
    assert {c for c, _ in seen} == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("env", [
    {"HOROVOD_AUTOTUNE_COMPRESSION": "1"},
    {"HOROVOD_AUTOTUNE_CODEC": "topk:0.5"},
    {"HOROVOD_AUTOTUNE_CODEC": "powersgd:2"}], ids=["fp8", "topk", "psgd"])
def test_microbatched_step_refuses_codecs_it_cannot_run(world1, monkeypatch,
                                                       env):
    """A compression axis holding fp8 or an error-feedback codec: the
    microbatched step is refused as it is built, never run under the
    configured codec while the tuner scores the sample's."""
    from horovod_tpu_torch.training import make_flax_train_step
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    world1.autotuner = Autotuner(world1.config, steps_per_sample=1,
                                 candidates=SMALL)
    try:
        model = _resnet()
        opt = _wrapped(model)
        with pytest.raises(ValueError, match="microbatch exchange"):
            make_flax_train_step(model, opt, microbatches=2)
        make_flax_train_step(model, opt)     # one batch: the wrap's own
    finally:
        world1.autotuner = None


def test_ef_wrap_refused_under_an_open_compression_axis(world1,
                                                       monkeypatch):
    monkeypatch.setenv("HOROVOD_AUTOTUNE_COMPRESSION", "1")
    world1.autotuner = Autotuner(world1.config, steps_per_sample=1,
                                 candidates=SMALL)
    try:
        model = _resnet()
        with pytest.raises(ValueError, match="ef exchange"):
            thvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters(),
                compression="topk:0.5")
    finally:
        world1.autotuner = None


def test_replan_refused_partway_through_an_accumulation(world1):
    model = _resnet()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    x, y = _data(1)[0]
    torch.nn.functional.cross_entropy(model(x), y).backward()
    with pytest.raises(RuntimeError, match="step boundary"):
        opt.replan()


def test_ef_wrap_keeps_its_pinned_plan(world1):
    model = _resnet()
    world1.autotuner = _small_tuner()
    try:
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            compression="topk:0.5")
        plan = opt.bucket_plan
        assert len(plan.buffers) == 1        # the configured 64 MiB
        world1.autotuner._idx = 2
        opt.replan()
        assert opt.bucket_plan is plan and len(opt.residuals) == 1
    finally:
        world1.autotuner = None


# ---------------------------------------------------------------------------
# Gloo worlds
# ---------------------------------------------------------------------------


def _worker(rank: int, world: int, store: str, out: str, mode: str):
    import torch.distributed as dist
    from horovod_tpu_torch.training import make_train_step
    if mode == "hier":
        os.environ["HOROVOD_HIERARCHICAL"] = "2,2"
    thvd.init(device="cpu", store=dist.FileStore(store, world), rank=rank,
              size=world)
    st = global_state()
    res = {}
    t = Autotuner(st.config, steps_per_sample=1, candidates=SMALL)
    res["hiers"] = sorted({c[2] for c in t.grid})
    if mode == "coord":
        # Rank-dependent timings: rank 0's decisions must rule.
        st.autotuner = tuner = Autotuner(st.config, steps_per_sample=2,
                                         candidates=SMALL, max_samples=4)
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(32, 32),
                                    torch.nn.Linear(32, 32),
                                    torch.nn.Linear(32, 8))
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        step = make_train_step(
            model, lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), opt)
        rng = np.random.RandomState(rank)
        seq, buckets = [], []
        while not tuner.done:
            seq.append(tuner.trace_key())
            x = torch.from_numpy(rng.randn(4, 32).astype(np.float32))
            step((x, torch.zeros(4, 8)))
            buckets.append(len(opt.bucket_plan.buffers))
            # A rank-local slowdown the scores see.
            if rank:
                import time
                time.sleep(0.002 * (tuner._idx % 3))
        res.update(seq=seq, buckets=buckets, best=tuner._best,
                   samples=[s[:-1] for s in tuner._samples])
        # The zero axis: one ZeRO-1 step through the reduce-scatter and
        # one through the allreduce exchange, from the same start.
        import dataclasses

        from horovod_tpu_torch.optim import zero as tzero
        os.environ["HOROVOD_AUTOTUNE_ZERO"] = "1"
        zcfg = dataclasses.replace(st.config, zero_stage=1)
        after = []
        for want in (1, 0):
            st.autotuner = zt = Autotuner(zcfg, steps_per_sample=1)
            zt._idx = next(i for i, c in enumerate(zt.grid) if c[4] == want)
            torch.manual_seed(0)
            params = [torch.nn.Parameter(torch.randn(5, 3)),
                      torch.nn.Parameter(torch.randn(7))]
            zopt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
            zs = tzero.zero_init(zopt, params)
            g = torch.Generator().manual_seed(10 + rank)
            tzero.zero_apply(zopt, [torch.randn(p.shape, generator=g)
                                    for p in params], zs, params)
            after.append([p.detach().clone() for p in params])
        res["zero_rs_vs_allreduce"] = [torch.equal(a, b)
                                       for a, b in zip(*after)]
        res["zero_params"] = after[0]
        st.autotuner = None
    thvd.shutdown()
    torch.save(res, out)


def _run_world(tmp, world, mode):
    store = str(tmp / "store")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), store,
         str(tmp / f"r{r}.pt"), mode], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(tmp / f"r{r}.pt", weights_only=False)
            for r in range(world)]


def test_world2_ranks_follow_rank0(tmp_path):
    r0, r1 = _run_world(tmp_path, 2, "coord")
    assert r0["seq"] == r1["seq"] and r0["best"] == r1["best"]
    assert r0["samples"] == r1["samples"] and len(r0["samples"]) == 4
    assert r0["buckets"] == r1["buckets"]
    assert len(set(r0["buckets"])) > 1
    # Both ZeRO-1 exchanges give the same step, bitwise, on both ranks.
    assert r0["zero_rs_vs_allreduce"] == r1["zero_rs_vs_allreduce"] == \
        [True, True]
    for a, b in zip(r0["zero_params"], r1["zero_params"]):
        assert torch.equal(a, b)
    assert r0["hiers"] == r1["hiers"] == [0]


def test_world4_two_level_layout_opens_the_hier_axis(tmp_path):
    ranks = _run_world(tmp_path, 4, "hier")
    assert all(r["hiers"] == [0, 1] for r in ranks)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
