"""The port's step auditor (``horovod_tpu_torch/analysis``: the recording
world, the collective recorder, the expected-exchange model and
``audit_step``) against the JAX package's (``horovod_tpu/analysis``).

* For each of the 13 reference configurations, the port's expected
  multiset of ``(kind, dtype, elements)`` equals the JAX
  ``expected_exchange``'s on the same tiny trees (the JAX side run once
  per module on the conftest's 8-device CPU mesh), and the port's audit
  -- every rank of a recording world of 8 -- is ``ok()`` with emitted =
  planned.  Three configs differ by the port's design, each a
  deliberate difference (``stepmodel``'s docstring, ROADMAP section 3)
  that :func:`_as_port` applies to the JAX multiset, leg by leg, before
  the comparison: the verify step's ``width`` width-1 steps, ZeRO-1's
  one scatter and one gather over a two-data-axis set, and the
  pipeline's per-tick collectives with Megatron's identity backward of
  its closing sum.
* The known-bad fixtures of ``tests/test_analysis.py``, mirrored: a rank
  branch before a sum is a desync, rank-masked data into a sum is not, a
  plan of the wrong width gives both plan rules, a barrier signature on
  a ``cuda`` device is a fence error, a collective inside a kernel
  wrapper is flagged.
* The documented leg counts of the standard and 3-D configs.
"""

from __future__ import annotations

import sys
from collections import Counter

import jax
import pytest
import torch

from horovod_tpu_torch.analysis import collective_walk as walk
from horovod_tpu_torch.analysis import trace_audit as ta
from horovod_tpu_torch.analysis.trace_audit import (ALL_CONFIGS,
                                                    HIER_CONFIGS,
                                                    audit_standard_configs,
                                                    audit_step,
                                                    build_standard_config)
from horovod_tpu_torch.collectives.ops import step_allreduce
from horovod_tpu_torch.collectives.reduce_op import Sum
from horovod_tpu_torch.core.state import global_state

torch.set_num_threads(2)

WORLD = 8
VERIFY_WIDTH = 5
PIPE_TICKS = 3          # 2 pipeline microbatches + 2 stages - 1


@pytest.fixture(scope="module")
def jax_expected():
    """``{config: Counter of (sig, label)}`` of the JAX model on its own
    reference builders (flat configs on the 8-device mesh, then the
    hierarchical ones on its two-level remesh)."""
    import horovod_tpu as hvd
    from horovod_tpu.analysis.stepmodel import (expected_exchange,
                                                meta_from_step)
    from horovod_tpu.analysis.trace_audit import \
        build_standard_config as jbuild
    from horovod_tpu.parallel.mesh import build_mesh
    out = {}
    hvd.shutdown()
    try:
        for hier in (False, True):
            if hier:
                hvd.init(mesh=build_mesh(jax.devices()[:WORLD],
                                         hierarchical=True, dcn_size=2))
            else:
                hvd.init()
            for config in ALL_CONFIGS:
                if (config in HIER_CONFIGS) != hier:
                    continue
                step, args, _, _ = jbuild(config)
                exp = expected_exchange(args[0], meta_from_step(step))
                out[config] = [(op.sig(), op.label) for op in exp.ops]
            hvd.shutdown()
    finally:
        hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def reports():
    assert not global_state().initialized
    return audit_standard_configs(ALL_CONFIGS, world=WORLD, device="cpu")


def _as_port(config, jax_ops):
    """The JAX multiset with the port's deliberate differences applied
    leg by leg (module docstring)."""
    out = Counter()
    for sig, label in jax_ops:
        kind, dt, n = sig
        if config == "serving_verify":
            out[(kind, dt, n // VERIFY_WIDTH)] += VERIFY_WIDTH
        elif config == "tp2_zero1" and label.endswith(
                ("reduce-scatter-ax1", "allgather-dcn")):
            continue                # one scatter, one gather over the set
        elif config == "tp2_pipe_micro" and "/" in label and \
                label.startswith("mb"):
            leg = label.split("/", 1)[1]
            out[sig] += {"pipe-shift-fwd": PIPE_TICKS - 1,
                         "pipe-shift-bwd": PIPE_TICKS - 1,
                         "pipe-out-fwd": 1, "pipe-out-bwd": 0,
                         "tp-row-fwd": PIPE_TICKS,
                         "tp-row-bwd": PIPE_TICKS - 1}[leg]
        else:
            out[sig] += 1
    return +out


@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_expected_multiset_matches_jax(config, reports, jax_expected):
    report = reports[config]
    assert report.expected is not None and report.expected.supported
    port = Counter(op.sig() for op in report.expected.ops)
    assert port == _as_port(config, jax_expected[config])


@pytest.mark.parametrize("config", ALL_CONFIGS)
def test_reference_config_audits_green(config, reports):
    """Every rank's sequence equal, emitted = planned, nothing
    unaccounted or missing."""
    report = reports[config]
    assert report.ok(), report.render()
    s = report.summary
    assert s["unaccounted_ops"] == 0 and s["missing_ops"] == 0, \
        report.render()
    assert s["matched_ops"] == s["expected_ops"] > 0
    assert s["desync"] == 0 and s["ranks"] == len(report.ranks) > 1
    assert all([r.rank_sig() for r in recs]
               == [r.rank_sig() for r in report.ranks[0]]
               for recs in report.ranks)


def test_standard_config_expected_leg_counts(reports):
    """``tests/test_analysis.py``'s counts: 1 psum a bucket (plain), RS +
    AG an arena (zero1), 2 psums a bucket (powersgd), k RS + 1 AG a
    bucket (microbatch2); the fp16 buckets at their planned widths."""
    assert reports["plain"].summary["expected_ops"] == 2
    assert reports["zero1"].summary["expected_ops"] == 2
    assert reports["powersgd_ef"].summary["expected_ops"] == 4
    assert reports["microbatch2"].summary["expected_ops"] == 6
    plain = reports["plain"]
    sigs = sorted(r.sig() for r in plain.collectives
                  if r.sig() in {op.sig() for op in plain.expected.ops})
    assert sigs == [("psum", "float16", 192), ("psum", "float16", 256)]


def test_parallel3d_expected_leg_counts(reports, jax_expected):
    """tp2: 3 DP buckets over the local shards + 2 TP row psums, as the
    JAX count (5); tp2_zero1: the JAX 6 less the per-axis second scatter
    and gather (4); tp2_pipe_micro: the JAX 18 with each pipeline leg at
    its tick count (26)."""
    want = {c: sum(_as_port(c, jax_expected[c]).values())
            for c in ("tp2", "tp2_zero1", "tp2_pipe_micro")}
    assert want == {"tp2": 5, "tp2_zero1": 4, "tp2_pipe_micro": 26}
    for config, n in want.items():
        assert reports[config].summary["expected_ops"] == n
    sigs = sorted(op.sig() for op in reports["tp2"].expected.ops)
    assert sigs == [("psum", "float16", 16), ("psum", "float16", 256),
                    ("psum", "float16", 256), ("psum", "float32", 32),
                    ("psum", "float32", 32)]
    assert sigs == sorted(s for s, _ in jax_expected["tp2"])


# -- known-bad fixtures ------------------------------------------------------

def _rules(findings):
    return sorted({f.rule for f in findings})


def _scalar_step(body):
    """A builder whose step runs ``body(x)`` on a 4-element tensor."""
    def make():
        return body, (torch.ones(4),)
    return make


def test_rank_dependent_branch_before_psum_is_flagged():
    """The canonical desync: only rank 0 enters the branch that reduces."""
    def body(x):
        if global_state().rank == 0:
            x = step_allreduce(x, Sum)
        return x

    report = audit_step(_scalar_step(body), world=4, device="cpu",
                        name="fixture:desync")
    assert not report.ok()
    desync = [f for f in report.findings if f.rule == "audit-desync-branch"]
    assert len(desync) == 3, report.render()           # ranks 1, 2, 3
    assert "psum" in desync[0].message


def test_rank_masked_data_into_psum_is_not_flagged():
    """The rank feeding DATA into a collective is legitimate; only a
    rank-chosen collective is a hazard."""
    def body(x):
        keep = torch.tensor(global_state().rank == 0)
        return step_allreduce(torch.where(keep, x, torch.zeros_like(x)),
                              Sum)

    report = audit_step(_scalar_step(body), world=4, device="cpu",
                        name="fixture:mask")
    assert not [f for f in report.findings
                if f.rule == "audit-desync-branch"], report.render()
    assert report.summary["ranks"] == 4


def test_plan_emitted_width_mismatch_is_flagged():
    """The two-bucket fp16 step against a one-bucket plan (a doubled
    threshold, on a copy of the model so its hooks never fire) gives BOTH
    plan rules: the planned 448-element leg is never emitted, and the
    real 256/192 psums are unaccounted."""
    from horovod_tpu_torch.collectives.compression import Compression
    from horovod_tpu_torch.optim import distributed as tdist
    make, world, _, _ = build_standard_config("plain", world=2)

    def wrong_plan():
        step, args = make()
        twin = ta._Tiny()
        wrong = tdist.DistributedOptimizer(
            torch.optim.SGD(twin.parameters(), lr=0.01),
            compression=Compression.fp16, fusion_threshold=4096)
        step._meta = dict(step._meta, optimizer=wrong)
        return step, args

    report = audit_step(wrong_plan, world=world, device="cpu",
                        name="fixture:mismatch")
    assert not report.ok()
    assert {"audit-plan-missing", "audit-plan-unaccounted"} <= \
        set(_rules(report.findings))
    missing = [f for f in report.findings if f.rule == "audit-plan-missing"]
    assert "448" in missing[0].message


def test_barrier_signature_on_cuda_device_is_flagged(monkeypatch):
    """A CPU-style barrier (scalar int32 psum) in a step body is an error
    on a ``cuda`` device (monkeypatched here), and fine on the CPU."""
    def body(x):
        b = step_allreduce(torch.ones((), dtype=torch.int32), Sum)
        return x + b

    cpu = audit_step(_scalar_step(body), world=2, device="cpu",
                     name="fixture:barrier-cpu")
    assert not [f for f in cpu.findings if f.rule == "audit-fence"]
    monkeypatch.setattr(ta, "_device", lambda: torch.device("cuda"))
    gpu = audit_step(_scalar_step(body), world=2, device="cpu",
                     name="fixture:barrier-cuda")
    fence = [f for f in gpu.findings if f.rule == "audit-fence"]
    assert any("barrier-signature" in f.message for f in fence), \
        gpu.render()


def test_collective_inside_kernel_wrapper_is_flagged(monkeypatch):
    """A sum dispatched while ``fused_update.matricize_p`` (a kernel
    wrapper) is on the stack is an in-kernel collective."""
    from horovod_tpu_torch.ops import fused_update as tfu
    on_gpu = tfu._on_gpu

    def smuggled(name, t, force_reference):
        step_allreduce(torch.ones(3), Sum)
        return on_gpu(name, t, force_reference)

    def body(x):
        return tfu.matricize_p(x, None, torch.ones(2, 1), rows=2)

    clean = audit_step(_scalar_step(body), world=2, device="cpu",
                       name="fixture:kernel-clean")
    assert clean.ok() and not clean.collectives
    monkeypatch.setattr(tfu, "_on_gpu", smuggled)
    report = audit_step(_scalar_step(body), world=2, device="cpu",
                        name="fixture:in-kernel")
    assert not report.ok()
    hits = [f for f in report.findings
            if f.rule == "audit-collective-in-kernel"]
    assert len(hits) == 2, report.render()            # one a rank
    assert report.collectives[0].in_kernel


def test_async_collective_and_its_wait_record_once():
    """``async_op=True`` and the handle's ``wait()`` are one record."""
    from horovod_tpu_torch.collectives.ops import exchange_allreduce_async_

    def body(x):
        h = exchange_allreduce_async_(x.clone(), Sum)
        return h.wait()

    report = audit_step(_scalar_step(body), world=2, device="cpu")
    assert [r.sig() for r in report.collectives] == \
        [("psum", "float32", 4)]


def test_recording_world_fails_loudly_without_the_fake_backend(
        monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake"):
        with walk.recording_world(2, 0, device="cpu"):
            pass
    assert not global_state().initialized
