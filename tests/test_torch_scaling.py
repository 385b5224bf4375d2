"""The port's scaling evidence (``horovod_tpu_torch/utils/scaling.py``)
against the JAX package's (``horovod_tpu/utils/scaling.py``).

* The analytic model -- ``ring_allreduce_seconds``, ``allreduce_seconds``
  (a toy ``ChipSpec`` handed to both sides, inside one link domain and
  past it), ``predict_efficiency``, ``predict_efficiency_scheduled`` and
  ``ScheduleReport``'s equivalent-payload properties -- and the autotuner's
  ``modeled_exchange_seconds`` give the JAX package's floats.
* Wire accounting: the JAX ``test_train_step_wire_accounting_in_process``
  step (``w`` f32 256x128, ``b`` f32 128, ``h`` bf16 64x64, SGD) recorded
  at recording worlds of 2, 4 and 8 equals the JAX emitted stats by kind:
  2 buckets and the loss, ``param_bytes + 4`` bytes.
* A tiny BatchNorm ResNet's gradient payload equals the planner's bytes
  and does not move with n; on the two-level layout each leg's bytes are
  the plan's and equal at 2 x 2 and 4 x 2.
* ``updates_in_place``, ``step_overlap_report`` on the CPU, and the chip
  model: ``H100_SXM`` and no TPU constant.
* ``split_gradient_stats`` by the issuing module, and ``_kernels`` on a
  synthetic profile: each kernel at its launch call, one without a
  launch call refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu_torch.utils import scaling

torch.set_num_threads(2)

NS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
TOY = dict(name="toy", bf16_tflops=1.0, ici_gbps=8.0, ici_domain_chips=4,
           dcn_gbps_per_chip=0.8)


def _jscaling():
    from horovod_tpu.utils import scaling as jscaling
    return jscaling


def _chips():
    """The toy spec and H100_SXM's figures, as ``(port, JAX)`` pairs."""
    j = _jscaling()
    h100 = dataclasses.asdict(scaling.H100_SXM)
    return [(scaling.ChipSpec(**TOY), j.ChipSpec(**TOY)),
            (scaling.H100_SXM, j.ChipSpec(**h100))]


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


# ---------------------------------------------------------------------------
# The analytic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes", [0.0, 100.0, 102.4e6, 672_395_268.0])
def test_ring_and_allreduce_seconds_match_jax(nbytes):
    j = _jscaling()
    for n in NS + (3, 300):
        for bw in (10.0, 450e9):
            _close(scaling.ring_allreduce_seconds(nbytes, n, bw),
                   j.ring_allreduce_seconds(nbytes, n, bw))
        for port, jax_chip in _chips():
            _close(scaling.allreduce_seconds(nbytes, n, port),
                   j.allreduce_seconds(nbytes, n, jax_chip))
    # The toy domain is 4: n = 8 is two-level, dearer than 4 and cheaper
    # than the whole payload over the NIC.
    toy = scaling.ChipSpec(**TOY)
    if nbytes:
        assert scaling.allreduce_seconds(nbytes, 8, toy) > \
            scaling.allreduce_seconds(nbytes, 4, toy)
        assert scaling.allreduce_seconds(nbytes, 8, toy) < \
            scaling.ring_allreduce_seconds(nbytes, 8,
                                           toy.dcn_allreduce_bytes_per_s)


@pytest.mark.parametrize("step_s,payload", [(0.1, 100e6), (0.0205, 553.4e6),
                                            (0.175, 672.4e6)])
def test_predict_efficiency_matches_jax(step_s, payload):
    j = _jscaling()
    for port, jax_chip in _chips():
        for frac in (2.0 / 3.0, 0.5):
            got = scaling.predict_efficiency(step_s, payload, port,
                                             backward_fraction=frac)
            want = j.predict_efficiency(step_s, payload, jax_chip,
                                        backward_fraction=frac)
            assert [p.n for p in got] == [p.n for p in want] == list(NS)
            for a, b in zip(got, want):
                for f in ("comm_seconds", "eff_no_overlap",
                          "eff_full_overlap"):
                    _close(getattr(a, f), getattr(b, f))
            for a, b in zip(got, got[1:]):
                assert b.eff_no_overlap <= a.eff_no_overlap
            for p in got:
                assert 0.0 < p.eff_no_overlap <= p.eff_full_overlap <= 1.0


def _reports():
    """The same schedule as a port and a JAX ``ScheduleReport``."""
    j = _jscaling()
    kw = dict(sync_collectives=[("all-reduce", 4, 3),
                                ("all-gather", 4096, 9)],
              async_collectives=[("all-reduce", 1 << 20, 1, 5),
                                 ("reduce-scatter", 1 << 16, 2, 7),
                                 ("all-to-all", 8192, 3, 8),
                                 ("collective-permute", 512, 4, 6)],
              async_window_seconds=3e-3, total_compute_seconds=9e-3,
              n_instructions=10)
    return [(scaling.ScheduleReport(n_devices=n, **kw),
             j.ScheduleReport(n_devices=n, **kw)) for n in (1, 2, 8, 256)]


def test_schedule_report_payloads_match_jax():
    for port, jax_rep in _reports():
        assert port.sync_bytes == jax_rep.sync_bytes
        assert port.async_bytes == jax_rep.async_bytes
        _close(port.sync_eq_payload(), jax_rep.sync_eq_payload())
        _close(port.async_eq_payload(), jax_rep.async_eq_payload())


@pytest.mark.parametrize("derate", [1.0, 4.0])
def test_predict_efficiency_scheduled_matches_jax(derate):
    j = _jscaling()
    for port_rep, jax_rep in _reports():
        for port, jax_chip in _chips():
            got = scaling.predict_efficiency_scheduled(
                0.02, port_rep, port, bandwidth_derate=derate)
            want = j.predict_efficiency_scheduled(
                0.02, jax_rep, jax_chip, bandwidth_derate=derate)
            for a, b in zip(got, want, strict=True):
                assert a.n == b.n
                for f in ("comm_seconds", "eff_no_overlap",
                          "eff_full_overlap"):
                    _close(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_modeled_exchange_seconds_matches_jax(hierarchical):
    from horovod_tpu.autotune import modeled_exchange_seconds as jmodel

    from horovod_tpu_torch.autotune import modeled_exchange_seconds
    h100 = scaling.H100_SXM
    for n_dcn, n_ici in ((1, 8), (2, 8), (32, 8), (4, 2)):
        for ici_s, dcn_s in ((1.0, 1.0), (0.5, 0.25), (1.0, 0.125)):
            kw = dict(n_dcn=n_dcn, n_ici=n_ici, hierarchical=hierarchical,
                      ici_bw=h100.ici_allreduce_bytes_per_s,
                      dcn_bw=h100.dcn_allreduce_bytes_per_s,
                      ici_wire_scale=ici_s, dcn_wire_scale=dcn_s,
                      quantize_s=1e-4, phase_overhead_s=2e-5)
            _close(modeled_exchange_seconds(102_228_128.0, **kw),
                   jmodel(102_228_128.0, **kw))


def test_chip_model_is_h100_without_tpu_constants():
    assert not hasattr(scaling, "V5E") and not hasattr(scaling, "V5P")
    h = scaling.H100_SXM
    assert (h.bf16_tflops, h.ici_gbps, h.ici_domain_chips,
            h.dcn_gbps_per_chip) == (989.0, 7200.0, 8, 400.0)
    assert h.links() == {"ici": 450e9, "dcn": 25e9}


# ---------------------------------------------------------------------------
# Wire accounting in the recording world
# ---------------------------------------------------------------------------

class _Three(torch.nn.Module):
    """The JAX test's three leaves, zeros."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(256, 128))
        self.b = torch.nn.Parameter(torch.zeros(128))
        self.h = torch.nn.Parameter(torch.zeros(64, 64,
                                                dtype=torch.bfloat16))


def _three_loss(m, batch):
    x, y = batch
    return (torch.mean((x @ m.w + m.b) ** 2)
            + torch.mean(m.h.float() ** 2) + torch.mean(y * 0.0))


def _three_step(lr=0.1):
    """``(step, (batch,))`` of the three-leaf model, built in a world."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.training import make_train_step
    model = _Three()
    named = list(model.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=lr),
        named_parameters=named)
    step = make_train_step(model, _three_loss, opt)
    return step, ((torch.zeros(2, 256), torch.zeros(2)),)


@pytest.fixture(scope="module")
def jax_emitted():
    """The JAX emitted stats of the same step (the conftest's 8-device
    mesh), the JAX test's own construction."""
    import horovod_tpu as hv
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.training import make_train_step

    j = _jscaling()
    hv.shutdown()
    hv.init()
    try:
        params = {"w": jnp.zeros((256, 128), jnp.float32),
                  "b": jnp.zeros((128,), jnp.float32),
                  "h": jnp.zeros((64, 64), jnp.bfloat16)}

        def loss_fn(p, batch):
            x, y = batch
            return (jnp.mean((x @ p["w"] + p["b"]) ** 2)
                    + jnp.mean(p["h"].astype(jnp.float32) ** 2)
                    + jnp.mean(y * 0.0))

        opt = hv.DistributedOptimizer(optax.sgd(0.1))
        params = hv.replicate(params)
        opt_state = hv.replicate(opt.init(params))
        step = make_train_step(loss_fn, opt)
        n = len(jax.devices())
        batch = hv.shard_batch((jnp.zeros((2 * n, 256), jnp.float32),
                                jnp.zeros((2 * n,), jnp.float32)))
        emitted = j.emitted_collective_stats(
            step.lower(params, opt_state, batch).as_text())
    finally:
        hv.shutdown()
    return emitted


@pytest.mark.parametrize("world", [2, 4, 8])
def test_train_step_wire_accounting_matches_jax(world, jax_emitted):
    from horovod_tpu_torch.controller.fusion import plan_buckets
    stats = scaling.step_collective_stats(_three_step, world=world,
                                          device="cpu")
    model = _Three()
    params = list(model.parameters())
    assert len(plan_buckets(params, 64 << 20, reverse=True).buffers) == 2
    param_bytes = sum(p.numel() * p.element_size() for p in params)
    assert stats.counts == {"all-reduce": 3}
    assert stats.bytes == {"all-reduce": param_bytes + 4}
    assert stats.counts == jax_emitted.counts
    assert stats.bytes == jax_emitted.bytes
    assert stats.total_bytes == jax_emitted.total_bytes
    assert stats.total_count == jax_emitted.total_count == 3
    # The wire keeps each bucket's dtype: bf16 stays bf16.
    assert sorted(r.dtype for r in stats.records) == \
        ["bfloat16", "float32", "float32"]


_BN_THRESHOLD = 16 * 1024       # a few buckets of the tiny ResNet


def _bn_model():
    from horovod_tpu_torch.models.resnet import BasicBlock, ResNet
    torch.manual_seed(0)
    return ResNet(stage_sizes=[1, 1], block_cls=BasicBlock, num_classes=10,
                  num_filters=8, dtype=torch.float32, device="cpu")


def _bn_step():
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.training import make_flax_train_step
    model = _bn_model()
    named = list(model.named_parameters())
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.01, momentum=0.9),
        named_parameters=named, fusion_threshold=_BN_THRESHOLD)
    rng = np.random.RandomState(1)
    batch = (torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 10, 4)))
    return make_flax_train_step(model, opt), (batch,)


def test_bn_cnn_payload_is_the_plan_at_every_n():
    from horovod_tpu_torch.controller.fusion import explain_plan
    model = _bn_model()
    rows = explain_plan(list(model.parameters()), _BN_THRESHOLD,
                        reverse=True, register=False)
    planned = sum(r["wire_bytes"] for r in rows)
    assert planned == 4 * sum(p.numel() for p in model.parameters())
    stat_bytes = 4 * sum(b.numel() for b in model.buffers()
                         if b.is_floating_point())
    seen = []
    for world in (2, 4, 8, 16):
        grads, sync = scaling.split_gradient_stats(
            scaling.step_collective_stats(_bn_step, world=world,
                                          device="cpu"))
        assert grads.counts == {"all-reduce": len(rows)}
        assert grads.bytes == {"all-reduce": planned}
        assert sync.bytes == {"all-reduce": stat_bytes + 4}
        seen.append((grads.bytes, grads.counts, sync.bytes, sync.counts))
    assert all(s == seen[0] for s in seen)


def test_two_level_legs_are_the_plan_and_do_not_move_with_n_dcn():
    from horovod_tpu_torch.controller.fusion import (explain_plan,
                                                     plan_hier_legs)
    model = _bn_model()
    rows = explain_plan(list(model.parameters()), _BN_THRESHOLD,
                        reverse=True, register=False)
    n_ici = 2
    legs = {}
    for n_dcn in (2, 4):
        grads, _ = scaling.split_gradient_stats(
            scaling.step_collective_stats(_bn_step, world=n_dcn * n_ici,
                                          device="cpu",
                                          hierarchical=(n_dcn, n_ici)))
        assert grads.counts == {"reduce-scatter": len(rows),
                                "all-reduce": len(rows),
                                "all-gather": len(rows)}
        want = {"reduce-scatter": 0, "all-reduce": 0, "all-gather": 0}
        for row in rows:
            rs, ar, ag = plan_hier_legs(row["elements"], row["dtype"],
                                        n_dcn=n_dcn, n_ici=n_ici)
            want["reduce-scatter"] += rs.nbytes // n_ici  # the B/n shard
            want["all-reduce"] += ar.nbytes
            want["all-gather"] += ag.nbytes
        assert grads.bytes == want
        legs[n_dcn] = grads.bytes
    assert legs[2] == legs[4]


def test_record_bytes_follow_the_hlo_result_semantics():
    from horovod_tpu_torch.analysis.collective_walk import CollectiveRecord

    def rec(kind, dtype="float32", elements=64, n=4):
        return CollectiveRecord(kind=kind, dtype=dtype, elements=elements,
                                path="p", group="world", group_size=n)

    assert scaling.record_op_bytes(rec("psum")) == ("all-reduce", 256)
    assert scaling.record_op_bytes(rec("pmax", "bfloat16")) == \
        ("all-reduce", 128)
    assert scaling.record_op_bytes(rec("all_gather")) == \
        ("all-gather", 1024)                       # shard x n
    assert scaling.record_op_bytes(rec("reduce_scatter")) == \
        ("reduce-scatter", 64)                     # input / n
    assert scaling.record_op_bytes(rec("all_to_all")) == ("all-to-all", 256)
    assert scaling.record_op_bytes(rec("ppermute")) == \
        ("collective-permute", 256)
    assert scaling.record_op_bytes(rec("barrier")) is None
    assert scaling.record_op_bytes(rec("broadcast")) is None
    with pytest.raises(ValueError, match="HLO"):
        scaling.record_op_bytes(rec("gather"))
    stats = scaling.recorded_collective_stats(
        [rec("psum"), rec("barrier"), rec("all_gather"), rec("psum")])
    assert stats.counts == {"all-reduce": 2, "all-gather": 1}
    assert stats.bytes == {"all-reduce": 512, "all-gather": 1024}
    assert len(stats.records) == 3


# ---------------------------------------------------------------------------
# In-place updates and the overlap report
# ---------------------------------------------------------------------------

def test_updates_in_place():
    from horovod_tpu_torch.analysis.collective_walk import recording_world
    with recording_world(2, 0, device="cpu"):
        step, (batch,) = _bn_step()
        model = step._meta["model"]
        assert scaling.updates_in_place(step, batch, params=model)
        assert step._meta["optimizer"].state      # momentum was checked

    model = _Three()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    def rebinding(batch):
        opt.zero_grad()
        _three_loss(model, batch).backward()
        with torch.no_grad():
            model.w.data = model.w - 0.1 * model.w.grad
        opt.step()

    batch = (torch.ones(2, 256), torch.zeros(2))
    assert not scaling.updates_in_place(rebinding, batch, params=model,
                                        optimizer=opt)

    def in_place(batch):
        opt.zero_grad()
        _three_loss(model, batch).backward()
        opt.step()

    assert scaling.updates_in_place(in_place, batch,
                                    params=list(model.parameters()),
                                    optimizer=opt)


def test_step_overlap_report_sorts_buckets_and_loss():
    rep = scaling.step_overlap_report(_three_step, world=4, device="cpu")
    params = list(_Three().parameters())
    f32 = sum(p.numel() * 4 for p in params if p.dtype == torch.float32)
    # Both planned buckets issued from their hooks, waited in
    # synchronize(): async, compute inside their windows.
    assert sorted(b for _, b, _, _ in rep.async_collectives) == \
        [64 * 64 * 2, f32]
    assert all(op == "all-reduce" for op, *_ in rep.async_collectives)
    assert rep.async_window_seconds > 0.0
    # The loss average is waited on by the call that issued it.
    assert rep.sync_collectives == [("all-reduce", 4,
                                     rep.sync_collectives[0][2])]
    assert rep.sync_bytes == 4 and rep.async_bytes == 64 * 64 * 2 + f32
    assert 0.0 < rep.async_window_seconds <= rep.total_compute_seconds
    assert rep.n_devices == 4 and rep.n_instructions > 0
    for _, _, issue, wait in rep.async_collectives:
        assert 0 <= issue <= wait <= rep.n_instructions
    assert rep.sync_collectives[0][2] <= rep.n_instructions
    # The report feeds the scheduled projection.
    pts = scaling.predict_efficiency_scheduled(
        rep.total_compute_seconds, rep, scaling.H100_SXM)
    assert all(p.eff_full_overlap >= p.eff_no_overlap for p in pts)


class _Event:
    """A profiler event as ``_kernels`` reads it (the kineto event's
    methods)."""

    def __init__(self, name, device, start, end, corr, linked=0):
        self._v = (name, device, start, end, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


def test_kernels_are_placed_at_their_launch_call_or_refused():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("aten::mm", cpu, 100, 400, 7),                  # the op
        _Event("cudaLaunchKernel", cpu, 150, 160, 11, linked=7),
        _Event("cudaLaunchKernel", cpu, 300, 310, 12, linked=7),
        _Event("gemm", cuda, 5_000, 5_250, 12),
        _Event("relu", cuda, 4_000, 4_100, 11),
        _Event("[memory]", cuda, 4_500, 4_500, 0),
    ]
    # At their launch calls' CPU times, not their device starts.
    assert scaling._kernels(events, "cuda") == [(150, 100), (300, 250)]
    # A kernel whose launch call is missing is refused, not placed at an
    # op (its linked id) or at its device start.
    lost = events + [_Event("softmax", cuda, 6_000, 6_040, 13, linked=7)]
    with pytest.raises(RuntimeError, match="1 of 3 device kernels"):
        scaling._kernels(lost, "cuda")
    zero = events + [_Event("softmax", cuda, 6_000, 6_040, 0)]
    with pytest.raises(RuntimeError, match="'softmax'"):
        scaling._kernels(zero, "cuda")


def test_split_gradient_stats_by_the_issuing_module():
    from horovod_tpu_torch.analysis.collective_walk import CollectiveRecord

    def rec(path, elements):
        return CollectiveRecord(kind="psum", dtype="float32",
                                elements=elements, path=path, group="world",
                                group_size=4)

    stats = scaling.recorded_collective_stats([
        rec("optim.distributed:_issue:582", 100),
        rec("training:_mean_loss:40", 1),
        rec("ops.bn:sync_stats:12", 8),
        rec("optim.distributed:synchronize:788", 50)])
    grads, sync = scaling.split_gradient_stats(stats)
    assert (grads.counts, grads.bytes) == ({"all-reduce": 2},
                                           {"all-reduce": 600})
    assert (sync.counts, sync.bytes) == ({"all-reduce": 2},
                                         {"all-reduce": 36})
