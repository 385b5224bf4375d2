"""PyTorch/CUDA port: the observability plane against the JAX package.

* ``Timeline``: the events of the same calls under a mocked clock equal
  the JAX writer's, event for event, spans mirrored through the span
  recorder included; the file is JSON after ``close()``.
* The merge CLI (``python -m horovod_tpu_torch.timeline --merge DIR``):
  the report and the merged trace equal JAX ``timeline.__main__.merge``
  on the same per-rank files, and the printed report equals the JAX
  CLI's.
* ``DispatchGapMonitor`` / ``OverlapMonitor`` equal the JAX formulas
  under a mocked clock; ``StragglerMonitor`` equals the JAX monitor on
  the same summaries (reports, renders, metric families, the eviction
  hook).
* ``render_prometheus`` equals the JAX text on the same registry
  operations (labels with escapes, histograms); the snapshot's
  unlabelled entries, ``bench_block``, ``histogram_window`` /
  ``histogram_quantile`` and ``record_step_report`` equal the JAX ones.
* ``MetricsServer`` on port 0 (text, JSON, liveness, 404, a signed
  variant), and from ``init()`` under ``HOROVOD_METRICS_PORT=0``.
* ``TracePlane`` over a local ``http_kv`` server; ``HOROVOD_TRACE_SYNC``
  without one only warns.
* The sampler: a train step's ``StepReport``, its span summary to the
  straggler monitor, one ``dispatch`` event a step in the timeline.
* ``init()`` / ``shutdown()`` start and stop the timeline writer and
  the metrics server threads, through a re-init too.
"""

import itertools
import json
import logging
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import timeline as ttimeline
from horovod_tpu_torch.timeline import __main__ as tmain
from horovod_tpu_torch.timeline import metrics as tmetrics
from horovod_tpu_torch.timeline import spans as tspans
from horovod_tpu_torch.timeline import straggler as tstraggler
from horovod_tpu_torch.timeline import sync as tsync

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "HOROVOD_RANK", "HOROVOD_SIZE",
        "HVD_TPU_RANK", "HVD_TPU_SIZE", "HOROVOD_TIMELINE",
        "HOROVOD_METRICS", "HOROVOD_METRICS_PORT", "HOROVOD_TRACE_SYNC",
        "HVD_TPU_ELASTIC_ASSIGNMENT", "HOROVOD_TIMELINE_MARK_CYCLES")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    import horovod_tpu.timeline.metrics as jm
    import horovod_tpu.timeline.spans as js
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for mod in (jm, tmetrics):
        mod.reset_metrics()
    for rec in (js.recorder(), tspans.recorder()):
        rec.reset()
    yield
    thvd.shutdown()
    for rec in (js.recorder(), tspans.recorder()):
        rec.reset()
    for mod in (jm, tmetrics):
        mod.reset_metrics()


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter`` and ``time.time`` as deterministic counters
    (1 ms and 1 s a call), restarted by calling the fixture."""
    import time

    def restart():
        ticks = itertools.count()
        wall = itertools.count(1_700_000_000)
        monkeypatch.setattr(time, "perf_counter",
                            lambda: next(ticks) * 1e-3)
        monkeypatch.setattr(time, "time", lambda: float(next(wall)))
    restart()
    return restart


def _events(path):
    with open(path) as f:
        return json.load(f)


def _drive_timeline(mod, spans_mod, path):
    """The same calls on one package's Timeline and span recorder."""
    tl = mod.Timeline(str(path), mark_cycles=True, rank=3,
                      hostname="host-a", flush_interval=60.0)
    tl.begin("allreduce.w", "NEGOTIATE_ALLREDUCE", args={"bytes": 64})
    tl.end("allreduce.w", "NEGOTIATE_ALLREDUCE")
    with tl.range("allreduce.w", "ALLREDUCE", args={"n": 2}):
        tl.instant("tick")
    tl.complete("gaps", "dispatch_gap", 0.25, args={"step": 1})
    tl.counter("host_dispatch_gap", 0.5)
    tl.counters({"b": 2, "a": 1})
    tl.mark_cycle()
    rec = spans_mod.recorder().configure(rank=3, timeline=tl)
    rec.set_step(7)
    with rec.span("dispatch", name="step", leg="flat_ar", bucket_id=2,
                  fuse_key="k"):
        pass
    rec.add("dispatch_gap", 0.125, emit=True)
    rec.note_leg("guard/screen", 8)
    summary = rec.step_boundary(7, 0.5, t0_unix_us=10.0)
    tl.close()
    tl.close()                                   # idempotent
    return summary


def test_timeline_events_equal_jax(tmp_path, clock):
    import horovod_tpu.timeline as jtimeline
    import horovod_tpu.timeline.spans as jspans
    want_summary = _drive_timeline(jtimeline, jspans, tmp_path / "j.json")
    clock()
    got_summary = _drive_timeline(ttimeline, tspans, tmp_path / "t.json")
    assert _events(tmp_path / "t.json") == _events(tmp_path / "j.json")
    assert got_summary == want_summary
    ev = _events(tmp_path / "t.json")
    assert ev[0]["name"] == "clock_anchor" and ev[0]["args"]["rank"] == 3
    assert any(e.get("ph") == "X" and e["name"] == "dispatch_gap" and
               e["args"]["step"] == 7 for e in ev)


def _rank_trace(path, rank, steps, seed):
    """A rank's trace through the port's recorder: per step a dispatch
    span and a dispatch gap."""
    rng = np.random.RandomState(seed)
    tl = ttimeline.Timeline(str(path), rank=rank, hostname=f"h{rank}",
                            flush_interval=60.0)
    rec = tspans.SpanRecorder().configure(rank=rank, timeline=tl)
    for s in range(1, steps + 1):
        rec.set_step(s)
        rec.add("dispatch_gap", float(rng.rand()) * 1e-3, emit=True)
        with rec.span("dispatch", name="step"):
            with tl.range("allreduce", "ALLREDUCE", args={"step": s}):
                pass
        rec.step_boundary(s, 0.01)
    tl.close()


def test_merge_cli_equals_jax(tmp_path, clock, capsys):
    from horovod_tpu.timeline import __main__ as jmain
    d = tmp_path / "traces"
    d.mkdir()
    for r in range(3):
        _rank_trace(d / f"timeline.json.{r}.json", r, steps=4, seed=r)
    (d / "broken.json").write_text("{")
    want = jmain.merge(str(d), str(tmp_path / "jmerged.json"))
    got = tmain.merge(str(d), str(tmp_path / "tmerged.json"))
    for rep in (want, got):
        rep.pop("out")
        for info in rep["per_rank"].values():
            info.pop("path")
    assert got == want
    assert got["ranks"] == 3 and len(got["skipped"]) == 1
    assert all(info["steps"] == 4 for info in got["per_rank"].values())
    assert _events(tmp_path / "tmerged.json") == \
        _events(tmp_path / "jmerged.json")
    capsys.readouterr()
    assert jmain.main(["--merge", str(d)]) == 0
    jout = capsys.readouterr().out
    os.remove(d / "merged_timeline.json")
    assert tmain.main(["--merge", str(d)]) == 0
    tout = capsys.readouterr().out
    assert tout == jout and "straggler: rank" in tout


def test_dispatch_gap_and_overlap_monitors_equal_jax(clock):
    import horovod_tpu.timeline as jtimeline
    from horovod_tpu.timeline import metrics as jm
    out = []
    for mod, reg in ((jtimeline, jm.registry), (ttimeline,
                                                tmetrics.registry)):
        clock()
        gap = mod.DispatchGapMonitor()
        for dispatches in (1, 3, 0):
            gap.begin_window()
            for _ in range(dispatches):
                with gap.dispatch():
                    pass
            gap.end_window()
        ov = mod.OverlapMonitor(compute_s=0.002, comm_s=0.003)
        for steps in (1, 2, 4):
            ov.begin_window()
            ov.end_window(steps)
        with pytest.raises(RuntimeError):
            gap.end_window()
        with pytest.raises(ValueError):
            mod.OverlapMonitor(-1.0, 1.0)
        out.append((gap.windows, gap.gap_fraction, ov.windows,
                    ov.overlap_fraction,
                    reg().gauge("horovod_dispatch_gap_fraction").value,
                    reg().gauge("horovod_exchange_overlap_fraction").value))
    assert out[0] == out[1]


SUMMARIES = [(r, s, 0.01 * (1 + r) + 0.001 * s, {"dispatch": 0.004 * r,
                                                  "fence": 0.002})
             for s in range(1, 6) for r in range(3)]


def test_straggler_monitor_equals_jax():
    from horovod_tpu.timeline import metrics as jm
    from horovod_tpu.timeline import straggler as jstraggler
    results = []
    for mod, reg in ((jstraggler, jm.registry), (tstraggler,
                                                 tmetrics.registry)):
        fired = []
        mon = mod.StragglerMonitor(world=3, stall_check_time=5.0)
        mon.add_eviction_hook(0.015, lambda r, late: fired.append(
            (r, round(late, 9))))
        for i, (r, s, wall, spans) in enumerate(SUMMARIES):
            mon.observe({"rank": r, "step": s, "wall_s": wall,
                         "spans": spans}, now=float(i))
        mon.observe({"bad": 1})
        rep = mon.report()
        rendered = mon.render()
        mon.evict(rep["straggler_rank"])
        after = mon.report()
        snap = reg().snapshot()
        fams = {k: {kk: v for kk, v in snap[k].items() if kk != "samples"}
                for k in snap if "straggler" in k or "skew" in k}
        results.append((rep, rendered, after, fired, fams,
                        mon.observations))
    assert results[0] == results[1]
    assert results[1][0]["straggler_rank"] == 2
    assert results[1][0]["dominant_span"] == "dispatch"


def _registry_ops(mod):
    reg = mod.registry()
    reg.counter("req_total", 'Requests "served"\nper path',
                ("path", "code")).labels(path='/a"b\\c\nd', code=200).inc(3)
    reg.counter("req_total").labels(path="/x", code=500).inc()
    reg.gauge("temp_c", "Temperature").set(21.5)
    reg.gauge("temp_c").dec(0.5)
    reg.gauge("depth", "Queue depth").set(1e20)
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.1, 0.7, 3.0, 1.0):
        h.observe(v)
    reg.histogram("ttft", "TTFT by tenant", labelnames=("tenant",)).labels(
        tenant="t1").observe(0.02)
    reg.counter("empty_total", "Never incremented")
    mod.record_step_report(mod.StepReport(
        step=4, wall_time_s=0.4, steps_per_exec=4, microbatches=2,
        codec="fp16", exchanged_bytes=100, uncompressed_bytes=200))
    return reg


def test_render_prometheus_and_snapshot_equal_jax():
    from horovod_tpu.timeline import metrics as jm
    jreg, treg = _registry_ops(jm), _registry_ops(tmetrics)
    assert tmetrics.render_prometheus() == jm.render_prometheus()
    assert 'path="/a\\"b\\\\c\\nd"' in tmetrics.render_prometheus()
    jsnap, tsnap = jm.metrics_snapshot(), tmetrics.metrics_snapshot()
    assert set(jsnap) == set(tsnap)
    for name, entry in jsnap.items():
        # The port keeps a samples list on unlabelled families too.
        got = tsnap[name] if "samples" in entry else \
            {k: v for k, v in tsnap[name].items() if k != "samples"}
        assert got == entry, name
    assert tmetrics.bench_block() == jm.bench_block()
    assert tmetrics.last_step_report() == tmetrics.StepReport(
        step=4, wall_time_s=0.4, steps_per_exec=4, microbatches=2,
        codec="fp16", exchanged_bytes=100, uncompressed_bytes=200)
    h1 = treg.histogram("lat_seconds").snapshot()
    treg.histogram("lat_seconds").observe(0.2)
    h2 = treg.histogram("lat_seconds").snapshot()
    win = tmetrics.histogram_window(h2, h1)
    assert win == jm.histogram_window(h2, h1)
    assert win["count"] == 1
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert tmetrics.histogram_quantile(h2, q) == \
            jm.histogram_quantile(h2, q)
    assert tmetrics.histogram_quantile({"count": 0}, 0.5) is None


def test_install_default_metrics_and_disabled_registry(monkeypatch):
    tmetrics.install_default_metrics()
    text = tmetrics.render_prometheus()
    for fam in ("horovod_step_total", "horovod_step_time_seconds",
                "horovod_plan_cache_hits_total", "horovod_plan_cache_size",
                "horovod_elastic_steps_to_recover"):
        assert f"# TYPE {fam} " in text, fam
    monkeypatch.setenv("HOROVOD_METRICS", "0")
    tmetrics.reset_metrics()
    assert tmetrics.registry().counter("x") is tmetrics.NULL_METRIC
    tmetrics.install_default_metrics()
    assert tmetrics.render_prometheus() == ""


# ---------------------------------------------------------------------------
# The /metrics server and the trace plane
# ---------------------------------------------------------------------------


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, "", None


def test_metrics_server_on_port_zero():
    from horovod_tpu_torch.run.http_kv import (SIG_HEADER, TS_HEADER,
                                               _signable)
    from horovod_tpu_torch.run.metrics_server import MetricsServer
    from horovod_tpu_torch.run.secret import compute_digest
    tmetrics.registry().counter("horovod_guard_skipped_total", "x").inc(2)
    srv = MetricsServer(port=0)
    try:
        assert srv.port > 0
        code, body, ctype = _get(srv.port, "/metrics")
        assert code == 200 and ctype == tmetrics.CONTENT_TYPE
        assert body == tmetrics.render_prometheus()
        assert "horovod_guard_skipped_total 2" in body
        code, body, _ = _get(srv.port, "/metrics.json")
        assert json.loads(body)["horovod_guard_skipped_total"]["value"] == 2
        assert _get(srv.port, "/healthz")[:2] == (200, "ok\n")
        assert _get(srv.port, "/nope")[0] == 404
    finally:
        srv.stop()
    srv = MetricsServer(port=0, secret_key="s3cret")
    try:
        assert _get(srv.port, "/metrics")[0] == 403
        assert _get(srv.port, "/healthz")[0] == 200
        import time
        ts = str(time.time())
        sig = compute_digest("s3cret", _signable("GET", "/metrics", ts, b""))
        assert _get(srv.port, "/metrics",
                    {SIG_HEADER: sig, TS_HEADER: ts})[0] == 200
    finally:
        srv.stop()
    assert not srv._thread.is_alive()


def test_trace_plane_over_a_local_kv_server(tmp_path):
    from horovod_tpu_torch.run.http_kv import KVClient, RendezvousServer
    server = RendezvousServer("k3y")
    try:
        kv = KVClient("127.0.0.1", server.port, "k3y", timeout_s=5.0)
        offset, rtt = tsync.estimate_clock_offset(kv, samples=4)
        assert abs(offset) < 1.0 and 0 <= rtt < 1.0
        mon = tstraggler.StragglerMonitor(world=2, stall_check_time=0.0)
        plane = tsync.TracePlane(kv, rank=0, size=2, publish_steps=2,
                                 monitor=mon)
        peer = tsync.TracePlane(kv, rank=1, size=2, publish_steps=2)
        for step in (1, 2):
            peer.on_summary({"rank": 1, "step": step, "t0_us": 1e6,
                             "wall_s": 0.030, "spans": {"fence": 0.02}})
            s0 = {"rank": 0, "step": step, "t0_us": 1e6, "wall_s": 0.010,
                  "spans": {"dispatch": 0.008}}
            mon.observe(s0)
            plane.on_summary(s0)
        assert [s["rank"] for s in plane._collected[2]] == [0, 1]
        assert plane.step_skew(2) == pytest.approx(0.02)
        assert plane.step_skew(1) is None            # step 1 not published
        rep = mon.report()
        assert rep["straggler_rank"] == 1 and rep["dominant_span"] == "fence"
        assert abs(plane.rank_offset(1)) < 1.0
        n = plane.write_merged(str(tmp_path / "merged.json"))
        ev = _events(tmp_path / "merged.json")
        assert n == 2 and sum(e["name"] == "step 2" for e in ev) == 2
    finally:
        server.stop()


def test_trace_sync_without_a_kv_store_only_warns(monkeypatch, caplog):
    monkeypatch.setenv("HOROVOD_TRACE_SYNC", "1")
    with caplog.at_level(logging.WARNING, logger="horovod_tpu_torch"):
        thvd.init(device="cpu")
    from horovod_tpu_torch.core.state import global_state
    assert global_state().trace_plane is None
    assert "HOROVOD_TRACE_SYNC=1 but no HTTP KV" in caplog.text


# ---------------------------------------------------------------------------
# init() wiring, the sampler, thread cleanup
# ---------------------------------------------------------------------------


def _observability_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name in ("hvd-torch-timeline", "hvd-torch-metrics"))


def test_init_starts_and_shutdown_stops_the_threads(monkeypatch, tmp_path):
    from horovod_tpu_torch.core.state import global_state
    base = _observability_threads()
    for life in range(2):                  # the second: an elastic re-init
        monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / f"t{life}"))
        monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
        thvd.init(device="cpu")
        st = global_state()
        assert st.straggler is not None and st.metrics_server.port > 0
        assert _observability_threads() == sorted(
            base + ["hvd-torch-metrics", "hvd-torch-timeline"])
        assert _get(st.metrics_server.port, "/healthz")[0] == 200
        server = st.metrics_server
        thvd.shutdown()
        assert _observability_threads() == base
        assert not server._thread.is_alive()
        assert _events(tmp_path / f"t{life}")[0]["name"] == "clock_anchor"


def test_start_and_stop_timeline_at_run_time(tmp_path):
    with pytest.raises(thvd.core.exceptions.NotInitializedError):
        thvd.start_timeline(str(tmp_path / "early.json"))
    thvd.init(device="cpu")
    thvd.start_timeline(str(tmp_path / "a.json"), mark_cycles=True)
    assert tspans.recorder().timeline is not None
    thvd.start_timeline(str(tmp_path / "b.json"))   # closes a.json
    assert _events(tmp_path / "a.json")[0]["name"] == "clock_anchor"
    thvd.stop_timeline()
    thvd.stop_timeline()
    assert tspans.recorder().timeline is None
    assert _events(tmp_path / "b.json")[0]["args"]["rank"] == 0


def test_sampler_reports_steps_and_feeds_the_straggler_monitor(
        monkeypatch, tmp_path):
    from horovod_tpu_torch.core.state import global_state
    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "tl.json"))
    thvd.init(device="cpu")
    model = torch.nn.Linear(4, 2)
    named = list(model.named_parameters())
    opt = thvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                    lr=0.1),
                                    named_parameters=named,
                                    compression=thvd.Compression.fp16)

    def loss_fn(m, b):
        return torch.mean((m(b[0]) - b[1]) ** 2)

    step = thvd.make_train_step(model, loss_fn, opt)
    batch = (torch.randn(8, 4), torch.randn(8, 2))
    for _ in range(3):
        step(batch)
    rep = tmetrics.last_step_report()
    assert rep.step == 3 and rep.codec == "FP16Compressor"
    assert rep.uncompressed_bytes == 40 and rep.exchanged_bytes == 20
    reg = tmetrics.registry()
    assert reg.counter("horovod_step_total").value == 3
    assert reg.histogram("horovod_step_time_seconds").snapshot()["count"] \
        == 3
    mon = global_state().straggler
    assert mon.observations == 3
    assert mon.report()["straggler_rank"] == 0
    assert sorted(tspans.recorder().summaries) == [1, 2, 3]
    assert set(tspans.recorder().summaries[3]["spans"]) == \
        {"dispatch", "dispatch_gap"}
    thvd.shutdown()
    ev = _events(tmp_path / "tl.json")
    steps = [e for e in ev if e.get("name") == "dispatch" and e["ph"] == "B"]
    assert [e["args"]["step"] for e in steps] == [1, 2, 3]
    assert sum(e.get("name") == "dispatch_gap" for e in ev) == 2


def test_sampler_unwraps_with_metrics_off(monkeypatch):
    monkeypatch.setenv("HOROVOD_METRICS", "0")
    thvd.init(device="cpu")
    model = torch.nn.Linear(2, 1)
    step = thvd.make_train_step(model, lambda m, b: m(b).sum(),
                                torch.optim.SGD(model.parameters(), lr=0.1))
    assert not hasattr(step, "_meta")
    step(torch.ones(3, 2))
    assert tmetrics.last_step_report() is None


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with ttimeline.device_trace(str(tmp_path / "prof")):
        torch.ones(64).sum()
    ev = json.load(open(tmp_path / "prof" / "device_trace.json"))
    assert "traceEvents" in ev
