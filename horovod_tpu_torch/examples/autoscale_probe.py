"""The serving control plane's closed loop, watched from ``/metrics`` (the
port of ``examples/autoscale_probe.py``).

Every rank of the world runs :class:`~horovod_tpu_torch.serving.
ServingControlPlane` over all the world's ranks at the top of the tp
ladder, serving a seeded Poisson load of ``LLAMA_SERVE`` requests while a
chaos spec fires *virtually*: ``kill@`` marks a rank dead mid-decode (a
mandatory shrink, its process keeps running the loop outside the mesh)
and ``slow@`` degrades a rank until the straggler monitor's lateness
EWMA has it evicted.  The ranks run in lock-step, so each one's report
is rank 0's.  Rank 0 then plays the monitoring stack: it GETs the
``/metrics`` endpoint that ``init()`` started (``HOROVOD_METRICS_PORT``,
0 for an ephemeral port) and checks every ``horovod_ctl_*`` family
against the drill report (:func:`check_ctl_metrics`: decisions, resizes,
evictions, drained requests, the mesh-size and healthy-rank gauges), and
that nothing was lost: every request completed across the transitions
with no KV page leaked.  Run under the launcher::

    python -m horovod_tpu_torch.run -np 4 --cpu \\
        python -m horovod_tpu_torch.examples.autoscale_probe --device cpu

The ranks run on ``cuda`` unless ``--device cpu`` (or the launcher's
``--cpu``).  Rank 0 prints ``autoscale probe OK`` last.
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.request
from typing import Dict, List

CTL_FAMILIES = (
    "horovod_ctl_decisions_total",
    "horovod_ctl_resizes_total",
    "horovod_ctl_evictions_total",
    "horovod_ctl_drained_requests_total",
    "horovod_ctl_mesh_size",
    "horovod_ctl_healthy_ranks",
)

DEFAULT_SPEC = "kill@step=20,rank=3;slow@step=35,rank=1,secs=0.2"


def _samples(text: str, family: str) -> Dict[str, float]:
    """``{labels: value}`` of the sample lines of ``family``."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(family) and not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            if name.split("{", 1)[0] == family:
                out[name[len(family):]] = float(value)
    return out


def check_ctl_metrics(text: str, report: dict, healthy: int) -> List[str]:
    """The ``horovod_ctl_*`` families in Prometheus ``text`` against a
    control-plane ``report`` (``ControlPlaneReport.as_dict()``) and the
    plane's ``healthy`` rank count; returns what disagrees."""
    families = [ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE ")]
    fails = [f"{f} absent" for f in CTL_FAMILIES if f not in families]
    decisions = _samples(text, "horovod_ctl_decisions_total")
    for action, n in report["decision_counts"].items():
        got = decisions.get(f'{{action="{action}"}}', 0.0)
        if got != n:
            fails.append(f"decisions {action}: {got} != {n}")
    total = sum(_samples(text, "horovod_ctl_resizes_total").values())
    if total != report["resizes"]:
        fails.append(f"resizes {total} != {report['resizes']}")
    evictions = sum(_samples(text, "horovod_ctl_evictions_total").values())
    if evictions != len(report["evicted_ranks"]) + len(report["dead_ranks"]):
        fails.append(f"evictions {evictions} != evicted "
                     f"{report['evicted_ranks']} + dead "
                     f"{report['dead_ranks']}")
    drained = _samples(text, "horovod_ctl_drained_requests_total")
    for path, key in (("completed", "drained_completed"),
                      ("reprefill", "drained_reprefilled")):
        got = drained.get(f'{{path="{path}"}}', 0.0)
        if got != report[key]:
            fails.append(f"drained {path}: {got} != {report[key]}")
    for family, want in (("horovod_ctl_mesh_size",
                          report["mesh_size_final"]),
                         ("horovod_ctl_healthy_ranks", healthy)):
        got = sum(_samples(text, family).values())
        if got != want:
            fails.append(f"{family} {got} != {want}")
    return fails


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=40.0,
                   help="open-loop arrival rate (requests/s)")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chaos-spec", default=DEFAULT_SPEC,
                   help="kill@/slow@ spec fired virtually (the chaos "
                        "grammar; ranks of the world)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    # The endpoint's port is read at init(); 0 = ephemeral.
    os.environ.setdefault("HOROVOD_METRICS_PORT", "0")
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import LLAMA_SERVE, init_llama_params
    from horovod_tpu_torch.serving import (LoadSpec, PolicyConfig,
                                           ServingControlPlane, generate)

    cpu = args.device == "cpu" or bool(os.environ.get("HVD_TPU_FORCE_CPU"))
    hvd.init(device="cpu" if cpu else None)
    rank, world = hvd.rank(), hvd.size()
    dev = global_state().device
    if world < 2:
        raise SystemExit("run under horovod_tpu_torch.run -np 2+")
    server = global_state().metrics_server
    if rank == 0:
        print(f"ranks: {world} on {dev}, /metrics on port {server.port}; "
              f"chaos spec: {args.chaos_spec}", flush=True)
    cfg = LLAMA_SERVE
    params = init_llama_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    policy_cfg = PolicyConfig(
        interval_s=0.05, ttft_slo_s=2.0, queue_high=20,
        occupancy_low=0.15, hysteresis=2, cooldown_s=0.3,
        evict_lateness_s=0.05, drain_steps=8)
    plane = ServingControlPlane(
        cfg, params, initial_tp=world, policy_config=policy_cfg,
        chaos_spec=args.chaos_spec, device=dev, slots=args.slots,
        page_size=8, max_len=64)
    spec = LoadSpec(num_requests=args.requests, rate_rps=args.rate,
                    prompt_lens=(4, 8, 16), output_lens=(8, 16, 24),
                    vocab_size=cfg.vocab_size, seed=11)
    rep = plane.serve(generate(spec))
    report = rep.as_dict()
    # Lock-step: every rank's report is rank 0's.
    reports = hvd.allgather_object(report)
    assert all(r == reports[0] for r in reports), "ranks disagree"
    assert rep.lost_requests == 0 and rep.drain_leaked_pages == 0, report
    assert plane.engine.cache.allocated_pages == 0, report
    assert rep.dead_ranks and rep.evicted_ranks, report
    assert rep.mesh_size_final < rep.mesh_size_initial, report
    if rank == 0:
        print(f"served {rep.serving.completed}/{rep.serving.num_requests} "
              f"requests across {rep.resizes} resize(s): mesh "
              f"{rep.mesh_size_initial} -> {rep.mesh_size_final}, dead "
              f"{rep.dead_ranks}, evicted {rep.evicted_ranks}; drain: "
              f"{rep.drained_completed} completed, "
              f"{rep.drained_reprefilled} re-prefilled, "
              f"{rep.drain_leaked_pages} leaked pages", flush=True)
        for d in rep.decisions:
            if d["action"] != "hold":
                print(f"  step {d['step']:3d}: {d['action']} "
                      f"({d['reason']}) -> tp {d['target_size']}",
                      flush=True)
        # Scrape the live endpoint, as Prometheus would.
        url = f"http://127.0.0.1:{server.port}/metrics"
        text = urllib.request.urlopen(url, timeout=10).read().decode()
        fails = check_ctl_metrics(text, report, len(plane.healthy))
        for ln in text.splitlines():
            if ln.startswith("horovod_ctl_"):
                print("  " + ln, flush=True)
        assert not fails, fails
    hvd.barrier()
    hvd.shutdown()
    if rank == 0:
        print(f"autoscale probe OK (mesh {rep.mesh_size_initial} -> "
              f"{rep.mesh_size_final}, {rep.serving.completed} requests, "
              f"0 lost)", flush=True)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
