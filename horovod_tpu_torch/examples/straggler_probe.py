"""Straggler-attribution demo -- catch a deterministically slow rank (the
port of ``examples/straggler_probe.py``).

Runs the same small training loop once per rank identity in one process
(``--ranks``, the JAX script's virtual ranks), with the chaos injector's
``slow`` fault stalling exactly one rank's host thread after one step
(``slow@step=K,rank=R,secs=T``).  Every rank identity writes its own
clock-anchored timeline JSON and feeds its per-step span summaries into
one :class:`~horovod_tpu_torch.timeline.straggler.StragglerMonitor`; the
probe then runs the same merge the CLI exposes (``python -m
horovod_tpu_torch.timeline --merge <dir>``), prints the merged
straggler/critical-path report and checks that both name the injected
rank, and that the step after the stall is ``dispatch_gap``-dominated
on that rank (the stall is host time between two steps).

The monitor's own ``dominant span`` is its newest summary's, which on a
synchronous step is ``dispatch`` once the stall has passed; the probe
reads the stalled step's summary instead, which the injected stall alone
decides.

Run::

    python -m horovod_tpu_torch.examples.straggler_probe --device cpu \\
        [--steps 12] [--slow-rank 5]

Without ``--device cpu`` the steps run on ``cuda``.  Prints ``straggler
probe OK`` last.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--ranks", type=int, default=8,
                   help="rank identities, one training loop each")
    p.add_argument("--slow-rank", type=int, default=5)
    p.add_argument("--slow-step", type=int, default=4)
    p.add_argument("--slow-secs", type=float, default=0.25)
    p.add_argument("--trace-dir", default=None,
                   help="where per-rank timelines land (default: tmp)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--json", default=None,
                   help="also write the verdicts here")
    args = p.parse_args(argv)
    if not 0 <= args.slow_rank < args.ranks:
        p.error(f"--slow-rank {args.slow_rank} is not one of the "
                f"{args.ranks} ranks")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the drill; returns the live monitor's ``live`` report, the
    merged ``merged`` report, the stalled step's ``stalled`` summary and
    the per-rank ``bound`` verdicts of the merge (host-bound where the
    stall outweighs a rank's steps together, which the stall alone does
    not decide: not checked here)."""
    args = parse_args(argv)
    world = args.ranks
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.elastic import chaos
    from horovod_tpu_torch.examples.metrics_probe import (draw_batch,
                                                          init_params,
                                                          loss_fn, TanhMLP)
    from horovod_tpu_torch.timeline import Timeline, spans
    from horovod_tpu_torch.timeline.__main__ import (_BOUND, _print_report,
                                                     merge)
    from horovod_tpu_torch.timeline.spans import dominant_span
    from horovod_tpu_torch.timeline.straggler import StragglerMonitor
    from horovod_tpu_torch.training import make_train_step

    hvd.init(device=args.device)
    dev = global_state().device
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="straggler_")
    os.makedirs(trace_dir, exist_ok=True)
    spec = (f"seed=1;slow@step={args.slow_step},rank={args.slow_rank},"
            f"secs={args.slow_secs}")
    print(f"ranks: {world} identities on {dev}, chaos spec: {spec}\n"
          f"traces -> {trace_dir}", flush=True)

    params = init_params(np.random.RandomState(0))
    rows = 4 * world

    def loop(r: int, inj=None):
        model = TanhMLP(params, dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        step = make_train_step(model, loss_fn, opt)
        batch_rng = np.random.RandomState(7)  # the same data every rank
        for i in range(1, args.steps + 1):
            x, y = draw_batch(batch_rng, rows)
            loss = step((torch.from_numpy(x).to(dev),
                         torch.from_numpy(y).to(dev)))
            if inj is not None:
                inj.on_step(i)  # the slow fault stalls HERE, between steps
        return float(loss)

    # The process's first steps pay one-off costs (the first collective,
    # kernel and allocator warm-up, the timeline writer's first flush)
    # that no rank identity should carry: one loop, timeline included,
    # runs before anything is observed, and the collector stays off.
    rec = spans.recorder()
    with tempfile.TemporaryDirectory() as warm:
        tl = Timeline(os.path.join(warm, "warmup.json"), rank=0)
        rec.configure(timeline=tl)
        loop(0)
        tl.close()
        rec.timeline = None
    gc.collect()
    gc.disable()
    monitor = StragglerMonitor(world=world, stall_check_time=0.0)
    seen = []
    rec.add_listener(monitor.observe)
    rec.add_listener(seen.append)

    # One sequential pass per rank identity: each gets its own anchored
    # timeline, its own chaos injector (the slow fault only fires when
    # the injector's rank matches the fault's), and a fresh train step
    # so the dispatch-gap accounting starts clean.
    try:
        for r in range(world):
            tl = Timeline(os.path.join(trace_dir, f"timeline_r{r}.json"),
                          rank=r, hostname=f"vrank{r}")
            rec.configure(rank=r, timeline=tl)
            chaos.reset()
            inj = chaos.install(spec, rank=r, size=world)
            loss = loop(r, inj)
            tl.close()
            rec.timeline = None
            fired = "slow" in inj.fired_kinds
            print(f"rank {r}: {args.steps} steps, loss {loss:.4f}"
                  f"{'  <-- chaos slow fired' if fired else ''}",
                  flush=True)
            assert fired == (r == args.slow_rank), (r, inj.fired_kinds)
    finally:
        gc.enable()
        chaos.reset()
        rec.remove_listener(monitor.observe)
        rec.remove_listener(seen.append)
        rec.configure(rank=hvd.rank())

    # Live-feed verdict (the monitor saw every rank's summaries).
    live = monitor.report()
    print("\nlive monitor verdict:")
    print(monitor.render())
    assert live["straggler_rank"] == args.slow_rank, live
    assert live["lateness_s"] > 0.0, live
    # The stall runs after step K's return, so it is the dispatch gap of
    # step K + 1 on the slow rank.
    stalled = [s for s in seen if s["rank"] == args.slow_rank
               and s["step"] == args.slow_step + 1]
    assert len(stalled) == 1, stalled
    stalled = stalled[0]
    gap = stalled["spans"].get("dispatch_gap", 0.0)
    print(f"rank {args.slow_rank} step {args.slow_step + 1}: dominant span "
          f"{dominant_span(stalled)}, dispatch_gap {gap * 1e3:.1f} ms",
          flush=True)
    assert dominant_span(stalled) == "dispatch_gap", stalled
    assert gap >= args.slow_secs, stalled

    # Offline merge over the per-rank anchored files -- the path of
    # `python -m horovod_tpu_torch.timeline --merge`.
    out = os.path.join(trace_dir, "merged_timeline.json")
    rep = merge(trace_dir, out)
    print("\nmerged-trace verdict:")
    _print_report(rep)
    assert rep["ranks"] == world, rep["ranks"]
    assert rep["straggler"]["straggler_rank"] == args.slow_rank, \
        rep["straggler"]
    with open(out) as f:
        merged = json.load(f)
    assert isinstance(merged, list) and merged, "merged trace empty"
    pids = {e.get("pid") for e in merged}
    assert len(pids) == world, pids  # one pid per rank
    bound = {}
    for r, info in rep["per_rank"].items():
        cats = info["categories"]
        top = max(cats, key=cats.get) if cats else "compute"
        bound[r] = _BOUND.get(top, "compute-bound")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"spec": spec, "world": world,
                       "injected_rank": args.slow_rank,
                       "injected_secs": args.slow_secs,
                       "detected_rank": live["straggler_rank"],
                       "lateness_s": live["lateness_s"],
                       "skew_s": live["skew_s"],
                       "stalled_dispatch_gap_s": gap,
                       "merged_rank": rep["straggler"]["straggler_rank"],
                       "merged_ranks": rep["ranks"],
                       "merged_events": rep["events"], "bound": bound},
                      f, indent=1)
    print("\nstraggler probe OK", flush=True)
    return {"live": live, "merged": rep, "stalled": stalled,
            "bound": bound, "trace_dir": trace_dir}


if __name__ == "__main__":
    main()
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    sys.exit(0)
