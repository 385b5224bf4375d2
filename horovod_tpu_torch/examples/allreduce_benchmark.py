"""Allreduce bandwidth benchmark (the port of
``examples/allreduce_benchmark.py``; BASELINE.json's metric is allreduce
bus bandwidth).

Sweeps payload sizes through the train step's own allreduce
(``collectives.ops.step_allreduce_``: NCCL on the card, gloo on the CPU),
``--iters`` dependent calls a size, each on the previous result
(``Average`` of a tensor of ones stays ones, so every result is checked
against its input exactly).  It reports the time a call, the algorithm
bandwidth (payload / time) and the ring bus bandwidth ``2 (n-1)/n *
payload / time`` a rank, NCCL's accounting.  At world 1 the bus factor
is 0 and the allreduce is a copy: the script says so instead of printing
a bus number.  On the card the calls are timed with CUDA events, on the
CPU with the host clock.

Run::

    python -m horovod_tpu_torch.examples.allreduce_benchmark --device cpu
    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.allreduce_benchmark
    python -m horovod_tpu_torch.examples.allreduce_benchmark \\
        --sizes-mb 1,4,16,64,256 --json sweep.json     # the card
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence

import torch


def bus_factor(n: int) -> float:
    """Ring allreduce bytes a rank moves, per payload byte."""
    return 2.0 * (n - 1) / n


def sweep(sizes_mb: Sequence[float], iters: int, device) -> List[dict]:
    """One record a size: ``mib``, ``ms`` a call, ``algo_gib_s``,
    ``bus_gib_s`` (None at world 1), ``exact`` (every result equal to its
    input)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.ops import step_allreduce_
    n = hvd.size()
    cuda = device.type == "cuda"
    out = []
    for mb in sizes_mb:
        elems = int(mb * (1 << 20) / 4)
        ones = torch.ones(elems, dtype=torch.float32, device=device)
        acc = ones.clone()
        step_allreduce_(acc, hvd.Average)        # warm-up
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            step_allreduce_(acc, hvd.Average)
        if cuda:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
        per_op = dt / iters
        algo = mb / 1024 / per_op
        out.append({"mib": mb, "ms": per_op * 1e3, "algo_gib_s": algo,
                    "bus_gib_s": bus_factor(n) * algo if n > 1 else None,
                    "exact": bool(torch.equal(acc, ones))})
        del ones, acc
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes-mb", default="1,4,16,64",
                   help="comma-separated payload sizes in MiB")
    p.add_argument("--iters", type=int, default=10,
                   help="chained allreduces a size")
    p.add_argument("--json", default=None,
                   help="also write the sweep's records here")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    hvd.init(device=args.device)
    dev, n = global_state().device, hvd.size()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if hvd.rank() == 0:
        print(f"# {n} ranks on {dev} ({backend}), {args.iters} chained "
              f"allreduces a size", flush=True)
    recs = sweep([float(s) for s in args.sizes_mb.split(",")], args.iters,
                 dev)
    if hvd.rank() == 0:
        for r in recs:
            bus = (f"bus>= {r['bus_gib_s']:7.2f} GiB/s/rank"
                   if r["bus_gib_s"] is not None else
                   "bus>= n/a (world 1: bus factor 2(n-1)/n = 0, the "
                   "allreduce is a copy)")
            print(f"{r['mib']:8.1f} MiB  {r['ms']:8.3f} ms/op  "
                  f"algo {r['algo_gib_s']:7.2f} GiB/s  {bus}", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"world": n, "device": str(dev),
                           "backend": backend, "iters": args.iters,
                           "sweep": recs}, f, indent=1)
    bad = [r["mib"] for r in recs if not r["exact"]]
    assert not bad, f"allreduce results differ from their inputs at {bad} MiB"
    return recs


if __name__ == "__main__":
    main()
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    sys.exit(0)
