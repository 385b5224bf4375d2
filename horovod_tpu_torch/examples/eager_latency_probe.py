"""Eager-dispatch control-plane latency probe (the port of
``examples/eager_latency_probe.py``).

Times an 8-op eager allreduce batch (2 tensors of each of float32,
float64, int32 and int64) under the launcher across the three dispatch
strategies of the port's eager plane (``collectives/eager.py``):

* ``sync``             -- 8 sequential ``hvd.allreduce`` calls;
* ``deferred_unfused`` -- ``allreduce_async`` x 8 and a ``synchronize``
                          drain with the fused flush off
                          (``deferred_fuse=False``): one collective an op;
* ``deferred_fused``   -- the same batch with the flush fused: compatible
                          ops share one collective a dtype bucket;

and ``grouped_allreduce`` of the same 8 tensors as the reference cost.
Beside each batch's ms it COUNTS the collectives a batch issues (the
``horovod_collective_calls_total`` counters, ``collective_totals()``):
the fused flush must issue fewer than the unfused one -- a count, which
no machine's timing noise can flip.

The deferral applies where the join's presence protocol does (world >
1); ``PROBE_FORCE_DEFER=1`` forces it at world 1 too (the seam
``eager._defer_applies``), so the fused flush's dispatch side shows on
one process.  ``PROBE_ITERS`` sets the timed batches (30).  Rank 0
prints one JSON line (``metric: eager_latency_probe``) and a summary on
stderr.  Run::

    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.eager_latency_probe
    PROBE_FORCE_DEFER=1 python -m \\
        horovod_tpu_torch.examples.eager_latency_probe --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence

import torch

K = 8  # ops a batch: 2 tensors x 4 dtypes -> 4 fusion buckets
DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)


def batch_tensors(device):
    return [torch.ones(64, dtype=dt, device=device)
            for dt in DTYPES for _ in range(2)]


def collective_calls() -> int:
    """Collectives issued so far, every op and process set."""
    from horovod_tpu_torch.timeline.metrics import collective_totals
    return int(sum(row["calls"] for row in collective_totals().values()))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the probe; returns rank 0's record (every rank's ``ms`` and
    ``collectives``)."""
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives import eager as _eager
    from horovod_tpu_torch.core.config import _env_bool
    from horovod_tpu_torch.core.state import global_state

    hvd.init(device=args.device)
    rank, n = hvd.rank(), hvd.size()
    dev = global_state().device
    cuda = dev.type == "cuda"
    n_iter = int(os.environ.get("PROBE_ITERS", "30"))
    forced = os.environ.get("PROBE_FORCE_DEFER", "") == "1"
    seam = _eager._defer_applies
    if forced:
        _eager._defer_applies = lambda ps: True
    xs = batch_tensors(dev)

    def sync_batch():
        return [hvd.allreduce(x, op=hvd.Sum) for x in xs]

    def async_batch():
        hs = [hvd.allreduce_async(x, op=hvd.Sum) for x in xs]
        return [hvd.synchronize(h) for h in hs]

    def grouped_batch():
        return hvd.grouped_allreduce(xs, op=hvd.Sum)

    def measure(fn):
        """``(ms a batch, collectives a batch)``; every result of the
        last batch must be exactly ``n`` (a sum of ones)."""
        fn()  # settle
        if cuda:
            torch.cuda.synchronize(dev)
        c0 = collective_calls()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            outs = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) / n_iter * 1e3
        calls = (collective_calls() - c0) / n_iter
        for x, y in zip(xs, outs):
            assert torch.equal(y, torch.full_like(x, n)), (x.dtype, y)
        return ms, calls

    def with_fuse(enabled, fn):
        st = global_state()
        saved = st.config
        st.config = dataclasses.replace(saved, deferred_fuse=enabled)
        try:
            return fn()
        finally:
            st.config = saved

    try:
        sync_ms, sync_n = measure(sync_batch)
        unfused_ms, unfused_n = with_fuse(False,
                                          lambda: measure(async_batch))
        _eager.reset_deferred()  # zero the fuse stats before the fused pass
        fused_ms, fused_n = with_fuse(True, lambda: measure(async_batch))
        fuse_stats = _eager.deferred_fuse_stats()
        grouped_ms, grouped_n = measure(grouped_batch)
    finally:
        _eager._defer_applies = seam
    deferred = forced or n > 1
    rec = {
        "metric": "eager_latency_probe",
        "value": round(fused_ms, 3),
        "unit": "ms/batch",
        "config": f"eager_probe_np{n}_k{K}_"
                  + ("join-disabled" if _env_bool("JOIN_DISABLE")
                     else "join-enabled")
                  + ("_forced-defer" if forced else ""),
        "device": str(dev),
        "variants": {"sync_ms": sync_ms, "deferred_unfused_ms": unfused_ms,
                     "deferred_fused_ms": fused_ms},
        "grouped_ms": grouped_ms,
        "collectives": {"sync": sync_n, "deferred_unfused": unfused_n,
                        "deferred_fused": fused_n, "grouped": grouped_n},
        "fuse_stats": fuse_stats,
    }
    if rank == 0:
        print(f"# [{rec['config']}] {K}-op batch ({n} ranks on {dev}): "
              f"sync {sync_ms:.2f} ms ({sync_n} collectives); "
              f"deferred-unfused {unfused_ms:.2f} ms ({unfused_n}); "
              f"deferred-fused {fused_ms:.2f} ms ({fused_n}; "
              f"{fuse_stats['fused_buckets']} buckets/"
              f"{fuse_stats['flushes']} flushes); "
              f"grouped reference {grouped_ms:.2f} ms ({grouped_n})",
              file=sys.stderr, flush=True)
        print(json.dumps(rec), flush=True)
    if deferred:
        assert fused_n < unfused_n, rec["collectives"]
    hvd.shutdown()
    return rec


if __name__ == "__main__":
    main()
    sys.exit(0)
