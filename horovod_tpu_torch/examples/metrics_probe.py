"""Observability demo -- scrape your own train loop (the port of
``examples/metrics_probe.py``).

Starts the Prometheus ``/metrics`` endpoint (``HOROVOD_METRICS_PORT``,
set to 0 -- an ephemeral port -- before ``init()``), trains a small
compressed model for a few steps, then plays the monitoring stack's part
itself: GETs the endpoint, prints the step and wire families it finds,
the last ``StepReport``, and the exchange planner's decision through
``fusion.explain_plan`` / ``render_plan``.  Last, the static auditor
(``analysis.audit_step``) re-runs the same step on every rank of a
recording world and proves it issues that plan.

The model and data are the JAX script's, drawn from one numpy
``RandomState(0)`` in its order (parameters, then each step's ``4 *
size`` rows); the parameters keep the JAX tree's names and layout.

Run::

    python -m horovod_tpu_torch.examples.metrics_probe --device cpu
    python -m horovod_tpu_torch.examples.metrics_probe --compression \\
        powersgd:4

Without ``--device cpu`` (or the launcher's ``--cpu``) it runs on
``cuda``.  Rank 0 prints ``metrics probe OK`` last.
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.request
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

REPORTED = ("horovod_step_total ", "horovod_wire_bytes_per_step ",
            "horovod_uncompressed_bytes_per_step ",
            "horovod_compression_ratio ")


class TanhMLP(nn.Module):
    """``tanh(x @ w1 + b1) @ w2 + b2`` with the JAX tree's names,
    registered in its leaf order."""

    def __init__(self, params: Dict[str, np.ndarray], device):
        super().__init__()
        for name in sorted(params):
            self.register_parameter(name, nn.Parameter(
                torch.tensor(params[name], device=device)))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


def loss_fn(model: nn.Module, batch) -> torch.Tensor:
    x, y = batch
    return F.cross_entropy(model(x), y)


def init_params(rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    return {"w1": rng.randn(32, 64).astype(np.float32) * 0.1,
            "b1": np.zeros((64,), np.float32),
            "w2": rng.randn(64, 8).astype(np.float32) * 0.1,
            "b2": np.zeros((8,), np.float32)}


def draw_batch(rng: np.random.RandomState, rows: int):
    x = rng.randn(rows, 32).astype(np.float32)
    y = rng.randint(0, 8, rows).astype(np.int64)
    return x, y


def build_step(params: Dict[str, np.ndarray], compression, device):
    """``(model, optimizer, step)``: SGD(0.1) in a ``DistributedOptimizer``
    under ``compression``, through ``make_train_step``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import make_train_step
    model = TanhMLP(params, device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), compression=compression)
    return model, opt, make_train_step(model, loss_fn, opt)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--compression", default="fp16",
                   help="exchange codec (none, fp16, powersgd:4, ...)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train, scrape, report and audit; returns ``losses``, the scraped
    ``lines`` of :data:`REPORTED`, the ``families``, the ``plan`` rows,
    the last step ``report`` and the ``audit`` (rank 0; the others get
    ``losses`` only).  Shuts the framework down: the audit opens its own
    recording worlds."""
    args = parse_args(argv)
    # The endpoint's port is read at init(); 0 = ephemeral.
    os.environ.setdefault("HOROVOD_METRICS_PORT", "0")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.controller import fusion
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.timeline.metrics import last_step_report
    from horovod_tpu_torch.training import shard_batch

    hvd.init(device=args.device)
    st = global_state()
    dev, n, rank = st.device, hvd.size(), hvd.rank()
    server = st.metrics_server
    if server is None:
        raise RuntimeError("metrics probe: no /metrics endpoint (is "
                           "HOROVOD_METRICS_PORT -1 or HOROVOD_METRICS 0?)")
    if rank == 0:
        print(f"ranks: {n} ({dev}), /metrics on port {server.port}",
              flush=True)

    rng = np.random.RandomState(0)
    params = init_params(rng)
    model, opt, step = build_step(params, args.compression, dev)
    losses = []
    for i in range(args.steps):
        x, y = shard_batch(draw_batch(rng, 4 * n))
        loss = step((torch.from_numpy(x).to(dev),
                     torch.from_numpy(y).to(dev)))
        losses.append(float(loss))
        if rank == 0:
            print(f"step {i + 1} loss {losses[-1]:.4f}", flush=True)
    out = {"losses": losses}

    if rank == 0:
        url = f"http://127.0.0.1:{server.port}/metrics"
        text = urllib.request.urlopen(url, timeout=10).read().decode()
        families = [ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE ")]
        print(f"\nscraped {url}: {len(families)} metric families")
        lines = [ln for ln in text.splitlines() if ln.startswith(REPORTED)]
        for ln in lines:
            print("  " + ln)

        rep = last_step_report()
        print(f"\nlast StepReport: step={rep.step} "
              f"codec={rep.codec} wall={rep.wall_time_s * 1e3:.1f}ms "
              f"wire={rep.exchanged_bytes}B raw={rep.uncompressed_bytes}B")

        leaves = [model.get_parameter(k) for k in sorted(params)]
        rows = fusion.explain_plan(leaves,
                                   threshold_bytes=fusion.fusion_threshold(),
                                   compression=args.compression)
        print("\nexchange plan (fusion.explain_plan):")
        print(fusion.render_plan(rows), flush=True)
        out.update(lines=lines, families=families, plan=rows, report=rep)

    hvd.barrier()
    del step, opt, model
    hvd.shutdown()

    if rank == 0:
        # The static auditor proves the trained step ISSUES that plan:
        # the same step, built on every rank of a recording world, run
        # once under the recorder and matched leg for leg.
        from horovod_tpu_torch.analysis import audit_step
        x, y = draw_batch(rng, 4 * n)

        def make():
            _, _, s = build_step(params, args.compression, dev)
            rows_here = shard_batch((x, y))
            return s, ((torch.from_numpy(rows_here[0]).to(dev),
                        torch.from_numpy(rows_here[1]).to(dev)),)

        # At least two ranks, so that the exchange's collectives run.
        report = audit_step(make, world=max(n, 2), name="probe:step",
                            device=dev)
        print("\nstatic audit (analysis.audit_step):")
        print(report.render())
        assert report.ok(), "audited step diverged from its exchange plan"
        assert len(out["families"]) >= 8, out["families"]
        out["audit"] = report
        print("\nmetrics probe OK", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
