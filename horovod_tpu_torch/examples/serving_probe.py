"""Serving observability demo -- scrape your own inference engine (the port
of ``examples/serving_probe.py``).

Every rank of the world serves one seeded open-loop load from
:mod:`horovod_tpu_torch.serving.loadgen` through
:class:`~horovod_tpu_torch.serving.ServingEngine` over a tensor-parallel
mesh of all the world's ranks (tp 1 alone, in lock-step under the
launcher), with the Prometheus ``/metrics`` endpoint ``init()`` started
(``HOROVOD_METRICS_PORT``, 0 for an ephemeral port).  Rank 0 then plays
the monitoring stack: it GETs the endpoint and checks every
request-lifecycle family the scheduler exports against the engine's
report (:func:`check_serving_metrics`: submitted == admitted ==
completed, prefill and decode tokens, a TTFT sample a request, token
latencies), and the span layer's attribution (:func:`check_spans`): the
``serving_prefill`` and ``serving_decode`` legs (one decode leg a
step), and at tp > 1 the row-parallel collectives' plan rows
(``serving_decode/layer*/{attn_wo,mlp_down}``).

``--long-prompts`` switches to the kilotoken mixture (512/2048/4096,
:func:`~horovod_tpu_torch.serving.loadgen.long_prompt_spec`) with chunked
prefill (``--prefill-chunk`` tokens a slice, interleaved with decode
steps) and also checks that the ``serving_prefill_chunk`` leg fired.

:func:`run_probe` is the drill for any ``LlamaConfig`` and parameters;
the CLI serves ``LLAMA_SERVE`` (head dim 16), which runs on the CPU
only: the card's attention kernels take head dims 64 and 128 and refuse
it.  Run::

    python -m horovod_tpu_torch.examples.serving_probe --device cpu
    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.serving_probe --long-prompts

Rank 0 prints ``serving probe OK`` last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request
from typing import List, Optional, Sequence

import torch

PAGE_SIZE = 8        # the JAX probe's; the card's decode kernel takes it
SEED = 11

SERVING_FAMILIES = (
    "horovod_serving_requests_total",
    "horovod_serving_tokens_total",
    "horovod_serving_queue_depth",
    "horovod_serving_batch_occupancy",
    "horovod_serving_ttft_seconds",
    "horovod_serving_token_latency_seconds",
)


def _sample(text: str, prefix: str) -> float:
    """Sum the values of every sample line starting with ``prefix``."""
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(prefix):
            total += float(ln.split()[-1])
    return total


def scrape(port: int) -> str:
    url = f"http://127.0.0.1:{port}/metrics"
    return urllib.request.urlopen(url, timeout=10).read().decode()


def check_serving_metrics(before: str, after: str, report) -> List[str]:
    """The request-lifecycle families of two scrapes around one
    ``serve()`` (Prometheus text ``before`` and ``after``) against its
    ``ServingReport``; returns what disagrees."""
    families = [ln.split()[2] for ln in after.splitlines()
                if ln.startswith("# TYPE ")]
    fails = [f"{f} absent" for f in SERVING_FAMILIES if f not in families]

    def delta(prefix):
        return _sample(after, prefix) - _sample(before, prefix)

    req = "horovod_serving_requests_total"
    tok = "horovod_serving_tokens_total"
    want = {
        f'{req}{{event="submitted"}}': report.num_requests,
        f'{req}{{event="admitted"}}': report.num_requests,
        f'{req}{{event="completed"}}': report.completed,
        f'{tok}{{phase="prefill"}}': report.prompt_tokens,
        f'{tok}{{phase="decode"}}': report.new_tokens,
        "horovod_serving_ttft_seconds_count": report.completed,
        # The first token of a request comes from its prefill, every
        # other from a decode step, which samples its latency.
        "horovod_serving_token_latency_seconds_count":
            report.new_tokens - report.completed,
    }
    for prefix, n in want.items():
        got = delta(prefix)
        if got != n:
            fails.append(f"{prefix}: {got} != {n}")
    buckets = sum(1 for ln in after.splitlines() if ln.startswith(
        "horovod_serving_token_latency_seconds_bucket"))
    if not buckets:
        fails.append("no token latency buckets")
    return fails


def check_spans(summary: dict, legs: dict, report, cfg, tp: int,
                chunked: bool) -> List[str]:
    """The span layer's attribution of one ``serve()``: the runtime legs
    of its step ``summary`` and, at ``tp > 1``, the row-parallel plan
    rows in the leg registry ``legs``; returns what disagrees."""
    fails = []
    want = ["serving_prefill", "serving_decode"]
    if chunked:
        # Kilotoken admissions must have gone through the chunked path.
        want.append("serving_prefill_chunk")
    for leg in want:
        got = summary["legs"].get(leg)
        if not (got and got["count"] > 0 and got["secs"] > 0):
            fails.append(f"leg {leg}: {got}")
    decode = summary["legs"].get("serving_decode", {}).get("count")
    if decode != report.decode_steps:
        fails.append(f"serving_decode count {decode} != decode steps "
                     f"{report.decode_steps}")
    if tp > 1:
        for li in range(cfg.num_layers):
            for part in ("attn_wo", "mlp_down"):
                leg = legs.get(f"serving_decode/layer{li}/{part}")
                if not (leg and leg["nbytes"] > 0):
                    fails.append(f"plan row serving_decode/layer{li}/"
                                 f"{part}: {leg}")
    return fails


def run_probe(cfg, params, *, mesh=None, device=None, slots: int = 8,
              requests: int = 16, rate: float = 50.0,
              long_prompts: bool = False, prefill_chunk: int = 512,
              dtype=torch.float32) -> dict:
    """Serve one seeded load on this rank's engine and check it; every
    rank of ``mesh`` calls it.  Returns the ``report``, the step
    ``summary``, the ``legs`` registry and ``fails`` (rank 0 scrapes
    ``/metrics`` and checks the families; the other ranks check the
    spans only)."""
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.serving import (LoadSpec, ServingEngine,
                                           generate, long_prompt_spec)
    from horovod_tpu_torch.timeline import spans
    st = global_state()
    server = st.metrics_server
    rank = st.rank
    if long_prompts:
        # The kilotoken mixture through chunked prefill: kilotoken
        # admissions slice into prefill_chunk forwards interleaved with
        # decode steps, so the live batch keeps emitting.
        engine = ServingEngine(cfg, params, mesh=mesh, device=device,
                               slots=slots, page_size=PAGE_SIZE,
                               max_len=4608, dtype=dtype,
                               prefill_chunk=prefill_chunk)
        spec = long_prompt_spec(num_requests=requests,
                                rate_rps=min(rate, 2.0),
                                vocab_size=cfg.vocab_size, seed=SEED)
    else:
        engine = ServingEngine(cfg, params, mesh=mesh, device=device,
                               slots=slots, page_size=PAGE_SIZE, max_len=64,
                               dtype=dtype, prefill_chunk=0)
        spec = LoadSpec(num_requests=requests, rate_rps=rate,
                        prompt_lens=(4, 8, 16), output_lens=(4, 8),
                        vocab_size=cfg.vocab_size, seed=SEED)
    tp = engine.step.tp if hasattr(engine.step, "tp") else 1
    rec = spans.recorder()
    # A step of its own: nothing booked before the serve is counted.
    step_id = rec.step + 1
    rec.set_step(step_id)
    before = scrape(server.port) if rank == 0 else ""
    report = engine.serve(generate(spec))
    summary = rec.step_boundary(step_id, report.wall_s)
    legs = rec.leg_registry()
    fails = []
    if report.completed != report.num_requests:
        fails.append(f"completed {report.completed} of "
                     f"{report.num_requests}")
    fails += check_spans(summary, legs, report, cfg, tp,
                         long_prompts and prefill_chunk > 0)
    out = {"report": report, "summary": summary, "legs": legs, "tp": tp,
           "engine": engine}
    if rank == 0:
        after = scrape(server.port)
        fails += check_serving_metrics(before, after, report)
        out["families"] = [ln.split()[2] for ln in after.splitlines()
                           if ln.startswith("# TYPE ")]
        out["lines"] = [ln for ln in after.splitlines() if ln.startswith((
            "horovod_serving_requests_total",
            "horovod_serving_tokens_total",
            "horovod_serving_batch_occupancy"))]
    out["fails"] = fails
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=50.0,
                   help="open-loop arrival rate (requests/s)")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--long-prompts", action="store_true",
                   help="serve the 512/2048/4096 kilotoken mixture "
                        "through chunked prefill")
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="chunk length for --long-prompts (0 = whole "
                        "prompt at once)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--json", default=None,
                   help="rank 0 also writes the engine's report here")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    # The endpoint's port is read at init(); 0 = ephemeral.
    os.environ.setdefault("HOROVOD_METRICS_PORT", "0")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import LLAMA_SERVE, init_llama_params
    from horovod_tpu_torch.parallel import build_parallel_mesh

    hvd.init(device=args.device)
    st = global_state()
    dev, world, rank = st.device, hvd.size(), hvd.rank()
    if st.metrics_server is None:
        raise RuntimeError("serving probe: no /metrics endpoint (is "
                           "HOROVOD_METRICS_PORT -1 or HOROVOD_METRICS 0?)")
    if rank == 0:
        print(f"ranks: {world} ({dev}), /metrics on port "
              f"{st.metrics_server.port}", flush=True)
    cfg = LLAMA_SERVE
    params = init_llama_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    mesh = build_parallel_mesh(tp=world) if world > 1 else None
    out = run_probe(cfg, params, mesh=mesh, device=dev, slots=args.slots,
                    requests=args.requests, rate=args.rate,
                    long_prompts=args.long_prompts,
                    prefill_chunk=args.prefill_chunk)
    report, summary = out["report"], out["summary"]
    if rank == 0:
        print(f"served {report.completed}/{report.num_requests} requests: "
              f"{report.tokens_per_s:.1f} tokens/s, "
              f"TTFT p50 {report.ttft_p50_s * 1e3:.1f} ms "
              f"p99 {report.ttft_p99_s * 1e3:.1f} ms, "
              f"occupancy {report.mean_occupancy:.2f}")
        print(f"\nscraped /metrics: {len(out['families'])} metric families")
        for ln in out["lines"]:
            print("  " + ln)
        print(f"\nspan legs attributed: serving_prefill "
              f"({summary['legs']['serving_prefill']['count']} dispatches) "
              f"+ serving_decode ({report.decode_steps} steps) + "
              f"{2 * cfg.num_layers if out['tp'] > 1 else 0} in-step "
              f"collective legs", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"world": world, "slots": args.slots,
                           **report.as_dict()}, f, indent=1)
    assert not out["fails"], out["fails"]
    hvd.barrier()
    hvd.shutdown()
    if rank == 0:
        print(f"\nserving probe OK ({report.tokens_per_s:.1f} tokens/s, "
              f"world {world})", flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
