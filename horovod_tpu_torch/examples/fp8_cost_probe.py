"""The fp8 wire codec's own cost on the device: e4m3 quantise +
dequantise of one BERT-bucket-sized f32 payload (the port of
``examples/fp8_cost_probe.py``).

``Compression.fp8`` quantises each bucket before it goes on the wire
(``collectives.compression.fp8_quantize``: one max-abs scale, e4m3 codes)
and dequantises what comes back (``fp8_dequantize``); at world 1 no
exchange runs, so this is the cost it adds at world > 1.  The probe
times ``--iters`` round trips of ``--elements`` f32 values (80,000,000
-- 305 MiB -- by default, the JAX probe's payload; a rank's Adasum
exchange of BERT-Large moves ~588M elements a step), with CUDA events on
the card and the host clock on the CPU, beside the memory-traffic floor:
the quantise reads 4 and writes 1 byte an element, the dequantise reads
1 and writes 4 -- 10 bytes an element at :data:`HBM_BYTES_S` (an H100
SXM's HBM3, NVIDIA's data sheet).  On the card the line carries
``nvidia-smi``'s name and power limit.  Every round trip is checked:
each value within one e4m3 step of its input.

Run::

    python -m horovod_tpu_torch.examples.fp8_cost_probe --device cpu \\
        --elements 1000000
    python -m horovod_tpu_torch.examples.fp8_cost_probe --json fp8.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

HBM_BYTES_S = 3.35e12


def card_line() -> str:
    """``nvidia-smi``'s ``name, power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def round_trip_error_ok(x: torch.Tensor, y: torch.Tensor,
                        scale: torch.Tensor) -> bool:
    """Each value within one e4m3 step: 2^-4 of its magnitude for a
    normal code, 2^-10 of the scale (half the smallest subnormal) for a
    subnormal one."""
    tol = torch.maximum(x.abs() * 2.0 ** -4, scale * 2.0 ** -10)
    return bool(((y - x).abs() <= tol).all())


def measure(elements: int, iters: int, device) -> dict:
    from horovod_tpu_torch.collectives.compression import (fp8_dequantize,
                                                           fp8_quantize)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(elements, generator=g, device=device)
    q, s = fp8_quantize(x)                     # warm-up
    y = fp8_dequantize(q, s, torch.float32)
    exact = round_trip_error_ok(x, y, s)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        q, s = fp8_quantize(x)
        y = fp8_dequantize(q, s, torch.float32)
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        ms = (time.perf_counter() - t0) / iters * 1e3
    floor_ms = 10 * elements / HBM_BYTES_S * 1e3
    return {"elements": elements, "mib": elements * 4 / 2 ** 20,
            "iters": iters, "ms": ms, "floor_ms": floor_ms,
            "ratio": ms / floor_ms,
            "within_one_step": exact and round_trip_error_ok(x, y, s),
            "device": str(device)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--elements", type=int, default=80_000_000)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--json", default=None,
                   help="also write the record here")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    from horovod_tpu_torch.core.device import resolve_device
    dev = resolve_device(args.device)
    rec = measure(args.elements, args.iters, dev)
    if dev.type == "cuda":
        rec["card"] = card_line()
    where = rec.get("card", str(dev))
    print(f"quant+dequant of {rec['mib']:.0f} MiB f32: {rec['ms']:.3f} ms "
          f"(HBM floor {rec['floor_ms']:.3f} ms at "
          f"{HBM_BYTES_S / 1e9:.0f} GB/s, {rec['ratio']:.2f}x) on {where}",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    assert rec["within_one_step"], "fp8 round trip off by more than a step"
    return rec


if __name__ == "__main__":
    main()
    sys.exit(0)
