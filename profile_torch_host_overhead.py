"""Host cost of the port's collective entry and of synchronized BatchNorm
at world 1 on one GPU.

Small shapes, so the host is the bound: each case is called back to back
``--calls`` times on the host clock (``time.perf_counter``, the device
synchronized before and after), in ``--repeats`` rounds, and its
microseconds a call are printed for every round:

* ``allreduce``: ``hvd.allreduce`` of a ``2C + 1`` f32 vector (the size
  of synchronized BatchNorm's statistics exchange);
* ``sync_bn_step`` / ``plain_bn_step``: one train-mode forward and
  backward of ``training.sync_batch_norm`` (two allreduces) and of the
  plain ``ops.bn.BatchNorm`` on a ``[32, 8, 8, C]`` bf16 input;
* ``SyncBatchNorm_step``: the same through ``hvd.SyncBatchNorm`` on the
  channels-last ``[32, C, 8, 8]`` input.

Only calls that every version of the package since synchronized
BatchNorm was ported offers are made, so the script compares two
checkouts: run it from the root of each (``python3
profile_torch_host_overhead.py``), in one session on one card.  Prints
the card's ``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

C = 64


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _us_per_call(fn, calls: int, repeats: int) -> list:
    for _ in range(20):
        fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--calls", type=int, default=500)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import bn
    from horovod_tpu_torch.training import sync_batch_norm

    hvd.init()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(3)
    vec = torch.randn(2 * C + 1, generator=gen, device=dev)
    x = torch.randn(32, 8, 8, C, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(32, 8, 8, C, generator=gen, device=dev).to(
        torch.bfloat16)
    x_cl = x.permute(0, 3, 1, 2)                   # [32, C, 8, 8], channels-last
    dy_cl = dy.permute(0, 3, 1, 2)

    def step(m, xin, gin):
        def run():
            m.zero_grad(set_to_none=True)
            xt = xin.detach().requires_grad_(True)
            m(xt).backward(gin)
        return run

    sync = sync_batch_norm(features=C, dtype=torch.bfloat16, device=dev)
    plain = bn.BatchNorm(C, dtype=torch.bfloat16, device=dev)
    layer = hvd.SyncBatchNorm(C, device=dev)
    cases = {
        "allreduce": lambda: hvd.allreduce(vec),
        "sync_bn_step": step(sync, x, dy),
        "plain_bn_step": step(plain, x, dy),
        "SyncBatchNorm_step": step(layer, x_cl, dy_cl),
    }
    rec = {name: _us_per_call(fn, args.calls, args.repeats)
           for name, fn in cases.items()}
    print(_card())
    print(json.dumps({"host_us_per_call": rec, "calls": args.calls,
                      "torch": torch.__version__}))
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
