"""Long-context training: sequence parallelism over a dp x sp rank mesh.

The JAX repository's ``examples/long_context.py`` on the port: the
context is sharded over the ``sp`` axis of ``build_parallel_mesh(dp=
world / sp, sp=sp)`` and attention runs as

* ``--mode ring``: ring attention -- the K/V blocks go round the sp ring
  by ``ppermute`` with an online softmax, no rank ever holding the whole
  sequence (plain PyTorch, as in JAX);
* ``--mode ulysses``: two all_to_alls swap sequence and heads around the
  port's ``flash_attention`` over the whole sequence (the kernels on the
  card).

A one-layer causal attention LM trains on next-token prediction; the
gradient averages over every rank (dp replicas and sp shards: each shard
owns an equal slice of tokens, so the mean over both is the global
loss's gradient).  ``--packed`` packs two half-length sequences a row,
isolated by segment ids that ride the shards.
``--compare-single-device`` checks the first step's loss against one
process's full attention.  ``--d-model`` / ``--heads`` widen the model
(the card's flash kernels take head dims 64 and 128).

Run::

    python -m horovod_tpu_torch.run -np 4 --cpu \\
        python -m horovod_tpu_torch.examples.long_context --seq-len 512 \\
        --sp 4 --mode ulysses --compare-single-device
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.state import global_state


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--sp", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=0,
                   help="global batch (default: 2 per dp rank)")
    p.add_argument("--mode", choices=("ring", "ulysses"), default="ring")
    p.add_argument("--packed", action="store_true",
                   help="pack two sequences a row, isolated by segment ids")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=97)
    p.add_argument("--compare-single-device", action="store_true")
    p.add_argument("--device", default=None,
                   help="cpu or cuda (default: cuda, or cpu under the "
                        "launcher's --cpu)")
    return p.parse_args(argv)


def _heads(e, w, heads):
    b, t, _ = e.shape
    return (e @ w).view(b, t, heads, -1).transpose(1, 2)


def local_loss(p, xb, yb, sb, attention, heads: int) -> torch.Tensor:
    """The LM's mean next-token cross-entropy over this rank's tokens."""
    e = p["emb"][xb]                                     # (b, t_l, dm)
    q, k, v = (_heads(e, p[w], heads) for w in ("wq", "wk", "wv"))
    o = attention(q, k, v, sb)                           # (b, h, t_l, dh)
    o = o.transpose(1, 2).reshape(e.shape) @ p["wo"]
    logits = o.float() @ p["emb"].float().T
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           yb.reshape(-1).long())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    from horovod_tpu_torch.ops.attention import attention_reference
    from horovod_tpu_torch.parallel import (build_parallel_mesh,
                                            ring_attention,
                                            ulysses_attention)
    world, sp = hvd.size(), args.sp
    if world % sp:
        raise SystemExit(f"--sp {sp} does not divide {world} ranks")
    dp = world // sp
    mesh = build_parallel_mesh(dp=dp, sp=sp)
    dev = global_state().device
    vocab, dm, heads, seq = args.vocab, args.d_model, args.heads, args.seq_len
    if seq % sp:
        raise SystemExit(f"--seq-len {seq} must divide by sp={sp}")
    batch = args.batch_size or 2 * dp
    if batch % dp:
        raise SystemExit(f"batch {batch} must divide by dp={dp}")

    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    half = seq // 2
    if args.packed:
        y = np.concatenate([np.roll(x[:, :half], -1, axis=1),
                            np.roll(x[:, half:], -1, axis=1)], axis=1)
    else:
        y = np.roll(x, -1, axis=1)
    seg = np.concatenate([np.zeros((batch, half), np.int32),
                          np.ones((batch, seq - half), np.int32)], axis=1)

    gen = torch.Generator(device=dev).manual_seed(0)
    scale = dm ** -0.5

    def normal(*shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    params = {"emb": normal(vocab, dm, std=0.3),
              **{w: normal(dm, dm, std=scale)
                 for w in ("wq", "wk", "wv", "wo")}}
    params = {k: torch.nn.Parameter(v) for k, v in params.items()}

    attn = ring_attention if args.mode == "ring" else ulysses_attention

    def attention(q, k, v, sb):
        return attn(q, k, v, causal=True, axis="sp",
                    segment_ids=sb if args.packed else None)

    # This rank's block: rows of its dp shard, columns of its sp shard.
    c = mesh.coords()
    rows = slice(c["dp"] * (batch // dp), (c["dp"] + 1) * (batch // dp))
    cols = slice(c["sp"] * (seq // sp), (c["sp"] + 1) * (seq // sp))

    def shard(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows, cols])).to(dev)

    xd, yd, sd = shard(x), shard(y), shard(seg)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(params.values(), lr=args.lr),
        named_parameters=params.items(), compression=hvd.Compression.none)

    ref_loss = None
    if args.compare_single_device:
        with torch.no_grad():
            ref_loss = float(local_loss(
                params, torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev), torch.from_numpy(seg).to(dev),
                lambda q, k, v, sb: attention_reference(
                    q, k, v, causal=True,
                    segment_ids=sb if args.packed else None), heads))

    losses = []
    for i in range(args.steps):
        loss = local_loss(params, xd, yd, sd, attention, heads)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(hvd.allreduce(loss.detach(), op=hvd.Average)))
        if hvd.rank() == 0 and i % 10 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}", flush=True)
    if hvd.rank() == 0:
        print(f"final loss {losses[-1]:.4f}  (mode={args.mode}, seq={seq}, "
              f"sp={sp}, dp={dp}{', packed x2' if args.packed else ''})",
              flush=True)
    if ref_loss is not None:
        diff = abs(losses[0] - ref_loss)
        if hvd.rank() == 0:
            print(f"|distributed - single-device| first-step loss diff: "
                  f"{diff:.2e}", flush=True)
        assert diff < 5e-4, (losses[0], ref_loss)
        if hvd.rank() == 0:
            print("PARITY OK", flush=True)
    assert losses[-1] < losses[0], "loss did not decrease"
    return {"losses": losses, "ref_loss": ref_loss, "mesh": mesh}


if __name__ == "__main__":
    main()
    hvd.shutdown()
