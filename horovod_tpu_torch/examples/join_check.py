"""Multi-process JoinOp check (the port of ``examples/join_check.py``):
ranks stop after different batch counts.

Upstream behaviour under test (SURVEY.md 3.2 JoinOp): rank ``r`` runs
``2 (r + 1)`` batches, so the low ranks run out first and call
``hvd.join()``; the others keep allreducing (averages are over the
ACTIVE ranks only); the last rank runs a ragged ``allgatherv`` that
receives zero rows from every drained rank, a grouped allreduce (two
dtype buckets behind one presence round) and fused deferred async
allreduces, then joins -- nobody deadlocks, and ``join`` returns the
last rank to join on every rank.  A second epoch checks that the join
generation starts afresh.  Run under the launcher::

    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.join_check

The worker runs on ``cuda`` unless ``HVD_TPU_FORCE_CPU`` is set (the
launcher's ``--cpu``).  Each rank prints ``rank r: join OK last=L``
(and ``join2 OK``); any mismatch raises.
"""

from __future__ import annotations

import os
import sys

import torch


def main() -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.collectives.eager import deferred_fuse_stats

    cpu = bool(os.environ.get("HVD_TPU_FORCE_CPU"))
    hvd.init(device="cpu" if cpu else None)
    rank, n = hvd.rank(), hvd.size()
    if n < 2:
        raise SystemExit("run under horovod_tpu_torch.run -np 2+")
    dev = torch.device("cpu") if cpu else torch.device("cuda",
                                                       hvd.local_rank())

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    for b in range(2 * (rank + 1)):
        got = hvd.allreduce(full((3,), 1.0 + rank), hvd.Average,
                            name="join_loop")
        active = [r for r in range(n) if 2 * (r + 1) > b]
        expect = sum(1.0 + r for r in active) / len(active)
        assert torch.allclose(got, full((3,), expect), atol=1e-5), \
            (b, got, expect)
        print(f"rank {rank}: batch {b} avg={got[0].item():.3f} (expect "
              f"{expect:.3f}, {len(active)} active)", flush=True)

    if rank == n - 1:
        # The sole survivor: the ragged allgather receives ZERO rows from
        # every drained rank.
        rows = hvd.allgatherv(full((2, 2), 7.0))
        assert rows.shape == (2, 2) and bool((rows == 7.0).all()), rows
        print(f"rank {rank}: allgatherv-during-join OK "
              f"{tuple(rows.shape)}", flush=True)

        # Grouped (two dtype buckets): ONE presence round covers both
        # bucket collectives; drained ranks replay both with identities.
        outs = hvd.grouped_allreduce(
            [full((2,), 6.0), full((3,), 2, torch.int32)], op=hvd.Sum,
            name="join_grouped")
        assert bool((outs[0] == 6.0).all()) and bool((outs[1] == 2).all())
        print(f"rank {rank}: grouped-during-join OK", flush=True)

        # Three compatible async allreduces flush behind ONE presence
        # round at the first synchronize and share ONE fused collective,
        # which the drained ranks replay from its header.
        hs = [hvd.allreduce_async(full((2,), float(i + 1)), op=hvd.Sum,
                                  name=f"join_async_{i}") for i in range(3)]
        for i, h in enumerate(hs):
            got = hvd.synchronize(h)
            assert bool((got == i + 1.0).all()), (i, got)
        st = deferred_fuse_stats()
        assert st["fused_buckets"] >= 1 and st["fused_ops"] >= 3, st
        print(f"rank {rank}: async-ungrouped-during-join OK", flush=True)

        # A mixed-dtype async batch: TWO fused buckets (f32, f64), each
        # replayed as its own bucket collective.
        hs = [hvd.allreduce_async(full((2,), float(i + 1)), op=hvd.Sum)
              for i in range(2)]
        hs += [hvd.allreduce_async(full((3,), 10.0 * (i + 1),
                                        torch.float64), op=hvd.Sum)
               for i in range(2)]
        vals = [hvd.synchronize(h) for h in hs]
        for v, want in zip(vals, (1.0, 2.0, 10.0, 20.0)):
            assert bool((v == want).all()), (vals, want)
        st = deferred_fuse_stats()
        assert st["fused_buckets"] >= 3 and st["fused_ops"] >= 7, st
        print(f"rank {rank}: fused-async-during-join OK "
              f"({st['fused_buckets']} buckets)", flush=True)

    last = hvd.join()
    print(f"rank {rank}: join OK last={last}", flush=True)
    assert last == n - 1, (last, n)  # the rank with the most batches

    # Epoch 2: a new join generation; the survivor still drains the rest.
    if rank == n - 1:
        got = hvd.allreduce(full((2,), 4.0), op=hvd.Sum, name="epoch2")
        assert bool((got == 4.0).all()), got   # only this rank adds
        print(f"rank {rank}: epoch2 sum OK", flush=True)
    last2 = hvd.join()
    print(f"rank {rank}: join2 OK last={last2}", flush=True)
    assert last2 == n - 1, last2
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
