"""Multi-process smoke workload: every rank allreduces its rank id (the
port of ``examples/allreduce_check.py``).

Each rank is one process with one device.  Every collective of the
eager surface runs once with rank-dependent inputs and an exact check:
the allreduce of the rank ids, the ragged ``allgatherv``, the object
collectives, ``broadcast_parameters``, ``alltoall`` / ``alltoallv``,
``reducescatter``, the grouped gather, scatter and allreduce, an
allreduce on a one-member process set, and a barrier.  The checks that
need another rank run at world > 1 only.  Run under the launcher::

    python -m horovod_tpu_torch.run -np 2 --cpu \\
        python -m horovod_tpu_torch.examples.allreduce_check

Each rank prints ``allreduce OK`` ... ``barrier OK``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def main() -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state

    hvd.init()
    n, rank = hvd.size(), hvd.rank()
    dev = global_state().device
    backend = "nccl" if dev.type == "cuda" else "gloo"
    print(f"rank {rank}/{n} local_size={hvd.local_size()} "
          f"backend={backend}", flush=True)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    got = hvd.allreduce(t(np.full((4,), float(rank), np.float32)), op=hvd.Sum)
    expect = float(sum(range(n)))
    assert torch.equal(got, torch.full_like(got, expect)), (got, expect)
    print(f"rank {rank}: allreduce OK -> {got[0].item()}", flush=True)

    if n > 1:
        # Ragged allgather: rank g contributes g + 1 rows of value g.
        got_v = hvd.allgatherv([np.full((rank + 1, 2), float(rank),
                                        np.float32)]).cpu().numpy()
        assert got_v.shape == (n * (n + 1) // 2, 2), got_v.shape
        off = 0
        for g in range(n):
            assert np.array_equal(got_v[off:off + g + 1],
                                  np.full((g + 1, 2), float(g))), got_v
            off += g + 1
        print(f"rank {rank}: allgatherv OK {got_v.shape}", flush=True)

    val = hvd.broadcast_object({"from": rank, "tag": 42}, root_rank=0)
    assert val["tag"] == 42 and val["from"] == 0, val
    print(f"rank {rank}: broadcast_object OK", flush=True)

    objs = hvd.allgather_object({"rank": rank, "payload": "x" * (rank + 1)})
    assert [o["rank"] for o in objs] == list(range(n)), objs
    assert [o["payload"] for o in objs] == ["x" * (r + 1)
                                            for r in range(n)], objs
    print(f"rank {rank}: allgather_object OK ({len(objs)} objects)",
          flush=True)

    params = {"w": t(np.full((4, 4), float(rank), np.float32))}
    hvd.broadcast_parameters(params, root_rank=0)
    w = params["w"]
    assert w.shape == (4, 4), w.shape  # the shape survives the sync
    assert torch.equal(w, torch.zeros_like(w)), w
    print(f"rank {rank}: broadcast_parameters OK {tuple(w.shape)}",
          flush=True)

    if n > 1:
        # alltoall: rank g sends chunk j (its own id) to rank j; every
        # receiver ends with [0, 1, ..., n - 1].
        a2a = hvd.alltoall(t(np.full((n,), float(rank), np.float32)),
                           name="a2a_check")
        assert torch.equal(a2a.cpu(), torch.arange(n, dtype=torch.float32)), \
            a2a
        print(f"rank {rank}: alltoall OK", flush=True)

        # alltoallv: rank g sends (g + i) % 2 + 1 rows of value 100 g + i
        # to rank i; every receiver checks the rank-order concatenation
        # and the received counts.
        def splits(g, i):
            return (g + i) % 2 + 1

        sp = np.array([splits(rank, i) for i in range(n)], np.int32)
        rows = np.concatenate([np.full((sp[i], 2), 100.0 * rank + i,
                                       np.float32) for i in range(n)])
        datas, rsplits = hvd.alltoallv([rows], [sp], name="a2av_check")
        want_counts = np.array([splits(s, rank) for s in range(n)], np.int32)
        assert np.array_equal(np.asarray(rsplits[0]), want_counts), (
            rsplits[0], want_counts)
        want_rows = np.concatenate([np.full((want_counts[s], 2),
                                            100.0 * s + rank, np.float32)
                                    for s in range(n)])
        assert np.array_equal(datas[0].cpu().numpy(), want_rows), datas[0]
        print(f"rank {rank}: alltoallv OK", flush=True)

        # reducescatter: each rank gets its 1/n slice of the sum.
        rs = hvd.reducescatter(t(np.arange(n * 2, dtype=np.float32)),
                               op=hvd.Sum, name="rs_check")
        base = np.arange(n * 2, dtype=np.float32) * n
        assert np.array_equal(rs.cpu().numpy(),
                              base[2 * rank:2 * rank + 2]), rs
        print(f"rank {rank}: reducescatter OK", flush=True)

        # grouped allgather + reducescatter (one fused collective each).
        ga = hvd.grouped_allgather(
            [t(np.full((1, 2), float(rank), np.float32)),
             t(np.full((1, 3, 2), 2.0 + rank, np.float32))],
            name="gga_check")
        want0 = np.repeat(np.arange(n, dtype=np.float32), 2).reshape(n, 2)
        assert np.array_equal(ga[0].cpu().numpy(), want0), ga[0]
        assert tuple(ga[1].shape) == (n, 3, 2), ga[1].shape
        assert np.array_equal(ga[1].cpu().numpy()[:, 0, 0],
                              2.0 + np.arange(n)), ga[1]
        grs = hvd.grouped_reducescatter(
            [t(np.tile(np.arange(n, dtype=np.float32), 2))], op=hvd.Sum,
            name="grs_check")
        base = np.tile(np.arange(n, dtype=np.float32), 2) * n
        assert np.array_equal(grs[0].cpu().numpy(),
                              base[2 * rank:2 * rank + 2]), grs[0]
        print(f"rank {rank}: grouped gather/scatter OK", flush=True)

        outs = hvd.grouped_allreduce(
            [t(np.full((3,), float(rank), np.float32)),
             t(np.full((2,), 2.0 * rank, np.float32))], op=hvd.Sum,
            name="grp_check")
        total = float(sum(range(n)))
        assert torch.equal(outs[0], torch.full_like(outs[0], total)), outs
        assert torch.equal(outs[1], torch.full_like(outs[1], 2 * total)), \
            outs
        print(f"rank {rank}: grouped_allreduce OK", flush=True)

        # Process-set collective: every rank registers the set, only its
        # members call the collective.
        ps = hvd.add_process_set([0])
        if ps.included():
            val = hvd.allreduce(t(np.full((2,), float(rank), np.float32)),
                                op=hvd.Average, name="ps_check",
                                process_set=ps)
            assert torch.equal(val, torch.zeros_like(val)), val
        hvd.barrier()  # align before deregistering on every rank
        hvd.remove_process_set(ps)
        print(f"rank {rank}: process_set allreduce OK", flush=True)

    hvd.barrier()
    print(f"rank {rank}: barrier OK", flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
