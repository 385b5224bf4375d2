"""Worker entry for :class:`horovod_tpu_torch.ray.elastic.ElasticRayExecutor`.

Loads the pickled ``(fn, args, kwargs)`` payload, runs it (the function
itself uses ``horovod_tpu_torch`` / ``horovod_tpu_torch.elastic`` as any
elastic script would), and drops the result under ``results/rank_<r>``.
"""

from __future__ import annotations

import os
import pickle
import sys


def main() -> int:
    payload_path, results_dir = sys.argv[1], sys.argv[2]
    with open(payload_path, "rb") as f:
        fn, args, kwargs = pickle.load(f)
    result = fn(*args, **kwargs)

    import horovod_tpu_torch as hvd
    rank = hvd.rank() if hvd.is_initialized() else \
        int(os.environ.get("HOROVOD_RANK", "0"))
    tmp = os.path.join(results_dir, f".rank_{rank}.{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(results_dir, f"rank_{rank}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
