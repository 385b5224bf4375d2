"""PyTorch/CUDA port: ``horovod_tpu_torch.examples.eager_latency_probe``
against the JAX repository's ``examples/eager_latency_probe.py``.

At np 2 (``PROBE_ITERS=5``, each package's launcher with ``--cpu``):
every result of every strategy exact (a sum of ones is the world size),
the fused deferred flush issuing fewer collectives a batch than the
unfused one (4 against 8: one a dtype bucket) -- counted, not timed --
and the fused flush's ``deferred_fuse_stats`` equal to the JAX
script's on the same arguments.  At world 1 with ``PROBE_FORCE_DEFER=1``
the same counts.
"""

import json
import re

from _jax_examples import run_jax_example, run_port


def _probe_record(out: str) -> dict:
    for ln in out.splitlines():
        ln = re.sub(r"^\[\d+\]<std(out|err)>", "", ln).strip()
        if ln.startswith("{") and "eager_latency_probe" in ln:
            return json.loads(ln)
    raise AssertionError(out)


def test_eager_latency_probe_at_world_two(tmp_path):
    jax_out, _ = run_jax_example("eager_latency_probe", [], tmp_path,
                                 launcher_np=2, PROBE_ITERS="5")
    rc, out = run_port("eager_latency_probe", [], tmp_path, launcher_np=2,
                       PROBE_ITERS="5")
    assert rc == 0, out
    got, want = _probe_record(out), _probe_record(jax_out)
    assert got["config"] == want["config"] == "eager_probe_np2_k8_" \
        "join-enabled"
    assert got["collectives"] == {"sync": 8, "deferred_unfused": 8,
                                  "deferred_fused": 4, "grouped": 4}
    assert got["fuse_stats"] == want["fuse_stats"]
    assert set(got["variants"]) == set(want["variants"])


def test_eager_latency_probe_forced_defer_at_world_one(tmp_path):
    rc, out = run_port("eager_latency_probe", ["--device", "cpu"], tmp_path,
                       PROBE_ITERS="3", PROBE_FORCE_DEFER="1")
    assert rc == 0, out
    rec = _probe_record(out)
    assert rec["config"].endswith("_forced-defer")
    assert rec["collectives"]["deferred_fused"] < \
        rec["collectives"]["deferred_unfused"]
    assert rec["fuse_stats"]["flushes"] == 4
    assert rec["fuse_stats"]["fused_buckets"] == 16


