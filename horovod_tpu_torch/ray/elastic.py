"""Elastic Ray executor (reference ``horovod/ray/elastic_v2.py`` parity).

The port's copy of ``horovod_tpu/ray/elastic.py``.  ``ElasticRayExecutor``
runs a python function on an elastically-managed worker set: host
membership comes from the Ray cluster (one slot per alive node) when Ray
is importable, or from a host file; workers ride the same
:class:`~horovod_tpu_torch.elastic.driver.ElasticDriver`
rescale/blacklist/heartbeat machinery as ``python -m
horovod_tpu_torch.run --host-discovery-script``.  The function is shipped
to workers by pickle; per-rank results come back through the run
directory, rank-ordered.

The user function runs under the worker's own elastic loop: decorate
training with ``@horovod_tpu_torch.elastic.run`` inside it exactly as a
script would (the executor deliberately does not hide that contract --
commit boundaries are the user's to choose, reference semantics).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Any, Callable, List, Optional

from ..elastic.driver import ElasticDriver


def _ray_discovery_script(workdir: str, slots: int) -> str:
    """Discovery script printing one worker id per alive Ray node."""
    path = os.path.join(workdir, "ray_discovery.py")
    with open(path, "w") as f:
        f.write(
            "#!/usr/bin/env python\n"
            "import ray\n"
            "ray.init(address='auto', ignore_reinit_error=True,\n"
            "         logging_level='ERROR')\n"
            "for node in ray.nodes():\n"
            "    if node.get('Alive'):\n"
            f"        print(node['NodeID'][:12] + ':{slots}')\n")
    os.chmod(path, 0o755)
    return path


def _file_discovery_script(workdir: str, host_file: str) -> str:
    import shlex
    path = os.path.join(workdir, "file_discovery.sh")
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\ncat {shlex.quote(host_file)}\n")
    os.chmod(path, 0o755)
    return path


class ElasticRayExecutor:
    """Elastic function runner over a dynamic host set.

    ``host_file``: path whose lines name the current hosts (the
    non-Ray discovery source; rewrite it to scale).  Without it, Ray's
    alive-node set is polled.  Workers run on the GPU unless ``cpu``.
    """

    def __init__(self, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 slots_per_worker: int = 1, cpu: bool = False,
                 host_file: Optional[str] = None,
                 heartbeat_timeout_s: float = 0.0,
                 network_rendezvous: bool = False,
                 chaos: Optional[str] = None):
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.slots = slots_per_worker
        self.cpu = cpu
        self.host_file = host_file
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.network_rendezvous = network_rendezvous
        # HOROVOD_CHAOS spec shipped to every worker (deterministic
        # fault-injection runs; see horovod_tpu_torch/elastic/chaos.py).
        self.chaos = chaos
        self.workdir = tempfile.mkdtemp(prefix="hvd_torch_ray_elastic_")

    def close(self) -> None:
        """Remove the working directory (pickled payload + results)."""
        import shutil
        shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self) -> "ElasticRayExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` elastically; rank-ordered results
        from the FINAL membership epoch."""
        payload = os.path.join(self.workdir, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args, kwargs or {}), f)
        results_dir = os.path.join(self.workdir, "results")
        # Fresh results dir per call: stale rank files from a previous
        # run() (or an earlier, larger membership epoch) must not leak
        # into this call's output.
        if os.path.isdir(results_dir):
            import shutil
            shutil.rmtree(results_dir)
        os.makedirs(results_dir)

        if self.host_file is not None:
            discovery = _file_discovery_script(self.workdir, self.host_file)
        else:
            try:
                import ray  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "ElasticRayExecutor without host_file requires ray; "
                    "pass host_file= for the file-backed discovery "
                    "source.") from e
            discovery = _ray_discovery_script(self.workdir, self.slots)

        # The pickled fn's defining module must be importable in workers;
        # the parent's sys.path (e.g. a test dir pytest inserted) may not
        # be in PYTHONPATH, so propagate it.
        pypath = os.pathsep.join(
            [p for p in sys.path if p] +
            [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
             if p])
        extra_env = {"PYTHONPATH": pypath}
        if self.chaos:
            extra_env["HOROVOD_CHAOS"] = self.chaos
        driver = ElasticDriver(
            command=[sys.executable, "-m",
                     "horovod_tpu_torch.ray._elastic_worker", payload,
                     results_dir],
            extra_env=extra_env,
            discovery_script=discovery,
            discovery_timeout_s=30.0 if self.host_file is None else 10.0,
            min_np=self.min_workers,
            max_np=self.max_workers,
            cpu=self.cpu,
            slots=self.slots,
            heartbeat_timeout_s=self.heartbeat_timeout_s,
            rendezvous=self.network_rendezvous,
        )
        rc = driver.run()
        if rc != 0:
            raise RuntimeError(f"elastic run failed (exit {rc})")
        results = {}
        for name in os.listdir(results_dir):
            if not name.startswith("rank_"):
                continue
            with open(os.path.join(results_dir, name), "rb") as f:
                results[int(name[len("rank_"):])] = pickle.load(f)
        # Return exactly the FINAL membership epoch's ranks: a worker from
        # an earlier (larger) epoch may have finished and written a rank
        # beyond the final size before the scale-down landed.  The driver
        # removes its assignment file on exit and keeps the last document.
        doc = driver.last_assignment
        final_size = doc["size"] if doc else len(results)
        missing = [r for r in range(final_size) if r not in results]
        if missing:
            raise RuntimeError(
                f"missing results for final-epoch rank(s) {missing}")
        return [results[r] for r in range(final_size)]
