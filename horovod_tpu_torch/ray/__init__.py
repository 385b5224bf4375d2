"""``horovod_tpu_torch.ray``: Ray cluster integration (reference
``horovod/ray/runner.py::RayExecutor`` parity).

The port's copy of ``horovod_tpu/ray/__init__.py``.  ``RayExecutor``
places one worker per slot, exports the ``HOROVOD_*`` identity env and
the rendezvous address (``MASTER_ADDR``/``MASTER_PORT``, from
:func:`~horovod_tpu_torch.run.launch.worker_env`) to each, and runs a
user function on all workers.  Two backends:

* **ray** (when importable): one Ray actor per worker -- the reference's
  model.
* **local** (always available, and the test backend): one spawned local
  process per worker, same env contract.  This doubles as a programmatic
  alternative to the ``python -m horovod_tpu_torch.run`` CLI.

A worker runs on the GPU once it calls ``init()`` unless the executor
was built with ``cpu=True`` (``HVD_TPU_FORCE_CPU=1`` in its env): with no
GPU it raises there, and the executor reports that as a failed worker.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
from typing import Any, Callable, List, Optional

from ..run.launch import free_port, worker_env
from .elastic import ElasticRayExecutor  # noqa: F401


def _local_worker_main(fn, args, kwargs, env, q, rank):
    os.environ.update(env)
    try:
        q.put((rank, True, fn(*args, **kwargs)))
    except Exception as e:  # noqa: BLE001 - crosses the process boundary
        q.put((rank, False, f"{type(e).__name__}: {e}"))


class RayExecutor:
    """Run a function on N workers with the framework env wired up.

    ``num_workers`` slots; ``cpu=True`` forces the CPU (gloo) in each
    worker; ``use_ray=None`` auto-detects.
    """

    def __init__(self, num_workers: int, cpu: bool = False,
                 use_ray: Optional[bool] = None, slots_per_worker: int = 1,
                 extra_env: Optional[dict] = None):
        self.num_workers = num_workers
        self.cpu = cpu
        self.slots = slots_per_worker
        self.extra_env = dict(extra_env or {})
        if use_ray is None:
            try:
                import ray  # noqa: F401
                use_ray = True
            except ImportError:
                use_ray = False
        self.use_ray = use_ray
        self._actors = None
        self._started = False

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._started:
            raise RuntimeError("executor already started")
        if self.use_ray:
            self._start_ray()
        self._started = True

    def _start_ray(self) -> None:
        import ray
        if not ray.is_initialized():
            ray.init()

        @ray.remote
        class _Worker:
            def set_env(self, env):
                os.environ.update(env)
                return socket.gethostname()

            def exec_fn(self, fn, args, kwargs):
                return fn(*args, **kwargs)

        self._actors = [_Worker.remote() for _ in range(self.num_workers)]

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        """Execute ``fn(*args, **kwargs)`` on every worker; rank-ordered
        results.  Raises RuntimeError if any worker fails."""
        if not self._started:
            raise RuntimeError("call start() first")
        kwargs = kwargs or {}
        port = free_port()
        envs = [{**self.extra_env,
                 **worker_env(rank=i, size=self.num_workers,
                              coordinator="127.0.0.1", port=port,
                              cpu=self.cpu, slots=self.slots)}
                for i in range(self.num_workers)]
        if self.use_ray:
            import ray
            ray.get([a.set_env.remote(e)
                     for a, e in zip(self._actors, envs)])
            return ray.get([a.exec_fn.remote(fn, args, kwargs)
                            for a in self._actors])
        return self._run_local(fn, args, kwargs, envs)

    def _run_local(self, fn, args, kwargs, envs,
                   timeout_s: float = 600.0,
                   failure_grace_s: float = 15.0) -> List[Any]:
        import queue as _queue
        import time

        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_local_worker_main,
                             args=(fn, args, kwargs, env, q, rank))
                 for rank, env in enumerate(envs)]
        for p in procs:
            p.start()
        results: dict = {}
        failures: dict = {}
        remaining = set(range(len(procs)))
        deadline = time.monotonic() + timeout_s
        term_deadline = None  # set on first failure: grace for peers'
        # secondary errors to surface, then stragglers are cut loose
        try:
            while remaining:
                now = time.monotonic()
                if now > deadline:
                    for r in sorted(remaining):
                        procs[r].terminate()
                        failures[r] = f"no result within {timeout_s}s"
                    break
                if term_deadline is not None and now > term_deadline:
                    for r in sorted(remaining):
                        procs[r].terminate()
                        failures[r] = ("terminated: still running "
                                       f"{failure_grace_s}s after a peer "
                                       "failed (likely blocked in a "
                                       "collective with the dead peer)")
                    break
                try:
                    rank, ok, value = q.get(timeout=1.0)
                    (results if ok else failures)[rank] = value
                    remaining.discard(rank)
                except _queue.Empty:
                    # Reap workers that died without reporting (segfault,
                    # os._exit); give one poll cycle for in-flight messages.
                    for r in sorted(remaining):
                        p = procs[r]
                        if not p.is_alive() and p.exitcode is not None \
                                and q.empty():
                            failures[r] = (f"exited with code {p.exitcode} "
                                           "without reporting")
                            remaining.discard(r)
                if failures and term_deadline is None:
                    term_deadline = time.monotonic() + failure_grace_s
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
        if failures:
            # Report every failure: the FIRST message received is often a
            # secondary "peer died" error, not the root cause.
            detail = "; ".join(f"worker {r}: {failures[r]}"
                               for r in sorted(failures))
            raise RuntimeError(f"worker(s) failed: {detail}")
        return [results[i] for i in range(self.num_workers)]

    def shutdown(self) -> None:
        if self.use_ray and self._actors is not None:
            import ray
            for a in self._actors:
                ray.kill(a)
            self._actors = None
        self._started = False
