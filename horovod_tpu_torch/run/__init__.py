"""The launcher (``horovodrun`` analogue): see ``run/launch.py``.

``python -m horovod_tpu_torch.run -np 2 --cpu python train.py`` starts
two workers meeting in one process group; ``--host-discovery-script``
starts the elastic driver instead.  :func:`run` is the programmatic
form (``horovod.run(func, np=)``): a function on ``np`` processes,
through :class:`~horovod_tpu_torch.ray.RayExecutor`.
"""

from .launch import check_build, free_port, run_command, worker_env  # noqa: F401


def run(func, args=(), kwargs=None, np=1, cpu=False, slots=1,
        use_ray=False, verbose=0):
    """Programmatic launcher (reference ``horovod.run.run()`` API).

    Runs ``func(*args, **kwargs)`` on ``np`` worker processes with the
    framework env wired (``HOROVOD_RANK``/``HOROVOD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``); returns the rank-ordered results.
    Each worker runs on the GPU (``cuda:<local_rank>`` under NCCL once it
    calls ``init()``) unless ``cpu=True``, which exports
    ``HVD_TPU_FORCE_CPU=1`` and makes ``init()`` take gloo.  A failing
    worker raises ``RuntimeError`` naming every failed rank.  ``func``
    must be importable by reference (a module-level function): the
    workers are spawned processes.
    """
    import os

    from ..ray import RayExecutor

    # verbose reaches workers through their env dict (works for both the
    # local-process and ray-actor backends; no process-global mutation).
    # An explicit user HOROVOD_LOG_LEVEL wins over the verbose default.
    extra = {}
    if verbose and "HOROVOD_LOG_LEVEL" not in os.environ:
        extra = {"HOROVOD_LOG_LEVEL": "debug" if verbose > 1 else "info"}
    ex = RayExecutor(num_workers=np, cpu=cpu, use_ray=use_ray,
                     slots_per_worker=slots, extra_env=extra)
    ex.start()
    try:
        return ex.run(func, args=args, kwargs=kwargs or {})
    finally:
        ex.shutdown()
