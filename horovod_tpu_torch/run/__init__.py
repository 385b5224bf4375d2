"""The launcher (``horovodrun`` analogue): see ``run/launch.py``.

``python -m horovod_tpu_torch.run -np 2 --cpu python train.py`` starts
two workers meeting in one process group; ``--host-discovery-script``
starts the elastic driver instead.  The programmatic ``run(func, np=)``
of the JAX package (a Ray executor) is not ported.
"""

from .launch import check_build, free_port, run_command, worker_env  # noqa: F401
