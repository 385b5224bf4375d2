"""Elastic (fault-tolerant, rescalable) training: ``hvd.elastic``.

The port's counterpart of ``horovod_tpu/elastic`` (reference:
``horovod/runner/elastic/`` and ``horovod/torch/elastic``): state commit
/ restore / sync / resize (:class:`TorchState`, which stands where the
JAX package has ``JaxState``), the ``@hvd.elastic.run`` rollback loop,
host discovery, the driver behind ``python -m horovod_tpu_torch.run
--host-discovery-script``, and seeded chaos injection
(``HOROVOD_CHAOS``).
"""

from .state import State, ObjectState, TorchState  # noqa: F401
from .run_loop import run, check_for_host_updates, apply_resize  # noqa: F401
from .sampler import ElasticSampler  # noqa: F401
from .discovery import HostDiscoveryScript  # noqa: F401
from . import chaos  # noqa: F401
from .chaos import ChaosCommError, ChaosInjector  # noqa: F401
