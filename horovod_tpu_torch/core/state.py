"""Process-global framework state.

Counterpart of ``horovod_tpu/core/state.py``: the parsed config and the
world's identity, set by ``init()``.  The communicator is
``torch.distributed``'s default process group; ``owns_group`` says
whether ``init()`` created it (and ``shutdown()`` must destroy it).
``process_sets`` maps each registered set's name to its
:class:`~horovod_tpu_torch.core.process_sets.ProcessSet` (the global set
included), ``hierarchy`` caches the node and cross groups of
hierarchical Adasum per ``local_size``, and ``mesh`` is the rank mesh
of :mod:`~horovod_tpu_torch.parallel.mesh` that named axes resolve
against.  ``generation`` counts the
``init()`` calls of the process and survives ``reset()``: what binds the
process group when it is built (a ``DistributedOptimizer``'s in-flight
handles and two-level groups, a captured ``TrainLoop`` graph) records it
and rebuilds or refuses itself after an elastic re-init.

The observability plane ``init()`` arms lives here too, and ``reset()``
(``shutdown()``, the elastic re-init) stops it: the ``timeline`` writer
(``HOROVOD_TIMELINE`` / ``start_timeline``), the ``metrics_server``
(``HOROVOD_METRICS_PORT``), the ``straggler`` monitor and the
``trace_plane`` (``HOROVOD_TRACE_SYNC``), and the span recorder's
wiring.  Each owns a thread or a socket, so none outlives the world it
was made for.

``autotuner`` is the online tuner ``init()`` builds under
``HOROVOD_AUTOTUNE=1`` (``autotune.Autotuner``); ``reset()`` drops it,
and the next ``init()`` builds a new one, which warm-starts from
``HOROVOD_AUTOTUNE_LOG``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .config import Config


class GlobalState:
    """Mutable singleton holding everything ``init()`` sets up."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.generation = 0
        self.timeline = None
        self.metrics_server = None
        self.reset()

    def reset(self) -> None:
        if self.timeline is not None:
            self.timeline.close()
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.timeline = None
        self.metrics_server = None
        self.trace_plane = None
        self.straggler = None
        self.autotuner = None
        self.initialized: bool = False
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None
        self.rank = self.size = 0
        self.local_rank = self.local_size = 0
        self.cross_rank = self.cross_size = 0
        self.owns_group: bool = False
        self.process_sets: Dict[str, object] = {}
        self.hierarchy: Dict[int, tuple] = {}
        # The rank mesh the last build_parallel_mesh / build_3d_mesh made
        # (parallel/mesh.py): what a named axis resolves against.
        self.mesh = None
        import sys
        spans = sys.modules.get("horovod_tpu_torch.timeline.spans")
        if spans is not None:
            spans.recorder().reset()
        # A shutdown (elastic re-init included) stops the preemption
        # module's metadata poll; a latched notice survives it.
        preemption = sys.modules.get(
            "horovod_tpu_torch.elastic.preemption")
        if preemption is not None:
            preemption.on_runtime_reset()


_state = GlobalState()


def global_state() -> GlobalState:
    return _state
