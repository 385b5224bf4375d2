"""Process-global framework state.

Counterpart of ``horovod_tpu/core/state.py``: the parsed config and the
world's identity, set by ``init()``.  The communicator is
``torch.distributed``'s default process group; ``owns_group`` says
whether ``init()`` created it (and ``shutdown()`` must destroy it).
``process_sets`` maps each registered set's name to its
:class:`~horovod_tpu_torch.core.process_sets.ProcessSet` (the global set
included), and ``hierarchy`` caches the node and cross groups of
hierarchical Adasum per ``local_size``.
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
        self.reset()

    def reset(self) -> None:
        self.initialized: bool = False
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None
        self.rank = self.size = 0
        self.local_rank = self.local_size = 0
        self.cross_rank = self.cross_size = 0
        self.owns_group: bool = False
        self.process_sets: Dict[str, object] = {}
        self.hierarchy: Dict[int, tuple] = {}


_state = GlobalState()


def global_state() -> GlobalState:
    return _state
