"""``horovod_tpu_torch.tensorflow.elastic``: TensorFlowKerasState + run.

The port's counterpart of ``horovod_tpu/tensorflow/elastic.py`` (over
the port's :mod:`~horovod_tpu_torch.elastic.state`).  Parity with ``horovod/tensorflow/elastic.py::TensorFlowKerasState``: the
elastic state object for keras models -- ``commit()`` snapshots
``model.get_weights()`` (+ optimizer variables and scalar attributes) in
host memory, ``restore()`` rolls back, ``sync()`` broadcasts rank 0's
weights to everyone after a rescale.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import numpy as np

from ..elastic.run_loop import run  # noqa: F401
from ..elastic.state import ObjectState, State  # noqa: F401


def _optimizer_weights(optimizer) -> List[np.ndarray]:
    if optimizer is None:
        return []
    vs = getattr(optimizer, "variables", None)
    if vs is None:
        return []
    vals = vs() if callable(vs) else vs
    return [np.asarray(v) for v in vals]


def _set_optimizer_weights(optimizer, weights: List[np.ndarray],
                           model=None) -> None:
    if optimizer is None or not weights:
        return
    vs = getattr(optimizer, "variables", None)
    if vs is None:
        return
    vals = vs() if callable(vs) else vs
    if len(vals) != len(weights) and model is not None:
        # A freshly joined worker's optimizer may not be built yet (no
        # slot variables); build against the model so every broadcast
        # variable has a home instead of being silently zip-truncated.
        build = getattr(optimizer, "build", None)
        if callable(build):
            build(model.trainable_variables)
            vals = vs() if callable(vs) else vs
    if len(vals) != len(weights):
        raise RuntimeError(
            f"optimizer variable count mismatch in elastic sync: local "
            f"{len(vals)} vs broadcast {len(weights)} -- the optimizers "
            "are structured differently across ranks")
    for var, w in zip(vals, weights):
        var.assign(w)


class TensorFlowKerasState(State):
    """Elastic state over a keras model (+ optimizer + scalars)::

        state = hvd.elastic.TensorFlowKerasState(model, optimizer=opt,
                                                 batch=0, epoch=0)
    """

    def __init__(self, model, optimizer=None, **kwargs):
        super().__init__()
        self.model = model
        self.optimizer = optimizer
        self._scalars = list(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._saved: Dict[str, Any] = {}
        self.commit()

    def commit(self) -> None:
        # get_weights() already returns fresh host copies; materialize
        # once and reuse for both the (usually disabled) desync check and
        # the snapshot -- commit runs at every batch boundary.
        weights = self.model.get_weights()
        self._check_desync({
            "weights": weights,
            "scalars": {k: getattr(self, k) for k in self._scalars}})
        self._saved = {
            "weights": weights,
            "opt": _optimizer_weights(self.optimizer),
            "scalars": {k: copy.deepcopy(getattr(self, k))
                        for k in self._scalars},
        }
        self._check_host_updates()

    def restore(self) -> None:
        self.model.set_weights([np.copy(w)
                                for w in self._saved["weights"]])
        if self.optimizer is not None and self._saved["opt"]:
            _set_optimizer_weights(self.optimizer, self._saved["opt"])
        for k, v in self._saved["scalars"].items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self) -> None:
        import torch

        from ..core.basics import _require_init
        from ..optim.functions import broadcast_object, broadcast_parameters

        dev = _require_init().device
        synced = {str(i): torch.tensor(w, device=dev)
                  for i, w in enumerate(self.model.get_weights())}
        broadcast_parameters(synced, root_rank=0)
        self.model.set_weights([t.cpu().numpy() for t in synced.values()])
        opt = broadcast_object(_optimizer_weights(self.optimizer),
                               root_rank=0)
        _set_optimizer_weights(self.optimizer, opt, model=self.model)
        scalars = broadcast_object(
            {k: getattr(self, k) for k in self._scalars}, root_rank=0)
        for k, v in scalars.items():
            setattr(self, k, v)
        self.commit()
