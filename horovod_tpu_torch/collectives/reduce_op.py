"""Reduction-op constants (``hvd.Sum / Average / Adasum / Min / Max /
Product``).

Counterpart of ``horovod_tpu/collectives/reduce_op.py``.  ``Adasum`` runs
the vector-halving, distance-doubling exchange of
:mod:`horovod_tpu_torch.adasum.vhdd`.
"""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    AVERAGE = "average"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"
    ADASUM = "adasum"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
Adasum = ReduceOp.ADASUM
