"""Reduction-op constants (``hvd.Sum / Average / Min / Max / Product``).

Counterpart of ``horovod_tpu/collectives/reduce_op.py``.  ``Adasum`` is
not ported yet (it needs the VHDD exchange of ``adasum/``).
"""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    AVERAGE = "average"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
