"""NumPy reference implementation of Adasum (for tests only).

The port's own copy of ``horovod_tpu/adasum/reference.py``: the
recursive pairwise combination of the reference's
``horovod/common/ops/adasum/adasum.h`` with dot-product mixing
coefficients,

    adasum(a, b) = (1 - a.b / (2 |a|^2)) a  +  (1 - a.b / (2 |b|^2)) b

applied over a binary tree: level k combines the results of index groups
whose bit k differs, lower-index group first.  Scalars in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_TOL = 1e-30


def adasum_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Combine two gradient vectors with Adasum mixing coefficients."""
    a64 = a.astype(np.float64).ravel()
    b64 = b.astype(np.float64).ravel()
    dot = float(a64 @ b64)
    anormsq = float(a64 @ a64)
    bnormsq = float(b64 @ b64)
    acoeff = 1.0 if anormsq < _TOL else 1.0 - dot / anormsq * 0.5
    bcoeff = 1.0 if bnormsq < _TOL else 1.0 - dot / bnormsq * 0.5
    return (acoeff * a.astype(np.float64) +
            bcoeff * b.astype(np.float64)).astype(a.dtype)


def adasum_reference(vectors: Sequence[np.ndarray]) -> np.ndarray:
    """Adasum over ``len(vectors)`` ranks (must be a power of two)."""
    n = len(vectors)
    if n & (n - 1) != 0:
        raise ValueError(f"power-of-two rank count required, got {n}")
    if n == 1:
        return vectors[0]
    half = n // 2
    lo = adasum_reference(vectors[:half])
    hi = adasum_reference(vectors[half:])
    return adasum_pair(lo, hi)
