"""Environment-driven configuration knobs.

Counterpart of ``horovod_tpu/core/config.py`` (``_env``/``_env_int``/
``_env_bool``): both the historical ``HOROVOD_*`` names and the
``HVD_TPU_*`` overrides are honoured, the latter winning when both are
set, so one environment drives either package identically.
"""

from __future__ import annotations

import os
from typing import Optional


def _env(name: str, default: Optional[str] = None) -> Optional[str]:
    """Look up ``HVD_TPU_<name>`` then ``HOROVOD_<name>``."""
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        v = os.environ.get(prefix + name)
        if v is not None:
            return v
    return default


def _env_int(name: str, default: int) -> int:
    v = _env(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = _env(name)
    if v in (None, ""):
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")
