"""Environment-driven configuration knobs.

Counterpart of ``horovod_tpu/core/config.py`` (``_env``/``_env_int``/
``_env_bool``): both the historical ``HOROVOD_*`` names and the
``HVD_TPU_*`` overrides are honoured, the latter winning when both are
set, so one environment drives either package identically.
:class:`Config` is the subset of the JAX package's ``Config`` that the
training path reads.
"""

from __future__ import annotations

import dataclasses
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


_MiB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class Config:
    """The runtime knobs the training path reads (a subset of the JAX
    package's ``Config``, same names and defaults)."""

    # Gradient bucketing threshold in bytes (HOROVOD_FUSION_THRESHOLD,
    # default 64 MiB, as in the reference).
    fusion_threshold: int = 64 * _MiB
    # Default gradient-exchange codec (HOROVOD_COMPRESSION): a spec string
    # parsed by ``collectives.compression.parse_compression`` --
    # none|fp16|bf16|powersgd:<rank>.  Applies to DistributedOptimizer
    # wraps built without an explicit ``compression`` argument; None = no
    # compression.
    compression: Optional[str] = None
    # Error-feedback residual carry for the powersgd codec
    # (HOROVOD_EF_RESIDUAL, default on).  Off drops each step's
    # compression error instead of feeding it back -- ablation only, it
    # biases convergence.
    ef_residual: bool = True
    # Launcher-provided identity (HOROVOD_RANK / _SIZE / _LOCAL_RANK /
    # _LOCAL_SIZE / _CROSS_RANK / _CROSS_SIZE); -1 = not set.
    env_rank: int = -1
    env_size: int = -1
    env_local_rank: int = -1
    env_local_size: int = -1
    env_cross_rank: int = -1
    env_cross_size: int = -1


def load_config() -> Config:
    """A :class:`Config` from the environment."""
    return Config(
        fusion_threshold=_env_int("FUSION_THRESHOLD", 64 * _MiB),
        compression=_env("COMPRESSION"),
        ef_residual=_env_bool("EF_RESIDUAL", True),
        env_rank=_env_int("RANK", -1),
        env_size=_env_int("SIZE", -1),
        env_local_rank=_env_int("LOCAL_RANK", -1),
        env_local_size=_env_int("LOCAL_SIZE", -1),
        env_cross_rank=_env_int("CROSS_RANK", -1),
        env_cross_size=_env_int("CROSS_SIZE", -1),
    )
