"""Environment-driven configuration knobs.

Counterpart of ``horovod_tpu/core/config.py`` (``_env``/``_env_int``/
``_env_float``/``_env_bool``): both the historical ``HOROVOD_*`` names and the
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


def _env_float(name: str, default: float) -> float:
    v = _env(name)
    return float(v) if v not in (None, "") else default


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
    # none|fp16|bf16|fp8|powersgd:<rank>|topk:<f>|ici:<c>,dcn:<c>.
    # Applies to DistributedOptimizer wraps built without an explicit
    # ``compression`` argument; None = no compression.
    compression: Optional[str] = None
    # Error-feedback residual carry for the powersgd and topk codecs
    # (HOROVOD_EF_RESIDUAL, default on).  Off drops each step's
    # compression error instead of feeding it back -- ablation only, it
    # biases convergence.
    ef_residual: bool = True
    # Two-level DCN x ICI reduction (HOROVOD_HIERARCHICAL_ALLREDUCE): the
    # gradient exchange becomes collectives.ops.hierarchical_allreduce
    # over nodes of local_size() ranks.
    hierarchical_allreduce: bool = False
    # Two-level topology spec (HOROVOD_HIERARCHICAL): ``auto`` takes
    # nodes of local_size() ranks, ``rows,cols`` pins ``rows`` nodes of
    # ``cols`` ranks; setting it implies hierarchical_allreduce.  Parsed
    # by core.topology.parse_topology_spec.
    hierarchical: Optional[str] = None
    # ZeRO-1 sharded optimizer state (HOROVOD_ZERO=1): the default
    # zero_stage of steps built without one (optim/zero.py).
    zero_stage: int = 0
    # Chunked gradient exchange (HOROVOD_EXCHANGE_CHUNK_MB, megabytes; 0
    # off): each bucket's allreduce becomes chunk-sized reduce-scatter +
    # allgather pairs (collectives.ops.chunked_allreduce).
    exchange_chunk_bytes: int = 0
    # Steps-per-execution loop (HOROVOD_STEPS_PER_EXEC): default k of
    # make_train_loop / make_flax_train_loop built without an explicit
    # steps_per_execution; on the GPU the k steps are one CUDA graph.
    steps_per_exec: int = 1
    # Microbatched backward-overlap exchange (HOROVOD_MICROBATCHES):
    # default k of train steps built without an explicit ``microbatches``;
    # each sub-batch's buckets reduce-scatter while the next sub-batch's
    # backward runs.
    microbatches: int = 1
    # Stall inspector (core/stall.py): warn about a blocking wait older
    # than stall_check_time seconds (HOROVOD_STALL_CHECK_TIME, default
    # 60; HOROVOD_STALL_CHECK_DISABLE=1 turns it off), abort the process
    # past stall_shutdown_time (0 = never), and latch the elastic
    # preemption notice past stall_reset_time (0 = never), so a wedged
    # collective becomes an elastic reset instead of a hang.
    stall_check_disable: bool = False
    stall_check_time: float = 60.0
    stall_shutdown_time: float = 0.0
    stall_reset_time: float = 0.0
    # Elastic (HOROVOD_ELASTIC_TIMEOUT, seconds): the driver's wait for
    # min-np hosts, and the process group's collective timeout, so a
    # peer lost under NCCL surfaces as an error instead of a hang.
    elastic_timeout: float = 600.0
    # Consecutive restore + sync attempts before a persistent desync or
    # sustained anomaly aborts the elastic loop
    # (HOROVOD_DESYNC_MAX_RETRIES).
    desync_max_retries: int = 3
    # Snapshot/rollback ledger cadence in committed steps
    # (HOROVOD_SNAPSHOT_STEPS); 0 disables the ring.
    snapshot_steps: int = 0
    # The silent-data-corruption plane (HOROVOD_CHECK_DESYNC,
    # HOROVOD_DESYNC_CHECK_STEPS, HOROVOD_GUARD) is not ported (ROADMAP
    # item 1.11): init() refuses the settings that turn it on.
    check_desync: bool = False
    desync_check_steps: int = 0
    guard: str = "auto"
    # Driver-side heartbeat eviction in seconds (HOROVOD_HEARTBEAT_TIMEOUT;
    # 0 disables).
    heartbeat_timeout: float = 0.0
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
        hierarchical_allreduce=_env_bool("HIERARCHICAL_ALLREDUCE"),
        hierarchical=_env("HIERARCHICAL"),
        zero_stage=_env_int("ZERO", 0),
        exchange_chunk_bytes=_env_int("EXCHANGE_CHUNK_MB", 0) * _MiB,
        steps_per_exec=_env_int("STEPS_PER_EXEC", 1),
        microbatches=_env_int("MICROBATCHES", 1),
        stall_check_disable=_env_bool("STALL_CHECK_DISABLE"),
        # Upstream spells these *_TIME_SECONDS; both are accepted.
        stall_check_time=_env_float(
            "STALL_CHECK_TIME_SECONDS", _env_float("STALL_CHECK_TIME", 60.0)),
        stall_shutdown_time=_env_float(
            "STALL_SHUTDOWN_TIME_SECONDS",
            _env_float("STALL_SHUTDOWN_TIME", 0.0)),
        stall_reset_time=_env_float(
            "STALL_RESET_TIME_SECONDS", _env_float("STALL_RESET_TIME", 0.0)),
        elastic_timeout=_env_float("ELASTIC_TIMEOUT", 600.0),
        desync_max_retries=_env_int("DESYNC_MAX_RETRIES", 3),
        snapshot_steps=_env_int("SNAPSHOT_STEPS", 0),
        check_desync=_env_bool("CHECK_DESYNC"),
        desync_check_steps=_env_int("DESYNC_CHECK_STEPS", 0),
        guard=(_env("GUARD", "auto") or "auto").strip().lower(),
        heartbeat_timeout=_env_float("HEARTBEAT_TIMEOUT", 0.0),
        env_rank=_env_int("RANK", -1),
        env_size=_env_int("SIZE", -1),
        env_local_rank=_env_int("LOCAL_RANK", -1),
        env_local_size=_env_int("LOCAL_SIZE", -1),
        env_cross_rank=_env_int("CROSS_RANK", -1),
        env_cross_size=_env_int("CROSS_SIZE", -1),
    )


def refuse_unported(cfg: Config) -> None:
    """``NotImplementedError`` for a setting that turns on the
    silent-data-corruption plane (``core/guard.py``, ``core/desync.py``),
    which is not ported (ROADMAP item 1.11)."""
    for on, knob in ((cfg.check_desync, "HOROVOD_CHECK_DESYNC"),
                     (cfg.desync_check_steps > 0,
                      "HOROVOD_DESYNC_CHECK_STEPS"),
                     (cfg.guard in ("1", "on", "true", "yes"),
                      "HOROVOD_GUARD")):
        if on:
            raise NotImplementedError(
                f"{knob} turns on the silent-data-corruption plane, which "
                f"is not ported (ROADMAP item 1.11)")
