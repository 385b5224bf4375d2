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
    # Cycle window of the native gradient batcher in milliseconds
    # (HOROVOD_CYCLE_TIME; collectives/batching.py).  The autotuner's
    # cycle axis opens while the batcher runs and pushes each sample's
    # value into it.
    cycle_time: float = 1.0
    # The batched DistributedOptimizer (HVD_TPU_NATIVE_CORE=1, opt-in):
    # gradient hooks hand each gradient to the native cycle scheduler
    # (_core/), which cuts fused batches, one grouped_allreduce each.  Off,
    # the planned buckets run; =0 also turns the native library off.
    native_core: bool = False
    # Cut the batcher's batches only at synchronize(), in name order
    # (HOROVOD_DETERMINISTIC); None = the default rule: always at world >
    # 1, on the GPU at world 1, not on the CPU at world 1.
    deterministic: Optional[bool] = None
    # Fuse compatible deferred async allreduces at a flush
    # (HOROVOD_DEFERRED_FUSE, default on) into per-rank buckets of at most
    # deferred_fuse_threshold bytes (HOROVOD_DEFERRED_FUSE_THRESHOLD; 0 =
    # the fusion threshold, autotuner included).
    deferred_fuse: bool = True
    deferred_fuse_threshold: int = 0
    # hvd.join's drain protocol: a drained rank's wait for the active
    # ranks' next collective, in seconds (HOROVOD_JOIN_TIMEOUT), and the
    # opt-out of the per-op presence round (HOROVOD_JOIN_DISABLE=1; join()
    # then raises at world > 1).
    join_timeout: float = 60.0
    join_disable: bool = False
    # Online autotuning (HOROVOD_AUTOTUNE; autotune/): init() builds an
    # Autotuner whose current sample wins over the knobs it tunes.
    # HOROVOD_AUTOTUNE_LOG persists the samples as CSV and warm-starts
    # the next run from them.  The HOROVOD_AUTOTUNE_<AXIS> switches are
    # read by the tuner itself.
    autotune: bool = False
    autotune_log: Optional[str] = None
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
    # The silent-data-corruption plane.  Commit-boundary checksums of
    # the replicated state across ranks (HOROVOD_CHECK_DESYNC,
    # core/desync.py::check_desync).
    check_desync: bool = False
    # The cross-rank corruption tripwire's cadence in commits
    # (HOROVOD_DESYNC_CHECK_STEPS; 0 off): a bit checksum a rank,
    # majority-voted, attributes a corrupt replica for quarantine.
    desync_check_steps: int = 0
    # The in-step numeric screen (HOROVOD_GUARD=auto|1|0, core/guard.py):
    # a nonfinite count and squared norm of the gradients, one extra
    # 8-byte allreduce a step, and the old state kept on a poisoned
    # step.  "auto" arms it when a corruption chaos kind, the desync
    # checks or the snapshot ledger is on.
    guard: str = "auto"
    # Skip a step whose global gradient norm exceeds this bound even
    # when finite (HOROVOD_GUARD_NORM_LIMIT); 0 = nonfinite screen only.
    guard_norm_limit: float = 0.0
    # Consecutive guard-skipped steps before the anomaly counts as
    # sustained and the rollback ledger engages (HOROVOD_GUARD_STREAK).
    guard_streak: int = 3
    # Chrome-trace timeline path (HOROVOD_TIMELINE) and its cycle marks
    # (HOROVOD_TIMELINE_MARK_CYCLES).
    timeline: Optional[str] = None
    timeline_mark_cycles: bool = False
    # Metrics plane (timeline/metrics.py): HOROVOD_METRICS=0 turns every
    # family into a no-op and unwraps the step sampler;
    # HOROVOD_METRICS_PORT >= 0 serves Prometheus text on that port at
    # init() (0 = ephemeral; global_state().metrics_server.port), -1 none.
    metrics_enabled: bool = True
    metrics_port: int = -1
    # Cross-rank trace plane (timeline/sync.py, HOROVOD_TRACE_SYNC=1):
    # the clock offset to the rendezvous KV server at init(), and a step
    # summary published every HOROVOD_TRACE_PUBLISH_STEPS steps.
    trace_sync: bool = False
    trace_publish_steps: int = 10
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
        cycle_time=_env_float("CYCLE_TIME", 1.0),
        native_core=_env_bool("NATIVE_CORE"),
        deterministic=(_env_bool("DETERMINISTIC")
                       if _env("DETERMINISTIC") not in (None, "")
                       else None),
        deferred_fuse=_env_bool("DEFERRED_FUSE", True),
        deferred_fuse_threshold=_env_int("DEFERRED_FUSE_THRESHOLD", 0),
        join_timeout=_env_float("JOIN_TIMEOUT", 60.0),
        join_disable=_env_bool("JOIN_DISABLE"),
        autotune=_env_bool("AUTOTUNE"),
        autotune_log=_env("AUTOTUNE_LOG"),
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
        guard_norm_limit=_env_float("GUARD_NORM_LIMIT", 0.0),
        guard_streak=_env_int("GUARD_STREAK", 3),
        timeline=_env("TIMELINE"),
        timeline_mark_cycles=_env_bool("TIMELINE_MARK_CYCLES"),
        metrics_enabled=_env_bool("METRICS", True),
        metrics_port=_env_int("METRICS_PORT", -1),
        trace_sync=_env_bool("TRACE_SYNC"),
        trace_publish_steps=_env_int("TRACE_PUBLISH_STEPS", 10),
        heartbeat_timeout=_env_float("HEARTBEAT_TIMEOUT", 0.0),
        env_rank=_env_int("RANK", -1),
        env_size=_env_int("SIZE", -1),
        env_local_rank=_env_int("LOCAL_RANK", -1),
        env_local_size=_env_int("LOCAL_SIZE", -1),
        env_cross_rank=_env_int("CROSS_RANK", -1),
        env_cross_size=_env_int("CROSS_SIZE", -1),
    )

