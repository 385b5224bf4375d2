"""Online autotuning of the exchange knobs (Horovod's ParameterManager).

The port's copy of ``horovod_tpu/autotune/__init__.py``.  The reference
(``horovod/common/parameter_manager.cc`` driving the GP Bayesian
optimization of ``optim/bayesian_optimization.cc``) tunes the exchange
against observed throughput, rank 0 deciding and broadcasting, so every
rank applies the same values.  Same architecture here:

* the search is expected-improvement Bayesian optimization over a
  discrete grid (:mod:`horovod_tpu_torch.autotune.gp`), seeded with a
  strided warmup; a sample is scored in bytes/s over
  ``steps_per_sample`` steps, the first step of each sample unscored
  (it pays for the switch);
* in a world of more than one rank, rank 0's decisions are broadcast
  (``optim.functions.broadcast_object``) at sample boundaries, so the
  ranks never cut divergent buckets while tuning;
* ``HOROVOD_AUTOTUNE=1`` makes ``init()`` build one, and
  ``HOROVOD_AUTOTUNE_LOG`` persists the sampled configurations as CSV
  (the JAX package's text) and warm-starts the next run from them.

The grid has the JAX tuner's ten members, in its order (``_grid``):

* **fusion threshold**: always open (2, 8, 32, 64, 128 MiB and the
  configured one); read by ``controller.fusion.fusion_threshold`` and
  applied by the train step's re-plan of the optimizer's buckets;
* **cycle time**: the native gradient batcher's cycle (0.5, 1 and 5 ms
  and ``HOROVOD_CYCLE_TIME``), open when the batched path is on
  (``HVD_TPU_NATIVE_CORE=1``, or the batcher running) and the batcher
  cuts by the clock -- the CPU at world 1 unless
  ``HOROVOD_DETERMINISTIC`` says otherwise; the JAX tuner keys it on its
  torch shim being imported.  A deterministic batcher (every world > 1,
  the GPU) cuts at ``synchronize()`` alone, so there the member is
  pinned to the configured value (it keeps the log's columns) and
  ``cycle_candidates=`` with more than one value raises ``ValueError``.
  Each sample's fusion threshold, and its cycle time while the axis is
  open, are pushed into the running batcher
  (:meth:`Autotuner._apply_to_batcher`);
* **hierarchical**: open only on a two-level layout
  (``core.topology.hier_mesh_shape`` with both extents above 1);
* **compression**: opt-in (``HOROVOD_AUTOTUNE_COMPRESSION=1``: the
  configured codec, bf16, fp16, fp8), extended by the error-feedback
  codecs of ``HOROVOD_AUTOTUNE_CODEC=powersgd:<r>,topk:<f>,...``
  (probed in their stateless form on a wrap configured without one);
  :meth:`Autotuner.codec_for` says which exchange runs which of them;
* **zero**: opt-in (``HOROVOD_AUTOTUNE_ZERO=1``) on a ``HOROVOD_ZERO=1``
  run: the reduce-scatter exchange (1) or the allreduce one (0) over
  the same arena (``optim/zero.py``);
* **exchange chunk**: opt-in (``HOROVOD_AUTOTUNE_CHUNK=1``): 0, 4 and
  16 MiB and the configured one;
* **steps per execution** and **microbatches**: opt-in
  (``HOROVOD_AUTOTUNE_STEPS_PER_EXEC=1``, ``HOROVOD_AUTOTUNE_MICROBATCH=1``,
  the latter closed on zero runs); build-time knobs read by the
  ``training.steps_per_execution`` / ``microbatches`` resolvers when a
  step or loop is built, so not members of :meth:`Autotuner.trace_key`;
* **DCN-leg codec**: opt-in (``HOROVOD_AUTOTUNE_HIER=1``) on a two-level
  layout;
* **MoE codec**: opt-in (``HOROVOD_AUTOTUNE_MOE=1``: none, bf16, fp16),
  the wire dtype of ``parallel.moe.moe_ffn``'s dispatch/combine
  all_to_all pair (:meth:`Autotuner.moe_codec`, read by
  ``resolve_moe_compression``); without it pinned to
  ``HOROVOD_MOE_COMPRESSION``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .gp import BayesianOptimizer

_MiB = 1024 * 1024
_THRESHOLDS = [2 * _MiB, 8 * _MiB, 32 * _MiB, 64 * _MiB, 128 * _MiB]
_CYCLES_MS = [0.5, 1.0, 5.0]
MAX_SAMPLES = 12
# Compression axis encoding (grid value -> codec); 0 keeps whatever the
# optimizer was configured with.  Codes >= COMP_CODEC_BASE are
# error-feedback codec candidates from HOROVOD_AUTOTUNE_CODEC, positional
# in that comma list.
COMP_DEFAULT, COMP_BF16, COMP_FP16, COMP_FP8 = 0, 1, 2, 3
COMP_CODEC_BASE = 4
# DCN-leg codec axis encoding (grid member 8); 0 keeps the sample's
# plain codec on every leg.
HIER_DCN_NONE, HIER_DCN_BF16, HIER_DCN_FP16, HIER_DCN_FP8 = 0, 1, 2, 3
# MoE all_to_all codec axis encoding (grid member 9): the wire dtype of
# the dispatch/combine shuffle in ``parallel.moe.moe_ffn``.
MOE_NONE, MOE_BF16, MOE_FP16 = 0, 1, 2
_MOE_CODES = {MOE_NONE: "none", MOE_BF16: "bf16", MOE_FP16: "fp16"}


def _grid(thresholds, cycles, hiers, comps, zeros, chunks, steps, micros,
          hcodecs, moes) -> List[Tuple[int, float, int, int, int, int, int,
                                       int, int, int]]:
    # A DCN-leg codec without the hierarchical schedule has no DCN hop to
    # compress: those combinations are pruned.
    return [(t, c, h, k, z, ch, sp, mb, hc, mo) for t in thresholds
            for c in cycles for h in hiers for k in comps for z in zeros
            for ch in chunks for sp in steps for mb in micros
            for hc in hcodecs for mo in moes if not (h == 0 and hc != 0)]


def modeled_exchange_seconds(payload_bytes: float, *, n_dcn: int,
                             n_ici: int, hierarchical: bool,
                             ici_bw: float, dcn_bw: float,
                             ici_wire_scale: float = 1.0,
                             dcn_wire_scale: float = 1.0,
                             quantize_s: float = 0.0,
                             phase_overhead_s: float = 0.0) -> float:
    """Analytic per-link ring cost of one gradient exchange (the JAX
    package's formula; ``utils.scaling.H100_SXM`` gives an H100's rates).

    The candidate scorer for the hierarchical/per-leg-codec axes when no
    wall clock is trustworthy: a flat ring moves ``2 (n-1)/n * bytes``
    over the SLOWEST link it crosses, while the two-level schedule moves
    the full payload over ICI (the NVLink domain) and only the
    ``1/n_ici`` shard over DCN (the NIC) -- with each leg's wire bytes
    scaled by that leg's codec (``*_wire_scale``).  ``quantize_s``
    prices the codec's cast/quantize work, ``phase_overhead_s`` one
    collective launch (the hierarchical schedule pays two extra phases).
    """
    n = n_dcn * n_ici
    if hierarchical and n_dcn > 1:
        return (2 * (n_ici - 1) / n_ici * payload_bytes * ici_wire_scale
                / ici_bw
                + 2 * (n_dcn - 1) / n_dcn
                * (payload_bytes * dcn_wire_scale / n_ici) / dcn_bw
                + 2 * phase_overhead_s + quantize_s)
    return (2 * (n - 1) / n * payload_bytes * ici_wire_scale
            / min(ici_bw, dcn_bw) + phase_overhead_s + quantize_s)


def _layout_is_two_level() -> bool:
    """True when the world is laid out in two levels with both extents
    above 1 (the JAX ``_mesh_is_two_level``): otherwise the hierarchical
    knob has nothing to choose between."""
    from ..core.topology import hier_mesh_shape
    shape = hier_mesh_shape()
    return shape is not None and all(s > 1 for s in shape)


def _batcher_deterministic(config) -> bool:
    """The native batcher's mode for this process: the running one's,
    else the one it would start in (``batching.resolve_deterministic``)."""
    from ..collectives import batching
    from ..core.state import global_state
    b = batching.current()
    if b is not None:
        return b.deterministic
    st = global_state()
    return batching.resolve_deterministic(config, st.size, st.device)


class Autotuner:
    """Feed ``record_step(seconds, nbytes)`` a training step; read the
    current knobs (``fusion_threshold()``, ``exchange_chunk_bytes()``,
    ...).  ``done`` once the best configuration is locked."""

    def __init__(self, config, steps_per_sample: int = 10,
                 candidates: Optional[List[int]] = None,
                 max_samples: int = MAX_SAMPLES,
                 cycle_candidates: Optional[List[float]] = None):
        from ..core.config import _env, _env_bool
        self.candidates = list(candidates or _THRESHOLDS)
        if config.fusion_threshold not in self.candidates:
            self.candidates.append(config.fusion_threshold)
        # The cycle time is read only by a native batcher that cuts its
        # batches by the clock.  A deterministic one (every world > 1,
        # the GPU at world 1) cuts at flush() alone, so there the axis
        # stays pinned: tuning it would re-measure identical
        # configurations under noise.
        from ..collectives import batching
        clocked = not _batcher_deterministic(config)
        if cycle_candidates is not None:
            if not clocked and len(set(cycle_candidates)) > 1:
                raise ValueError(
                    "cycle_candidates: the native batcher is deterministic "
                    "here (world > 1, or the GPU) and cuts batches at "
                    "synchronize() only, so no cycle time changes a step")
            cycles = list(cycle_candidates)
        else:
            batched = batching.current() is not None or \
                getattr(config, "native_core", False)
            cycles = list(_CYCLES_MS) if batched and clocked else []
        if config.cycle_time not in cycles:
            cycles.append(config.cycle_time)
        self.tunes_cycle = len(cycles) > 1
        self.tunes_hier = _layout_is_two_level()
        hiers = [0, 1] if self.tunes_hier else \
            [1 if config.hierarchical_allreduce else 0]
        comps = [COMP_DEFAULT, COMP_BF16, COMP_FP16, COMP_FP8] \
            if _env_bool("AUTOTUNE_COMPRESSION") else [COMP_DEFAULT]
        # Error-feedback codec candidates (HOROVOD_AUTOTUNE_CODEC): each
        # spec extends the compression axis with its own code from
        # COMP_CODEC_BASE up, positional in the list -- keep the list
        # stable between runs, or a warm-start log's codec rows seed
        # another candidate.
        self._codec_axis = {}
        codec_spec = _env("AUTOTUNE_CODEC")
        if codec_spec:
            from ..collectives.compression import parse_compression
            for i, tok in enumerate(
                    t.strip() for t in codec_spec.split(",") if t.strip()):
                code = COMP_CODEC_BASE + i
                self._codec_axis[code] = parse_compression(tok)
                if code not in comps:
                    comps.append(code)
        # ZeRO exchange axis: only a zero-configured run can switch (the
        # sharded state is laid out when the step is built).
        configured_zero = 1 if getattr(config, "zero_stage", 0) else 0
        self.tunes_zero = bool(_env_bool("AUTOTUNE_ZERO") and
                               configured_zero)
        zeros = [0, 1] if self.tunes_zero else [configured_zero]
        configured_chunk = int(getattr(config, "exchange_chunk_bytes", 0))
        if _env_bool("AUTOTUNE_CHUNK"):
            chunks = sorted({0, 4 * _MiB, 16 * _MiB, configured_chunk})
        else:
            chunks = [configured_chunk]
        configured_steps = max(1, int(getattr(config, "steps_per_exec", 1)))
        if _env_bool("AUTOTUNE_STEPS_PER_EXEC"):
            steps = sorted({1, 4, 16, configured_steps})
        else:
            steps = [configured_steps]
        # Zero-configured runs pin k = 1: the two exchanges exclude each
        # other when the step is built.
        configured_micro = max(1, int(getattr(config, "microbatches", 1)))
        if _env_bool("AUTOTUNE_MICROBATCH") and not configured_zero:
            micros = sorted({1, 2, 4, configured_micro})
        else:
            micros = [configured_micro]
        self.tunes_hier_codec = bool(_env_bool("AUTOTUNE_HIER")
                                     and self.tunes_hier)
        hcodecs = [HIER_DCN_NONE, HIER_DCN_BF16, HIER_DCN_FP16,
                   HIER_DCN_FP8] if self.tunes_hier_codec \
            else [HIER_DCN_NONE]
        # The MoE codec axis (opt-in: it narrows the expert shuffle's
        # numerics); without the opt-in it pins to the configured
        # HOROVOD_MOE_COMPRESSION.
        configured_moe = {v: k for k, v in _MOE_CODES.items()}.get(
            str(getattr(config, "moe_compression", None) or "none").lower(),
            MOE_NONE)
        self.tunes_moe = bool(_env_bool("AUTOTUNE_MOE"))
        moes = [MOE_NONE, MOE_BF16, MOE_FP16] if self.tunes_moe \
            else [configured_moe]
        self.grid = _grid(sorted(self.candidates), sorted(cycles), hiers,
                          comps, zeros, chunks, steps, micros, hcodecs,
                          moes)
        self.steps_per_sample = steps_per_sample
        self.max_samples = min(max_samples, len(self.grid))
        self.log_path = config.autotune_log
        self.warm_start_skipped = 0
        self._opt = BayesianOptimizer(
            [(float(t), c, float(h), float(k), float(z), float(ch),
              float(sp), float(mb), float(hc), float(mo))
             for t, c, h, k, z, ch, sp, mb, hc, mo in self.grid])
        self._samples: List[tuple] = []
        self._best: Optional[tuple] = None
        self._step = 0
        self._accum_s = 0.0
        self._accum_bytes = 0
        # The first recorded step of every sample is not scored: it pays
        # for the switch (the re-plan, new collective shapes).
        self._skip_next = True
        self._warm_start()
        self._idx = self._next_index()
        self._apply_to_batcher()     # the first sample, to a running one

    # -- current knobs ----------------------------------------------------
    def _current(self) -> tuple:
        return self._best or self.grid[self._idx]

    def fusion_threshold(self) -> int:
        return self._current()[0]

    def cycle_time_ms(self) -> float:
        """The native batcher's cycle time of the current sample."""
        return self._current()[1]

    def hierarchical_explicit(self) -> bool:
        """Use the two-level allreduce schedule."""
        return bool(self._current()[2])

    def hier_dcn_codec(self):
        """DCN-leg codec of the current sample (None: no per-leg codec).
        Meaningful only with the hierarchical axis on: the grid prunes
        the other combinations."""
        return self._hier_dcn_codec_of(self._current())

    @staticmethod
    def _hier_dcn_codec_of(cfg: tuple):
        code = int(cfg[8])
        if not code or not cfg[2]:
            return None
        from ..collectives.compression import Compression
        return {HIER_DCN_BF16: Compression.bf16,
                HIER_DCN_FP16: Compression.fp16,
                HIER_DCN_FP8: Compression.fp8}[code]

    def compression_override(self, configured):
        """The codec this sample picks: ``configured`` unless the opt-in
        compression axis picked another.  With the DCN-codec axis on, the
        per-leg composite: the plain codec on the node legs, the axis's
        codec across nodes (a configured per-leg codec wins).  An
        exchange asks :meth:`codec_for`, which knows what it can run."""
        return self._codec_of(self._current(), configured)

    def _codec_of(self, cfg: tuple, configured):
        from ..collectives.compression import Compression
        k = cfg[3]
        if k == COMP_BF16:
            override = Compression.bf16
        elif k == COMP_FP16:
            override = Compression.fp16
        elif k == COMP_FP8:
            override = Compression.fp8
        elif k >= COMP_CODEC_BASE:
            override = self._codec_axis[k]
        else:
            override = configured
        hc = self._hier_dcn_codec_of(cfg)
        if hc is not None:
            from ..collectives.compression import (hier_leg_compressor,
                                                   is_hier_legs)
            if is_hier_legs(override):
                return override
            ici = override if (override is not None and getattr(
                override, "wire_format", "") == "") else "none"
            return hier_leg_compressor(ici, hc)
        return override

    def codec_for(self, configured, exchange: str, *, op=None,
                  subset: bool = False, cfg: Optional[tuple] = None):
        """The codec ``exchange`` runs in this sample (or in grid member
        ``cfg``), ``configured`` being the codec it was built with -- the
        one place that knows which exchange runs which of the axis's
        codecs:

        * ``"wrap"`` (``DistributedOptimizer``, ``allreduce_gradients``):
          the sample's codec, but the configured one where fp8 meets a
          process subset, or an error-feedback codec meets a subset or
          Adasum (the JAX package's escape hatches: those exchanges serve
          whole-world Sum/Average only);
        * ``"zero"`` (ZeRO-1's allgather): the sample's codec unless it
          would switch error feedback on or off, which the state laid out
          by ``zero_init`` fixes (the JAX package's rule);
        * ``"microbatch"`` (the backward-overlap exchange): runs neither
          fp8 nor an error-feedback codec it was not built with;
        * ``"ef"`` (an error-feedback wrap, its residuals laid out for its
          codec): its configured codec only.

        Where ``"microbatch"`` or ``"ef"`` cannot run the sample's codec it
        raises ``ValueError`` rather than run another one under the
        sample's name; :meth:`check_exchange` raises it when the
        exchange is built."""
        from ..collectives.compression import is_error_feedback, is_fp8
        from ..collectives.reduce_op import Adasum
        if exchange not in ("wrap", "zero", "microbatch", "ef"):
            raise ValueError(f"unknown exchange {exchange!r}")
        cfg = self._current() if cfg is None else cfg
        override = self._codec_of(cfg, configured)
        if override is configured:
            return override
        new_fp8 = is_fp8(override) and not is_fp8(configured)
        new_ef = is_error_feedback(override) and \
            not is_error_feedback(configured)
        if exchange == "wrap":
            if (new_fp8 and subset) or \
                    (new_ef and (subset or op is Adasum)):
                return configured
            return override
        if exchange == "zero":
            if is_error_feedback(override) != is_error_feedback(configured):
                return configured
            return override
        if exchange == "microbatch" and not (new_fp8 or new_ef):
            return override
        raise ValueError(
            f"the autotuner's compression axis samples "
            f"{getattr(override, '__name__', override)}, which the "
            f"{exchange} exchange built with "
            f"{getattr(configured, '__name__', configured)} cannot run "
            f"(the microbatched exchange runs neither fp8 nor an "
            f"error-feedback codec; an error-feedback wrap's residuals "
            f"are laid out for its own codec): leave "
            f"HOROVOD_AUTOTUNE_COMPRESSION / HOROVOD_AUTOTUNE_CODEC / "
            f"HOROVOD_AUTOTUNE_HIER off for this run")

    def check_exchange(self, configured, exchange: str) -> None:
        """Raise :meth:`codec_for`'s ``ValueError`` when ``exchange``
        cannot run some grid member's codec (called as it is built)."""
        for cfg in self.grid:
            self.codec_for(configured, exchange, cfg=cfg)

    def zero_stage(self) -> int:
        """The ZeRO exchange of the current sample (0: the allreduce
        exchange, 1: reduce-scatter + allgather; ``optim/zero.py``)."""
        return int(self._current()[4])

    def exchange_chunk_bytes(self) -> int:
        """The chunked exchange's chunk of the current sample (0: one
        allreduce a bucket; ``collectives.ops.chunked_allreduce``)."""
        return int(self._current()[5])

    def steps_per_exec(self) -> int:
        """Steps per execution of the current sample, read when a loop is
        built (not a :meth:`trace_key` member)."""
        return int(self._current()[6])

    def microbatches(self) -> int:
        """Microbatch count of the current sample, read when a step is
        built (not a :meth:`trace_key` member)."""
        return int(self._current()[7])

    def moe_codec(self) -> str:
        """The MoE all_to_all wire codec of the current sample
        (``"none"``, ``"bf16"`` or ``"fp16"``; ``parallel.moe.moe_ffn``)."""
        return _MOE_CODES[int(self._current()[9])]

    def trace_key(self) -> tuple:
        """The knobs a built step applies per call (the JAX step's trace
        key): threshold, hierarchical, compression, zero, chunk, DCN-leg
        codec and MoE codec.  A changed key makes the tuned step re-plan
        its buckets and the loop capture its graph again.  Cycle time,
        steps per execution and microbatches are not members."""
        thr, _cyc, hier, comp, zero, chunk, _sp, _mb, hc, mo = \
            self._current()
        return (thr, hier, comp, zero, chunk, hc, mo)

    @property
    def done(self) -> bool:
        return self._best is not None

    # -- sampling loop ----------------------------------------------------
    def record_step(self, seconds: float, nbytes: int,
                    warmup: bool = False) -> bool:
        """Report one training step's (or loop window's) wall time and
        gradient bytes; True when it was scored.  ``warmup`` marks a call
        that pays for a switch besides the first (the loop's eager and
        capture windows): it is not scored, and it stands in for the
        sample's skipped first step."""
        if self._best is not None:
            return False
        if warmup or self._skip_next:
            self._skip_next = False
            return False
        self._accum_s += seconds
        self._accum_bytes += nbytes
        self._step += 1
        if self._step < self.steps_per_sample:
            return True
        score = self._accum_bytes / max(self._accum_s, 1e-9)  # bytes/s
        self._opt.observe(self._idx, score)
        self._samples.append(self.grid[self._idx] + (score,))
        from ..timeline import metrics as _metrics
        reg = _metrics.registry()
        reg.counter("horovod_autotune_samples_total",
                    "Autotuner samples scored (one per sample window)"
                    ).inc()
        reg.gauge("horovod_autotune_score_bytes_per_second",
                  "Most recent autotuner sample score").set(score)
        self._step = 0
        self._accum_s = 0.0
        self._accum_bytes = 0
        self._idx = self._next_index()
        self._skip_next = True
        self._apply_to_batcher()
        return True

    def _next_index(self) -> int:
        """The next configuration (rank 0 decides; the others follow)."""
        if self._opt.n_observed >= self.max_samples:
            self._finish()
            return self._opt.best_index or 0
        nxt = self._sync(self._opt.suggest())
        if nxt is None:
            self._finish()
            return self._opt.best_index or 0
        return nxt

    def _sync(self, value):
        """Rank 0's ``value`` on every rank when the world has more than
        one: per-rank scores differ, and diverging thresholds would cut
        mismatched buckets."""
        from ..core.state import global_state
        st = global_state()
        if not st.initialized or st.size == 1:
            return value
        from ..optim.functions import broadcast_object
        return broadcast_object(value, root_rank=0)

    def _finish(self) -> None:
        if self._best is not None:
            return
        best = self._sync(self._opt.best_index)
        self._best = self.grid[best if best is not None else 0]
        self._write_log()
        self._apply_to_batcher()

    def _apply_to_batcher(self) -> None:
        """Push the current fusion threshold, and the cycle time while its
        axis is open, into the running native batcher (the
        ParameterManager owning the C++ knobs); nothing without one."""
        from ..collectives import batching
        b = batching.current()
        if b is not None:
            b.update_tuning(self.cycle_time_ms() if self.tunes_cycle
                            else -1.0, self.fusion_threshold())

    # -- warm start / log -------------------------------------------------
    def _warm_start(self) -> None:
        """Seed the optimizer from the previous run's log.  Rank 0 reads
        it and broadcasts the observations, so a log on rank 0's
        filesystem alone cannot desync the schedule."""
        from ..core.state import global_state
        obs: List[tuple] = []
        skipped = 0
        if self.log_path and os.path.exists(self.log_path) and \
                global_state().rank == 0:
            with open(self.log_path) as f:
                lines = list(f)
            for line in lines:
                if line.startswith(("fusion", "#")) or not line.strip():
                    continue
                parts = line.strip().split(",")
                # A malformed row is skipped, counted and warned about
                # once: a half-written row must not lose the warm start.
                try:
                    cfg = _row_config(parts)
                    if cfg is None:         # unknown column count
                        skipped += 1
                        continue
                    score = float(parts[-1])
                except ValueError:          # non-numeric cell
                    skipped += 1
                    continue
                if not np.isfinite(score):
                    # A NaN/inf score would poison the GP posterior.
                    skipped += 1
                    continue
                if cfg in self.grid:
                    obs.append((self.grid.index(cfg), score))
        if skipped:
            import warnings
            warnings.warn(
                f"autotune warm start: skipped {skipped} unusable row(s) "
                f"in {self.log_path} (unknown column count or NaN/inf "
                "score)", RuntimeWarning, stacklevel=2)
        self.warm_start_skipped = skipped
        obs = self._sync(obs)
        for idx, score in obs:
            self._opt.observe(idx, score)
            # Warm rows stay in _samples, so the log keeps them.
            self._samples.append(self.grid[idx] + (score,))

    def _write_log(self) -> None:
        if not self.log_path:
            return
        with open(self.log_path, "w") as f:
            f.write("fusion_threshold_bytes,cycle_time_ms,hierarchical,"
                    "compression,zero,exchange_chunk_bytes,steps_per_exec,"
                    "microbatches,hier_dcn_codec,moe_codec,"
                    "score_bytes_per_s\n")
            for thr, cyc, hier, comp, zero, chunk, sp, mb, hc, mo, score \
                    in self._samples:
                f.write(f"{thr},{cyc},{hier},{comp},{zero},{chunk},{sp},"
                        f"{mb},{hc},{mo},{score}\n")
            f.write("# best," + ",".join(str(v) for v in self._best) + "\n")


def _row_config(parts: List[str]) -> Optional[tuple]:
    """A log row's configuration, from every historical column count (3:
    threshold and cycle; 5: + hierarchical and compression; 6: + zero;
    8: + chunk and steps; 9, 10, 11: + microbatches, DCN codec, MoE
    codec; the score is the last column).  None for another count.
    Axes a format lacks load as their defaults: 0, but steps and
    microbatches 1."""
    n = len(parts)
    if n not in (3, 5, 6, 8, 9, 10, 11):
        return None

    def col(i: int, default: int) -> int:
        return int(float(parts[i])) if i < n - 1 else default

    return (int(float(parts[0])), float(parts[1]),
            col(2, 0), col(3, COMP_DEFAULT), col(4, 0), col(5, 0),
            col(6, 1), col(7, 1), col(8, 0), col(9, 0))
