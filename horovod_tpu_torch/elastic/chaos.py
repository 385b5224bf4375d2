"""Seeded, deterministic fault injection for elastic training.

The port's copy of ``horovod_tpu/elastic/chaos.py``: the same grammar, the
same seeded victims, the same latches.  Two differences: the chaos clock
ticks at the START of ``State.commit()`` (before the snapshot), so a
``comm`` fault at commit ``k`` rolls back to commit ``k - 1`` and the
drill replays the steps between; and consuming a ``bitflip`` raises
``NotImplementedError`` -- flipping a replica's bit is
``core/desync.corrupt_replica``, part of the silent-data-corruption plane
that is not ported (ROADMAP item 1.11).

``HOROVOD_CHAOS=<spec>`` arms a process-local injector that fires faults
at commit boundaries (every ``State.commit()`` advances the chaos step
counter) so the same spec reproduces the same failure on every run.  The
spec is ``;``-separated clauses::

    HOROVOD_CHAOS="seed=42;kill@step=5,rank=1;kv_blackout@step=3,secs=2"

Each fault clause is ``<kind>@step=<k>[,rank=<r>|rank=any][,secs=<t>]
[,at=sync]`` and fires exactly once.  Kinds:

- ``kill``: the target rank exits hard (``os._exit(137)``) -- a lost
  worker, the driver notices via heartbeat loss and republishes.
- ``sigterm``: latches the preemption notice
  (:func:`horovod_tpu.elastic.preemption.trigger`) as if the cloud sent
  a termination warning.
- ``comm``: raises :class:`ChaosCommError` (a ``ConnectionError``, so it
  passes ``run_loop._comm_error_types()`` and the message-needle gate of
  ``_looks_like_comm_failure``).  With ``at=sync`` the error is armed
  instead and raised from the next eager ``synchronize``/``barrier``
  (see :func:`raise_if_armed`), modeling a wedged collective.
- ``kv_blackout``: for ``secs`` seconds every KV request fails
  client-side (``http_kv.KVClient`` checks
  :func:`kv_blackout_active`), exercising the retry policy.
- ``hb_drop``: for ``secs`` seconds heartbeat writes are suppressed
  (``core/stall.py`` writers check :func:`heartbeat_drop_active`),
  exercising driver-side staleness handling.
- ``slow``: the target rank's host thread sleeps ``secs`` at the step
  boundary -- a deterministic straggler.
- ``nan``: latches a one-shot input-poisoning notice; the training
  driver consumes it via :func:`consume_nan_poison` /
  :func:`poison_batch` and NaNs one element of the next batch.  The
  in-step SDC guard (``HOROVOD_GUARD``) must detect and skip that step.
- ``bitflip``: latches a one-shot replica-corruption notice carrying
  the victim rank; the driver consumes it via :func:`consume_bitflip`
  (which raises here: the flip and the cross-rank tripwire that catches
  it are the silent-data-corruption plane, not ported).

``rank=any`` picks a victim with the seeded RNG -- identical on every
process because the choice depends only on (seed, fault index, size).
``secs=`` is accepted only on the duration kinds (``kv_blackout``,
``hb_drop``, ``slow``); the others reject it instead of silently
dropping it.  ``nan``/``bitflip`` clauses fire on EVERY process at the
given step (the latch records the victim rank) because the victim's
host may not be the process that owns the injection point.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import logging

logger = logging.getLogger("horovod_tpu_torch.elastic")

_ENV = "HOROVOD_CHAOS"
_ENV_ALT = "HVD_TPU_CHAOS"

_KINDS = ("kill", "sigterm", "comm", "kv_blackout", "hb_drop", "slow",
          "bitflip", "nan")
# Kinds with a duration; only these accept a secs= field.
_DURATION_KINDS = ("kv_blackout", "hb_drop", "slow")
# Corruption kinds fire on every process (the latch carries the victim).
_CORRUPTION_KINDS = ("bitflip", "nan")


class ChaosSpecError(ValueError):
    """Malformed HOROVOD_CHAOS specification."""


class ChaosCommError(ConnectionError):
    """Injected communication failure.

    Subclasses ``ConnectionError`` so it is already in
    ``run_loop._comm_error_types()``; the message carries the
    ``UNAVAILABLE``/``connection`` needles the classifier looks for, plus
    an explicit ``chaos`` marker.
    """


@dataclass
class ChaosFault:
    kind: str
    step: int
    rank: Optional[int]  # None == any (resolved at install time)
    secs: float = 5.0
    at_sync: bool = False
    fired: bool = False


def parse_spec(spec: str) -> (int, List[ChaosFault]):
    """``spec`` -> (seed, faults).  Raises :class:`ChaosSpecError`."""
    seed = 0
    faults: List[ChaosFault] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            try:
                seed = int(clause[5:])
            except ValueError:
                raise ChaosSpecError(f"bad seed clause {clause!r}")
            continue
        if "@" not in clause:
            raise ChaosSpecError(
                f"bad chaos clause {clause!r}: expected "
                f"<kind>@step=<k>[,rank=<r>|rank=any][,secs=<t>][,at=sync] "
                f"with kind in {_KINDS} (secs= only on {_DURATION_KINDS})")
        kind, _, rest = clause.partition("@")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ChaosSpecError(
                f"unknown chaos kind {kind!r}; choose from {_KINDS}")
        step = None
        rank: Optional[int] = None
        secs = 5.0
        at_sync = False
        for field in rest.split(","):
            field = field.strip()
            if not field:
                continue
            key, _, val = field.partition("=")
            key, val = key.strip(), val.strip()
            if key == "step":
                step = int(val)
            elif key == "rank":
                rank = None if val == "any" else int(val)
            elif key == "secs":
                if kind not in _DURATION_KINDS:
                    raise ChaosSpecError(
                        f"secs= does not apply to {kind!r} faults "
                        f"(duration kinds: {_DURATION_KINDS}); rejecting "
                        f"{clause!r} instead of silently dropping it")
                secs = float(val)
            elif key == "at":
                if val != "sync":
                    raise ChaosSpecError(
                        f"bad at= value {val!r} in {clause!r} "
                        "(only at=sync is supported)")
                at_sync = True
            else:
                raise ChaosSpecError(
                    f"unknown field {key!r} in chaos clause {clause!r}")
        if step is None:
            raise ChaosSpecError(f"chaos clause {clause!r} missing step=")
        if at_sync and kind != "comm":
            raise ChaosSpecError("at=sync only applies to comm faults")
        faults.append(ChaosFault(kind=kind, step=step, rank=rank,
                                 secs=secs, at_sync=at_sync))
    return seed, faults


class ChaosInjector:
    """Deterministic per-process fault schedule."""

    def __init__(self, spec: str, rank: int = 0, size: int = 1):
        self.spec = spec
        self.rank = int(rank)
        self.size = max(1, int(size))
        self.seed, self.faults = parse_spec(spec)
        # Resolve rank=any with the seeded RNG: depends only on
        # (seed, fault index, size), so every process agrees on the
        # victim without any communication.
        for i, f in enumerate(self.faults):
            if f.rank is None:
                rng = random.Random(self.seed * 1000003 + i)
                f.rank = rng.randrange(self.size)
        self.step = 0
        self.fired_kinds: List[str] = []

    def _fire(self, f: ChaosFault) -> None:
        f.fired = True
        self.fired_kinds.append(f.kind)
        logger.warning("chaos: firing %s at step %d (rank %d/%d)",
                       f.kind, self.step, self.rank, self.size)
        try:
            from ..timeline import metrics as _metrics
            _metrics.registry().counter(
                "horovod_chaos_faults_total",
                "Faults fired by the chaos injector").inc()
        except Exception:
            pass
        if f.kind == "kill":
            logger.warning("chaos: killing rank %d (os._exit(137))",
                           self.rank)
            os._exit(137)
        elif f.kind == "sigterm":
            from . import preemption
            preemption.trigger(
                f"chaos: injected preemption notice at step {self.step}")
        elif f.kind == "comm":
            err = ChaosCommError(
                f"UNAVAILABLE: chaos injected comm failure at step "
                f"{self.step} (rank {self.rank}): connection reset by "
                f"peer")
            if f.at_sync:
                _arm(err)
            else:
                raise err
        elif f.kind == "kv_blackout":
            _set_kv_blackout(f.secs)
        elif f.kind == "hb_drop":
            _set_hb_drop(f.secs)
        elif f.kind == "slow":
            # Deterministic straggler: stall THIS rank's host thread for
            # secs at the step boundary.
            logger.warning("chaos: slowing rank %d by %.3fs at step %d",
                           self.rank, f.secs, self.step)
            time.sleep(max(0.0, f.secs))
        elif f.kind == "nan":
            _set_nan_poison(f.rank if f.rank is not None else 0)
        elif f.kind == "bitflip":
            _set_bitflip(f.rank if f.rank is not None else 0)

    def on_step(self, step: Optional[int] = None) -> None:
        """Advance the chaos clock and fire any due faults.

        Without an explicit ``step`` the injector's own monotone commit
        counter is used (replayed commits after a rollback count as new
        chaos steps; the once-only latch keeps faults from re-firing).
        Corruption kinds (``bitflip``/``nan``) fire on every process --
        the victim rank rides in the latch, not in the firing condition.
        """
        if step is None:
            self.step += 1
            step = self.step
        else:
            self.step = int(step)
        for f in self.faults:
            if not f.fired and f.step == self.step and (
                    f.rank == self.rank
                    or f.kind in _CORRUPTION_KINDS):
                self._fire(f)


# --- module singleton + latches ------------------------------------------

_lock = threading.Lock()
_injector: Optional[ChaosInjector] = None
_env_checked = False
_kv_blackout_until = 0.0
_hb_drop_until = 0.0
_armed_comm_error: Optional[ChaosCommError] = None
# One-shot corruption latches: the pending victim rank, or None.
_nan_poison_pending: Optional[int] = None
_bitflip_pending: Optional[int] = None


def _set_kv_blackout(secs: float) -> None:
    global _kv_blackout_until
    _kv_blackout_until = time.monotonic() + max(0.0, secs)


def _set_nan_poison(rank: int) -> None:
    global _nan_poison_pending
    _nan_poison_pending = int(rank)


def _set_bitflip(rank: int) -> None:
    global _bitflip_pending
    _bitflip_pending = int(rank)


def consume_nan_poison() -> Optional[int]:
    """One-shot: the pending ``nan`` victim rank, or None.

    The training driver calls this before each dispatch and poisons the
    next batch (:func:`poison_batch`) when it returns a rank."""
    global _nan_poison_pending
    rank, _nan_poison_pending = _nan_poison_pending, None
    return rank


def consume_bitflip() -> Optional[int]:
    """One-shot: None when no ``bitflip`` is pending.  A pending one is
    dropped and raises ``NotImplementedError``: its consumer flips a bit
    of the victim's parameter replica (``core/desync.corrupt_replica``),
    part of the silent-data-corruption plane, which is not ported
    (ROADMAP item 1.11)."""
    global _bitflip_pending
    rank, _bitflip_pending = _bitflip_pending, None
    if rank is not None:
        raise NotImplementedError(
            f"chaos bitflip (victim rank {rank}) needs "
            f"core/desync.corrupt_replica, part of the silent-data-"
            f"corruption plane, which is not ported (ROADMAP item 1.11)")
    return rank


def _leaves_in_order(tree, out):
    """Leaves of nested tuples, lists and dicts in ``jax.tree.leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves_in_order(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _leaves_in_order(x, out)
    else:
        out.append(tree)
    return out


def poison_batch(batch):
    """NaN one element of the first floating tensor of ``batch`` (nested
    tuples, lists and dicts, walked in ``jax.tree.leaves`` order), in a
    copy: the poisoned value flows into the next step exactly like a
    corrupt input shard would.  The input is left as it is."""
    import torch

    from ..data.tree import tree_map

    victim = None
    for leaf in _leaves_in_order(batch, []):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and t.numel():
            victim = leaf
            break
    if victim is None:
        raise ValueError("poison_batch: no floating leaf to poison")

    def poison(x):
        if x is not victim:
            return x
        out = torch.as_tensor(x).clone()
        out.view(-1)[0] = float("nan")
        return out

    return tree_map(poison, batch)


def _set_hb_drop(secs: float) -> None:
    global _hb_drop_until
    _hb_drop_until = time.monotonic() + max(0.0, secs)


def _arm(err: ChaosCommError) -> None:
    global _armed_comm_error
    _armed_comm_error = err


def kv_blackout_active() -> bool:
    """True while an injected KV blackout window is open."""
    return time.monotonic() < _kv_blackout_until


def heartbeat_drop_active() -> bool:
    """True while heartbeat writes should be suppressed."""
    return time.monotonic() < _hb_drop_until


def raise_if_armed() -> None:
    """Raise a pending ``at=sync`` comm fault (called from the eager
    synchronize/barrier path); one-shot."""
    global _armed_comm_error
    if _armed_comm_error is not None:
        err, _armed_comm_error = _armed_comm_error, None
        raise err


def install(spec: str, rank: int = 0, size: int = 1) -> ChaosInjector:
    """Install (or replace) the process-wide injector for ``spec``."""
    global _injector, _env_checked
    with _lock:
        inj = ChaosInjector(spec, rank=rank, size=size)
        _injector = inj
        _env_checked = True
        logger.info("chaos: installed injector (seed=%d, %d fault(s), "
                    "rank=%d/%d)", inj.seed, len(inj.faults), rank, size)
        return inj


def maybe_install(rank: int = 0, size: int = 1) -> Optional[ChaosInjector]:
    """Install from ``HOROVOD_CHAOS``/``HVD_TPU_CHAOS`` if set.

    Idempotent across re-inits: an injector installed earlier in this
    process survives (its fired-once latches must persist through
    elastic recovery so a fault does not re-fire after the reset).
    """
    global _env_checked
    with _lock:
        if _injector is not None or _env_checked:
            return _injector
        _env_checked = True
    spec = os.environ.get(_ENV_ALT) or os.environ.get(_ENV)
    if not spec:
        return None
    return install(spec, rank=rank, size=size)


def injector() -> Optional[ChaosInjector]:
    return _injector


def corruption_armed() -> bool:
    """Does the installed spec include a corruption kind (bitflip/nan)?
    (The JAX package's SDC guard keys its ``auto`` mode on this.)"""
    return _injector is not None and any(
        f.kind in _CORRUPTION_KINDS for f in _injector.faults)


def on_commit() -> None:
    """Commit-boundary hook: advance the injector clock if installed."""
    if _injector is not None:
        _injector.on_step()


def reset() -> None:
    """Drop the injector and clear every latch (tests only)."""
    global _injector, _env_checked, _kv_blackout_until, _hb_drop_until
    global _armed_comm_error, _nan_poison_pending, _bitflip_pending
    with _lock:
        _injector = None
        _env_checked = False
        _kv_blackout_until = 0.0
        _hb_drop_until = 0.0
        _armed_comm_error = None
        _nan_poison_pending = None
        _bitflip_pending = None
