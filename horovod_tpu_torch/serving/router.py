"""Fleet router: prefix-affinity + least-loaded dispatch across engines.

Counterpart of ``horovod_tpu/serving/router.py``, decision for decision.

A disaggregated fleet runs several decode engines behind one front
door.  The router decides which engine's scheduler a request joins,
reading only live gauges (queue depth + active slots vs capacity --
the same numbers the ``horovod_serving_*`` families export), so the
decision needs no side channel into engine internals.

Dispatch precedence:

1. ``engine_hint`` on the request (loadgen's per-engine arrival skew,
   or a session pinned by an external LB) -- honored verbatim while
   that engine is registered.
2. Prefix affinity (``HOROVOD_FLEET_AFFINITY``, default on): requests
   whose prompts share a head hash to the same engine, so the
   radix prefix cache sees repeat prefixes instead of having them
   sprayed across pools.  The hash is CRC32 over the first
   ``affinity_tokens`` prompt tokens -- cheap, stable across runs, and
   deliberately coarser than the radix tree (the tree disambiguates
   once the request lands).
3. Overload spill: when the affinity target's load score exceeds
   ``spill_factor``x the fleet minimum, locality loses to the queue --
   the request spills to the least-loaded engine.
4. Least-loaded (no affinity, or affinity disabled): lowest
   ``(queued + active) / slots``, registration order breaking ties so
   dispatch is deterministic.

Every decision increments ``horovod_fleet_dispatch_total{engine,
reason}``; ``horovod_fleet_engines`` gauges the live registry so the
grow-under-traffic drill shows capacity arriving.
"""

from __future__ import annotations

import collections
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.config import _env_bool
from ..timeline.metrics import registry as _registry
from .scheduler import ContinuousBatchScheduler, Request


class FleetRouter:
    """Routes requests to named engine schedulers off live load gauges."""

    def __init__(self, *, affinity: Optional[bool] = None,
                 affinity_tokens: int = 16,
                 spill_factor: float = 2.0) -> None:
        self.affinity = (_env_bool("FLEET_AFFINITY", True)
                         if affinity is None else bool(affinity))
        self.affinity_tokens = int(affinity_tokens)
        self.spill_factor = float(spill_factor)
        # name -> scheduler; insertion order is registration order and
        # the deterministic tie-break.
        self.engines: "collections.OrderedDict[str, ContinuousBatchScheduler]" = \
            collections.OrderedDict()
        reg = _registry()
        self._m_dispatch = reg.counter(
            "horovod_fleet_dispatch_total",
            "Fleet router dispatch decisions",
            labelnames=("engine", "reason"))
        self._m_engines = reg.gauge(
            "horovod_fleet_engines",
            "Decode engines currently registered with the fleet router")

    # -- registry ----------------------------------------------------------
    def register(self, name: str, sched: ContinuousBatchScheduler) -> None:
        self.engines[name] = sched
        self._m_engines.set(len(self.engines))

    def deregister(self, name: str) -> None:
        self.engines.pop(name, None)
        self._m_engines.set(len(self.engines))

    # -- load --------------------------------------------------------------
    def load_score(self, name: str) -> float:
        """Outstanding work per slot: ``(queued + active) / slots``.
        >1 means a backlog beyond what the decode batch can hold."""
        s = self.engines[name]
        return (len(s.queue) + len(s.active)) / max(s.slots, 1)

    def _least_loaded(self) -> str:
        return min(self.engines, key=lambda n: (self.load_score(n),
                                                self._order(n)))

    def _order(self, name: str) -> int:
        return list(self.engines).index(name)

    def prefix_key(self, prompt: Sequence[int]) -> int:
        head = np.asarray(list(prompt)[:self.affinity_tokens], np.int32)
        return zlib.crc32(head.tobytes())

    # -- dispatch ----------------------------------------------------------
    def route(self, req: Request) -> Tuple[str, str]:
        """Pick an engine for ``req``; returns ``(engine, reason)`` with
        reason one of ``hint | affinity | spill | least-loaded``."""
        if not self.engines:
            raise RuntimeError("fleet router has no registered engines")
        names = list(self.engines)
        hint = getattr(req, "engine_hint", None)
        if hint is not None and 0 <= int(hint) < len(names):
            choice, reason = names[int(hint)], "hint"
        elif self.affinity:
            target = names[self.prefix_key(req.prompt) % len(names)]
            floor = min(self.load_score(n) for n in names)
            if self.load_score(target) > self.spill_factor * max(floor,
                                                                 1e-9) \
                    and self.load_score(target) > 0:
                choice, reason = self._least_loaded(), "spill"
            else:
                choice, reason = target, "affinity"
        else:
            choice, reason = self._least_loaded(), "least-loaded"
        self._m_dispatch.labels(engine=choice, reason=reason).inc()
        return choice, reason

    def snapshot(self) -> Dict[str, float]:
        """Live load score per engine (router's own decision inputs)."""
        return {n: self.load_score(n) for n in self.engines}
