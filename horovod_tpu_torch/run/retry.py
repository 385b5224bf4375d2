"""Unified transport retry policy for the rendezvous/control plane.

The port's copy of ``horovod_tpu/run/retry.py``: the same knobs, the same
schedule, the same ``horovod_kv_retries_total`` counter.

One policy object governs every HTTP KV interaction (``run/http_kv.py``),
driver heartbeat writes, and assignment reads in ``elastic/notify.py``:
exponential backoff with full jitter and a bounded retry budget, tuned by
``HOROVOD_KV_RETRIES`` (extra attempts after the first, default 3) and
``HOROVOD_KV_BACKOFF_MS`` (initial delay, default 50ms).

Reference: ``horovod/runner/http/http_client.py`` retries PUT/GET against
the Gloo rendezvous server a fixed number of times with a flat sleep; the
TPU-native plane upgrades that to capped exponential backoff + jitter so a
driver restart (seconds) is survived without hammering the KV endpoint,
while a wrong secret (``RendezvousAuthError``) still fails on the first
attempt -- auth failures are configuration bugs and are never retried.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..core.config import _env_float, _env_int

import logging

logger = logging.getLogger("horovod_tpu_torch.run")

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter.

    ``retries`` is the budget of *additional* attempts after the first
    (``retries=0`` disables retrying entirely); attempt ``i`` sleeps
    ``min(backoff_ms * multiplier**i, max_backoff_ms)`` scaled by a
    uniform jitter factor in ``[1 - jitter, 1]``.
    """

    retries: int = 3
    backoff_ms: float = 50.0
    multiplier: float = 2.0
    max_backoff_ms: float = 2000.0
    jitter: float = 0.5
    # Total backoff-sleep budget in seconds across ALL attempts of one
    # call (None = unbounded, the pre-PR-20 behavior).  Bulk transfers
    # -- a multi-MiB KV-page stream is many chunked PUTs, each with its
    # own retry loop -- use this to cap worst-case stall per chunk so a
    # dead peer fails the handoff in bounded time instead of
    # retries * max_backoff per chunk.
    budget_s: Optional[float] = None

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(retries=_env_int("KV_RETRIES", 3),
                   backoff_ms=_env_float("KV_BACKOFF_MS", 50.0))

    def delay_s(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        base = min(self.backoff_ms * (self.multiplier ** attempt),
                   self.max_backoff_ms) / 1000.0
        r = rng.random() if rng is not None else random.random()
        return base * (1.0 - self.jitter * r)


def call_with_retries(fn: Callable[[], T], *,
                      policy: Optional[RetryPolicy] = None,
                      retry_on: Tuple[Type[BaseException], ...] = (
                          ConnectionError,),
                      no_retry: Tuple[Type[BaseException], ...] = (),
                      describe: str = "",
                      sleep: Callable[[float], None] = time.sleep,
                      rng: Optional[random.Random] = None) -> T:
    """Run ``fn`` under ``policy``, retrying only ``retry_on`` failures.

    ``no_retry`` wins over ``retry_on`` (e.g. an auth error that happens
    to subclass a retryable type).  ``sleep`` and ``rng`` are injectable
    so tests stay instant and deterministic.
    """
    if policy is None:
        policy = RetryPolicy.from_env()
    attempt = 0
    slept = 0.0
    while True:
        try:
            return fn()
        except no_retry:
            raise
        except retry_on as e:
            if attempt >= policy.retries:
                raise
            delay = policy.delay_s(attempt, rng)
            if policy.budget_s is not None \
                    and slept + delay > policy.budget_s:
                # The next backoff would blow the per-call stall budget:
                # fail NOW with the underlying error so bulk callers
                # (chunked KV streams) see a bounded worst case.
                raise
            slept += delay
            logger.debug("retry %d/%d for %s after %s: %.3fs backoff",
                         attempt + 1, policy.retries, describe or "call",
                         e, delay)
            try:
                from ..timeline import metrics as _metrics
                _metrics.registry().counter(
                    "horovod_kv_retries_total",
                    "Control-plane requests retried after a transport "
                    "failure").inc()
            except Exception:
                pass
            sleep(delay)
            attempt += 1
