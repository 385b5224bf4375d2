"""Synthetic open-loop load generator.

Counterpart of ``horovod_tpu/serving/loadgen.py``; pure numpy, ported as
is.  Arrivals are scheduled by a Poisson process BEFORE service starts
and do not slow down when the engine falls behind (no coordinated
omission).  One seeded ``numpy.random.RandomState`` drives everything,
in the reference's fixed draw order, so the same :class:`LoadSpec`
yields byte-identical request streams in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import Request


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Shape of the synthetic workload."""

    num_requests: int = 32
    rate_rps: float = 8.0                      # mean Poisson arrival rate
    prompt_lens: Tuple[int, ...] = (8, 16, 32)
    prompt_weights: Optional[Tuple[float, ...]] = None   # uniform if None
    output_lens: Tuple[int, ...] = (8, 16)
    output_weights: Optional[Tuple[float, ...]] = None
    vocab_size: int = 256
    num_adapters: int = 0                      # 0: base model only
    seed: int = 0
    # Prefix-shared traffic (0.0 disables; the stream is then
    # unchanged byte for byte): a shared request's prompt = one of
    # ``num_prefixes`` fixed prefixes (length from ``prefix_lens``)
    # ++ a unique tail of ``prompt_lens`` tokens.
    prefix_share: float = 0.0
    num_prefixes: int = 1
    prefix_lens: Tuple[int, ...] = (64,)
    # Multi-turn sessions: ``session_share`` of non-continuation
    # requests open a session; later requests continue the oldest open
    # session (prompt = previous turn's prompt ++ fresh delta) until it
    # reaches ``session_turns`` turns.
    session_share: float = 0.0
    session_turns: int = 1
    # Tenant mix: ``((name, arrival_weight), ...)``; empty = everyone
    # is the single implicit "default" tenant.
    tenants: Tuple[Tuple[str, float], ...] = ()
    # Fleet traffic shapes (0/empty disables; the stream is then
    # byte-identical to one without them):
    # * rate doubling -- arrivals at/after this offset come twice as
    #   fast (each post-boundary gap is halved AFTER the draw, so the
    #   underlying exponential stream is untouched), the step-function
    #   surge the fleet scaler must absorb;
    # * per-engine arrival skew -- each request draws an
    #   ``engine_hint`` from these weights (one per engine), modeling
    #   an external LB that sprays engines unevenly.  The router
    #   honors hints verbatim, so skew stresses spill/migration.
    rate_double_at_s: float = 0.0
    engine_skew: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        for name, lens, weights in (
                ("prompt", self.prompt_lens, self.prompt_weights),
                ("output", self.output_lens, self.output_weights)):
            if not lens or any(x < 1 for x in lens):
                raise ValueError(f"{name}_lens must be positive: {lens}")
            if weights is not None and len(weights) != len(lens):
                raise ValueError(
                    f"{name}_weights length {len(weights)} != "
                    f"{len(lens)} choices")
        if not 0.0 <= self.prefix_share <= 1.0:
            raise ValueError(
                f"prefix_share must be in [0, 1]: {self.prefix_share}")
        if not 0.0 <= self.session_share <= 1.0:
            raise ValueError(
                f"session_share must be in [0, 1]: {self.session_share}")
        if self.prefix_share > 0 and (
                self.num_prefixes < 1 or not self.prefix_lens
                or any(x < 1 for x in self.prefix_lens)):
            raise ValueError(
                "prefix_share > 0 needs num_prefixes >= 1 and positive "
                "prefix_lens")
        if self.session_turns < 1:
            raise ValueError("session_turns must be >= 1")
        for t in self.tenants:
            if len(t) != 2 or not t[0] or float(t[1]) <= 0:
                raise ValueError(
                    f"tenants entries are (name, weight > 0): {t}")
        if self.rate_double_at_s < 0:
            raise ValueError(
                f"rate_double_at_s must be >= 0: {self.rate_double_at_s}")
        if self.engine_skew and any(
                float(w) < 0 for w in self.engine_skew):
            raise ValueError(
                f"engine_skew weights must be >= 0: {self.engine_skew}")
        if self.engine_skew and sum(self.engine_skew) <= 0:
            raise ValueError("engine_skew must have positive mass")


def _norm(weights: Optional[Sequence[float]], n: int):
    if weights is None:
        return None
    w = np.asarray(weights, np.float64)
    return w / w.sum()


def long_prompt_spec(**overrides) -> LoadSpec:
    """The kilotoken-prompt mixture the chunked-prefill TTFT gate runs:
    512/2048/4096-token prompts weighted toward the long tail (the 4k
    bucket is the TTFT p99 tail)."""
    base = dict(num_requests=16, rate_rps=2.0,
                prompt_lens=(512, 2048, 4096),
                prompt_weights=(0.5, 0.25, 0.25),
                output_lens=(8, 16), seed=0)
    base.update(overrides)
    return LoadSpec(**base)


def prefix_spec(**overrides) -> LoadSpec:
    """The prefix-shared mixture: >= 50% of requests share
    one of a handful of fixed 64-token system prefixes, a quarter open
    two-turn sessions, and arrivals split across a gold/bronze tenant
    mix -- the workload where the radix prefix cache's avoided-prefill
    win is measurable."""
    base = dict(num_requests=40, rate_rps=30.0,
                prompt_lens=(8, 16), output_lens=(8, 16),
                prefix_share=0.6, num_prefixes=4, prefix_lens=(64,),
                session_share=0.25, session_turns=2,
                tenants=(("gold", 4.0), ("bronze", 1.0)), seed=0)
    base.update(overrides)
    return LoadSpec(**base)


def fleet_spec(**overrides) -> LoadSpec:
    """The fleet chaos mixture: prefix-shared traffic that
    DOUBLES its arrival rate partway through the run while an external
    LB skews arrivals 3:1 toward engine 0 -- the surge + imbalance the
    fleet router's spill path and the scaler's grow-under-traffic path
    must absorb together."""
    base = dict(num_requests=48, rate_rps=30.0,
                prompt_lens=(8, 16), output_lens=(8, 16),
                prefix_share=0.5, num_prefixes=4, prefix_lens=(64,),
                rate_double_at_s=0.8, engine_skew=(3.0, 1.0), seed=0)
    base.update(overrides)
    return LoadSpec(**base)


def generate(spec: LoadSpec) -> List[Request]:
    """Materialize the request stream for ``spec`` (sorted by arrival).

    Determinism contract: one RandomState, draws in a FIXED order per
    request, and each optional shape draws only when enabled -- identical
    specs yield byte-identical streams, and all-defaults specs yield the
    exact streams of the plain generator.
    """
    rng = np.random.RandomState(spec.seed)
    pw = _norm(spec.prompt_weights, len(spec.prompt_lens))
    ow = _norm(spec.output_weights, len(spec.output_lens))
    tenant_names = [str(t[0]) for t in spec.tenants]
    tw = _norm([float(t[1]) for t in spec.tenants],
               len(spec.tenants)) if spec.tenants else None
    prefixes: List[np.ndarray] = []
    if spec.prefix_share > 0:
        for i in range(spec.num_prefixes):
            plen = int(spec.prefix_lens[i % len(spec.prefix_lens)])
            prefixes.append(rng.randint(
                0, spec.vocab_size, size=plen).astype(np.int32))
    sessions_on = spec.session_share > 0 and spec.session_turns > 1
    skw = _norm(spec.engine_skew, len(spec.engine_skew)) \
        if spec.engine_skew else None
    open_sessions: List[dict] = []   # FIFO of {sid, ctx, turns}
    next_sid = 0
    out: List[Request] = []
    t = 0.0
    for rid in range(spec.num_requests):
        # Poisson process: exponential inter-arrival gaps.  The rate
        # doubling halves the gap AFTER the draw, so the exponential
        # stream (and every later draw) is byte-identical to the
        # undoubled spec's.
        gap = float(rng.exponential(1.0 / spec.rate_rps))
        if spec.rate_double_at_s > 0 and t >= spec.rate_double_at_s:
            gap *= 0.5
        t += gap
        tenant = "default"
        if tenant_names:
            tenant = tenant_names[int(rng.choice(len(tenant_names),
                                                 p=tw))]
        cont = None
        if sessions_on and open_sessions and rng.rand() < 0.5:
            cont = open_sessions.pop(0)
        base = None
        if cont is None and prefixes and rng.rand() < spec.prefix_share:
            base = prefixes[int(rng.randint(len(prefixes)))]
        # Legacy draw order from here (gap happened above): prompt
        # length, output length, prompt tokens -- all-defaults specs
        # reproduce the plain streams byte for byte.
        plen = int(rng.choice(spec.prompt_lens, p=pw))
        olen = int(rng.choice(spec.output_lens, p=ow))
        tail = rng.randint(0, spec.vocab_size,
                           size=plen).astype(np.int32)
        sid: Optional[int] = None
        if cont is not None:
            # Session continuation: the previous turn's prompt plus a
            # fresh delta -- the stored context radix-matches whole.
            prompt = np.concatenate([cont["ctx"], tail])
            sid = cont["sid"]
            cont["turns"] += 1
            cont["ctx"] = prompt
            if cont["turns"] < spec.session_turns:
                open_sessions.append(cont)
        else:
            prompt = tail if base is None \
                else np.concatenate([base, tail])
            if sessions_on and rng.rand() < spec.session_share:
                sid = next_sid
                next_sid += 1
                open_sessions.append(
                    {"sid": sid, "ctx": prompt, "turns": 1})
        adapter = rid % spec.num_adapters if spec.num_adapters else 0
        # Engine skew draws LAST, so skew-free specs never touch the
        # stream (defaults stay byte-identical).
        hint: Optional[int] = None
        if skw is not None:
            hint = int(rng.choice(len(skw), p=skw))
        out.append(Request(rid=rid, prompt=prompt, max_new_tokens=olen,
                           adapter_id=adapter, arrival_s=t,
                           tenant=tenant, session_id=sid,
                           engine_hint=hint))
    return out
