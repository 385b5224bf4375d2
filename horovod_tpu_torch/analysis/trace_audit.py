"""Layer-1 static step auditor: record, compare, cross-check -- nothing
moves.

Counterpart of ``horovod_tpu/analysis/trace_audit.py``.  ``audit_step``
builds and runs a step once on every rank of a recording world
(:func:`~.collective_walk.recording_world`: the ``fake`` backend, whose
collectives move nothing), records the ``c10d`` ops each rank's step
dispatches (:class:`~.collective_walk.CollectiveRecorder`), derives the
planner contract with :mod:`.stepmodel`, and reports
:class:`~horovod_tpu_torch.analysis.findings.Finding` rows for:

- ``audit-plan-missing`` (error): a planned collective leg the step
  never emits -- the exchange silently dropped a bucket;
- ``audit-plan-unaccounted`` (error): an emitted collective no plan row
  (nor the scalar loss/metric or BatchNorm-statistics allowance)
  accounts for -- untracked wire traffic;
- ``audit-desync-branch`` (error): two ranks' sequences differ
  (:func:`~.collective_walk.compare_ranks`).  Every rank gets the same
  arguments, built from one seed, so only code that reads the rank can
  make them differ: the port's form of the JAX taint walk from
  ``axis_index``;
- ``audit-fence`` (error): a barrier-signature collective (scalar
  int32 psum) in a step body on a ``cuda`` device.  The JAX rule's
  other form, a TPU mesh resolving a blocking eager policy, has no
  counterpart: the port's policy (``controller/fusion.py::_fence_policy``)
  is a function of the device type, ``stream-ordered(nccl)`` on every
  ``cuda`` device;
- ``audit-collective-in-kernel`` (error): a collective dispatched while
  a kernel wrapper was on the stack -- every registered kernel family
  (``ops/registry.py::KERNEL_CONTRACTS``) contracts to keep its
  exchanges outside, where the planner, this auditor and the span
  recorder see them.

The JAX ``audit-donation`` has no counterpart: the port's steps update
in place and take no ``donate``.

Under the recording world a collective returns each rank's own input,
so values a step reduces (a loss, the guard's verdict) are per-rank
values; with equal arguments they agree, and a step's outputs are not a
training result.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import collective_walk as _walk
from .findings import ERROR, WARNING, Finding
from .stepmodel import (ExpectedExchange, expected_exchange, meta_from_step,
                        trainable)

# Scalar reductions (the loss average, metric max/min) ride beside any
# exchange; they are matched after plan legs so a planned scalar leg
# still claims its record first.
_AUX_KINDS = frozenset({"psum", "pmax", "pmin"})


@dataclasses.dataclass
class AuditReport:
    """Outcome of one ``audit_step`` call: rank 0's records (``ranks``:
    every rank's) against the plan."""
    name: str
    findings: List[Finding]
    collectives: List[_walk.CollectiveRecord]
    expected: Optional[ExpectedExchange]
    summary: Dict[str, int]
    ranks: List[List[_walk.CollectiveRecord]] = dataclasses.field(
        default_factory=list)

    def ok(self) -> bool:
        return not any(f.severity == ERROR for f in self.findings)

    def render(self) -> str:
        s = self.summary
        head = (f"audit {self.name}: "
                f"{s['planned_buckets']} planned bucket(s), "
                f"{s['expected_ops']} planned collective leg(s), "
                f"{s['emitted_ops']} emitted, {s['matched_ops']} matched, "
                f"{s['aux_ops']} scalar-aux, {s['stats_ops']} stats, "
                f"{s['ranks']} rank(s) -- "
                f"{'OK' if self.ok() else 'FINDINGS'}")
        lines = [head]
        lines += [f"  {f.render()}" for f in self.findings]
        return "\n".join(lines)


def _device() -> Optional[torch.device]:
    from ..core.state import global_state
    return global_state().device


def _fence_findings(name: str,
                    records: Sequence[_walk.CollectiveRecord]
                    ) -> List[Finding]:
    """The fence rule, read while the rank's world is open."""
    dev = _device()
    if dev is None or dev.type != "cuda":
        return []
    findings = []
    for r in records:
        if r.kind == "psum" and r.elements == 1 and r.dtype == "int32":
            findings.append(Finding(
                rule="audit-fence", severity=ERROR, path=name,
                ident=r.path,
                message="barrier-signature collective (scalar int32 psum) "
                        "in a step body on a cuda device; NCCL orders GPU "
                        "collectives on the stream -- CPU-style barriers "
                        "only serialize"))
    return findings


def _match_plan(name: str, expected: ExpectedExchange,
                records: Sequence[_walk.CollectiveRecord]
                ) -> Tuple[List[Finding], Dict[str, int]]:
    want = Counter(op.sig() for op in expected.ops)
    stats_allowance = Counter(expected.allowance)
    labels: Dict[Tuple[str, str, int], List[str]] = {}
    for op in expected.ops:
        labels.setdefault(op.sig(), []).append(op.label)
    matched = aux = stats = 0
    unaccounted: List[_walk.CollectiveRecord] = []
    for r in records:
        sig = r.sig()
        if want.get(sig, 0) > 0:
            want[sig] -= 1
            matched += 1
        elif stats_allowance.get(sig, 0) > 0:
            stats_allowance[sig] -= 1
            stats += 1
        elif r.kind in _AUX_KINDS and r.elements == 1:
            aux += 1
        else:
            unaccounted.append(r)

    findings = []
    for sig, n in want.items():
        if n <= 0:
            continue
        for label in labels[sig][-n:]:
            findings.append(Finding(
                rule="audit-plan-missing", severity=ERROR, path=name,
                ident=label,
                message=f"planned collective leg never emitted: "
                        f"{sig[0]} {sig[1]}[{sig[2]}] ({label})"))
    for r in unaccounted:
        findings.append(Finding(
            rule="audit-plan-unaccounted", severity=ERROR, path=name,
            ident=r.path,
            message=f"emitted collective not in the plan: {r.kind} "
                    f"{r.dtype}[{r.elements}] on {r.group} at {r.path}"))
    counts = {"matched_ops": matched, "aux_ops": aux,
              "stats_ops": stats,
              "stats_unused": sum(stats_allowance.values()),
              "unaccounted_ops": len(unaccounted),
              "missing_ops": sum(n for n in want.values() if n > 0)}
    return findings, counts


def record_rank(fn: Callable[..., Tuple[Any, Sequence]], *args,
                world: int, rank: int = 0, device=None,
                hierarchical: Optional[Tuple[int, int]] = None,
                recorder: Optional[_walk.CollectiveRecorder] = None,
                warmup: int = 0,
                after: Optional[Callable[[Any, list], None]] = None
                ) -> List[_walk.CollectiveRecord]:
    """Rank ``rank``'s records: inside its ``world``-rank recording world
    (``device``, ``hierarchical`` as :func:`audit_step` takes them)
    ``fn(*args) -> (step, step_args)`` builds the step, which runs
    ``warmup`` times unrecorded and then once under ``recorder`` (a new
    :class:`~.collective_walk.CollectiveRecorder` by default);
    ``after(step, records)`` runs next, the world still open."""
    rec = recorder if recorder is not None else _walk.CollectiveRecorder()
    with _walk.recording_world(world, rank, device=device,
                               hierarchical=hierarchical):
        step, step_args = fn(*args)
        for _ in range(int(warmup)):
            step(*step_args)
        with rec:
            step(*step_args)
        if after is not None:
            after(step, rec.records)
        del step, step_args
    return rec.records


def audit_step(fn: Callable[..., Tuple[Any, Sequence]], *args,
               meta: Optional[dict] = None, world: int = 2,
               name: str = "step", device=None,
               hierarchical: Optional[Tuple[int, int]] = None
               ) -> AuditReport:
    """Audit a step against its exchange plan on every rank of a
    ``world``-rank recording world.

    ``fn(*args) -> (step, step_args)`` builds the rank's step; it is
    called once a rank, inside that rank's recording world (``device``:
    ``init()``'s, ``"cpu"`` or ``"cuda"``; ``hierarchical=(n_dcn,
    n_ici)`` lays the world out in two levels), with the same ``args``
    on every rank.  The auditor runs ``step(*step_args)`` once under the
    recorder.  ``meta`` overrides the step's builder metadata (``_meta``:
    a train step's, or a serving step's ``kind``/``num_layers``/...);
    without either, plan matching is skipped."""
    by_rank: List[List[_walk.CollectiveRecord]] = []
    findings: List[Finding] = []
    expected = None

    def plan(step, records) -> None:
        nonlocal expected
        m = meta if meta is not None else meta_from_step(step)
        if m is not None:
            m = dict(m)
            params = trainable(m) if m.get("optimizer") is not None \
                else []
            expected = expected_exchange(params, m)
        findings.extend(_fence_findings(name, records))

    for rank in range(int(world)):
        by_rank.append(record_rank(
            fn, *args, world=world, rank=rank, device=device,
            hierarchical=hierarchical, after=plan if rank == 0 else None))
    records = by_rank[0]
    summary: Dict[str, int] = {
        "emitted_ops": len(records), "planned_buckets": 0,
        "expected_ops": 0, "matched_ops": 0, "aux_ops": 0,
        "stats_ops": 0, "unaccounted_ops": 0, "missing_ops": 0,
        "ranks": len(by_rank)}
    if expected is not None:
        for note in expected.notes:
            findings.append(Finding(
                rule="audit-plan-unsupported" if not expected.supported
                else "audit-plan-note", severity=WARNING, path=name,
                ident="model", message=note))
        if expected.supported:
            plan_findings, counts = _match_plan(name, expected, records)
            findings += plan_findings
            summary.update(counts)
            summary["planned_buckets"] = len(expected.plan_rows)
            summary["expected_ops"] = len(expected.ops)

    for rank, recs in enumerate(by_rank):
        for r in recs:
            if r.in_kernel:
                findings.append(Finding(
                    rule="audit-collective-in-kernel", severity=ERROR,
                    path=name, ident=f"rank{rank}/{r.path}",
                    message=f"collective {r.kind} {r.dtype}[{r.elements}] "
                            "dispatched inside a kernel wrapper; kernel "
                            "contracts declare every family collective-"
                            "free (a collective there is invisible to the "
                            "planner's wire accounting)"))

    for d in _walk.compare_ranks(by_rank):
        findings.append(Finding(
            rule="audit-desync-branch", severity=ERROR, path=name,
            ident=f"rank{d.rank}#{d.index}",
            message=f"rank {d.rank}'s collective {d.index} is {d.got} where "
                    f"rank {d.ref}'s is {d.want}: code that reads the rank "
                    "chose the collective (desync stall)"))
    summary["desync"] = sum(1 for f in findings
                            if f.rule == "audit-desync-branch")
    return AuditReport(name=name, findings=findings, collectives=records,
                       expected=expected, summary=summary, ranks=by_rank)


# -- the reference configurations -------------------------------------------

STANDARD_CONFIGS = ("plain", "zero1", "powersgd_ef", "microbatch2")

# Two-level reference configurations: the same tiny tree on a world laid
# out as (dcn 2, inner n/2) -- plain per-leg hier, hier composed with
# the ZeRO-1 arena, and hier with the EF codec scoped to the DCN hop.
HIER_CONFIGS = ("hier", "hier_zero1", "hier_powersgd_ef")

# Serving decode configurations: the tensor-parallel decode step at the
# largest tp the world allows and at the next size down (the mesh the
# control plane's shrink path lands on), and the width-5 verify step.
SERVING_CONFIGS = ("serving_decode", "serving_decode_resized",
                   "serving_verify")

# 3-D parallelism reference configurations: ``tp2`` runs TP=2 with the
# fp16 DP exchange over the (dcn, data) pair, ``tp2_zero1`` shards the
# optimizer arena over the same data set, ``tp2_pipe_micro`` stacks
# TP=2 x pipe=2 x microbatches=2 on a flat data axis.  World 8.
PARALLEL3D_CONFIGS = ("tp2", "tp2_zero1", "tp2_pipe_micro")

ALL_CONFIGS = (STANDARD_CONFIGS + HIER_CONFIGS + SERVING_CONFIGS
               + PARALLEL3D_CONFIGS)

# Threshold chosen so the tiny parameter tree below splits into TWO f32
# buckets (256 + 192 elements), exercising multi-bucket matching.
_TINY_THRESHOLD = 1024


class _Tiny(torch.nn.Module):
    """The JAX auditor's ``_tiny_params`` tree as a module."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(
            np.linspace(-1.0, 1.0, 256, dtype=np.float32).reshape(16, 16)))
        self.b = torch.nn.Parameter(torch.from_numpy(
            np.linspace(0.5, 1.5, 128, dtype=np.float32)))
        self.c = torch.nn.Parameter(torch.from_numpy(
            np.linspace(-0.5, 0.5, 64, dtype=np.float32)))


def _tiny_loss(model, batch):
    s = (torch.sum(model.a ** 2) + torch.sum(model.b ** 2)
         + torch.sum(model.c ** 2))
    return torch.mean(batch) * s


def _data_parallel(config: str, device):
    """``(step, (batch,))`` of a standard or hierarchical config."""
    from .. import training as _training
    from ..collectives.compression import Compression
    from ..optim import distributed as _dist
    model = _Tiny().to(device)
    batch = torch.ones((2, 4), device=device)
    sgd = torch.optim.SGD(model.parameters(), lr=0.01)
    kw: Dict[str, Any] = {}
    comp: Any = Compression.fp16
    if config in ("zero1", "hier_zero1"):
        opt = sgd
        kw = {"zero_stage": 1}
        if config == "hier_zero1":
            kw["zero_compression"] = "ici:none,dcn:none"
    else:
        comp = {"powersgd_ef": "powersgd:2", "hier": "ici:none,dcn:none",
                "hier_powersgd_ef": "ici:none,dcn:powersgd:2"}.get(config,
                                                                   comp)
        opt = _dist.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(),
            compression=comp, fusion_threshold=_TINY_THRESHOLD)
        if config == "microbatch2":
            kw = {"microbatches": 2}
    step = _training.make_train_step(model, _tiny_loss, opt, **kw)
    return step, (batch,)


class _TPMLP(torch.nn.Module):
    """This rank's shards of the JAX auditor's tiny TP MLP (``d_model
    16, d_ff 32``): ``w_up`` / ``w_down`` stacked ``[tp, ...]`` (and
    ``[pipe, tp, ...]`` for the pipeline config) from one seed, this
    rank's slice kept."""

    def __init__(self, tp_index: int, stage: Optional[int], device,
                 d_model: int = 16, d_ff: int = 32, tp: int = 2):
        super().__init__()
        rng = np.random.default_rng(0)
        if stage is None:
            up = rng.normal(size=(tp, d_model, d_ff // tp))
            down = rng.normal(size=(tp, d_ff // tp, d_model))
            up, down = up[tp_index], down[tp_index]
            self.bias = torch.nn.Parameter(torch.from_numpy(np.linspace(
                0.5, 1.5, d_model, dtype=np.float32)).to(device))
        else:
            up = rng.normal(size=(2, tp, d_model, d_ff // tp))
            down = rng.normal(size=(2, tp, d_ff // tp, d_model))
            up, down = up[stage, tp_index], down[stage, tp_index]
        self.w_up = torch.nn.Parameter(
            torch.as_tensor(up, dtype=torch.float32, device=device))
        self.w_down = torch.nn.Parameter(
            torch.as_tensor(down, dtype=torch.float32, device=device))


def _parallel_3d(config: str, device):
    """``(step, (batch,))`` of a 3-D config on its own mesh over the
    world's 8 ranks."""
    from .. import training as _training
    from ..collectives.compression import Compression
    from ..optim import distributed as _dist
    from ..parallel import (build_3d_mesh, data_axes, pipeline_apply,
                            split_microbatches, tp_mlp)
    d_model, tp = 16, 2
    pipe = config == "tp2_pipe_micro"
    if pipe:
        mesh = build_3d_mesh(data=2, pipe=2, model=2)
    else:
        mesh = build_3d_mesh(data=2, model=2, dcn_size=2)
    model = _TPMLP(mesh.axis_index("model"),
                   mesh.axis_index("pipe") if pipe else None, device)
    specs = {"w_up": (None, "model"), "w_down": ("model", None)}
    if not pipe:
        specs["bias"] = ()
    sgd = torch.optim.SGD(model.parameters(), lr=0.01)
    data_set = mesh.group(data_axes(mesh))

    def wrap():
        return _dist.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(),
            compression=Compression.fp16, fusion_threshold=_TINY_THRESHOLD,
            process_set=data_set)

    if pipe:
        def loss(m, batch):
            mb = split_microbatches(batch, 2)

            def stage_fn(p, x):
                return tp_mlp(x, p["w_up"], p["w_down"], axis="model",
                              mesh=mesh)

            out = pipeline_apply(stage_fn, {"w_up": m.w_up,
                                            "w_down": m.w_down}, mb,
                                 axis="pipe", mesh=mesh)
            y = torch.cat(list(out), dim=0)
            return torch.mean(y * y)

        step = _training.make_train_step(
            model, loss, wrap(), tp=tp, pipeline_stages=2, microbatches=2,
            param_specs=specs, mesh=mesh)
        batch = torch.ones((8, d_model), device=device)
        # 8 rows a data rank / 2 train microbatches = 4 rows a loss call,
        # halved again by the 2 pipeline microbatches.
        step._meta["model_parallel"] = {"d_model": d_model, "act_rows": 4,
                                        "pipe_microbatches": 2}
        return step, (batch,)

    def loss(m, batch):
        y = tp_mlp(batch + m.bias, m.w_up, m.w_down, axis="model",
                   mesh=mesh)
        return torch.mean(y * y)

    if config == "tp2":
        step = _training.make_train_step(model, loss, wrap(), tp=tp,
                                         param_specs=specs, mesh=mesh)
    else:
        step = _training.make_train_step(model, loss, sgd, tp=tp,
                                         zero_stage=1, param_specs=specs,
                                         mesh=mesh)
    # 2 rows a data rank: the rows of one loss call.
    step._meta["model_parallel"] = {"d_model": d_model, "act_rows": 2}
    return step, (torch.ones((2, d_model), device=device),)


def _serving(config: str, tp: int, device, resized_from=None):
    """``(step, args)`` of a serving config: the port's ``LLAMA_SERVE``
    decode (or width-5 verify) step over a tp mesh of the world."""
    from ..models import LLAMA_SERVE, init_llama_params
    from ..parallel import build_parallel_mesh, shard_params
    from ..serving import (CacheConfig, PagedKVCache, build_decode_step,
                           cache_sharding, decode_param_specs)
    cfg = LLAMA_SERVE
    if torch.device(device).type == "cuda":
        # The decode kernel takes head_dim 64 or 128; no collective's
        # width depends on it.
        cfg = dataclasses.replace(cfg, head_dim=64)
    mesh = build_parallel_mesh(tp=tp)
    ccfg = CacheConfig(num_layers=cfg.num_layers,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       slots=4, page_size=8, max_len=64)
    cache = PagedKVCache(ccfg, cache_sharding(mesh, device=device))
    params = init_llama_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    local = shard_params(params, decode_param_specs(params),
                         mesh.axis_index("tp"), tp)
    width = 5 if config == "serving_verify" else 1
    step = build_decode_step(cfg, mesh, slots=ccfg.slots,
                             page_size=ccfg.page_size,
                             pages_per_slot=ccfg.pages_per_slot, width=width)
    if resized_from is not None:
        step._meta["resized_from"] = resized_from
    shape = (ccfg.slots,) if width == 1 else (ccfg.slots, width)
    tokens = torch.zeros(shape, dtype=torch.long, device=device)
    return step, (local, cache.k, cache.v, tokens,
                  cache.lengths_device().long(), cache.table_device(),
                  torch.zeros(ccfg.slots, dtype=torch.bool, device=device))


def _serving_tp(config: str, world: int) -> Tuple[int, Optional[int]]:
    """``(tp, resized_from)`` of a serving config in a ``world``-rank
    pool: the largest tp ``LLAMA_SERVE`` allows, or for
    ``serving_decode_resized`` the next size down."""
    from ..models import LLAMA_SERVE
    from ..serving.policy import valid_tp_sizes
    sizes = valid_tp_sizes(LLAMA_SERVE, world)
    if config == "serving_decode_resized" and len(sizes) > 1:
        return sizes[-2], sizes[-1]
    return sizes[-1], None


def build_standard_config(config: str, world: int = 8, device=None):
    """``(make, world, hierarchical, name)`` of one reference config:
    ``make()`` builds the rank's step and its arguments inside the
    recording world (:func:`audit_step`'s ``fn``), on ``device`` (the
    world's device when ``None``)."""
    def dev():
        from ..core.state import global_state
        return device if device is not None else global_state().device

    if config in STANDARD_CONFIGS:
        return (lambda: _data_parallel(config, dev()), world, None,
                f"step:{config}")
    if config in HIER_CONFIGS:
        if world < 4 or world % 2:
            raise ValueError(f"config {config!r} needs an even world of at "
                             f"least 4 for its (2, n/2) layout, got {world}")
        return (lambda: _data_parallel(config, dev()), world,
                (2, world // 2), f"step:{config}")
    if config in SERVING_CONFIGS:
        tp, resized_from = _serving_tp(config, world)
        return (lambda: _serving(config, tp, dev(), resized_from), tp,
                None, f"step:{config}")
    if config in PARALLEL3D_CONFIGS:
        if world < 8:
            raise ValueError(f"config {config!r} needs a world of 8 for "
                             f"its 2x2x2 mesh, got {world}")
        return (lambda: _parallel_3d(config, dev()), 8, None,
                f"step:{config}")
    raise ValueError(
        f"unknown standard config {config!r}; pick from {ALL_CONFIGS}")


def audit_standard_configs(configs: Optional[Sequence[str]] = None,
                           world: int = 8, device=None
                           ) -> Dict[str, AuditReport]:
    """Audit the reference configurations (default: the standard four)
    against their plans, each in its own recording world(s) of ``world``
    ranks on ``device``."""
    reports = {}
    for config in (configs or STANDARD_CONFIGS):
        make, n, hier, name = build_standard_config(config, world, device)
        reports[config] = audit_step(make, world=n, name=name,
                                     device=device, hierarchical=hier)
    return reports
