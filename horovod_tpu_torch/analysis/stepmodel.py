"""Expected-collective model: what a train or serving step SHOULD emit.

Counterpart of ``horovod_tpu/analysis/stepmodel.py``.  Given the builder
metadata a :func:`horovod_tpu_torch.training.make_train_step` /
``make_flax_train_step`` step carries (optimizer wrap, zero stage,
microbatch count, guard, tp / pipeline stages, data set and its size),
derive the multiset of collectives the exchange is contracted to put on
the wire -- op kind, dtype and element count a leg -- from the SAME
planner calls the exchange makes (the wrap's ``plan_buckets`` plan,
``zero.plan_arena`` / ``zero_plan``, the ``plan_exchange`` families and
the codec widths of ``collectives/compression.py``), so the expectation
and the emission can only diverge if the exchange code itself diverges
from its plan.

The widths are the JAX model's (its module docstring lists them): cast
codecs one ``psum`` a bucket at the wire dtype; powersgd(r) two f32
``psum`` legs of the factor widths; top-k two ``all_gather`` legs of
``k``; ZeRO-1 per arena one ``reduce_scatter`` of the padded arena and
one ``all_gather`` of the shard (per axis on a two-level layout);
``microbatches=k`` k ``reduce_scatter`` legs and one ``all_gather`` a
reverse-planned bucket (EF codecs: one EF exchange a step); hierarchical
the ICI scatter, the DCN hop under its codec and the ICI gather;
chunked one scatter and one gather a chunk; the guard's ``f32[2]`` leg.

Deliberate differences from the JAX model, each the port's exchange:

- **world 1.** The JAX ``allreduce_gradients`` bypasses the planner at
  one device and maps an identity ``psum`` over the leaves; the port's
  exchanges run their planned buckets at any world size, so world 1 is
  priced as any other.
- **counts are executed, not traced.** The recorder sees each
  collective a step issues; a JAX jaxpr holds a scan body's collective
  once.  The pipeline's ``M + S - 1`` ticks are priced tick by tick.
- **the pipeline's closing sum** is Megatron's "g" (identity backward):
  no backward psum of the stacked outputs.
- **ZeRO-1 on a two-data-axis set** reduce-scatters and gathers once
  over the set; the arena runs per axis only under a per-leg codec.
- **the verify step** runs ``width`` width-1 steps: ``width x 2`` psums
  a layer of ``slots x d_model`` (the ``serving`` plan rows).

``supported=False`` (a warning, no plan matching) where the JAX model
declines: process-set and Adasum exchanges, fp8 and EF ZeRO codecs,
per-slot LoRA banks, undeclared model-parallel activation contracts.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import torch

from ..collectives.compression import (Compression, is_error_feedback,
                                       is_fp8, is_hier_legs,
                                       parse_compression)
from ..controller import fusion as _fusion


@dataclasses.dataclass(frozen=True)
class ExpectedOp:
    """One collective leg the exchange contract requires."""
    kind: str
    dtype: str
    elements: int
    label: str    # e.g. "bucket0(float32)/psum-P"

    def sig(self) -> Tuple[str, str, int]:
        return (self.kind, self.dtype, self.elements)


@dataclasses.dataclass
class ExpectedExchange:
    """The derived contract plus the plan rows it was derived from.

    ``supported=False`` means the config uses an exchange the model does
    not price; the auditor then skips plan matching and reports a
    warning instead of guessing.  ``allowance`` holds legs that may ride
    beside the plan (the flax step's BatchNorm statistics average), as
    the JAX auditor's ``batch_stats`` allowance."""
    ops: List[ExpectedOp]
    plan_rows: List[dict]
    supported: bool = True
    notes: Tuple[str, ...] = ()
    allowance: Counter = dataclasses.field(default_factory=Counter)


def _unsupported(notes) -> ExpectedExchange:
    return ExpectedExchange(ops=[], plan_rows=[], supported=False,
                            notes=tuple(notes))


def meta_from_step(step) -> Optional[dict]:
    """The builder metadata riding a step (``None`` for an unknown
    callable -- pass ``meta=`` to ``audit_step`` then)."""
    meta = getattr(step, "_meta", None)
    return dict(meta) if isinstance(meta, dict) else None


def _plan_ops(legs, tag=None) -> List[ExpectedOp]:
    """Render plan-IR legs' audit contracts as ExpectedOp rows -- the
    expectation IS the plan, flattened by ``fusion.ops_from_legs``."""
    return [ExpectedOp(kind, dt, elements, label)
            for kind, dt, elements, label
            in _fusion.ops_from_legs(legs, tag=tag)]


def _rows(spec) -> List[dict]:
    return [{"bucket": i, "dtype": _fusion.dtype_name(dt),
             "leaves": len(lspecs),
             "elements": sum(s.size for s in lspecs)}
            for i, (dt, lspecs) in enumerate(spec.buffers)]


def _exchange(optimizer) -> Optional[dict]:
    """A ``DistributedOptimizer`` wrap's exchange (``None`` for a bare
    optimizer): codec, op, threshold, process set and bucket plan."""
    from ..optim import distributed as _dist
    if not isinstance(optimizer, _dist._DistributedOptimizer):
        return None
    return {"compression": optimizer._compression, "op": optimizer._op,
            "fusion_threshold": optimizer._fusion_threshold,
            "process_set": optimizer._process_set,
            "bucket_plan": optimizer.bucket_plan, "wrap": optimizer}


def trainable(meta: dict) -> List[torch.Tensor]:
    """The step's trainable parameters in its optimizer's order (a wrap's
    or a ZeRO-1 step's bare optimizer)."""
    opt = meta.get("optimizer")
    return [p for g in opt.param_groups for p in g["params"]
            if p.requires_grad]


def expected_exchange(params: Sequence[torch.Tensor],
                      meta: dict) -> ExpectedExchange:
    """Derive the collective contract of a step built with ``meta`` over
    its trainable ``params`` (in the optimizer's order)."""
    expected = _expected_exchange(list(params), meta)
    if meta.get("guard") and expected.supported:
        # The SDC guard screen: one f32[2] psum riding beside the
        # gradient exchange, priced from the plan row the step notes (NOT
        # absorbed by the scalar-aux allowance: elements == 2).
        expected.ops.extend(_plan_ops(_fusion.plan_exchange("guard").legs,
                                      tag=""))
    if meta.get("flax") and expected.supported:
        expected.allowance.update(_stats_allowance(meta))
    return expected


def _stats_allowance(meta: dict) -> Counter:
    """The flax step's BatchNorm running statistics, averaged over the
    data set by one grouped allreduce: a psum a bucket of
    ``plan_buckets`` over the floating buffers (the step's own call)."""
    model = meta.get("model")
    stats = [b for b in model.buffers() if b.is_floating_point()] \
        if model is not None else []
    if not stats:
        return Counter()
    spec = _fusion.plan_buckets(stats)
    return Counter(("psum", r["dtype"], r["elements"]) for r in _rows(spec))


def _expected_exchange(params: List[torch.Tensor],
                       meta: dict) -> ExpectedExchange:
    from ..collectives.reduce_op import Adasum, Average, Sum

    if meta.get("kind") in ("serving_decode", "serving_verify"):
        return _expected_serving_decode(meta)
    if (int(meta.get("tp", 1) or 1) > 1
            or int(meta.get("pipeline_stages", 1) or 1) > 1):
        return _expected_3d(params, meta)
    world = int(meta.get("world", 1))
    if not params:
        return ExpectedExchange(ops=[], plan_rows=[])
    if meta.get("zero_stage"):
        return _expected_zero(params, meta)
    exchange = _exchange(meta.get("optimizer"))
    k_micro = int(meta.get("microbatches", 1))
    if k_micro > 1:
        return _expected_microbatch(params, exchange, k_micro, world,
                                    meta.get("data_set"))
    if exchange is None:
        return ExpectedExchange(ops=[], plan_rows=[], notes=(
            "bare optimizer: no gradient exchange",))
    notes = []
    ps = exchange["process_set"]
    if ps is not None and not _same_set(ps, meta.get("data_set")):
        notes.append("process-set reduction")
    if exchange["op"] is Adasum:
        notes.append("Adasum exchange")
    if exchange["op"] not in (Sum, Average, Adasum):
        notes.append(f"{exchange['op']} exchange")
    if notes:
        return _unsupported(f"unmodeled exchange path: {n}" for n in notes)
    return _wrap_ops(exchange, world)


def _same_set(ps, data_set) -> bool:
    return data_set is not None and tuple(ps.ranks) == tuple(data_set.ranks)


def _wrap_ops(exchange: dict, world: int) -> ExpectedExchange:
    """The wrap's buckets under its codec (``_launch_bucket`` /
    ``_launch_ef_bucket``'s routing), over its process set."""
    from ..core.topology import set_pair
    comp = exchange["compression"]
    ps = exchange["process_set"]
    spec = exchange["bucket_plan"]
    rows = _rows(spec)
    if is_error_feedback(comp):
        if is_hier_legs(comp):
            pair = set_pair(ps)
            if pair is None:
                return _unsupported((
                    "per-leg EF codec without a two-level layout: the "
                    "runtime raises",))
            return ExpectedExchange(ops=_hier_ops(rows, comp, pair),
                                    plan_rows=rows)
        return ExpectedExchange(ops=_ef_ops(rows, comp), plan_rows=rows)
    if is_fp8(comp):
        return _unsupported(("unmodeled exchange path: fp8 exchange",))
    pair = set_pair(ps) if _fusion.hier_requested(comp) else None
    if pair is not None:
        return ExpectedExchange(ops=_hier_ops(rows, comp, pair),
                                plan_rows=rows, notes=(
            f"two-level exchange on the ({pair.n_dcn}, {pair.n_ici}) "
            "layout",))
    notes: Tuple[str, ...] = ()
    if is_hier_legs(comp):
        # No two-level layout: the ICI codec rides the flat exchange.
        comp = comp.ici
        notes = ("per-leg codec on one level: ICI codec on the flat psum",)
    chunk = _fusion.exchange_chunk_bytes()
    if chunk > 0 and (ps is None or getattr(ps, "hier", None) is not None):
        n = world if ps is None else ps.size()
        return ExpectedExchange(ops=_chunked_ops(rows, comp, chunk, n),
                                plan_rows=rows, notes=notes + (
            f"chunked exchange ({chunk}B chunks of the wire buffer)",))
    return ExpectedExchange(ops=_flat_ops(rows, comp), plan_rows=rows,
                            notes=notes)


def _wire(comp, dtype) -> str:
    return _fusion.dtype_name(_fusion._wire_cast_dtype(comp, dtype))


def _flat_ops(rows: List[dict], comp) -> List[ExpectedOp]:
    """One flat psum a bucket at the codec's wire dtype (the memoized
    ``plan_exchange("flat")`` rows ``_launch_bucket`` notes)."""
    ops = []
    for r in rows:
        plan = _fusion.plan_exchange("flat", size=int(r["elements"]),
                                     dtype=_wire(comp, r["dtype"]))
        ops += _plan_ops(plan.legs, tag=f"bucket{r['bucket']}({r['dtype']})")
    return ops


def _hier_ops(rows: List[dict], comp, pair) -> List[ExpectedOp]:
    """The two-level exchange a bucket (``plan_hier_legs``' rows)."""
    ops = []
    for r in rows:
        legs = _fusion.plan_hier_legs(int(r["elements"]), r["dtype"],
                                      n_dcn=pair.n_dcn, n_ici=pair.n_ici,
                                      compression=comp)
        ops += _plan_ops(legs, tag=f"bucket{r['bucket']}({r['dtype']})")
    return ops


def _chunked_ops(rows: List[dict], comp, chunk_bytes: int,
                 world: int) -> List[ExpectedOp]:
    """The scatter + gather pieces of ``chunked_allreduce`` a bucket,
    keyed on the compressed wire buffer."""
    ops = []
    for r in rows:
        plan = _fusion.plan_exchange(
            "chunked", size=int(r["elements"]), dtype=_wire(comp, r["dtype"]),
            chunk_bytes=int(chunk_bytes), world=int(world))
        ops += _plan_ops(plan.legs, tag=f"bucket{r['bucket']}({r['dtype']})")
    return ops


def _ef_ops(rows: List[dict], comp) -> List[ExpectedOp]:
    """The EF exchange a bucket (``plan_exchange("ef")``: the ledger row
    and the nested PowerSGD / top-k legs; a non-floating bucket's flat
    psum)."""
    ops = []
    for r in rows:
        plan = _fusion.plan_exchange("ef", size=int(r["elements"]),
                                     dtype=r["dtype"], compression=comp)
        ops += _plan_ops(plan.legs, tag=f"bucket{r['bucket']}({r['dtype']})")
    return ops


def _expected_serving_decode(meta: dict) -> ExpectedExchange:
    """The serving TP decode / verify activation contract: the
    ``serving`` plan rows the step builder plans (two row-parallel sums a
    layer of ``slots x d_model`` at the compute dtype; ``width`` times
    that for the verify step).  Per-slot LoRA banks are declined, not
    guessed, as in the JAX model."""
    if meta.get("lora"):
        return _unsupported(("serving TP decode with per-slot LoRA banks: "
                             "unmodeled adapter exchange",))
    missing = [k for k in ("num_layers", "d_model", "slots")
               if not meta.get(k)]
    if missing:
        return _unsupported(
            (f"serving decode meta missing {'/'.join(missing)}: "
             "cannot derive activation widths",))
    layers = int(meta["num_layers"])
    width = int(meta.get("width", 1))
    dtype = str(meta.get("dtype", "float32"))
    kind = str(meta.get("kind", "serving_decode"))
    plan = _fusion.plan_exchange(
        "serving", kind=kind, layers=layers, slots=int(meta["slots"]),
        width=width, d_model=int(meta["d_model"]), dtype=dtype,
        axis=str(meta.get("tp_axis", "tp")))
    elements = int(meta["slots"]) * int(meta["d_model"])
    rows = [{"bucket": 0, "dtype": dtype, "leaves": len(plan.legs),
             "elements": len(plan.legs) * elements, "kind": kind}]
    notes = [f"serving decode: {len(plan.legs)} row-parallel allreduces "
             f"({layers} layer(s) x 2 x width {width}), {elements} "
             "elements each"]
    if meta.get("resized_from"):
        notes.append(
            f"resized decode mesh: tp {meta['resized_from']} -> "
            f"{meta.get('tp', meta.get('world'))}; activation contract "
            "is mesh-size invariant")
    return ExpectedExchange(ops=_plan_ops(plan.legs, tag=""),
                            plan_rows=rows, notes=tuple(notes))


def _expected_microbatch(params: List[torch.Tensor], exchange, k: int,
                         world: int, data_set=None) -> ExpectedExchange:
    """The backward-overlap pipe: k reduce-scatters + 1 allgather a
    reverse-planned bucket (``_MicrobatchGradPipe``'s plan), or one EF
    exchange a step over the wrap's plan."""
    if exchange is None:
        return ExpectedExchange(ops=[], plan_rows=[], notes=(
            "bare optimizer: local microbatch accumulation only",))
    comp = exchange["compression"]
    if is_error_feedback(comp):
        rows = _rows(exchange["bucket_plan"])
        return ExpectedExchange(ops=_ef_ops(rows, comp), plan_rows=rows,
                                notes=("EF-once-per-step microbatch pipe",))
    wrap = exchange["wrap"]
    order = list(range(len(params)))
    name_of = getattr(wrap, "_name_of", None)
    if name_of is not None:
        from ..models.convert import flax_leaf_order
        order = flax_leaf_order([name_of[id(p)] for p in params])
    spec = _fusion.plan_buckets([params[i] for i in order],
                                exchange["fusion_threshold"], reverse=True)
    n = world if data_set is None else data_set.size()
    plan = _fusion.plan_exchange(
        "microbatch", buffers=tuple((dt, sum(s.size for s in lspecs))
                                    for dt, lspecs in spec.buffers),
        k=int(k), world=int(n), compression=comp)
    nb = len(spec.buffers)
    ops, rows = [], []
    for i, r in enumerate(_rows(spec)):
        rs, ag = plan.legs[i], plan.legs[nb + i]
        ops += _plan_ops([rs, ag], tag=f"bucket{i}({r['dtype']})")
        rows.append(dict(r, padded=rs.elements, wire_dtype=rs.wire_dtype,
                         codec=comp.__name__, kind="microbatch-pipe"))
    return ExpectedExchange(ops=ops, plan_rows=rows)


def _expected_zero(params: List[torch.Tensor],
                   meta: dict) -> ExpectedExchange:
    """ZeRO-1 arena exchange (``zero_apply``): a reduce-scatter and a
    compressed allgather an arena, per axis under a per-leg codec on a
    two-level layout (``zero_plan``'s rows)."""
    from ..core.topology import set_pair
    from ..optim import zero as _zero
    zs = meta.get("zero_state")
    comp = meta.get("zero_compression")
    comp = parse_compression(comp) if comp else Compression.none
    if is_error_feedback(comp) or is_fp8(comp):
        return _unsupported(
            (f"unmodeled zero allgather codec: {comp.__name__}",))
    ps = zs.process_set if zs is not None else None
    n = int(meta.get("world", 1)) if ps is None else ps.size()
    leaves = params if zs is None or zs.order is None \
        else [params[i] for i in zs.order]
    spec = _zero.plan_arena(leaves, n)
    pair = set_pair(ps) if is_hier_legs(comp) else None
    shape = pair.shape if pair is not None and pair.n_dcn > 1 else None
    rs_legs, ag_legs = _zero.zero_plan(spec, comp, shape,
                                       _zero._use_reducescatter())
    ops, rows = [], []
    for i, buf in enumerate(spec.buffers):
        if buf.size < 1:
            continue
        dt = _fusion.dtype_name(buf.dtype)
        ops += _plan_ops([rs_legs[i], ag_legs[i]], tag=f"arena{i}({dt})")
        rows.append({"bucket": i, "dtype": dt, "leaves": len(buf.leaves),
                     "elements": buf.size, "padded": buf.padded,
                     "shard": buf.shard, "codec": comp.__name__,
                     "kind": "zero-arena"})
    notes = () if shape is None else (
        f"per-axis zero exchange on the {shape} layout (per-leg codec)",)
    return ExpectedExchange(ops=ops, plan_rows=rows, notes=notes)


def _expected_3d(params: List[torch.Tensor], meta: dict) -> ExpectedExchange:
    """DP x TP x pipeline step on a ``build_3d_mesh``.  The model holds
    this rank's shards, so the DP leg is priced over its own parameters
    and the data set; the activation legs come from the contract the
    reference configs declare in ``meta["model_parallel"]`` (``d_model``,
    ``act_rows`` entering the loss a call, optional
    ``pipe_microbatches``, ``dtype`` and ``tp_pairs``): tensor
    parallelism ``tp_pairs`` (default 1: the JAX contract's one block)
    forward (Megatron "g") and backward (Megatron "f") psums of the
    activation a stage call -- a transformer declares two a layer; a
    pipeline ``M + S - 1`` stage calls a loss call, a ppermute each way
    between ticks, and one closing psum of the stacked
    outputs (identity backward); the first tick's input is data, so its
    "f" sum never runs."""
    from ..collectives.reduce_op import Average, Sum
    tp = int(meta.get("tp", 1) or 1)
    pipe = int(meta.get("pipeline_stages", 1) or 1)
    world = int(meta.get("world", 1))
    k_micro = int(meta.get("microbatches", 1))
    mp = meta.get("model_parallel")
    if not (isinstance(mp, dict) and "d_model" in mp and "act_rows" in mp):
        return _unsupported((
            "model-parallel step without a declared activation contract "
            "(meta['model_parallel'] with d_model/act_rows): the 3-D "
            "reference configs declare theirs, arbitrary TP/pipeline "
            "losses are not priced",))
    if meta.get("zero_stage"):
        base = _expected_zero(params, meta)
    else:
        exchange = _exchange(meta.get("optimizer"))
        if k_micro > 1:
            base = _expected_microbatch(params, exchange, k_micro, world,
                                        meta.get("data_set"))
        elif exchange is None:
            base = ExpectedExchange(ops=[], plan_rows=[], notes=(
                "bare optimizer: no gradient exchange",))
        elif (is_error_feedback(exchange["compression"])
              or is_fp8(exchange["compression"])
              or exchange["op"] not in (Sum, Average)
              or not _same_set(exchange["process_set"],
                               meta.get("data_set"))):
            return _unsupported((
                "unmodeled 3-D DP exchange (EF/fp8 codec, non-sum op or "
                "a process set other than the data set)",))
        else:
            base = _wrap_ops(exchange, world)
    if not base.supported:
        return base
    d = int(mp["d_model"])
    act_rows = int(mp["act_rows"])
    act_dt = str(mp.get("dtype", "float32"))
    m_pipe = max(1, int(mp.get("pipe_microbatches", 1)))
    # Only a declared transformer sets ``tp_pairs`` (``chip_smoke.py``'s
    # BERT-Large step, two a layer); the reference configs keep the
    # default.
    pairs = max(1, int(mp.get("tp_pairs", 1)))
    ops = list(base.ops)
    for mb in range(k_micro):
        tag = f"mb{mb}" if k_micro > 1 else "act"
        if pipe > 1:
            rp = act_rows // m_pipe
            ticks = m_pipe + pipe - 1
            for t in range(ticks - 1):
                ops.append(ExpectedOp("ppermute", act_dt, rp * d,
                                      f"{tag}/pipe-shift-fwd{t}"))
                ops.append(ExpectedOp("ppermute", act_dt, rp * d,
                                      f"{tag}/pipe-shift-bwd{t}"))
            ops.append(ExpectedOp("psum", act_dt, act_rows * d,
                                  f"{tag}/pipe-out-fwd"))
            if tp > 1:
                for t in range(ticks):
                    ops.append(ExpectedOp("psum", act_dt, rp * d,
                                          f"{tag}/tp-row-fwd{t}"))
                for t in range(1, ticks):
                    ops.append(ExpectedOp("psum", act_dt, rp * d,
                                          f"{tag}/tp-row-bwd{t}"))
        elif tp > 1:
            for j in range(pairs):
                sub = f"{j}" if pairs > 1 else ""
                ops.append(ExpectedOp("psum", act_dt, act_rows * d,
                                      f"{tag}/tp-row-fwd{sub}"))
                ops.append(ExpectedOp("psum", act_dt, act_rows * d,
                                      f"{tag}/tp-row-bwd{sub}"))
    notes = tuple(base.notes) + (
        f"3-D config: tp={tp} pipe={pipe} data={world}",)
    return ExpectedExchange(ops=ops, plan_rows=base.plan_rows, notes=notes)
