"""Scaling evidence: collective accounting from the recording world,
overlap windows timed from the card's kernels, and the analytic
efficiency model.

Counterpart of ``horovod_tpu/utils/scaling.py``, with its names.  The
north star is scaling efficiency from 1 to 256 GPUs; one card cannot
time that, so this module produces the evidence that can be produced
mechanically:

1. **Wire accounting.**  The JAX package compiles a step for an
   n-device mesh and parses its HLO; the port runs one rank's step once
   in a recording world of n ranks (``torch.distributed``'s ``fake``
   backend, :mod:`horovod_tpu_torch.analysis.collective_walk`) and counts
   the collectives it issues (:func:`step_collective_stats`).  Two
   invariants are checkable a model: a rank's gradient bytes equal the
   planner's payload, and they do not depend on n.
2. **Overlap evidence.**  A planned gradient bucket is issued from its
   gradients' hook and waited on in ``synchronize()``; the kernels the
   step launches in between run while the bucket is on the wire.
   :func:`step_overlap_report` sorts each collective into sync (waited
   on by the call that issued it) and async (its handle outlives that
   call), and times the kernels inside the async windows from the
   card's own profile -- where the JAX package could only estimate a
   TPU schedule's.
3. **Analytic 1 -> n projection.**  A measured one-card step, the
   measured bytes and published link rates give the efficiency curve
   at no overlap and at full overlap (:func:`predict_efficiency`,
   :func:`predict_efficiency_scheduled`).  Every constant and formula is
   below; the one chip model is :data:`H100_SXM`.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import os
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Wire accounting from the recording world.
# ---------------------------------------------------------------------------

# Record kind (the JAX primitive names of ``collective_walk``) -> the HLO
# op name the JAX accounting keys its stats by.
_HLO_OP = {"psum": "all-reduce", "pmax": "all-reduce",
           "pmin": "all-reduce", "pprod": "all-reduce",
           "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
           "all_to_all": "all-to-all", "ppermute": "collective-permute"}

# Not wire traffic of the step's exchange: barriers and control-plane
# broadcasts, which the HLO accounting never sees either.
_IGNORED = frozenset({"barrier", "broadcast"})


@dataclasses.dataclass
class CollectiveStats:
    """Per-op-kind (count, payload bytes) of one rank's step; ``records``
    are the collective records they were counted from (the port's
    addition: split them to count a part of the step)."""
    counts: Dict[str, int]
    bytes: Dict[str, int]
    records: tuple = dataclasses.field(default=(), repr=False,
                                       compare=False)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())


def record_op_bytes(record) -> Optional[Tuple[str, int]]:
    """``(HLO op name, payload bytes)`` of one collective record, or
    ``None`` for a barrier or broadcast.

    Bytes follow the HLO result semantics :meth:`ScheduleReport.
    _eq_payload` expects: an all-reduce's payload B, an all-gather's full
    result, a reduce-scatter's ``B/n`` shard, an all-to-all's or a
    permute's operand.  A record keeps the operand the wire moves (an
    all-gather's shard, a reduce-scatter's whole input), so those two
    are converted with the record's group size: the shard times n, the
    input over n."""
    if record.kind in _IGNORED:
        return None
    op = _HLO_OP.get(record.kind)
    if op is None:
        raise ValueError(f"collective kind {record.kind!r} has no HLO "
                         f"counterpart to account it as")
    nbytes = int(record.elements) * getattr(torch, record.dtype).itemsize
    if op in ("all-gather", "reduce-scatter"):
        n = int(record.group_size)
        if n <= 0:
            raise ValueError(f"{op} record {record.path} has no group size")
        nbytes = nbytes * n if op == "all-gather" else nbytes // n
    return op, nbytes


def recorded_collective_stats(records: Sequence) -> CollectiveStats:
    """Count one rank's :class:`~horovod_tpu_torch.analysis.
    collective_walk.CollectiveRecord` s by HLO op name, bytes as
    :func:`record_op_bytes` gives them (the port's
    ``optimized_collective_stats`` / ``emitted_collective_stats``: a
    record is one issued collective, as an emitted op is one traced)."""
    counts: Dict[str, int] = {}
    bytes_: Dict[str, int] = {}
    kept = []
    for r in records:
        ob = record_op_bytes(r)
        if ob is None:
            continue
        op, b = ob
        counts[op] = counts.get(op, 0) + 1
        bytes_[op] = bytes_.get(op, 0) + b
        kept.append(r)
    return CollectiveStats(counts=counts, bytes=bytes_, records=tuple(kept))


def split_gradient_stats(stats: CollectiveStats
                         ) -> Tuple[CollectiveStats, CollectiveStats]:
    """``(gradient stats, sync stats)`` of one rank's step: the records
    the optimizer's exchange issued (a record's ``path`` names the first
    port frame outside the exchange layer, here a module of ``optim/``),
    and the rest (the loss average, BatchNorm's statistics sums)."""
    grads = [r for r in stats.records if r.path.startswith("optim.")]
    rest = [r for r in stats.records if not r.path.startswith("optim.")]
    return recorded_collective_stats(grads), recorded_collective_stats(rest)


def step_collective_stats(build: Callable[..., Tuple[Any, Sequence]], *args,
                          world: int, rank: int = 0, device=None,
                          hierarchical: Optional[Tuple[int, int]] = None
                          ) -> CollectiveStats:
    """Rank ``rank``'s stats in a ``world``-rank recording world:
    ``build(*args) -> (step, step_args)`` builds the step inside the
    world (``device``: ``init()``'s, ``"cpu"`` or ``"cuda"``;
    ``hierarchical=(n_dcn, n_ici)`` lays it out in two levels), and
    ``step(*step_args)`` runs once under the collective recorder
    (``analysis.trace_audit.record_rank``, the step audit's loop)."""
    from ..analysis.trace_audit import record_rank
    return recorded_collective_stats(record_rank(
        build, *args, world=world, rank=rank, device=device,
        hierarchical=hierarchical))


def updates_in_place(step: Callable, *args, params,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> bool:
    """True when one ``step(*args)`` leaves every parameter and
    optimizer-state tensor in the storage it had (``data_ptr``): the
    update is in place, with no second copy of the state -- the port's
    form of ``has_buffer_donation`` (its steps take no ``donate``).

    ``params`` is a module (its parameters are read again after the
    step, so a rebound attribute shows) or the parameters; the optimizer
    is ``optimizer`` or the step's (``step._meta["optimizer"]``).  A
    first step runs before the check, to build the optimizer's state."""
    if optimizer is None:
        optimizer = (getattr(step, "_meta", None) or {}).get("optimizer")

    def tensors() -> List[torch.Tensor]:
        out = list(params.parameters()) \
            if isinstance(params, torch.nn.Module) else list(params)
        if optimizer is not None:
            for state in optimizer.state.values():
                out += [v for _, v in sorted(state.items())
                        if isinstance(v, torch.Tensor)]
        return out

    if not isinstance(params, torch.nn.Module):
        params = list(params)
    step(*args)
    before = [t.data_ptr() for t in tensors()]
    step(*args)
    after = [t.data_ptr() for t in tensors()]
    return before == after


# ---------------------------------------------------------------------------
# Overlap evidence timed on the device.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScheduleReport:
    """Overlap evidence from one rank's profiled step."""
    sync_collectives: list          # (op, payload_bytes, kernel_idx)
    async_collectives: list         # (op, payload_bytes, issue_idx, wait_idx)
    async_window_seconds: float     # kernel time inside the async windows
    total_compute_seconds: float    # kernel time of the whole step
    n_instructions: int             # the step's kernels
    n_devices: int = 0              # world the step was recorded in

    @property
    def sync_bytes(self) -> int:
        return sum(b for _, b, _ in self.sync_collectives)

    @property
    def async_bytes(self) -> int:
        return sum(b for _, b, _, _ in self.async_collectives)

    @staticmethod
    def _eq_payload(ops, n: int) -> float:
        """Result bytes -> EQUIVALENT allreduce payload (the B in
        2B(n-1)/n), so traffic can be projected to other mesh sizes with
        the same ring law.  Per-op result-bytes semantics differ: a
        ``collective-permute`` result is LINK bytes (one hop); an
        ``all-gather``/``all-to-all`` result is the full payload B
        (link B(n-1)/n = HALF an allreduce of the same B); a
        ``reduce-scatter`` result is the B/n shard."""
        if n <= 1:
            return float(sum(b for _, b in ops))
        ring = 2.0 * (n - 1) / n
        eq = 0.0
        for op, b in ops:
            if op in ("all-gather", "all-to-all"):
                eq += b / 2.0
            elif op == "all-reduce":
                eq += b            # result bytes == full payload == B
            elif op == "reduce-scatter":
                eq += b * n / 2.0  # result is B/n shard; link = B(n-1)/n
            else:                  # permute: result bytes ARE link bytes
                eq += b / ring
        return eq

    def async_eq_payload(self) -> float:
        """Async traffic as equivalent allreduce payload.  Requires
        ``n_devices``."""
        return self._eq_payload(
            [(op, b) for op, b, _, _ in self.async_collectives],
            self.n_devices)

    def sync_eq_payload(self) -> float:
        """Sync traffic as equivalent allreduce payload.  Identical to
        ``sync_bytes`` when every sync collective is an all-reduce (the
        usual case); differs once sync all-to-all / all-gather appear
        (e.g. the fp8 exchange codec on a plain-DP config)."""
        return self._eq_payload(
            [(op, b) for op, b, _ in self.sync_collectives],
            self.n_devices)


_ISSUE, _WAIT = "hvd.issue#", "hvd.wait#"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The exchange layer: a collective's issuing call is the outermost frame
# of these directories around its dispatch.
_EXCHANGE_DIRS = tuple(os.path.join(_PKG_DIR, d) + os.sep
                       for d in ("collectives", "adasum"))


def _issuing_call(frame):
    """The outermost exchange-layer frame of the run of them around a
    dispatch (frames outside the package, torch's, may sit between)."""
    outer = None
    while frame is not None:
        fname = frame.f_code.co_filename
        if fname.startswith(_EXCHANGE_DIRS):
            outer = frame
        elif fname.startswith(_PKG_DIR) and outer is not None:
            break
        frame = frame.f_back
    return outer


def _on_stack(target) -> bool:
    frame = sys._getframe(1)
    while frame is not None:
        if frame is target:
            return True
        frame = frame.f_back
    return False


def _works(out) -> list:
    """The ``torch.distributed`` works a c10d op returned."""
    from torch.distributed.distributed_c10d import Work
    found = []

    def walk(x):
        if isinstance(x, torch.ScriptObject):
            if x._type().qualified_name().endswith("Work"):
                found.append(Work.unbox(x))
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
    walk(out)
    return found


def _timed_recorder():
    """A :class:`~horovod_tpu_torch.analysis.collective_walk.
    CollectiveRecorder` that also runs ``torch.profiler`` over its block
    (CUDA activity on a ``cuda`` world), marks each collective's issue (a
    ``record_function`` range around its dispatch) and, through the
    handle layer's ``wait_observer``, its first wait, and sorts it into
    sync (the issuing call is on the waiting thread's stack) or async."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..analysis.collective_walk import C10D_OPS, CollectiveRecorder
    from ..collectives import ops
    from ..core.state import global_state

    class TimedRecorder(CollectiveRecorder):
        def __init__(self):
            super().__init__()
            self.issues: Dict[int, int] = {}     # issue mark -> record
            self.synced: Dict[int, bool] = {}    # record -> sync?
            self.events = None
            self.device_type = "cpu"
            self._marks = itertools.count()
            self._pending: Dict[int, tuple] = {}
            self._prof = self._observer = None

        def __enter__(self):
            dev = global_state().device
            self.device_type = dev.type if dev is not None else "cpu"
            acts = [ProfilerActivity.CPU]
            if self.device_type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._observer, ops.wait_observer = ops.wait_observer, \
                self.on_wait
            return super().__enter__()

        def __exit__(self, *exc):
            try:
                super().__exit__(*exc)
            finally:
                ops.wait_observer = self._observer
                if self.device_type == "cuda":
                    torch.cuda.synchronize()
                self._prof.__exit__(*exc)
            self.events = self._prof.profiler.kineto_results.events()
            self._pending.clear()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func._schema.name.split("::", 1)[-1] \
                if getattr(func, "namespace", "") == "c10d" else ""
            if name not in C10D_OPS:
                return func(*args, **kwargs)
            mark = next(self._marks)
            with record_function(f"{_ISSUE}{mark}"):
                index = self._record(name, list(args) + list(kwargs.values()))
                out = func(*args, **kwargs)
            if index is not None:
                self.issues[mark] = index
                call = _issuing_call(sys._getframe(1))
                for w in _works(out):
                    self._pending[id(w)] = (w, index, threading.get_ident(),
                                            call)
            return out

        def on_wait(self, work) -> None:
            entry = self._pending.pop(id(work), None)
            if entry is None:
                return
            _, index, thread, call = entry
            sync = (thread == threading.get_ident() and call is not None
                    and _on_stack(call))
            with record_function(f"{_WAIT}{index}"):
                pass
            self.synced.setdefault(index, sync)

    return TimedRecorder()


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def _kernels(events, device_type) -> List[Tuple[int, int]]:
    """``(launch ns, duration ns)`` of the step's kernels from the
    profiler's raw events, sorted by launch.  On ``cuda``: every device
    activity but annotations and memory records, each placed at the CPU
    time of its launch, the runtime call (a CPU event linked to an op)
    of the same correlation id; a kernel with no such call raises, since
    any other placement (its device start, an op's) moves the windows.
    On the CPU: every ``aten::`` op no other ``aten::`` op on its thread
    encloses."""
    from torch.autograd import DeviceType
    out = []
    if device_type == "cuda":
        runtime: Dict[int, int] = {}
        kernels = []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if not _is_annotation(e) and not e.name().startswith("["):
                    kernels.append(e)
            elif (e.device_type() == DeviceType.CPU
                  and e.linked_correlation_id() > 0
                  and e.correlation_id() > 0):
                runtime.setdefault(e.correlation_id(), e.start_ns())
        unmatched = [k.name() for k in kernels
                     if k.correlation_id() not in runtime]
        if unmatched:
            raise RuntimeError(
                f"{len(unmatched)} of {len(kernels)} device kernels have no "
                f"runtime launch event of their correlation id in the "
                f"profile (first: {unmatched[0]!r}); their launch times "
                f"are unknown")
        for k in kernels:
            out.append((runtime[k.correlation_id()],
                        k.end_ns() - k.start_ns()))
        return sorted(out)
    ops = sorted((e.start_thread_id(), e.start_ns(), -e.end_ns())
                 for e in events if e.device_type() == DeviceType.CPU
                 and e.name().startswith("aten::"))
    thread, top_end = None, 0
    for tid, begin, neg_end in ops:
        if tid != thread or begin >= top_end:
            thread, top_end = tid, -neg_end
            out.append((begin, top_end - begin))
    return sorted(out)


def step_overlap_report(build: Callable[..., Tuple[Any, Sequence]], *args,
                        world: int, device=None,
                        hierarchical: Optional[Tuple[int, int]] = None
                        ) -> ScheduleReport:
    """Overlap evidence of rank 0's step in a ``world``-rank recording
    world (``build``, ``device`` and ``hierarchical`` as
    :func:`step_collective_stats` takes them): after one warm-up step,
    one step runs under the recorder and ``torch.profiler`` (CUDA
    activity on the card, CPU ops on the CPU).  The warm-up builds what a
    first step builds once -- the optimizer's state, the kernels' and
    cuDNN's caches -- so the profiled step is a steady one.

    Each collective is *sync* when the exchange call that issued it
    waits on it before returning (the loss average, BatchNorm's
    statistics sums), and *async* when its handle outlives that call and
    is waited on later (a planned bucket issued from a gradient hook and
    waited on in ``synchronize()``).  ``async_window_seconds`` is the
    device time of the kernels launched between an async collective's
    issue and its first wait, a kernel counted once however many windows
    hold it; ``total_compute_seconds`` that of every kernel of the step
    (on the CPU: the top-level ``aten::`` ops' CPU time).  The ``fake``
    backend launches nothing, so every kernel is the step's own.  Indices
    are kernel positions: how many kernels launched before the issue (and
    the wait)."""
    from torch.autograd import DeviceType

    from ..analysis.trace_audit import record_rank

    rec = _timed_recorder()
    records = record_rank(build, *args, world=world, device=device,
                          hierarchical=hierarchical, recorder=rec,
                          warmup=1)
    issue: Dict[int, Tuple[int, int]] = {}
    wait: Dict[int, int] = {}
    for e in rec.events:
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith(_ISSUE):
            index = rec.issues.get(int(name[len(_ISSUE):]))
            if index is not None:
                issue[index] = (e.start_ns(), e.end_ns())
        elif name.startswith(_WAIT):
            index = int(name[len(_WAIT):])
            wait[index] = min(wait.get(index, e.start_ns()), e.start_ns())
    kernels = _kernels(rec.events, rec.device_type)
    launches = [t for t, _ in kernels]
    in_window = [False] * len(kernels)
    sync, async_ = [], []
    for index, r in enumerate(records):
        ob = record_op_bytes(r)
        if ob is None:
            continue
        if index not in issue:
            raise RuntimeError(f"collective {index} ({r.path}) has no issue "
                               f"mark in the profile")
        start, end = issue[index]
        first = bisect.bisect_left(launches, start)
        if rec.synced.get(index, True) or index not in wait:
            sync.append((ob[0], ob[1], first))
            continue
        last = bisect.bisect_left(launches, wait[index])
        async_.append((ob[0], ob[1], first, last))
        for j in range(bisect.bisect_left(launches, end), last):
            in_window[j] = True
    return ScheduleReport(
        sync_collectives=sync, async_collectives=async_,
        async_window_seconds=1e-9 * sum(
            d for (_, d), w in zip(kernels, in_window) if w),
        total_compute_seconds=1e-9 * sum(d for _, d in kernels),
        n_instructions=len(kernels), n_devices=int(world))


def predict_efficiency_scheduled(step_seconds: float, report: ScheduleReport,
                                 chip: "ChipSpec",
                                 ns: Tuple[int, ...] = (
                                     1, 2, 4, 8, 16, 32, 64, 128, 256),
                                 bandwidth_derate: float = 1.0):
    """Efficiency from the measured schedule: sync collective time is
    fully exposed; async collective time hides up to the compute the
    step actually launched inside the windows (measured at the report's
    n, assumed n-invariant -- per-rank compute is fixed in DP scaling).

    ``bandwidth_derate`` > 1 divides the effective link bandwidth for the
    ASYNC traffic, to quote a headline at a pessimistic link model as
    well: if the window still covers the comm there, the overlap
    conclusion does not rest on the bandwidth model.
    """
    out = []
    for n in ns:
        t_sync = allreduce_seconds(report.sync_eq_payload(), n, chip)
        t_async = bandwidth_derate * allreduce_seconds(
            report.async_eq_payload(), n, chip)
        exposed = t_sync + max(0.0, t_async - report.async_window_seconds)
        out.append(EfficiencyPoint(
            n=n, comm_seconds=t_sync + t_async,
            eff_no_overlap=step_seconds / (step_seconds + t_sync + t_async),
            eff_full_overlap=step_seconds / (step_seconds + exposed)))
    return out


# ---------------------------------------------------------------------------
# Analytic efficiency model.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Published per-device numbers plus the one ASSUMED constant (the
    per-device share of the inter-node network), kept explicit.  The
    field names are the JAX package's: on a GPU ``ici`` is the NVLink
    domain (the GPUs of one NVLink switch fabric) and ``dcn`` the
    inter-node NIC."""
    name: str
    bf16_tflops: float         # published peak (dense)
    ici_gbps: float            # published aggregate per-GPU NVLink (both dirs)
    ici_domain_chips: int      # GPUs in one NVLink domain
    dcn_gbps_per_chip: float   # ASSUMED: NIC Gbps per GPU

    @property
    def ici_allreduce_bytes_per_s(self) -> float:
        """Effective allreduce bandwidth inside the NVLink domain.

        A bidirectional ring allreduce streams the 2B(n-1)/n wire bytes
        through each GPU's links; of the published aggregate (all links,
        both directions) at most HALF is usable in one direction, so the
        model charges ici_gbps/2.
        """
        return self.ici_gbps / 2 / 8 * 1e9

    @property
    def dcn_allreduce_bytes_per_s(self) -> float:
        return self.dcn_gbps_per_chip / 2 / 8 * 1e9

    def links(self) -> Dict[str, float]:
        """The two rates as the plan IR's cost model takes them
        (``controller.fusion.leg_cost_seconds``' ``links``), bytes/s."""
        return {"ici": self.ici_allreduce_bytes_per_s,
                "dcn": self.dcn_allreduce_bytes_per_s}


# Published: NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 80GB
# (989 dense bf16 TFLOP/s; NVLink 4 at 900 GB/s = 7,200 Gbps per GPU,
# both directions); eight GPUs on one NVLink switch fabric in an HGX
# H100 8-GPU board.  The NIC share ASSUMES a DGX H100: one 400 Gbps
# ConnectX-7 NDR port per GPU.
H100_SXM = ChipSpec("h100-sxm", 989.0, 7200.0, 8, 400.0)


def ring_allreduce_seconds(nbytes: float, n: int, bw: float) -> float:
    """Ring allreduce wall time: 2B(n-1)/n wire bytes per chip at bw."""
    if n <= 1:
        return 0.0
    return 2.0 * nbytes * (n - 1) / n / bw


def allreduce_seconds(nbytes: float, n: int, chip: ChipSpec) -> float:
    """Allreduce time on n GPUs: a ring inside one NVLink domain;
    two-level beyond it (in-domain reduce-scatter -> NIC allreduce on the
    shard -> in-domain allgather, the ``hierarchical_allreduce``
    schedule)."""
    if n <= chip.ici_domain_chips:
        return ring_allreduce_seconds(nbytes, n, chip.ici_allreduce_bytes_per_s)
    s = chip.ici_domain_chips
    g = (n + s - 1) // s               # DCN groups (full domains)
    ici = 2.0 * nbytes * (s - 1) / s / chip.ici_allreduce_bytes_per_s
    dcn = ring_allreduce_seconds(nbytes / s, g,
                                 chip.dcn_allreduce_bytes_per_s)
    return ici + dcn


@dataclasses.dataclass
class EfficiencyPoint:
    n: int
    comm_seconds: float
    eff_no_overlap: float      # worst case: collectives fully exposed
    eff_full_overlap: float    # best case: hidden behind the backward pass


def predict_efficiency(step_seconds: float, wire_bytes: float,
                       chip: ChipSpec, ns: Tuple[int, ...] = (
                           1, 2, 4, 8, 16, 32, 64, 128, 256),
                       backward_fraction: float = 2.0 / 3.0):
    """Efficiency curve for a data-parallel step.

    ``step_seconds``: measured single-card step time (the compute that
    perfect scaling preserves).  ``wire_bytes``: per-rank collective
    payload from the accounting (the allreduce input bytes B; the ring
    moves 2B(n-1)/n of traffic).  Bounds:

    * no overlap:   eff = step / (step + t_ar)
    * full overlap: eff = step / (step + max(0, t_ar - backward_fraction
      * step)) -- collectives hide behind the backward pass, which is
      ~2/3 of fwd+bwd FLOPs; anything beyond it is exposed.
    """
    out = []
    for n in ns:
        t_ar = allreduce_seconds(wire_bytes, n, chip)
        exposed = max(0.0, t_ar - backward_fraction * step_seconds)
        out.append(EfficiencyPoint(
            n=n, comm_seconds=t_ar,
            eff_no_overlap=step_seconds / (step_seconds + t_ar),
            eff_full_overlap=step_seconds / (step_seconds + exposed)))
    return out
