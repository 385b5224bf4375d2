"""Recording mechanics for the step auditor: the recording world, the
collective recorder, and the rank comparison.

Counterpart of ``horovod_tpu/analysis/jaxpr_walk.py``.  The JAX auditor
traces a step and walks the collective primitives of its jaxpr; the port
has no jaxpr, so it runs the step once on every rank of a **recording
world** instead -- ``torch.distributed``'s ``fake`` backend, which opens
a world of any size in one process at any rank, and whose collectives
return at once and move nothing (each rank's own input comes back) --
and records every ``c10d`` op the step dispatches
(:class:`CollectiveRecorder`, a ``TorchDispatchMode``).  That is the
port's "trace, never execute" of the exchange.

Every rank gets the same arguments, built from one seed, so a difference
between two ranks' sequences can only come from code that reads the
rank: :func:`compare_ranks` is the port's form of the JAX taint walk from
``axis_index`` (the desync check).  Everything here is mechanics, with no
planner knowledge; :mod:`.trace_audit` turns the records into findings.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import os
import sys
import threading
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# c10d op -> (kind, index of the operand whose size the wire moves).
# ``kind`` uses the JAX primitive names, as the plan rows' audit tuples
# do; an all-reduce's kind follows its reduce op (:func:`_reduce_kind`).
C10D_OPS: Dict[str, Tuple[str, int]] = {
    "allreduce_": ("psum", 0),
    "allreduce_coalesced_": ("psum", 0),
    "_allgather_base_": ("all_gather", 1),
    "allgather_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "_reduce_scatter_base_": ("reduce_scatter", 1),
    "reduce_scatter_": ("reduce_scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
    "alltoall_base_": ("all_to_all", 1),
    "alltoall_": ("all_to_all", 1),
    "send": ("ppermute", 0),
    "recv_": ("ppermute", 0),
    "recv_any_source_": ("ppermute", 0),
    "broadcast_": ("broadcast", 0),
    "reduce_": ("reduce", 0),
    "gather_": ("gather", 1),
    "scatter_": ("scatter", 1),
    "barrier": ("barrier", 0),
    "monitored_barrier_": ("barrier", 0),
}

# The kernel wrapper modules: a collective dispatched while one of their
# launching functions is on the stack would sit inside a kernel's
# contract, which declares every family collective-free.
KERNEL_MODULES = ("ops/attention.py", "ops/bn.py", "ops/fused_update.py")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Frames a record's ``path`` skips: this package, and the exchange layer
# (every collective is issued there; the caller is the informative frame).
_SKIP_DIRS = tuple(os.path.join(_PKG_DIR, d) + os.sep
                   for d in ("analysis", "collectives", "adasum"))


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective a rank's step dispatched.

    ``elements`` is the element count of the operand the wire moves (an
    all-gather's shard, a reduce-scatter's whole input: the JAX record's
    first operand); ``dtype`` its dtype name.  ``path`` is the first
    frame of ``horovod_tpu_torch`` outside its exchange layer on the
    Python stack (``module:function:line``: the exchange's caller) and
    the record's index, ``group`` a
    rank-invariant name of the process group (``world``, or the member
    offsets from the lowest member, so rank 0's and rank 2's in-node
    groups compare equal), ``in_kernel`` whether a kernel wrapper was on
    the stack, ``group_size`` the group's rank count."""
    kind: str
    dtype: str
    elements: int
    path: str
    group: str
    in_kernel: bool = False
    group_size: int = 0

    def sig(self) -> Tuple[str, str, int]:
        return (self.kind, self.dtype, self.elements)

    def rank_sig(self) -> Tuple[str, str, int, str]:
        return (self.kind, self.dtype, self.elements, self.group)


# -- the recording world ----------------------------------------------------

def _fake_store():
    """A ``FakeStore`` (importing it registers the ``fake`` backend).
    ``torch.testing._internal`` is internal, so this is its one import
    in the package, and a torch without it fails here, loudly."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the step audit's recording world needs torch's 'fake' "
            "process-group backend (torch.testing._internal.distributed."
            f"fake_pg), which this torch does not have: {e}") from e
    return FakeStore()


@contextlib.contextmanager
def recording_world(world: int, rank: int, *, device=None,
                    hierarchical: Optional[Tuple[int, int]] = None):
    """Rank ``rank`` of a ``world``-rank recording world, for the
    ``with`` block: ``init_process_group("fake")`` then the port's
    ``init(device=device)``, which adopts the open group; with
    ``hierarchical=(n_dcn, n_ici)`` the world is laid out in two levels
    (``HOROVOD_HIERARCHICAL=n_dcn,n_ici``).  On exit ``shutdown()`` and
    every group destroyed, so no ``new_group`` survives into the next
    world."""
    from ..core import basics
    from ..core.state import global_state
    if dist.is_initialized() or global_state().initialized:
        raise RuntimeError("recording_world: a process group or the "
                           "framework is already initialized")
    # init_process_group wraps sys.excepthook with a rank prefix; a
    # process opening many worlds would stack one prefix a world.
    hook = sys.excepthook
    dist.init_process_group("fake", rank=int(rank), world_size=int(world),
                            store=_fake_store())
    sys.excepthook = hook
    try:
        basics.init(device=device)
        if hierarchical is not None:
            st = global_state()
            st.config = dataclasses.replace(
                st.config, hierarchical=f"{int(hierarchical[0])},"
                                        f"{int(hierarchical[1])}")
        yield
    finally:
        basics.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()


# -- the recorder -----------------------------------------------------------

_kernel_codes: Optional[FrozenSet[Tuple[str, str]]] = None


def _launching_functions(path: str) -> List[str]:
    """Names of the functions in ``path`` that count a kernel launch
    (call ``note_launch``): the kernel wrappers."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    fn = sub.func
                    name = fn.attr if isinstance(fn, ast.Attribute) else \
                        fn.id if isinstance(fn, ast.Name) else ""
                    if name == "note_launch":
                        out.append(node.name)
                        break
    return out


def kernel_wrappers() -> FrozenSet[Tuple[str, str]]:
    """``{(file, function)}`` of the kernel wrappers of
    :data:`KERNEL_MODULES` (read once from their source)."""
    global _kernel_codes
    if _kernel_codes is None:
        codes = set()
        for rel in KERNEL_MODULES:
            path = os.path.join(_PKG_DIR, rel)
            codes.update((path, fn) for fn in _launching_functions(path))
        _kernel_codes = frozenset(codes)
    return _kernel_codes


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _operand(args, index: int) -> Optional[torch.Tensor]:
    """The tensor at ``args[index]`` (the first of a list, flattened),
    else the first tensor anywhere in ``args``."""
    def first(x):
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (list, tuple)):
            for y in x:
                t = first(y)
                if t is not None:
                    return t
        return None
    if index < len(args):
        t = first(args[index])
        if t is not None:
            return t
    return first(list(args))


def _script_objects(args, suffix: str) -> list:
    return [a for a in args if isinstance(a, torch.ScriptObject)
            and a._type().qualified_name().endswith(suffix)]


def _reduce_kind(args) -> str:
    ops = _script_objects(args, "ReduceOp")
    if not ops:
        return "psum"
    code = int(ops[0].op())
    names = {int(dist.ReduceOp.MAX): "pmax", int(dist.ReduceOp.MIN): "pmin",
             int(dist.ReduceOp.PRODUCT): "pprod"}
    return names.get(code, "psum")


def _group(args) -> Tuple[str, int]:
    """``(rank-invariant name, rank count)`` of the op's process group."""
    groups = _script_objects(args, "ProcessGroup")
    if not groups:
        return "?", 0
    try:
        pg = dist.ProcessGroup.unbox(groups[0])
        ranks = dist.get_process_group_ranks(pg)
    except Exception:               # noqa: BLE001 - a torch without unbox
        return "?", 0
    if len(ranks) == dist.get_world_size():
        return "world", len(ranks)
    base = min(ranks)
    return "+" + ",".join(str(r - base) for r in sorted(ranks)), len(ranks)


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec:`` records every ``c10d`` op
    dispatched in the block, from any thread (a backward hook's included),
    into ``rec.records``.  An op is recorded where it is issued, once: an
    ``async_op=True`` call and its ``Work.wait()`` are one record.  The
    sends and receives of one ``batch_isend_irecv`` are one ``ppermute``
    record (a ring's rank both sends and receives)."""

    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []
        self._lock = threading.Lock()
        self._kernels = kernel_wrappers()
        self._batch = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "namespace", "") == "c10d":
            name = func._schema.name.split("::", 1)[-1]
            if name in C10D_OPS:
                self._record(name, list(args) + list(kwargs.values()))
        return func(*args, **kwargs)

    def _record(self, name: str, args) -> Optional[int]:
        """Record one c10d op; its index in ``records``, or ``None`` for
        a send or receive folded into its batch's record."""
        kind, index = C10D_OPS[name]
        if kind == "psum":
            kind = _reduce_kind(args)
        t = _operand(args, index)
        if name == "reduce_scatter_" and isinstance(args[1], list) and \
                args[1] and isinstance(args[1][0], list):
            elements = sum(x.numel() for x in args[1][0])
        else:
            elements = int(t.numel()) if t is not None else 0
        where, in_kernel, batch = self._stack()
        group, group_size = _group(args)
        with self._lock:
            if kind == "ppermute" and batch is not None and \
                    batch == self._batch:
                return None
            self._batch = batch if kind == "ppermute" else None
            self.records.append(CollectiveRecord(
                kind=kind,
                dtype=_dtype_name(t.dtype) if t is not None else "?",
                elements=elements, path=f"{where}#{len(self.records)}",
                group=group, in_kernel=in_kernel, group_size=group_size))
            return len(self.records) - 1

    def _stack(self):
        """``(first port frame, kernel wrapper on the stack, the
        batch_isend_irecv frame or None)``."""
        where, in_kernel, batch = "?", False, None
        frame = sys._getframe(2)
        while frame is not None:
            code = frame.f_code
            fname = code.co_filename
            if code.co_name == "batch_isend_irecv" and batch is None:
                batch = id(frame)
            if fname.startswith(_PKG_DIR):
                if where == "?" and not fname.startswith(_SKIP_DIRS):
                    mod = os.path.relpath(fname, _PKG_DIR)[:-3].replace(
                        os.sep, ".")
                    where = f"{mod}:{code.co_name}:{frame.f_lineno}"
                if (fname, code.co_name) in self._kernels:
                    in_kernel = True
            frame = frame.f_back
        return where, in_kernel, batch


# -- the rank comparison (desync) ------------------------------------------

@dataclasses.dataclass(frozen=True)
class DesyncRecord:
    """The first index where rank ``rank``'s collective sequence leaves
    rank ``ref``'s (a differing ``(kind, dtype, elements, group)``, or
    one sequence ending first): code that reads the rank chose another
    collective, or none -- the static form of Horovod's runtime mismatch
    stall."""
    ref: int
    rank: int
    index: int
    want: str
    got: str


def _describe(r: Optional[CollectiveRecord]) -> str:
    if r is None:
        return "<end of sequence>"
    return f"{r.kind} {r.dtype}[{r.elements}] on {r.group} at {r.path}"


def compare_ranks(records_by_rank: Sequence[Sequence[CollectiveRecord]]
                  ) -> List[DesyncRecord]:
    """One :class:`DesyncRecord` per rank whose sequence differs from
    rank 0's, at the first index where it does."""
    out: List[DesyncRecord] = []
    if not records_by_rank:
        return out
    ref = list(records_by_rank[0])
    for rank, recs in enumerate(records_by_rank[1:], 1):
        recs = list(recs)
        for i in range(max(len(ref), len(recs))):
            a = ref[i] if i < len(ref) else None
            b = recs[i] if i < len(recs) else None
            if a is None or b is None or a.rank_sig() != b.rank_sig():
                out.append(DesyncRecord(0, rank, i, _describe(a),
                                        _describe(b)))
                break
    return out
