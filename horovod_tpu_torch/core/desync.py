"""Desync detection and the cross-rank corruption tripwire.

The port's counterpart of ``horovod_tpu/core/desync.py``.  Every rank
holds what it believes is a replica of the model state; a bug (a missed
broadcast after a restore, a non-deterministic update) or a flipped bit
silently diverges the replicas until the loss explodes.

* :func:`check_desync` (``HOROVOD_CHECK_DESYNC=1``): CRC32 of every
  leaf's host bytes, the checksum vectors allgathered over the ranks,
  :class:`~horovod_tpu_torch.core.exceptions.DesyncError` naming the
  leaves that differ.  ``TorchState.commit()`` runs it before the
  snapshot it would overwrite.
* :func:`tripwire_check` (``HOROVOD_DESYNC_CHECK_STEPS=n``, every n
  commits): one position-weighted bit checksum a rank
  (:func:`_traced_bit_checksum` of each leaf, combined ``c * 31 + leaf``
  over the leaves), allgathered; the host majority-votes and raises
  :class:`~horovod_tpu_torch.core.exceptions.CorruptRankError` naming
  the minority rank(s), which the elastic loop quarantines.  The JAX
  package checksums each DEVICE's replica inside one program; the port
  has one device a rank, so its vector is per rank.
* :func:`corrupt_replica`: the chaos ``bitflip`` kind's consumer.

Trees are nested dicts (keys sorted, as ``jax.tree.leaves`` visits
them), lists and tuples of tensors, numpy arrays and scalars; ``None``
is an empty subtree.  :func:`module_tree` gives a model the flax
variables' shape -- ``{"params": ..., "batch_stats": ...}`` nested by the
dotted names, 4-D ``.kernel`` leaves in flax's HWIO layout -- so a port
model's leaves, their order and their bytes are the JAX package's.
"""

from __future__ import annotations

import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .exceptions import CorruptRankError, DesyncError

_MASK32 = 0xFFFFFFFF
_KNUTH = 2654435761


def _flatten_with_path(tree, path: str = "", out=None):
    """``[(jax keystr path, leaf)]`` in ``jax.tree.leaves`` order."""
    out = [] if out is None else out
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_path(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_with_path(v, f"{path}[{i}]", out)
    else:
        out.append((path, tree))
    return out


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return [v for _, v in _flatten_with_path(tree)]


def _nest(named) -> dict:
    """``{dotted name: leaf}`` pairs as a tree nested by the name's
    parts."""
    root: dict = {}
    for name, leaf in named:
        parts = name.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return root


def module_tree(model: torch.nn.Module) -> dict:
    """``model``'s parameters and buffers as flax variables: ``{"params":
    ..., "batch_stats": ...}`` nested by their dotted names, 4-D
    ``.kernel`` leaves as HWIO views (``models.convert.to_flax_layout``).
    The leaves are views of the live tensors."""
    from ..models.convert import to_flax_layout
    out = {"params": _nest((n, to_flax_layout(n, t.detach()))
                           for n, t in model.named_parameters())}
    buffers = list(model.named_buffers())
    if buffers:
        out["batch_stats"] = _nest((n, to_flax_layout(n, t.detach()))
                                   for n, t in buffers)
    return out


def optimizer_tree(optimizer: torch.optim.Optimizer,
                   model: Optional[torch.nn.Module] = None) -> dict:
    """``optimizer``'s state as a tree keyed by each parameter's dotted
    name in ``model`` (nested, flax layout as :func:`module_tree`), else
    by its position in the param groups.  Per-rank state (an
    error-feedback wrap's residuals) is not in ``optimizer.state``."""
    from ..models.convert import to_flax_layout
    names = {id(p): n for n, p in model.named_parameters()} \
        if model is not None else {}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    named = []
    for i, p in enumerate(params):
        st = optimizer.state.get(p)
        if st:
            name = names.get(id(p), str(i))
            named.append((name, {
                k: (to_flax_layout(name, v.detach())
                    if torch.is_tensor(v) and v.shape == p.shape else v)
                for k, v in st.items()}))
    return _nest(named)


def _canonical_bytes(obj, _depth: int = 0) -> bytes:
    """Deterministic, version-stable byte encoding of a non-array leaf:
    type-tagged reprs for scalars, recursive tagged encodings for
    containers (dict items and set elements sorted by their encoding),
    an object's instance state -- never a repr that embeds an address,
    never pickle bytes, which change across Python and numpy versions."""
    if _depth > 64:
        raise TypeError("leaf nests too deeply for canonical encoding")
    if obj is None or isinstance(obj, (bool, int)):
        return f"{type(obj).__name__}:{obj!r}".encode()
    if isinstance(obj, float):
        return b"float:" + repr(obj).encode()
    if isinstance(obj, complex):
        return (b"complex:" + repr(obj.real).encode() + b"," +
                repr(obj.imag).encode())
    if isinstance(obj, str):
        return b"str:" + obj.encode("utf-8", "surrogatepass")
    if isinstance(obj, (bytes, bytearray)):
        return b"bytes:" + bytes(obj)
    if isinstance(obj, (list, tuple)):
        parts = [_canonical_bytes(v, _depth + 1) for v in obj]
        tag = b"list" if isinstance(obj, list) else b"tuple"
        return tag + b"[" + b";".join(parts) + b"]"
    if isinstance(obj, dict):
        items = sorted(
            (_canonical_bytes(k, _depth + 1),
             _canonical_bytes(v, _depth + 1)) for k, v in obj.items())
        return b"dict{" + b";".join(k + b"=" + v for k, v in items) + b"}"
    if isinstance(obj, (set, frozenset)):
        parts = sorted(_canonical_bytes(v, _depth + 1) for v in obj)
        return b"set{" + b";".join(parts) + b"}"
    state = getattr(obj, "__dict__", None)
    if isinstance(state, dict):
        return (b"obj:" + type(obj).__qualname__.encode()
                + _canonical_bytes(state, _depth + 1))
    raise TypeError(f"no canonical encoding for {type(obj).__qualname__}")


def _host_bytes(leaf) -> bytes:
    """A leaf's host bytes: a tensor's (any dtype, bf16 included), else
    ``np.asarray``'s, as the JAX package reads them."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(leaf))
    if a.dtype == object:
        raise TypeError
    return a.tobytes()


def _leaf_checksum(leaf) -> int:
    """Stable CRC32 of a leaf's host bytes; a leaf with no array view
    through :func:`_canonical_bytes`, and one with no canonical encoding
    by its type name alone (under-checked, never a false positive)."""
    try:
        return zlib.crc32(_host_bytes(leaf))
    except (TypeError, ValueError):
        pass
    try:
        return zlib.crc32(_canonical_bytes(leaf))
    except Exception:  # noqa: BLE001 - unencodable leaf
        return zlib.crc32(type(leaf).__qualname__.encode())


def tree_checksums(tree: Any) -> Tuple[List[str], np.ndarray]:
    """(leaf paths, per-leaf CRC32 vector) of a tree."""
    flat = _flatten_with_path(tree)
    paths = [p or "<root>" for p, _ in flat]
    sums = np.array([_leaf_checksum(v) for _, v in flat], dtype=np.int64)
    return paths, sums


def mismatched_rows(rows: np.ndarray, paths: List[str]) -> List[str]:
    """Leaf paths whose checksum differs across the rank rows."""
    if rows.size == 0:
        return []
    diff = (rows != rows[0:1]).any(axis=0)
    return [p for p, d in zip(paths, diff) if d]


def _gather_rows(values: np.ndarray, process_set=None) -> np.ndarray:
    """Every member's int64 vector ``values``, one row a member in rank
    order (an allgather on the world's device)."""
    from ..collectives.ops import allgather
    from .process_sets import get_process_set
    from .state import global_state
    ps = get_process_set(process_set)
    local = torch.as_tensor(values, dtype=torch.int64).reshape(1, -1)
    out = allgather(local.to(global_state().device), process_set=ps)
    return out.cpu().numpy().reshape(ps.size(), -1)


def check_desync(tree: Any, name: str = "state", process_set=None,
                 raise_error: bool = True) -> List[str]:
    """Verify ``tree`` is bit-identical on every member of the set: each
    rank CRC32s its host view of every leaf, the vectors are allgathered
    and compared.  Returns the paths of the leaves that differ (and
    raises :class:`DesyncError` naming them unless
    ``raise_error=False``)."""
    paths, sums = tree_checksums(tree)
    if not paths:
        return []
    rows = _gather_rows(sums, process_set)
    bad = mismatched_rows(rows, paths)
    if bad and raise_error:
        raise DesyncError(
            f"desync detected in {name!r}: {len(bad)} leaf/leaves differ "
            f"across ranks: {bad[:8]}{'...' if len(bad) > 8 else ''} -- a "
            f"replica of the model state has diverged (missed broadcast "
            f"after restore, or non-deterministic update?)", leaves=bad)
    return bad


def maybe_check(tree: Any, name: str = "state",
                process_set=None) -> Optional[List[str]]:
    """:func:`check_desync` when ``HOROVOD_CHECK_DESYNC`` is on."""
    from .state import global_state
    st = global_state()
    if not st.initialized or st.config is None or not st.config.check_desync:
        return None
    return check_desync(tree, name=name, process_set=process_set)


# --- cross-rank corruption tripwire (SDC defense plane) -------------------


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """The tensor's elements as int32 words, as the JAX checksum reads
    them: bool as 0/1; 32- and 64-bit dtypes bitcast (64-bit ones as two
    words each, low first); narrower floats bitcast to their integer
    width and sign-extended; narrower integers by value."""
    x = x.detach().contiguous().reshape(-1)
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    nbytes = x.element_size()
    if nbytes >= 4:
        return x.view(torch.int32)
    if x.is_floating_point():
        narrow = torch.int16 if nbytes == 2 else torch.int8
        return x.view(narrow).to(torch.int32)
    return x.to(torch.int32)


def _traced_bit_checksum(x: torch.Tensor) -> torch.Tensor:
    """The uint32 position-weighted wrapping bit sum of a tensor (as a
    0-dim int64 on its device): ``sum(u[i] * (i * 2654435761 | 1)) mod
    2**32`` over its words ``u``, the JAX package's function of the same
    name.  Exact in any reduction order; the odd weights make a
    permutation of the same values visible.  torch has few uint32 ops, so
    the arithmetic is int64 with each product taken mod 2**32 from the
    weight's 16-bit halves, so no product overflows."""
    u = _bits32(x).to(torch.int64) & _MASK32
    n = u.numel()
    if not n:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    w = ((torch.arange(n, dtype=torch.int64, device=u.device) * _KNUTH)
         & _MASK32) | 1
    prod = (u * (w & 0xFFFF) + (((u * (w >> 16)) & 0xFFFF) << 16)) \
        & _MASK32
    return prod.sum() & _MASK32


def local_checksum(tree: Any) -> int:
    """This rank's tripwire checksum of ``tree``: ``c = c * 31 + leaf``
    mod 2**32 over its tensor leaves in flax leaf order (the 31x combine
    keeps leaf order significant).  One device-to-host read."""
    leaves = [t for t in tree_leaves(tree) if torch.is_tensor(t)]
    if not leaves:
        return 0
    sums = [_traced_bit_checksum(t) for t in leaves]
    vals = torch.stack(sums).tolist() \
        if len({s.device for s in sums}) == 1 else [int(s) for s in sums]
    c = 0
    for s in vals:
        c = (c * 31 + int(s)) & _MASK32
    return c


def tripwire_check(tree: Any, name: str = "params", process_set=None,
                   raise_error: bool = True) -> List[int]:
    """Cross-rank corruption tripwire: every rank checksums its replica
    of ``tree`` (:func:`local_checksum`), the values are allgathered, and
    a rank whose checksum disagrees with the strict majority holds a
    corrupt replica (a flipped bit: finite values the numeric guard
    cannot see).  Returns the minority ranks and raises
    :class:`CorruptRankError` naming them (unless ``raise_error=False``)
    for the elastic plane to quarantine.  Without a strict majority no
    rank can be named: the error carries an empty list (a plain desync:
    restore)."""
    from ..timeline import metrics as _metrics

    rows = _gather_rows(np.array([local_checksum(tree)]),
                        process_set).reshape(-1)
    reg = _metrics.registry()
    reg.counter("horovod_guard_tripwire_checks_total",
                "Cross-rank corruption tripwire samples").inc()
    vals, counts = np.unique(rows, return_counts=True)
    if len(vals) <= 1:
        return []
    reg.counter("horovod_guard_tripwire_trips_total",
                "Tripwire samples that found divergent replicas").inc()
    majority = vals[np.argmax(counts)]
    bad = [] if counts.max() * 2 <= rows.size else \
        [int(i) for i in np.nonzero(rows != majority)[0]]
    if raise_error:
        raise CorruptRankError(
            f"corruption tripwire: {name!r} replicas diverge across the "
            f"ranks (checksums {rows.tolist()}); "
            + (f"minority rank(s) {bad} attributed for quarantine"
               if bad else "no strict majority, cannot attribute"),
            ranks=bad)
    return bad


def corrupt_replica(tree: Any, rank: int, bit: int = 0) -> Any:
    """Flip bit ``bit`` of byte 0 of the first floating leaf of ``tree``
    (flax leaf order) in place on rank ``rank``; every other rank does
    nothing.  The chaos ``bitflip`` kind's consumer: a finite
    perturbation (the mantissa's lowest bit for little-endian floats)
    that only the tripwire can see.  Returns ``tree``."""
    from .basics import _require_init
    st = _require_init()
    if not 0 <= int(rank) < st.size:
        raise ValueError(f"rank {rank} outside a world of {st.size}")
    leaf = next((t for t in tree_leaves(tree) if torch.is_tensor(t)
                 and t.is_floating_point() and t.numel()), None)
    if leaf is None:
        raise ValueError("corrupt_replica: no floating leaf to corrupt")
    if st.rank == int(rank):
        with torch.no_grad():
            # Element [0, ..., 0] of a view of any layout is its storage
            # offset; its bytes, little-endian, start with byte 0.
            elem = leaf.as_strided((1,), (1,), leaf.storage_offset())
            byte0 = elem.view(torch.uint8)[:1]
            byte0.bitwise_xor_(1 << (int(bit) & 7))
    return tree
