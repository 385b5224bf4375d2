"""Checkpoint/resume helpers: the rank-0-saves + broadcast idiom.

The port's copy of ``horovod_tpu/utils/checkpoint.py``.  The reference
ships no checkpoint format of its own -- its documented idiom is "rank 0
saves; on resume everyone restores and ``broadcast_parameters`` syncs".
These helpers codify it for trees of tensors (nested dicts, lists and
tuples -- a ``state_dict()`` is one):

* :func:`save_checkpoint`: rank ``root_rank`` atomically writes a flat npz
  of the tree's leaves; a collective status broadcast makes completion
  global (and turns a root-side failure into an error on every rank).
* :func:`restore_checkpoint`: rank ``root_rank`` reads, then every leaf
  is broadcast -- correct whether or not the path is on a shared
  filesystem.
* :func:`latest_checkpoint`: newest ``step``-stamped file in a directory.

The file is the JAX package's: the npz keys are the flattened tree paths
as ``jax.tree_util.keystr`` spells them (``['params']['w']``, ``[0]``;
``<root>`` for a bare leaf), leaves in ``jax.tree.leaves`` order (dict
keys sorted), and bfloat16 / float8 leaves stored as opaque void records
of their bytes, as numpy stores ``ml_dtypes`` arrays.  A checkpoint
written by either package restores bitwise in the other.

The sharded checkpoints (:func:`save_checkpoint_sharded` /
:func:`restore_checkpoint_sharded`) are for states too large to gather on
one rank.  The card machine has no orbax, so they have a format of their
own: ``<directory>/sharded_<step:010d>/shard_<rank>.npz`` (the npz
encoding above) and ``index.json`` (the step, the world, the keys each
shard holds), which rank 0 writes last, once every shard is on disk: a
step without an index is not a checkpoint.  A step saved again replaces
the old one whole (rank 0 removes it before any shard is written, as
orbax's ``force=True`` does), so a failed overwrite leaves no index over
a mix of new and old shards.  A replicated leaf is written
once, by rank ``i % world`` for the ``i``-th leaf in :func:`_flatten`
order; a :class:`~horovod_tpu_torch.optim.zero.ZeroState` in the tree is
per-rank state, written by every rank into its own shard (its arena
shards, its inner optimizer's state, its residuals).  Every rank reads
what it needs from the shard files, so the directory must be on a shared
filesystem, as orbax's is.  Neither package reads the other's sharded
checkpoint; the rank-0 npz is the format both read.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_STEP_KEY = "__hvd_tpu_step__"

# Dtypes numpy has no type for: stored as void records of their bytes,
# reinterpreted through an integer of the same width.
_OPAQUE = {torch.bfloat16: torch.int16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _OPAQUE[getattr(torch, _name)] = torch.uint8


def _flatten(tree: Any, path: str = "",
             out: Optional[List[Tuple[str, Any]]] = None
             ) -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in ``jax.tree.leaves`` order; ``None`` is an
    empty subtree, as in JAX."""
    if out is None:
        out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _flatten(x, f"{path}[{i}]", out)
    elif tree is not None:
        out.append((path or "<root>", tree))
    return out


def _unflatten(like: Any, values: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced by ``values``, in
    :func:`_flatten`'s order."""
    it = iter(values)

    def rebuild(t):
        if isinstance(t, dict):
            done = {k: rebuild(t[k]) for k in sorted(t)}
            return type(t)((k, done[k]) for k in t) \
                if type(t) is not dict else {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            items = [rebuild(x) for x in t]
            return type(t)(*items) if hasattr(t, "_fields") else \
                type(t)(items)
        return None if t is None else next(it)

    return rebuild(like)


def _to_numpy(v: Any) -> np.ndarray:
    """A leaf as the npz stores it."""
    if torch.is_tensor(v):
        t = v.detach().cpu().contiguous()
        if t.dtype in _OPAQUE:
            a = t.view(_OPAQUE[t.dtype]).numpy()
            return a.view(np.dtype(f"V{a.itemsize}"))
        return t.numpy()
    return np.asarray(v)


def _like_dtype(like: Any) -> torch.dtype:
    if torch.is_tensor(like):
        return like.dtype
    return torch.from_numpy(np.zeros((), np.asarray(like).dtype)).dtype


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The npz's array as a tensor of ``dtype`` (void records viewed back
    through the target's dtype, as the JAX restore does)."""
    if a.dtype.kind == "V":
        raw = a.view(np.dtype(f"i{a.itemsize}") if a.itemsize == 2
                     else np.uint8)
        return torch.from_numpy(raw.copy()).view(dtype)
    return torch.from_numpy(np.array(a)).to(dtype)


def checkpoint_path(directory: str, step: int,
                    prefix: str = "ckpt") -> str:
    return os.path.join(directory, f"{prefix}_{step:010d}.npz")


def save_checkpoint(path: str, tree: Any, *, step: Optional[int] = None,
                    root_rank: int = 0) -> str:
    """Rank ``root_rank`` writes ``tree`` to ``path`` (npz, atomic);
    everyone waits on a status broadcast, so a later restore sees a
    complete file and a failure on the root raises on every rank."""
    from ..core import basics as _basics
    from ..optim.functions import broadcast_object

    err = None
    if _basics.rank() == root_rank:
        try:
            payload = {k: _to_numpy(v) for k, v in _flatten(tree)}
            if step is not None:
                payload[_STEP_KEY] = np.asarray(step, np.int64)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            buf = io.BytesIO()
            np.savez(buf, **payload)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 - must reach every rank
            err = f"{type(e).__name__}: {e}"
    err = broadcast_object(err, root_rank=root_rank)
    if err:
        raise RuntimeError(f"checkpoint save failed on root: {err}")
    return path


def restore_checkpoint(path: str, like: Any, *,
                       root_rank: int = 0) -> Tuple[Any, Optional[int]]:
    """Restore a tree shaped ``like``; returns ``(tree, step)``.

    Rank ``root_rank`` reads the file; every leaf is then broadcast (on
    this rank's device), so only the root needs the file.  Leaves come
    back as tensors of ``like``'s dtypes, on ``like``'s devices (this
    rank's device where a ``like`` leaf is not a tensor).  Root-side
    read errors are broadcast as a status before any leaf, so every rank
    raises instead of the others waiting on a broadcast the root never
    joins."""
    from ..core import basics as _basics
    from ..optim.functions import _broadcast_tensors_, broadcast_object

    st = _basics._require_init()
    flat = _flatten(like)
    step = None
    err = None
    values = [torch.zeros(tuple(np.shape(v)), dtype=_like_dtype(v))
              for _, v in flat]
    if st.rank == root_rank:
        try:
            with np.load(path) as z:
                missing = [k for k, _ in flat if k not in z.files]
                if missing:
                    raise KeyError(
                        f"checkpoint {path!r} lacks {len(missing)} "
                        f"leaf/leaves of the restore target: {missing[:5]}")
                values = [_from_numpy(z[k], _like_dtype(v))
                          for k, v in flat]
                if _STEP_KEY in z.files:
                    step = int(z[_STEP_KEY])
        except Exception as e:  # noqa: BLE001 - must reach every rank
            err = f"{type(e).__name__}: {e}"
    err = broadcast_object(err, root_rank=root_rank)
    if err:
        exc = KeyError if err.startswith("KeyError") else RuntimeError
        raise exc(f"checkpoint restore failed on root: {err}")
    values = [v.to(st.device) for v in values]
    _broadcast_tensors_(values, root_rank)
    values = [v.to(like_v.device) if torch.is_tensor(like_v) else v
              for v, (_, like_v) in zip(values, flat)]
    step = broadcast_object(step, root_rank=root_rank)
    return _unflatten(like, values), step


def latest_checkpoint(directory: str,
                      prefix: str = "ckpt") -> Optional[str]:
    """Path of the highest-step checkpoint in ``directory`` (None: none)."""
    if not os.path.isdir(directory):
        return None
    best: Tuple[int, Optional[str]] = (-1, None)
    pat = re.compile(rf"^{re.escape(prefix)}_(\d+)\.npz$")
    for name in os.listdir(directory):
        m = pat.match(name)
        if m:
            best = max(best, (int(m.group(1)),
                              os.path.join(directory, name)))
    return best[1]


_INDEX = "index.json"
_SHARDED_DIR = re.compile(r"^sharded_(\d+)$")


def _sharded_path(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f"sharded_{step:010d}"))


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _zero_entries(key: str, zs) -> List[Tuple[str, Any]]:
    """A ``ZeroState``'s per-rank state as ``[(key, value)]``: its arena
    shards, its inner optimizer's state (tensors and host values, by
    shard and name) and its residuals."""
    out = [(f"{key}['shards'][{i}]", t) for i, t in enumerate(zs.shards)]
    for i, shard in enumerate(zs.shards):
        for name, v in sorted(zs.inner.state.get(shard, {}).items()):
            out.append((f"{key}['inner'][{i}][{name!r}]", v))
    out += [(f"{key}['residuals'][{i}]", t)
            for i, t in enumerate(zs.residuals or ())]
    return out


def save_checkpoint_sharded(directory: str, tree: Any, *,
                            step: int = 0) -> str:
    """Every rank writes its part of ``tree`` to
    ``<directory>/sharded_<step:010d>/shard_<rank>.npz``: the replicated
    leaves ``i`` with ``i % world == rank``, and every ``ZeroState``'s
    state of this rank.  Once every shard is written (an allgather of
    each rank's status), rank 0 writes ``index.json``, the commit
    marker; a step already on disk is removed first.  Collective: every
    rank calls it with the same ``step``.  Returns the step's directory;
    a failure on any rank raises on every rank."""
    from ..core.basics import _require_init
    from ..optim.functions import allgather_object, broadcast_object
    from ..optim.zero import ZeroState

    st = _require_init()
    path = _sharded_path(directory, step)
    payload, host = {}, []
    for i, (key, leaf) in enumerate(_flatten(tree)):
        if isinstance(leaf, ZeroState):
            for k, v in _zero_entries(key, leaf):
                payload[k] = _to_numpy(v)
                if not torch.is_tensor(v):
                    host.append(k)
        elif i % st.size == st.rank:
            payload[key] = _to_numpy(leaf)
    err = None
    if st.rank == 0 and os.path.exists(path):
        try:
            shutil.rmtree(path)
        except OSError as e:
            err = f"rank 0 removing the old step: {type(e).__name__}: {e}"
    # The barrier: no rank writes a shard until the old step is gone.
    err = broadcast_object(err, root_rank=0)
    if err:
        raise RuntimeError(f"sharded checkpoint save failed: [{err!r}]")
    try:
        os.makedirs(path, exist_ok=True)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        _atomic_write(os.path.join(path, f"shard_{st.rank}.npz"),
                      buf.getvalue())
    except OSError as e:
        err = f"rank {st.rank}: {type(e).__name__}: {e}"
    status = allgather_object((err, sorted(payload), host))
    errors = [e for e, _, _ in status if e]
    if not errors and st.rank == 0:
        index = {"step": int(step), "world": st.size,
                 "shards": {str(r): keys for r, (_, keys, _) in
                            enumerate(status)},
                 "host": sorted(k for _, _, h in status for k in h)}
        try:
            _atomic_write(os.path.join(path, _INDEX),
                          json.dumps(index, indent=1).encode())
        except OSError as e:
            errors.append(f"rank 0 index: {type(e).__name__}: {e}")
    errors = broadcast_object(errors, root_rank=0)
    if errors:
        raise RuntimeError(f"sharded checkpoint save failed: {errors}")
    return path


def _latest_sharded_step(directory: str) -> Optional[int]:
    """The newest step under ``directory`` that has an index."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _SHARDED_DIR.match(name)) and os.path.exists(
                 os.path.join(directory, name, _INDEX))]
    return max(steps) if steps else None


def restore_checkpoint_sharded(directory: str, like: Any, *,
                               step: Optional[int] = None
                               ) -> Tuple[Any, Optional[int]]:
    """Restore a tree shaped ``like`` from :func:`save_checkpoint_sharded`;
    returns ``(tree, step)``.  ``step=None`` takes the newest step with an
    index (rank 0's pick, broadcast); with none, ``(None, None)``.
    Leaves come back as tensors of ``like``'s dtypes on ``like``'s
    devices (this rank's device where a ``like`` leaf is not a tensor);
    a ``ZeroState`` in ``like`` is filled in place (its shards, its inner
    optimizer's state and residuals) and must have been saved at this
    world size -- another raises ``ValueError`` (``optim.zero.
    zero_resize`` re-lays such state).  A leaf the checkpoint lacks
    raises ``KeyError``."""
    from ..core.basics import _require_init
    from ..optim.functions import broadcast_object
    from ..optim.zero import ZeroState

    st = _require_init()
    if step is None:
        step = broadcast_object(_latest_sharded_step(directory)
                                if st.rank == 0 else None, root_rank=0)
        if step is None:
            return None, None
    path = _sharded_path(directory, step)
    with open(os.path.join(path, _INDEX)) as f:
        index = json.load(f)
    held = {int(r): set(keys) for r, keys in index["shards"].items()}
    owner = {k: r for r, keys in held.items() for k in keys}
    host = set(index.get("host", ()))
    files = {}

    def read(key: str, rank: Optional[int] = None) -> np.ndarray:
        """``key`` from its owner's shard, or from ``rank``'s (per-rank
        state, which every rank holds under the same keys)."""
        r = owner.get(key) if rank is None else rank
        if r is None or key not in held.get(r, ()):
            raise KeyError(f"sharded checkpoint {path!r} lacks {key}")
        if r not in files:
            files[r] = np.load(os.path.join(path, f"shard_{r}.npz"))
        return files[r][key]

    def load(key: str, like_v) -> torch.Tensor:
        t = _from_numpy(read(key), _like_dtype(like_v))
        return t.to(like_v.device if torch.is_tensor(like_v) else st.device)

    values = []
    try:
        for key, leaf in _flatten(like):
            if not isinstance(leaf, ZeroState):
                values.append(load(key, leaf))
                continue
            if index["world"] != st.size:
                raise ValueError(
                    f"{key} is ZeRO-1 state saved at world "
                    f"{index['world']}, restored at world {st.size}: "
                    f"re-lay it with optim.zero.zero_resize")
            _restore_zero(key, leaf, held.get(st.rank, set()), host,
                          lambda k: read(k, st.rank))
            values.append(leaf)
    finally:
        for z in files.values():
            z.close()
    return _unflatten(like, values), int(index["step"])


def _restore_zero(key: str, zs, keys: set, host: set, read) -> None:
    """Fill ``zs`` in place from this rank's shard (``keys``: what it
    holds; ``read(key)``): the arena shards and residuals, and every
    inner optimizer entry saved for them -- created where the optimizer
    has not stepped yet, on the shard's device (a 0-dim ``step`` on the
    host unless the optimizer is capturable, as torch keeps it)."""
    with torch.no_grad():
        for i, t in enumerate(zs.shards):
            t.copy_(_from_numpy(read(f"{key}['shards'][{i}]"), t.dtype))
        for i, t in enumerate(zs.residuals or ()):
            t.copy_(_from_numpy(read(f"{key}['residuals'][{i}]"), t.dtype))
        prefix = f"{key}['inner']["
        on_device = bool(zs.inner.param_groups[0].get("capturable")
                         or zs.inner.param_groups[0].get("fused"))
        for k in sorted(k for k in keys if k.startswith(prefix)):
            i, name = re.match(r"(\d+)\]\['(.+)'\]$",
                               k[len(prefix):]).groups()
            shard = zs.shards[int(i)]
            state = zs.inner.state[shard]
            a = read(k)
            if k in host:
                state[name] = a.item()
            elif torch.is_tensor(state.get(name)):
                state[name].copy_(_from_numpy(a, state[name].dtype))
            else:
                dtype = shard.dtype if a.dtype.kind == "V" else \
                    _like_dtype(np.zeros((), a.dtype))
                dev = shard.device if a.ndim or on_device else "cpu"
                state[name] = _from_numpy(a, dtype).to(dev)
