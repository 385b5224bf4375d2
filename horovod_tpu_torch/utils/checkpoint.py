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

The sharded (orbax) calls are not ported (ROADMAP item 1.11): they
raise ``NotImplementedError``.
"""

from __future__ import annotations

import io
import os
import re
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


def save_checkpoint_sharded(directory: str, tree: Any, *,
                            step: int = 0) -> str:
    """Not ported: the orbax sharded checkpoint (ROADMAP item 1.11)."""
    raise NotImplementedError(
        "save_checkpoint_sharded (orbax) is not ported (ROADMAP item "
        "1.11); use save_checkpoint")


def restore_checkpoint_sharded(directory: str, like: Any, *,
                               step: Optional[int] = None
                               ) -> Tuple[Any, Optional[int]]:
    """Not ported: the orbax sharded checkpoint (ROADMAP item 1.11)."""
    raise NotImplementedError(
        "restore_checkpoint_sharded (orbax) is not ported (ROADMAP item "
        "1.11); use restore_checkpoint")
