"""Nested batches: tensors in tuples, lists and dicts.

``tree_map`` and ``tree_leaves`` walk them; ``stack_steps`` stacks k
per-step batches into the ``[k, batch, ...]`` layout of
``training.make_train_loop`` and ``DevicePrefetcher(stack_steps=k)``.
"""

from __future__ import annotations

from typing import Any, List

import torch


def tree_map(fn, *trees):
    """``fn`` over the tensors of nested tuples, lists and dicts."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def stack_steps(batches) -> Any:
    """Stack k per-step batches into the layout ``make_train_loop``
    takes: each tensor gains a leading steps axis ``[k, batch, ...]``."""
    batches = list(batches)
    if not batches:
        raise ValueError("stack_steps needs at least one batch")
    return tree_map(lambda *xs: torch.stack(xs), *batches)
