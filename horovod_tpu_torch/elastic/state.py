"""Elastic state objects: commit / restore / sync / resize.

Counterpart of ``horovod_tpu/elastic/state.py`` (``State``,
``ObjectState``, ``JaxState``) and of the JAX shim's
``torch_api/elastic_state.py::TorchState`` (reference:
``horovod/torch/elastic/state.py``).  A :class:`State` snapshots its
values in host memory on ``commit()`` (no disk), rolls back on
``restore()`` after a failed collective, and ``sync()``\\ s from rank 0
after a re-rendezvous so new and restarted workers adopt the survivors'
progress.

:class:`TorchState` stands where the JAX package has ``JaxState``: the
port's trees are tensors.  It takes ``TorchState(model=None,
optimizer=None, **kwargs)``: the model's and optimizer's ``state_dict``
state, and kwargs that are tensor trees (nested dicts, lists and tuples:
flax-style params, BN statistics), a ZeRO-1 :class:`~horovod_tpu_torch.
optim.zero.ZeroState` (``step.zero_state``), or scalars.

* ``commit()`` ticks the chaos clock, snapshots everything to host
  memory (``.cpu()`` copies: the snapshot survives the loss of device
  state), pushes the snapshot ledger (``HOROVOD_SNAPSHOT_STEPS``), then
  checks for a new membership epoch -- so a ``HostsUpdatedInterrupt``
  comes after the snapshot, and an injected fault before it.  State
  that is sharded or per rank -- a ZeRO-1 state, the error-feedback
  residuals of a ``DistributedOptimizer`` -- is gathered from every rank
  (collective) so a resize can carry the lost ranks' part; the commit of
  the constructor and of ``sync()`` snapshot this rank's part alone
  (those commits run where a newly joined worker and the survivors are
  not at the same collective).
* ``restore()`` copies the snapshot back IN PLACE: the parameters,
  buffers, optimizer state tensors, residuals and ZeRO shards that the
  optimizer, a live step or a captured train loop hold stay the same
  objects.  ``rollback()`` goes back further, through the ledger.
* ``sync()`` broadcasts rank 0's values (``broadcast_`` / the object
  broadcast), then commits.
* ``resize(old, new)`` re-lays the gathered ZeRO-1 state
  (:func:`~horovod_tpu_torch.optim.zero.zero_resize`) and re-buckets the
  error-feedback residuals (:func:`~horovod_tpu_torch.optim.distributed.
  ef_resize_residuals`) for the new world, counted in
  ``horovod_ef_residual_recovered_bytes``.  A ZeRO-1 state is bound to
  its world: after a re-init, rebuild the step and hand its new state to
  :meth:`TorchState.bind_zero`, which loads the resized snapshot into it.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import torch

from ..data.tree import tree_leaves, tree_map

# Snapshot-ledger ring depth (entries, not steps), as in the JAX package.
LEDGER_DEPTH = 4


def _config():
    from ..core.state import global_state
    st = global_state()
    return st.config if st.initialized else None


def _snapshot_steps() -> int:
    """HOROVOD_SNAPSHOT_STEPS from the live config (0 = ledger off)."""
    cfg = _config()
    return max(0, int(cfg.snapshot_steps)) if cfg is not None else 0


def _is_scalar(v) -> bool:
    return isinstance(v, (int, float, str, bool)) or v is None


def _host(tree):
    """A host copy of a tensor tree (every tensor ``.cpu()``-cloned)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if torch.is_tensor(t) else copy.deepcopy(t), tree)


def _same_layout(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.is_tensor(x) and torch.is_tensor(y) and x.shape == y.shape
        and x.dtype == y.dtype for x, y in zip(la, lb))


@torch.no_grad()
def _copy_into(live, saved):
    """Copy a host snapshot into the live tree in place; a live tree of
    another layout is replaced by copies on its first tensor's device
    (the CPU when it holds none)."""
    if _same_layout(live, saved):
        tree_map(lambda d, s: d.copy_(s) if torch.is_tensor(d) else None,
                 live, saved)
        return live
    devs = [t.device for t in tree_leaves(live) if torch.is_tensor(t)]
    dev = devs[0] if devs else torch.device("cpu")
    return tree_map(lambda s: s.to(dev, copy=True) if torch.is_tensor(s)
                    else copy.deepcopy(s), saved)


def _optimizer_snapshot(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's state tensors (host copies) and param-group
    hyperparameters, keyed by parameter position."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return {
        "state": {i: {k: (v.detach().to("cpu", copy=True)
                          if torch.is_tensor(v) else copy.deepcopy(v))
                      for k, v in opt.state[p].items()}
                  for i, p in enumerate(params) if p in opt.state},
        "devices": {i: {k: v.device for k, v in opt.state[p].items()
                        if torch.is_tensor(v)}
                    for i, p in enumerate(params) if p in opt.state},
        "groups": [{k: copy.deepcopy(v) for k, v in g.items()
                    if k != "params"} for g in opt.param_groups],
    }


@torch.no_grad()
def _optimizer_restore(opt: torch.optim.Optimizer, snap: dict) -> None:
    """Load an optimizer snapshot in place: existing state tensors are
    copied into, missing ones created on the device they were committed
    from, entries the snapshot lacks dropped."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        saved = snap["state"].get(i)
        if saved is None:
            opt.state.pop(p, None)
            continue
        live = opt.state[p]
        for k in [k for k in live if k not in saved]:
            del live[k]
        for k, v in saved.items():
            cur = live.get(k)
            if not torch.is_tensor(v):
                live[k] = copy.deepcopy(v)
            elif torch.is_tensor(cur) and cur.shape == v.shape and \
                    cur.dtype == v.dtype:
                cur.copy_(v)
            else:
                live[k] = v.to(snap["devices"][i][k], copy=True)
    for g, hp in zip(opt.param_groups, snap["groups"]):
        g.update(copy.deepcopy(hp))


class State:
    """Base elastic state: commit/restore/sync + reset listeners."""

    def __init__(self):
        self._reset_callbacks: List[Callable[[], None]] = []
        # Successful-commit counter (the run loop tells a persistent
        # desync from a recovered one by it).
        self._commit_count = 0

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        from ..timeline import metrics as _metrics
        _metrics.registry().counter(
            "horovod_elastic_reset_total",
            "Elastic state resets (rank-change recoveries)").inc()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp=None, update_res=None) -> None:
        """Hook invoked when the driver announces a topology change."""
        from ..timeline import metrics as _metrics
        _metrics.registry().counter(
            "horovod_elastic_host_updates_total",
            "Elastic host-set update notifications").inc()

    def _tick_chaos(self) -> None:
        """The chaos clock ticks at the start of a commit: an injected
        fault fires before the snapshot, so the drill rolls back to the
        commit before and replays the steps between."""
        from . import chaos
        chaos.on_commit()

    def _check_host_updates(self) -> None:
        """Raise HostsUpdatedInterrupt at the commit boundary if the
        driver advanced the membership epoch; the snapshot is already
        saved, so no progress is lost."""
        self._commit_count += 1
        from .run_loop import check_for_host_updates
        check_for_host_updates(self)

    def commit(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError


class ObjectState(State):
    """Elastic state over plain Python attributes (pickle-synced).

    Reference: ``horovod/common/elastic.py::ObjectState``."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._known = list(kwargs)
        self.commit()

    def commit(self) -> None:
        self._tick_chaos()
        self._saved = {k: copy.deepcopy(getattr(self, k))
                       for k in self._known}
        self._check_host_updates()

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self) -> None:
        from ..optim.functions import broadcast_object
        values = {k: getattr(self, k) for k in self._known}
        values = broadcast_object(values, root_rank=0)
        for k, v in values.items():
            setattr(self, k, v)
        self.commit()


class TorchState(State):
    """Elastic state of a torch model, optimizer, tensor trees, ZeRO-1
    states and scalars::

        state = hvd.elastic.TorchState(model=model, optimizer=opt,
                                       batch=0, epoch=0)

    See the module docstring for what each call does."""

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 **kwargs):
        super().__init__()
        from ..optim.zero import ZeroState
        self.model = model
        self.optimizer = optimizer
        self._tree_keys: List[str] = []
        self._scalar_keys: List[str] = []
        self._zero_keys: List[str] = []
        for k, v in kwargs.items():
            setattr(self, k, v)
            if isinstance(v, ZeroState):
                self._zero_keys.append(k)
            elif _is_scalar(v):
                self._scalar_keys.append(k)
            else:
                self._tree_keys.append(k)
        self._saved: Dict[str, Any] = {}
        self._ledger: List[Dict[str, Any]] = []
        self._gather = False
        self.last_resize: Optional[Dict[str, Any]] = None
        self.commit()
        self._gather = True

    # -- what is per rank -------------------------------------------------
    def _ef_optimizer(self):
        from ..optim.distributed import is_ef_optimizer
        opt = self.optimizer
        return opt if opt is not None and is_ef_optimizer(opt) else None

    def _rank_world(self):
        from ..core.state import global_state
        st = global_state()
        return (st.rank, st.size) if st.initialized else (0, 1)

    def _stack_local(self, tensors):
        """This rank's tensors as the rows of a one-rank stack, at its
        position in a world of its size (other rows zero): what a
        bootstrap commit can say without a collective."""
        rank, n = self._rank_world()
        out = []
        for t in tensors:
            s = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype)
            s[rank] = t.detach().cpu()
            out.append(s)
        return tuple(out)

    def _snapshot(self) -> Dict[str, Any]:
        from ..optim import zero as _zero
        snap: Dict[str, Any] = {
            "scalars": {k: copy.deepcopy(getattr(self, k))
                        for k in self._scalar_keys},
            "trees": {k: _host(getattr(self, k)) for k in self._tree_keys},
        }
        if self.model is not None:
            snap["model"] = {k: v.detach().to("cpu", copy=True)
                             for k, v in self.model.state_dict().items()}
        if self.optimizer is not None:
            snap["optimizer"] = _optimizer_snapshot(self.optimizer)
        # Per-rank state: gathered from every rank, else (a bootstrap
        # commit) the last snapshot's when it is of this world, else this
        # rank's row alone.  "gathered" says whether other ranks' rows
        # are real, i.e. whether sync() may hand rank 0's to everyone.
        old = self._saved
        _, n = self._rank_world()
        snap["gathered"] = self._gather
        ef = self._ef_optimizer()
        if ef is not None:
            if self._gather:
                from ..collectives.ops import allgather
                snap["ef"] = tuple(
                    allgather(r.detach().reshape((1,) + tuple(r.shape))
                              .contiguous()).cpu()
                    for r in ef.residuals)
            elif old.get("ef") is not None and \
                    old["ef"][0].shape[0] == n:
                snap["ef"] = old["ef"]
                snap["gathered"] = old["gathered"]
            else:
                snap["ef"] = self._stack_local(ef.residuals)
        snap["zero"] = {}
        for k in self._zero_keys:
            zs = getattr(self, k)
            if self._gather and zs.spec.world == n:
                snap["zero"][k] = _zero.zero_stack(zs)
            elif k in old.get("zero", {}) and \
                    _stack_world(old["zero"][k]) == n:
                snap["zero"][k] = old["zero"][k]
                snap["gathered"] = old["gathered"]
            else:
                snap["zero"][k] = self._local_zero(zs)
        return snap

    def _local_zero(self, zs):
        """A stacked ZeRO-1 state holding this rank's row only."""
        from ..optim.zero import StackedZeroState
        rank, n = self._rank_world()

        def stack(v):
            if not torch.is_tensor(v):
                return v
            return self._stack_local([v])[0]

        inner = [{k: stack(v) for k, v in sorted(
            zs.inner.state.get(s, {}).items())} for s in zs.shards]
        res = None if zs.residuals is None else \
            self._stack_local(zs.residuals)
        return StackedZeroState(res, inner)

    # -- commit / restore -------------------------------------------------
    def commit(self) -> None:
        self._tick_chaos()
        # Built whole before it replaces the last snapshot: a gather that
        # fails (a peer died) leaves the last commit intact.
        self._saved = self._snapshot()
        self._ledger_push()
        self._check_host_updates()

    def _ledger_push(self) -> None:
        """Ring-buffer the snapshot just taken, every
        ``HOROVOD_SNAPSHOT_STEPS`` commits (entry 0 is the constructor's
        commit, so a rollback floor always exists).  Snapshots are never
        mutated in place, so an entry aliases its tensors."""
        n = _snapshot_steps()
        if n <= 0 or self._commit_count % n:
            return
        self._ledger.append({"commit": self._commit_count,
                             "saved": dict(self._saved)})
        while len(self._ledger) > LEDGER_DEPTH:
            self._ledger.pop(0)

    def rollback(self, before_commit: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
        """Roll back to the newest ledger entry with ``commit <=
        before_commit`` (None: the newest), drop the newer entries,
        install it as the committed snapshot and restore it.  Returns a
        report, or None when the ledger has no eligible entry (the caller
        falls back to ``restore()``)."""
        entry = None
        while self._ledger:
            e = self._ledger[-1]
            if before_commit is None or e["commit"] <= int(before_commit):
                entry = e
                break
            self._ledger.pop()
        if entry is None:
            return None
        self._saved = dict(entry["saved"])
        from ..timeline import metrics as _metrics
        _metrics.registry().counter(
            "horovod_guard_rollbacks_total",
            "Snapshot-ledger rollbacks (sustained anomaly / corrupt "
            "replica recoveries)").inc()
        self.restore()
        return {"commit": entry["commit"], "depth": len(self._ledger)}

    def restore(self) -> None:
        """Copy the last commit back in place (see the module
        docstring); exports the steps rolled back as
        ``horovod_elastic_steps_to_recover``."""
        saved = self._saved
        lost = 0
        for k, old in saved["scalars"].items():
            cur = getattr(self, k, None)
            if (isinstance(cur, int) and not isinstance(cur, bool)
                    and isinstance(old, int) and not isinstance(old, bool)):
                lost = max(lost, cur - old)
        if lost > 0:
            from ..timeline import metrics as _metrics
            _metrics.registry().gauge(
                "horovod_elastic_steps_to_recover",
                "Steps rolled back to the last commit during the most "
                "recent elastic recovery").set(float(lost))
        with torch.no_grad():
            if self.model is not None and "model" in saved:
                live = self.model.state_dict()
                for k, v in saved["model"].items():
                    live[k].copy_(v)
            if self.optimizer is not None and "optimizer" in saved:
                _optimizer_restore(self.optimizer, saved["optimizer"])
            self._load_per_rank(saved)
        for k, v in saved["trees"].items():
            setattr(self, k, _copy_into(getattr(self, k), v))
        for k, v in saved["scalars"].items():
            setattr(self, k, copy.deepcopy(v))

    @torch.no_grad()
    def _load_per_rank(self, saved) -> None:
        """This rank's row of the EF residuals and of every ZeRO-1 state
        whose world matches the snapshot's, in place."""
        from ..optim.zero import zero_load
        rank, n = self._rank_world()
        ef = self._ef_optimizer()
        if ef is not None and saved.get("ef") is not None and \
                saved["ef"][0].shape[0] == n:
            for r, s in zip(ef.residuals, saved["ef"]):
                r.copy_(s[rank])
        for k, stacked in saved.get("zero", {}).items():
            zs = getattr(self, k)
            if zs.spec.world == n and _stack_world(stacked) == n:
                zero_load(zs, stacked)

    def bind_zero(self, key: str, zero_state) -> None:
        """Track ``zero_state`` (a rebuilt step's ZeRO-1 state for the
        current world) under ``key`` and load the committed (resized)
        snapshot into it."""
        from ..optim.zero import zero_load
        if key not in self._zero_keys:
            self._zero_keys.append(key)
        setattr(self, key, zero_state)
        stacked = self._saved.get("zero", {}).get(key)
        if stacked is not None and \
                _stack_world(stacked) == zero_state.spec.world:
            zero_load(zero_state, stacked)

    # -- resize / sync ----------------------------------------------------
    def _ef_leaves(self, ef):
        return [ef._flax_view(i, p) for i, p in enumerate(ef._trainable)]

    def resize(self, old_size: int, new_size: int, *,
               zero_keys: Optional[List[str]] = None,
               fusion_threshold: Optional[int] = None,
               compression=None) -> Dict[str, Any]:
        """Checkpointless carry-state reconstruction after a world-size
        change (the JAX ``JaxState.resize``): the committed ZeRO-1 states
        (``zero_keys``, default every one) are re-laid out and the
        error-feedback residuals re-bucketed for ``new_size``, carrying
        the lost ranks' part; this rank's row of the residuals is loaded
        into the optimizer in place (a ZeRO-1 state loads when its
        rebuilt step's state is bound, :meth:`bind_zero`).  Replicated
        values are untouched -- ``sync()`` broadcasts them.  Returns
        ``{"old_size", "new_size", "resized", "carried_bytes",
        "zeroed_buckets"}``."""
        from ..optim import distributed as _dist
        from ..optim import zero as _zero
        report: Dict[str, Any] = {
            "old_size": int(old_size), "new_size": int(new_size),
            "resized": [], "carried_bytes": 0, "zeroed_buckets": 0,
        }
        if int(old_size) == int(new_size):
            return report
        saved = dict(self._saved)
        ef = self._ef_optimizer()
        if ef is not None and saved.get("ef") is not None:
            new_res, rep = _dist.ef_resize_residuals(
                saved["ef"], self._ef_leaves(ef), old_size, new_size,
                fusion_threshold=(fusion_threshold if fusion_threshold
                                  is not None else ef._fusion_threshold),
                compression=(compression if compression is not None
                             else ef._compression))
            saved["ef"] = new_res
            report["resized"].append("optimizer")
            report["carried_bytes"] += rep["carried_bytes"]
            report["zeroed_buckets"] += rep["zeroed_buckets"]
        zkeys = set(zero_keys) if zero_keys is not None else \
            set(self._zero_keys)
        zero = dict(saved.get("zero", {}))
        for k in self._zero_keys:
            if k not in zkeys or k not in zero:
                continue
            params = self._zero_params(getattr(self, k))
            zero[k], rep = _zero.zero_resize(zero[k], params, old_size,
                                             new_size)
            report["resized"].append(k)
            report["carried_bytes"] += rep["carried_bytes"]
            report["zeroed_buckets"] += rep["zeroed_buckets"]
        saved["zero"] = zero
        self._saved = saved
        self._load_per_rank(saved)
        self.last_resize = report
        if report["resized"]:
            from ..timeline import metrics as _metrics
            _metrics.registry().counter(
                "horovod_ef_residual_recovered_bytes",
                "Bytes of optimizer/EF carry state reconstructed "
                "checkpointlessly across elastic resizes").inc(
                    report["carried_bytes"])
        return report

    @staticmethod
    def _zero_params(zs):
        """Leaves with the arena plan's shapes and dtypes (the plan is a
        pure function of them)."""
        shapes = [None] * zs.spec.num_leaves
        for buf in zs.spec.buffers:
            for s in buf.leaves:
                shapes[s.index] = torch.empty(s.shape, dtype=buf.dtype,
                                              device="meta")
        return shapes

    def sync(self) -> None:
        """Broadcast rank 0's model, optimizer, trees, per-rank
        snapshots and scalars, then commit (this rank's part only)."""
        from ..core.basics import _require_init
        from ..optim.functions import _broadcast_tensors_, broadcast_object
        st = _require_init()
        with torch.no_grad():
            if self.model is not None:
                _broadcast_tensors_(
                    list(self.model.state_dict().values()), 0)
            if self.optimizer is not None:
                _sync_optimizer(self.optimizer, st.device)
            for k in self._tree_keys:
                tree = getattr(self, k)
                leaves = [t for t in tree_leaves(tree) if torch.is_tensor(t)]
                if all(t.device == st.device for t in leaves):
                    _broadcast_tensors_(leaves, 0)
                else:
                    setattr(self, k, _copy_into(tree, broadcast_object(
                        _host(tree), root_rank=0)))
        # Rank 0's per-rank snapshot, when it holds every rank's rows
        # (after a gathered commit, or a resize of one): a worker that
        # joined late adopts its row from it.
        per_rank = broadcast_object(
            {"ef": self._saved.get("ef"),
             "zero": self._saved.get("zero", {}),
             "gathered": self._saved.get("gathered", False)}, root_rank=0)
        if per_rank["gathered"]:
            self._saved = dict(self._saved, **per_rank)
            self._load_per_rank(self._saved)
        scalars = broadcast_object(
            {k: getattr(self, k) for k in self._scalar_keys}, root_rank=0)
        for k, v in scalars.items():
            setattr(self, k, v)
        gather, self._gather = self._gather, False
        try:
            self.commit()
        finally:
            self._gather = gather


def _stack_world(stacked) -> Optional[int]:
    """The world a stacked ZeRO-1 state was gathered at (its leading
    axis), or None when it holds no tensor."""
    for t in tree_leaves(list(stacked.inner)) + \
            list(stacked.residuals or ()):
        if torch.is_tensor(t) and t.dim() >= 1:
            return int(t.shape[0])
    return None


@torch.no_grad()
def _sync_optimizer(opt: torch.optim.Optimizer, device) -> None:
    """Rank 0's optimizer state on every rank: the layout (which entries,
    their shapes, dtypes and devices) and host values travel as one
    object, the device tensors by broadcast in place -- a rank that
    joined late, with no state yet, gets rank 0's."""
    from ..optim.functions import _broadcast_tensors_, broadcast_object
    params = [p for g in opt.param_groups for p in g["params"]]
    layout, host = {}, {}
    for i, p in enumerate(params):
        for k, v in sorted(opt.state.get(p, {}).items()):
            if torch.is_tensor(v) and v.device.type == device.type:
                layout[(i, k)] = (tuple(v.shape), v.dtype)
            else:
                host[(i, k)] = v.detach().cpu() if torch.is_tensor(v) \
                    else v
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt.param_groups]
    layout, host, groups = broadcast_object((layout, host, groups),
                                            root_rank=0)
    keep = set(layout) | set(host)
    for i, p in enumerate(params):
        live = opt.state.get(p, {})
        for k in [k for k in live if (i, k) not in keep]:
            del live[k]
        if not live and p in opt.state:
            del opt.state[p]
    tensors = []
    for (i, k), (shape, dtype) in sorted(layout.items()):
        live = opt.state[params[i]]
        cur = live.get(k)
        if not (torch.is_tensor(cur) and tuple(cur.shape) == shape
                and cur.dtype == dtype and cur.device.type == device.type):
            live[k] = cur = torch.zeros(shape, dtype=dtype, device=device)
        tensors.append(cur)
    _broadcast_tensors_(tensors, 0)
    for (i, k), v in host.items():
        opt.state[params[i]][k] = v.clone() if torch.is_tensor(v) else v
    for g, hp in zip(opt.param_groups, groups):
        g.update(hp)
