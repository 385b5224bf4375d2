"""Distributed-training estimators (``horovod/spark`` Estimator parity).

The port's counterpart of ``horovod_tpu/spark/estimator.py`` (reference
surface: ``horovod/spark/keras/KerasEstimator``,
``horovod/spark/torch/TorchEstimator``): an Estimator materializes a
DataFrame into rank-sharded intermediate storage (Petastorm in the
reference; npz shards under the :class:`Store` here -- the same files
with the same arrays as the JAX package writes), ``fit()`` launches
``num_proc`` workers that train with the port's
``DistributedOptimizer``, rank 0 checkpoints the result through the
Store, and the returned Model transforms new data with the trained
weights.

Workers are spawned through the local executor (one process per slot;
the Spark barrier-mode path under ``backend="spark"``) and run on the
GPU, or on the CPU over gloo when ``HVD_TPU_FORCE_CPU`` is set in the
caller's environment -- the switch ``init()`` reads.  ``TorchEstimator``
and ``LightningEstimator`` train a ``torch.nn.Module`` in the
``horovod.torch`` idiom; ``JaxEstimator`` (named after its JAX
counterpart) trains a port module with batch statistics through
:func:`~horovod_tpu_torch.training.make_flax_train_step`;
``KerasEstimator`` rides the :mod:`horovod_tpu_torch.keras` shim.

Input flexibility: ``fit`` accepts a dict of numpy arrays, a pandas
DataFrame + ``feature_cols``/``label_cols``, a pyspark DataFrame
(partitions STREAM to Store chunks through ``toLocalIterator`` -- the
driver never materializes the dataset, the Petastorm-scale path), or any
iterator/generator of such items (each item becomes one streamed chunk).
Pandas and Spark frames are duck-typed: this module imports neither.
"""

from __future__ import annotations

import io
import os
import pickle
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from .store import LocalStore, Store

__all__ = ["EstimatorParams", "JaxEstimator", "JaxModel", "TorchEstimator",
           "TorchModel", "KerasEstimator", "KerasModel",
           "LightningEstimator"]


# ---------------------------------------------------------------------------
# data plumbing
# ---------------------------------------------------------------------------

def _as_arrays(df, feature_cols, label_cols) -> Dict[str, np.ndarray]:
    """Normalize any supported input into {'features': ..., 'labels': ...}."""
    if isinstance(df, dict):
        return {"features": np.asarray(df["features"]),
                "labels": np.asarray(df["labels"])}
    if isinstance(df, (tuple, list)) and len(df) == 2:
        return {"features": np.asarray(df[0]), "labels": np.asarray(df[1])}
    # pyspark DataFrame? (duck-typed: has .toPandas and .sparkSession)
    if hasattr(df, "toPandas"):
        df = df.toPandas()
    # pandas DataFrame (duck-typed: has .loc and .columns)
    if hasattr(df, "columns") and hasattr(df, "loc"):
        if not feature_cols or not label_cols:
            raise ValueError("feature_cols and label_cols are required for "
                             "DataFrame input")
        feats = np.stack([np.stack(df[c].to_numpy())
                          for c in feature_cols], axis=-1)
        if feats.shape[-1] == 1:
            feats = feats[..., 0]
        labels = df[label_cols[0]].to_numpy() if len(label_cols) == 1 else \
            np.stack([df[c].to_numpy() for c in label_cols], axis=-1)
        return {"features": np.asarray(feats), "labels": np.asarray(labels)}
    raise TypeError(f"unsupported data input: {type(df).__name__}")


_CHUNK_ROWS = 65536   # flush threshold: the driver buffers at most this
                      # many rows per rank (+ one validation buffer)
_HASH_MULT = np.uint64(2654435761)  # Knuth multiplicative hash
_HASH_MASK = np.uint64(0xFFFFFFFF)


def _iter_chunks(df, feature_cols, label_cols, chunk_rows: int = _CHUNK_ROWS):
    """Yield normalized ``{'features','labels'}`` chunks WITHOUT
    materializing the dataset on the driver.

    The reference feeds workers from Petastorm shards written partition by
    partition (SURVEY.md 3.6); here the equivalents are:

    * pyspark DataFrame: rows stream through ``toLocalIterator()`` (the
      driver holds one partition at a time), buffered to ``chunk_rows``;
    * a generator/iterator of any supported item (dict of arrays,
      ``(x, y)`` tuple, pandas frame): each item is one chunk;
    * anything else (in-memory arrays / frames): one chunk -- the local
      fallback.
    """
    import itertools

    if hasattr(df, "toLocalIterator") and hasattr(df, "sparkSession"):
        rows = df.toLocalIterator()
        while True:
            buf = list(itertools.islice(rows, chunk_rows))
            if not buf:
                return
            import pandas as pd
            pdf = pd.DataFrame([r.asDict() for r in buf])
            yield _as_arrays(pdf, feature_cols, label_cols)
    elif hasattr(df, "__next__") or (
            hasattr(df, "__iter__")
            and not isinstance(df, (dict, tuple, list))
            and not hasattr(df, "shape") and not hasattr(df, "columns")):
        for item in df:
            yield _as_arrays(item, feature_cols, label_cols)
    else:
        yield _as_arrays(df, feature_cols, label_cols)


class _ShardWriter:
    """Streams row chunks into equal-length per-rank Store shards.

    Rows are assigned round-robin by train ordinal (balanced +
    shuffled-ish, like the old strided slice); every ``flush_rows`` rows a
    rank's buffer is written out as ``<train_path>.chunkNNNNN``, so driver
    memory is bounded by ``num_proc * flush_rows`` rows regardless of
    dataset size.  Validation rows are selected deterministically by a
    multiplicative hash of the global row index compared against the
    fraction -- any fraction is honored to ~1/2^32 resolution without
    driver-side shuffling or RNG state.

    Equal shard sizes are a CORRECTNESS requirement, not just balance:
    each worker's step count derives from its shard length, and a worker
    running one extra step would enter a collective its peers never join;
    :meth:`finish` trims the ragged tail (rewriting a flushed last chunk
    when necessary).
    """

    def __init__(self, store: Store, num_proc: int, val_fraction: float,
                 flush_rows: int = _CHUNK_ROWS):
        self.store = store
        self.num_proc = num_proc
        self.val_threshold = np.uint64(int(val_fraction * float(2 ** 32)))
        self.flush_rows = flush_rows
        self.seen = 0        # total rows
        self.train_seen = 0  # train ordinals handed out
        self.bufs = [{"features": [], "labels": []} for _ in range(num_proc)]
        self.buf_rows = [0] * num_proc
        self.chunk_seq = [0] * num_proc
        self.val_buf = {"features": [], "labels": []}
        self.val_rows = 0
        self.val_seq = 0
        self.written = [0] * num_proc  # rows flushed per rank

    def add(self, chunk: Dict[str, np.ndarray]) -> None:
        feats = np.asarray(chunk["features"])
        labels = np.asarray(chunk["labels"])
        n = len(feats)
        if len(labels) != n:
            raise ValueError(f"features ({n}) and labels ({len(labels)}) "
                             "row counts differ")
        idx = np.arange(self.seen, self.seen + n, dtype=np.uint64)
        val_mask = ((idx * _HASH_MULT) & _HASH_MASK) < self.val_threshold
        self.seen += n
        if val_mask.any():
            self.val_buf["features"].append(feats[val_mask])
            self.val_buf["labels"].append(labels[val_mask])
            self.val_rows += int(val_mask.sum())
            if self.val_rows >= self.flush_rows:
                self._flush_val()
        tf_, tl = feats[~val_mask], labels[~val_mask]
        nt = len(tf_)
        ranks = (self.train_seen + np.arange(nt)) % self.num_proc
        self.train_seen += nt
        for r in range(self.num_proc):
            sel = ranks == r
            if not sel.any():
                continue
            self.bufs[r]["features"].append(tf_[sel])
            self.bufs[r]["labels"].append(tl[sel])
            self.buf_rows[r] += int(sel.sum())
            if self.buf_rows[r] >= self.flush_rows:
                self._flush_rank(r)

    def _write_npz(self, path: str, feats, labels) -> None:
        _npz_write(self.store, path, feats, labels)

    def _flush_rank(self, r: int) -> None:
        if not self.buf_rows[r]:
            return
        path = (f"{self.store.get_train_data_path(r)}"
                f".chunk{self.chunk_seq[r]:05d}")
        self._write_npz(path, np.concatenate(self.bufs[r]["features"]),
                        np.concatenate(self.bufs[r]["labels"]))
        self.written[r] += self.buf_rows[r]
        self.chunk_seq[r] += 1
        self.bufs[r] = {"features": [], "labels": []}
        self.buf_rows[r] = 0

    def _flush_val(self) -> None:
        if not self.val_rows:
            return
        path = f"{self.store.get_val_data_path()}.chunk{self.val_seq:05d}"
        self._write_npz(path, np.concatenate(self.val_buf["features"]),
                        np.concatenate(self.val_buf["labels"]))
        self.val_seq += 1
        self.val_buf = {"features": [], "labels": []}
        self.val_rows = 0

    def finish(self) -> int:
        """Equalize shard lengths, flush remainders; returns val rows."""
        if self.train_seen < self.num_proc:
            raise ValueError(f"{self.train_seen} training rows < "
                             f"num_proc={self.num_proc}")
        target = self.train_seen // self.num_proc
        for r in range(self.num_proc):
            extra = self.written[r] + self.buf_rows[r] - target
            assert 0 <= extra <= 1, (r, extra)  # round-robin invariant
            if extra:
                if self.buf_rows[r]:
                    self.bufs[r]["features"][-1] = \
                        self.bufs[r]["features"][-1][:-1]
                    self.bufs[r]["labels"][-1] = \
                        self.bufs[r]["labels"][-1][:-1]
                    self.buf_rows[r] -= 1
                else:
                    # The extra row is already on disk: trim the last chunk.
                    path = (f"{self.store.get_train_data_path(r)}"
                            f".chunk{self.chunk_seq[r] - 1:05d}")
                    with np.load(io.BytesIO(self.store.read(path)),
                                 allow_pickle=False) as z:
                        self._write_npz(path, z["features"][:-1],
                                        z["labels"][:-1])
                    self.written[r] -= 1
            self._flush_rank(r)
        total_val = self.seen - self.train_seen
        self._flush_val()
        return total_val


def _npz_write(store: Store, path: str, feats, labels) -> None:
    buf = io.BytesIO()
    np.savez(buf, features=feats, labels=labels)
    store.write(path, buf.getvalue())


def _executor_partition_writer(store: Store, feature_cols, label_cols,
                               num_proc: int, val_threshold,
                               chunk_rows: int = _CHUNK_ROWS):
    """Build the ``mapPartitionsWithIndex`` task that writes one
    partition's rows straight to the Store from the executor.

    Rows are consumed in bounded sub-chunks (executor memory stays
    O(chunk_rows)); the validation stripe uses the same multiplicative
    hash as the driver path, keyed by a 64-bit (partition, ordinal)
    index so the split is deterministic without any global row count.
    Train rows round-robin over ranks with a per-partition rotating
    offset, so rank totals stay within one row per partition of equal.
    Yields ``(kind, rank, path, rows)`` records for the driver to
    aggregate and equalize.
    """

    def task(pid: int, rows):
        import itertools

        results = []
        seen = 0
        train_seen = 0
        sub = 0
        rows = iter(rows)
        while True:
            buf = list(itertools.islice(rows, chunk_rows))
            if not buf:
                break
            import pandas as pd
            pdf = pd.DataFrame(
                [r.asDict() if hasattr(r, "asDict") else r for r in buf])
            arrs = _as_arrays(pdf, feature_cols, label_cols)
            feats, labels = arrs["features"], arrs["labels"]
            n = len(feats)
            # Mix the partition id into the LOW 32 bits (a high shift
            # would vanish under the 32-bit mask, making every partition
            # reuse one per-ordinal pattern -- and always send ordinal 0
            # to validation).  Both constants are odd, so each term is a
            # bijection mod 2^32.
            ordinals = np.arange(seen + 1, seen + n + 1, dtype=np.uint64)
            h = (ordinals * _HASH_MULT
                 + np.uint64(pid) * np.uint64(2246822519)) & _HASH_MASK
            seen += n
            val_mask = h < val_threshold
            if val_mask.any():
                path = (f"{store.get_val_data_path()}"
                        f".chunk{pid:07d}_{sub:03d}")
                _npz_write(store, path, feats[val_mask], labels[val_mask])
                results.append(("val", -1, path, int(val_mask.sum())))
            tf_, tl = feats[~val_mask], labels[~val_mask]
            ranks = (pid + train_seen + np.arange(len(tf_))) % num_proc
            train_seen += len(tf_)
            for r in range(num_proc):
                sel = ranks == r
                if sel.any():
                    path = (f"{store.get_train_data_path(r)}"
                            f".chunk{pid:07d}_{sub:03d}")
                    _npz_write(store, path, tf_[sel], tl[sel])
                    results.append(("train", r, path, int(sel.sum())))
            sub += 1
        return iter(results)

    return task


def _trim_rank_to(store: Store, chunks: List, excess: int) -> None:
    """Drop ``excess`` rows from the END of a rank's chunk list (rewrite
    or delete tail chunks)."""
    while excess > 0:
        path, count = chunks[-1]
        if count <= excess:
            store.delete(path)
            chunks.pop()
            excess -= count
            continue
        with np.load(io.BytesIO(store.read(path)), allow_pickle=False) as z:
            _npz_write(store, path, z["features"][:-excess],
                       z["labels"][:-excess])
        chunks[-1] = (path, count - excess)
        excess = 0


def _write_shards_on_executors(store: Store, df, feature_cols, label_cols,
                               num_proc: int,
                               val_fraction: float) -> Optional[int]:
    """Materialize the rank shards FROM THE EXECUTORS, in parallel.

    Reference behavior (SURVEY.md 3.6): Petastorm materializes the
    DataFrame by writing parquet from the Spark workers; the driver never
    streams the rows.  Here each partition task writes its own Store
    chunks (requires ``store.executor_writable`` -- shared FS / object
    store) and returns (rank, rows) records; the driver only aggregates
    the records and trims tail chunks so every rank shard has EQUAL
    length (collective step counts must match across workers).

    Returns the validation row count, or ``None`` when the input is not
    an RDD-bearing DataFrame or the store is not executor-writable (the
    caller falls back to the streamed driver path).
    """
    rdd = getattr(df, "rdd", None)
    if rdd is None or not hasattr(rdd, "mapPartitionsWithIndex"):
        return None
    if not getattr(store, "executor_writable", False):
        return None
    _clean_intermediate(store, num_proc)
    thresh = np.uint64(int(val_fraction * float(2 ** 32)))
    task = _executor_partition_writer(store, feature_cols, label_cols,
                                      num_proc, thresh)
    records = list(rdd.mapPartitionsWithIndex(task).collect())
    # The chunks must be visible HERE for the trim (and for workers): a
    # non-shared filesystem (each executor's private /tmp) would
    # otherwise silently yield partial, unequal shards.  Fall back to the
    # driver-streamed path instead.
    missing = [path for _k, _r, path, _c in records
               if not store.exists(path)]
    if missing:
        import logging
        logging.getLogger(__name__).warning(
            "%d executor-written chunk(s) not visible from the driver "
            "(non-shared store path? e.g. %s); falling back to driver "
            "materialization", len(missing), missing[0])
        return None
    train_rows = [0] * num_proc
    val_rows = 0
    by_rank: Dict[int, List] = {r: [] for r in range(num_proc)}
    for kind, r, path, count in records:
        if kind == "val":
            val_rows += count
        else:
            train_rows[r] += count
            by_rank[r].append((path, count))
    total = sum(train_rows)
    if total < num_proc:
        raise ValueError(f"{total} training rows < num_proc={num_proc}")
    # Equal shard lengths are a correctness requirement (step counts
    # derive from shard length); trim every rank to the smallest -- the
    # per-partition rotating round-robin bounds the loss to at most one
    # row per partition per rank.
    target = min(train_rows)
    if target == 0:
        # Possible with more ranks than rows-per-partition spread; an
        # empty shard would crash its worker, and trimming everyone to
        # zero destroys the dataset.
        raise ValueError(
            f"executor materialization left rank(s) with zero rows "
            f"(per-rank counts {train_rows}); use fewer workers or "
            f"repartition the DataFrame")
    for r in range(num_proc):
        by_rank[r].sort(key=lambda pc: pc[0])
        _trim_rank_to(store, by_rank[r], train_rows[r] - target)
    return val_rows


def _clean_intermediate(store: Store, num_proc: int) -> None:
    """Remove stale chunk files from a previous fit on the same store."""
    for r in range(num_proc):
        for p in store.list_prefix(f"{store.get_train_data_path(r)}.chunk"):
            store.delete(p)
        if store.exists(store.get_train_data_path(r)):
            store.delete(store.get_train_data_path(r))
    for p in store.list_prefix(f"{store.get_val_data_path()}.chunk"):
        store.delete(p)
    if store.exists(store.get_val_data_path()):
        store.delete(store.get_val_data_path())


def _write_shards(store: Store, chunks, num_proc: int,
                  val_fraction: float) -> int:
    """Stream chunks into the store's rank-sharded intermediate layout.

    Returns the number of validation rows held out.
    """
    _clean_intermediate(store, num_proc)
    w = _ShardWriter(store, num_proc, val_fraction)
    for chunk in chunks:
        w.add(chunk)
    return w.finish()


def _orderly_teardown(hvd) -> None:
    """Align every worker past the last collective, then tear the process
    group down (a barrier, then ``shutdown()``)."""
    hvd.barrier()
    hvd.shutdown()


def _shard_chunk_paths(store: Store, base: str) -> List[str]:
    paths = store.list_prefix(f"{base}.chunk")
    if not paths:
        if not store.exists(base):
            raise FileNotFoundError(f"no shard data under {base}")
        paths = [base]
    return paths


def _load_shard(store: Store, base: str) -> Dict[str, np.ndarray]:
    """Load one rank's WHOLE shard into memory (chunked layout or a bare
    ``<base>`` file).  Used by the torch/keras workers, whose training
    loops index the shard randomly; the JAX worker streams batches through
    :func:`_iter_shard_batches` instead and stays out-of-core end to end."""
    feats, labels = [], []
    for p in _shard_chunk_paths(store, base):
        with np.load(io.BytesIO(store.read(p)), allow_pickle=False) as z:
            feats.append(z["features"])
            labels.append(z["labels"])
    return {"features": np.concatenate(feats),
            "labels": np.concatenate(labels)}


def _shard_row_count(store: Store, base: str) -> int:
    total = 0
    for p in _shard_chunk_paths(store, base):
        with np.load(io.BytesIO(store.read(p)), allow_pickle=False) as z:
            total += int(z["labels"].shape[0])
    return total


def _iter_shard_batches(store: Store, base: str, bs: int):
    """Stream ``(features, labels)`` batches of exactly ``bs`` rows from a
    chunked shard, holding at most one chunk + ``bs`` rows in memory.

    The tail (< bs rows) is dropped; equal shard lengths make the drop
    identical across ranks, keeping collective step counts aligned.
    """
    fb, lb, have = [], [], 0
    for p in _shard_chunk_paths(store, base):
        with np.load(io.BytesIO(store.read(p)), allow_pickle=False) as z:
            fb.append(z["features"])
            lb.append(z["labels"])
            have += len(lb[-1])
        if have >= bs:
            f, l = np.concatenate(fb), np.concatenate(lb)
            n_full = (have // bs) * bs
            for i in range(0, n_full, bs):
                yield f[i:i + bs], l[i:i + bs]
            fb, lb, have = [f[n_full:]], [l[n_full:]], have - n_full


# ---------------------------------------------------------------------------
# estimator base
# ---------------------------------------------------------------------------

@dataclass
class EstimatorParams:
    """Common estimator parameters (reference ``common/params.py``)."""

    num_proc: int = 1
    batch_size: int = 32
    epochs: int = 1
    store: Optional[Store] = None
    feature_cols: Optional[List[str]] = None
    label_cols: Optional[List[str]] = None
    validation: float = 0.0  # fraction of rows held out
    run_id: Optional[str] = None
    verbose: int = 1
    backend: str = "local"  # "local" (spawned procs) or "spark" (barrier)
    # Write intermediate shards from the Spark executors (Petastorm-style
    # parallel materialization) when the input has an RDD and the store is
    # executor-writable; falls back to the streamed driver path otherwise.
    materialize_on_executors: bool = True


class _EstimatorBase:
    def __init__(self, **kwargs):
        self.params = EstimatorParams(**{
            k: v for k, v in kwargs.items()
            if k in EstimatorParams.__dataclass_fields__})

    # subclasses define: _make_worker_spec(), _worker_fn, _make_model()

    def fit(self, df) -> Any:
        p = self.params
        store = p.store or LocalStore(os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "hvd_torch_estimator"))
        run_id = p.run_id or f"run_{uuid.uuid4().hex[:8]}"
        val_rows = None
        if p.materialize_on_executors:
            try:
                val_rows = _write_shards_on_executors(
                    store, df, p.feature_cols, p.label_cols, p.num_proc,
                    p.validation)
            except ValueError:
                raise           # too few rows: not a fallback situation
            except Exception:
                import logging
                logging.getLogger(__name__).warning(
                    "executor-parallel materialization failed; falling "
                    "back to the streamed driver path", exc_info=True)
                val_rows = None
        if val_rows is None:
            chunks = _iter_chunks(df, p.feature_cols, p.label_cols)
            _write_shards(store, chunks, p.num_proc, p.validation)
        spec = dict(self._make_worker_spec(),
                    store_prefix=store.prefix_path,
                    run_id=run_id, num_proc=p.num_proc,
                    batch_size=p.batch_size, epochs=p.epochs,
                    verbose=p.verbose)
        if p.backend == "spark":
            from . import run as spark_run
            histories = spark_run(type(self)._worker_fn, args=(spec,),
                                  num_proc=p.num_proc)
        else:
            from ..core.config import _env_bool
            from ..ray import RayExecutor

            # The workers take the caller's device switch: the GPU, or
            # the CPU (gloo) under HVD_TPU_FORCE_CPU.
            ex = RayExecutor(num_workers=p.num_proc,
                             cpu=_env_bool("FORCE_CPU"), use_ray=False)
            ex.start()
            try:
                histories = ex.run(type(self)._worker_fn, args=(spec,))
            finally:
                ex.shutdown()
        ckpt = store.read(store.get_checkpoint_path(run_id))
        return self._make_model(ckpt, histories[0])


def _init_worker():
    """``init()`` in a spawned worker: the framework module and this
    rank's device."""
    import horovod_tpu_torch as hvd
    from ..core.state import global_state

    hvd.init()
    return hvd, global_state().device


def _save_checkpoint(store: Store, run_id: str, payload) -> None:
    import torch

    buf = io.BytesIO()
    torch.save(payload, buf)
    store.write(store.get_checkpoint_path(run_id), buf.getvalue())


# ---------------------------------------------------------------------------
# The JAX estimator's counterpart: a port module with batch statistics
# through make_flax_train_step
# ---------------------------------------------------------------------------

def _mse(logits, y):
    if logits.dim() > y.dim():
        logits = logits.squeeze(-1)
    return ((logits - y) ** 2).mean()


def _jax_worker(spec) -> List[float]:
    """Per-worker training loop: runs in a spawned process with the
    ``HOROVOD_*`` identity env already exported by the executor.

    The JAX worker's machinery on the port: ``DistributedOptimizer`` over
    the model's parameters, ``make_flax_train_step`` (the BN running
    statistics averaged over the ranks each step), and each rank feeding
    its own shard.  Batches STREAM from the chunked shard (one chunk in
    memory at a time) and are copied to the rank's device.
    """
    import torch

    from ..training import make_flax_train_step

    hvd, dev = _init_worker()
    store = LocalStore(spec["store_prefix"])
    base = store.get_train_data_path(hvd.rank())
    n = _shard_row_count(store, base)
    model = pickle.loads(spec["model"]).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=spec["lr"])
        if spec["opt"] == "adam"
        else torch.optim.SGD(model.parameters(), lr=spec["lr"],
                             momentum=0.9),
        named_parameters=model.named_parameters())
    if spec["loss"] == "mse":
        label_dtype, loss_fn = torch.float32, _mse
    else:
        label_dtype, loss_fn = torch.int64, None  # softmax xent
    step = make_flax_train_step(model, opt, loss_fn=loss_fn)

    bs = max(1, min(spec["batch_size"], n))
    history = []
    for _ in range(spec["epochs"]):
        ep = []
        for xb, yb in _iter_shard_batches(store, base, bs):
            # torch.tensor copies: the step never sees the shard's buffer.
            batch = (torch.tensor(xb, dtype=torch.float32, device=dev),
                     torch.tensor(yb, dtype=label_dtype, device=dev))
            ep.append(float(step(batch)))
        history.append(float(np.mean(ep)))
    if hvd.rank() == 0:
        _save_checkpoint(store, spec["run_id"], model.state_dict())
    _orderly_teardown(hvd)
    return history


class JaxEstimator(_EstimatorBase):
    """Train a port module with batch statistics (a
    :mod:`~horovod_tpu_torch.models` network, or any ``torch.nn.Module``)
    across ``num_proc`` workers through ``make_flax_train_step``; named
    after the JAX package's flax estimator.

    ``loss`` is ``"xent"`` (integer labels) or ``"mse"``; ``optimizer``
    is ``"adam"`` or ``"sgd"`` (momentum 0.9).  Every rank starts from
    the module's own weights (rank 0's are broadcast).
    """

    def __init__(self, model, loss: str = "xent", lr: float = 1e-3,
                 optimizer: str = "adam", **kwargs):
        super().__init__(**kwargs)
        self.model = model
        self.loss = loss
        self.lr = lr
        self.optimizer = optimizer

    _worker_fn = staticmethod(_jax_worker)

    def _make_worker_spec(self) -> dict:
        return {"model": pickle.dumps(self.model), "loss": self.loss,
                "lr": self.lr, "opt": self.optimizer}

    def _make_model(self, ckpt: bytes, history) -> "JaxModel":
        return JaxModel(self.model, ckpt, history)


def _extract_features(df, feature_cols=None) -> np.ndarray:
    """Feature matrix from a DataFrame / dict / raw array."""
    if hasattr(df, "columns") and hasattr(df, "loc"):
        cols = feature_cols or list(df.columns)
        x = np.stack([np.stack(df[c].to_numpy()) for c in cols], axis=-1)
        return x[..., 0] if x.shape[-1] == 1 else x
    if isinstance(df, dict):
        return np.asarray(df["features"])
    return np.asarray(df)


def _predict(model, x: np.ndarray) -> np.ndarray:
    """``model`` (eval mode) on ``x`` as f32 on the model's device; the
    output back on the host."""
    import torch

    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.tensor(x, dtype=torch.float32, device=dev))
    return out.float().cpu().numpy()


class JaxModel:
    """Fitted transformer: the trained module (parameters and running
    statistics from the checkpoint) on ``resolve_device()``, in eval
    mode."""

    def __init__(self, module, ckpt: bytes, history):
        import copy

        import torch

        from ..core.device import resolve_device

        dev = resolve_device()
        self.history = history
        self.module = copy.deepcopy(module).to(dev)
        self.module.load_state_dict(torch.load(
            io.BytesIO(ckpt), map_location=dev, weights_only=True))
        self.module.eval()

    def transform(self, df, feature_cols=None):
        return _predict(self.module, _extract_features(df, feature_cols))

    predict = transform


# ---------------------------------------------------------------------------
# Torch estimator (the horovod.torch idiom on the port)
# ---------------------------------------------------------------------------

def _run_torch_training(spec, make_optimizer, compute_loss,
                        float_labels: Optional[bool]) -> List[float]:
    """Shared torch worker scaffold: init + shard load + broadcast, the
    distributed batch loop, rank-0 checkpoint through the Store, and
    orderly teardown.  ``make_optimizer(model)`` sources the base
    optimizer; ``compute_loss(model, xb, yb, batch_idx)`` returns the
    per-batch loss tensor.  The model and the shard live on the rank's
    device.
    """
    import torch

    hvd, dev = _init_worker()
    store = LocalStore(spec["store_prefix"])
    shard = _load_shard(store, store.get_train_data_path(hvd.rank()))
    model = pickle.loads(spec["model"]).to(dev)
    model.train()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        make_optimizer(model), named_parameters=model.named_parameters())

    # torch.tensor copies: training never aliases the loaded shard.
    x = torch.tensor(shard["features"], dtype=torch.float32, device=dev)
    y = torch.tensor(shard["labels"], device=dev)
    if float_labels is None:  # infer: float labels stay, others are classes
        float_labels = y.dtype.is_floating_point
    if not float_labels:
        y = y.long()
    n, bs = len(x), max(1, min(spec["batch_size"], len(x)))
    history = []
    for _ in range(spec["epochs"]):
        ep = []
        for bi, i in enumerate(range(0, n - bs + 1, bs)):
            opt.zero_grad()
            loss = compute_loss(model, x[i:i + bs], y[i:i + bs], bi)
            loss.backward()
            opt.step()
            ep.append(float(loss.detach()))
        history.append(float(np.mean(ep)))
    if hvd.rank() == 0:
        _save_checkpoint(store, spec["run_id"],
                         {"model": model, "state_dict": model.state_dict()})
    _orderly_teardown(hvd)
    return history


def _torch_worker(spec) -> List[float]:
    import torch

    def make_optimizer(model):
        if spec["opt"] == "sgd":
            return torch.optim.SGD(model.parameters(), lr=spec["lr"],
                                   momentum=0.9)
        return torch.optim.Adam(model.parameters(), lr=spec["lr"])

    mse = spec["loss"] == "mse"
    loss_fn = torch.nn.MSELoss() if mse else torch.nn.CrossEntropyLoss()

    def compute_loss(model, xb, yb, bi):
        out = model(xb)
        return loss_fn(out.squeeze() if mse else out, yb)

    return _run_torch_training(spec, make_optimizer, compute_loss,
                               float_labels=mse)


class TorchEstimator(_EstimatorBase):
    """Reference ``horovod.spark.torch.TorchEstimator`` parity: trains a
    ``torch.nn.Module`` with the port's ``DistributedOptimizer``
    (gradients allreduced over NCCL on the GPU, gloo on the CPU)."""

    def __init__(self, model, loss: str = "xent", lr: float = 1e-3,
                 optimizer: str = "adam", **kwargs):
        super().__init__(**kwargs)
        self.model = model
        self.loss = loss
        self.lr = lr
        self.optimizer = optimizer

    _worker_fn = staticmethod(_torch_worker)

    def _make_worker_spec(self) -> dict:
        return {"model": pickle.dumps(self.model), "loss": self.loss,
                "lr": self.lr, "opt": self.optimizer}

    def _make_model(self, ckpt: bytes, history) -> "TorchModel":
        return TorchModel(ckpt, history)


class TorchModel:
    """The checkpointed model on ``resolve_device()`` (a checkpoint made
    on the GPU loads on a CPU caller), in eval mode."""

    def __init__(self, ckpt: bytes, history):
        import torch

        from ..core.device import resolve_device

        payload = torch.load(io.BytesIO(ckpt), map_location=resolve_device(),
                             weights_only=False)
        self.model = payload["model"]
        self.model.load_state_dict(payload["state_dict"])
        self.model.eval()
        self.history = history

    def transform(self, df, feature_cols=None):
        return _predict(self.model, _extract_features(df, feature_cols))

    predict = transform


# ---------------------------------------------------------------------------
# Lightning estimator (LightningModule protocol on the port)
# ---------------------------------------------------------------------------

def _first_optimizer(cfg):
    """``configure_optimizers()`` -> the (single) optimizer to drive.

    Accepts the LightningModule return shapes: an optimizer, a list/tuple
    of optimizers (optionally paired with schedulers), or a dict with an
    ``"optimizer"`` key.
    """
    if isinstance(cfg, dict):
        return cfg["optimizer"]
    if isinstance(cfg, (list, tuple)):
        head = cfg[0]
        if isinstance(head, (list, tuple)):  # ([opts], [scheds])
            return head[0]
        return _first_optimizer(head) if isinstance(head, dict) else head
    return cfg


def _lightning_worker(spec) -> List[float]:
    """Mini Trainer loop speaking the LightningModule protocol:
    ``configure_optimizers`` -> DistributedOptimizer wrap,
    ``training_step((x, y), i)`` -> backward -> step.  Works with real
    ``pytorch_lightning.LightningModule`` objects and with any
    ``torch.nn.Module`` implementing the two methods.
    """
    def make_optimizer(model):
        return _first_optimizer(model.configure_optimizers())

    def compute_loss(model, xb, yb, bi):
        out = model.training_step((xb, yb), bi)
        return out["loss"] if isinstance(out, dict) else out

    return _run_torch_training(spec, make_optimizer, compute_loss,
                               float_labels=None)


class LightningEstimator(_EstimatorBase):
    """Reference ``horovod.spark.lightning.TorchEstimator`` parity: trains
    a LightningModule-protocol model (``training_step`` +
    ``configure_optimizers``) across workers with the port's
    DistributedOptimizer.  ``pytorch_lightning`` itself is optional --
    the worker drives the protocol directly, so plain modules
    implementing it work too."""

    def __init__(self, model, **kwargs):
        super().__init__(**kwargs)
        if not (callable(getattr(model, "training_step", None))
                and callable(getattr(model, "configure_optimizers", None))):
            raise TypeError(
                "LightningEstimator needs a model implementing "
                "training_step(batch, batch_idx) and "
                "configure_optimizers() (a pytorch_lightning."
                "LightningModule, or any torch.nn.Module with those "
                "methods)")
        self.model = model

    _worker_fn = staticmethod(_lightning_worker)

    def _make_worker_spec(self) -> dict:
        return {"model": pickle.dumps(self.model)}

    def _make_model(self, ckpt: bytes, history) -> "TorchModel":
        return TorchModel(ckpt, history)


# ---------------------------------------------------------------------------
# Keras estimator (rides the horovod_tpu_torch.keras shim)
# ---------------------------------------------------------------------------

def _keras_worker(spec) -> List[float]:
    import tensorflow as tf

    import horovod_tpu_torch.keras as hvd

    hvd.init()
    store = LocalStore(spec["store_prefix"])
    shard = _load_shard(store, store.get_train_data_path(hvd.rank()))
    model = tf.keras.models.model_from_json(spec["model_json"])
    weights = pickle.loads(spec["weights"])
    if weights is not None:
        model.set_weights(weights)
    opt = hvd.DistributedOptimizer(
        tf.keras.optimizers.Adam(spec["lr"]) if spec["opt"] == "adam"
        else tf.keras.optimizers.SGD(spec["lr"], momentum=0.9))
    model.compile(optimizer=opt, loss=spec["loss"])
    callbacks = [hvd.BroadcastGlobalVariablesCallback(0),
                 hvd.MetricAverageCallback()]
    hist = model.fit(shard["features"], shard["labels"],
                     batch_size=spec["batch_size"], epochs=spec["epochs"],
                     verbose=0, callbacks=callbacks)
    if hvd.rank() == 0:
        # Re-use the pre-compile architecture json: the compiled model's
        # to_json() embeds the Distributed optimizer wrapper in its compile
        # config, which model_from_json cannot deserialize on the driver.
        store.write(store.get_checkpoint_path(spec["run_id"]),
                    pickle.dumps({"json": spec["model_json"],
                                  "weights": model.get_weights()}))
    _orderly_teardown(hvd)
    return [float(v) for v in hist.history["loss"]]


class KerasEstimator(_EstimatorBase):
    """Reference ``horovod.spark.keras.KerasEstimator`` parity: Keras model
    trained under the keras shim (DistributedOptimizer + broadcast/metric
    callbacks).  ``loss`` is any keras-serializable loss name."""

    def __init__(self, model, loss: str = "sparse_categorical_crossentropy",
                 lr: float = 1e-3, optimizer: str = "adam", **kwargs):
        super().__init__(**kwargs)
        self.model = model
        self.loss = loss
        self.lr = lr
        self.optimizer = optimizer

    _worker_fn = staticmethod(_keras_worker)

    def _make_worker_spec(self) -> dict:
        return {"model_json": self.model.to_json(),
                "weights": pickle.dumps(self.model.get_weights()
                                        if self.model.built else None),
                "loss": self.loss, "lr": self.lr, "opt": self.optimizer}

    def _make_model(self, ckpt: bytes, history) -> "KerasModel":
        return KerasModel(ckpt, history)


class KerasModel:
    def __init__(self, ckpt: bytes, history):
        import tensorflow as tf

        payload = pickle.loads(ckpt)
        self.model = tf.keras.models.model_from_json(payload["json"])
        self.model.set_weights(payload["weights"])
        self.history = history

    def transform(self, df, feature_cols=None):
        x = _extract_features(df, feature_cols)
        return self.model.predict(x, verbose=0)

    predict = transform
