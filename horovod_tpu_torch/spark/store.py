"""Estimator storage abstraction (``horovod/spark/common/store.py``
parity): the port's copy of ``horovod_tpu/spark/store.py`` (pure Python).

A ``Store`` names the directory layout the Spark estimators use for
checkpoints, logs and intermediate (Petastorm-style) training data.  The
local-filesystem implementation is complete; HDFS/S3 flavours of the
reference require their respective clients and raise with guidance.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional


class Store:
    """Abstract storage layout: run-scoped checkpoint/log/data prefixes."""

    #: True when executor/worker processes can write the store's paths
    #: directly (shared filesystem, object store) -- enables the
    #: executor-parallel shard materialization (SURVEY.md 3.6: Petastorm
    #: writes shards from Spark workers, not through the driver).
    executor_writable = False

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path

    # -- layout -----------------------------------------------------------
    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self.prefix_path, "runs", run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def get_train_data_path(self, idx: Optional[int] = None) -> str:
        p = os.path.join(self.prefix_path, "intermediate_train_data")
        return p if idx is None else f"{p}.{idx}"

    def get_val_data_path(self, idx: Optional[int] = None) -> str:
        p = os.path.join(self.prefix_path, "intermediate_val_data")
        return p if idx is None else f"{p}.{idx}"

    # -- IO (subclasses implement) ---------------------------------------
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def list_prefix(self, prefix: str):
        """Paths in the store starting with ``prefix``, sorted.  Used by the
        chunked intermediate-data layout (shards stream in as
        ``<base>.chunk00000``, ``.chunk00001``, ...)."""
        raise NotImplementedError

    @classmethod
    def create(cls, prefix_path: str) -> "Store":
        """Pick a store flavour from the path scheme (reference
        ``Store.create`` behavior)."""
        if prefix_path.startswith(("hdfs://", "webhdfs://")):
            return HDFSStore(prefix_path)
        if prefix_path.startswith(("s3://", "gs://")):
            raise ValueError(
                f"object-store paths need a fuse mount or client; got "
                f"{prefix_path!r}. Mount it and pass the local mount path.")
        return LocalStore(prefix_path)


class LocalStore(Store):
    """Local-filesystem store (the reference's ``FilesystemStore``).

    ``executor_writable`` assumes the path is reachable from every
    executor -- true for local-mode Spark and for NFS-style shared
    mounts, the same assumption the reference's FilesystemStore makes.
    """

    executor_writable = True

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def list_prefix(self, prefix: str):
        import glob
        return sorted(glob.glob(glob.escape(prefix) + "*"))


class HDFSStore(Store):
    def __init__(self, prefix_path: str):
        raise ImportError(
            "HDFSStore requires an hdfs client (pyarrow.fs or hdfs3), "
            "not installed in this environment; use LocalStore on a "
            "mounted path instead.")
