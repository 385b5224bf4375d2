"""Worker <-> driver signalling for elastic runs.

The port's copy of ``horovod_tpu/elastic/notify.py``: the same
environment names and assignment document, so either package's driver
can lead the other's workers.

Reference: ``horovod/runner/elastic/worker.py`` (WorkerNotificationService:
the driver pushes a HostsUpdated ping over HTTP; workers raise
``HostsUpdatedInterrupt`` at the next commit boundary).

This runtime publishes an *assignment document* per job: the driver
atomically rewrites a JSON document ``{"epoch": N, "size": S, "port": P,
"ranks": {worker_id: rank}}`` whenever membership changes; workers poll
its epoch inside ``state.commit()``/the run loop.  The port's driver adds
``"store"``, the ``FileStore`` path of the epoch's process group (see
:func:`write_assignment`); a document without it rendezvouses at
``port``.  Two transports behind one worker-side API:

* **file** (localhost tests; pod slices with a shared staging volume):
  atomic rewrite + cheap stat/read polling.
* **HTTP KV** (multi-host without shared storage): ``ASSIGNMENT_ENV`` set
  to ``http://driver:port`` points workers at the launcher's HMAC-signed
  :class:`~horovod_tpu_torch.run.http_kv.RendezvousServer` (reference: the Gloo
  rendezvous + elastic registration HTTP server).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

ASSIGNMENT_ENV = "HVD_TPU_ELASTIC_ASSIGNMENT"
WORKER_ID_ENV = "HVD_TPU_ELASTIC_WORKER_ID"
# The epoch a worker was spawned into (the port's driver sets it): a
# worker that starts after the driver already published the next epoch
# must still see that epoch as new.
EPOCH_ENV = "HVD_TPU_ELASTIC_EPOCH"
ASSIGNMENT_KEY = ("elastic", "assignment")


def write_assignment(path: str, epoch: int, size: int, port: int,
                     ranks: Dict[str, int],
                     store: Optional[str] = None) -> None:
    """Atomically publish a new membership epoch (driver side).
    ``store`` names the epoch's ``FileStore`` (workers on the driver's
    host meet there, so no port is raced for)."""
    doc = {"epoch": epoch, "size": size, "port": port, "ranks": ranks}
    if store is not None:
        doc["store"] = store
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_assignment(path: str) -> Optional[dict]:
    if path.startswith("http://"):
        return _read_assignment_http(path)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _read_assignment_http(url: str) -> Optional[dict]:
    from ..run.http_kv import KVClient
    from ..run.secret import SECRET_ENV

    secret = os.environ.get(SECRET_ENV)
    if not secret:
        raise RuntimeError(
            f"{ASSIGNMENT_ENV} is an http:// rendezvous but {SECRET_ENV} "
            "is unset; the launcher must export the per-job secret")
    try:
        raw = KVClient.from_url(url, secret).get(*ASSIGNMENT_KEY)
    except (ConnectionError, OSError):
        return None
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None


class Notifier:
    """Worker-side epoch watcher."""

    def __init__(self, path: Optional[str] = None,
                 worker_id: Optional[str] = None):
        self.path = path or os.environ.get(ASSIGNMENT_ENV)
        self.worker_id = worker_id or os.environ.get(WORKER_ID_ENV)
        self.current_epoch = -1
        spawned = os.environ.get(EPOCH_ENV, "").strip()
        if spawned.lstrip("-").isdigit():
            self.current_epoch = int(spawned)
        else:
            doc = self.read()
            if doc:
                self.current_epoch = doc["epoch"]

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def read(self) -> Optional[dict]:
        return read_assignment(self.path) if self.path else None

    def updated(self) -> Optional[dict]:
        """The new assignment doc if the epoch advanced, else None."""
        doc = self.read()
        if doc and doc["epoch"] > self.current_epoch:
            return doc
        return None

    def accept(self, doc: dict) -> None:
        self.current_epoch = doc["epoch"]

    def excluded_from_current(self) -> Optional[bool]:
        """True when the LATEST assignment no longer ranks this worker
        (the driver evicted it -- its SIGTERM was an eviction, not a
        cloud preemption); None when unknown (no doc readable)."""
        if not self.enabled or not self.worker_id:
            return None
        doc = self.read()
        if not doc:
            return None
        return self.worker_id not in doc.get("ranks", {})

    def mark_preempted(self) -> bool:
        """Tell the driver this worker is leaving after a preemption
        notice (graceful commit-boundary exit); True on success (the
        caller retries at the next commit otherwise).

        Required even when discovery drops the host at the same time: the
        driver's rescale trigger compares desired vs CURRENT workers, and
        a cleanly-exited worker has already left both sets -- without this
        marker no new epoch would be published and the survivors would
        wait on the old assignment forever.
        """
        if not self.enabled or not self.worker_id:
            return True  # nothing to deliver to
        if self.path.startswith("http://"):
            from ..run.http_kv import KVClient
            from ..run.secret import SECRET_ENV

            secret = os.environ.get(SECRET_ENV)
            if not secret:
                return False
            try:
                KVClient.from_url(self.path, secret).put(
                    "preempted", self.worker_id, b"1")
                return True
            except (ConnectionError, OSError):  # pragma: no cover
                return False
        safe = self.worker_id.replace(":", "_").replace("/", "_")
        try:
            with open(f"{self.path}.preempted.{safe}", "w") as f:
                f.write(self.worker_id)
            return True
        except OSError:  # pragma: no cover - driver dir gone
            return False


def read_preempted_markers(path: str) -> Dict[str, str]:
    """Driver side (file transport): ``{worker_id: marker_path}`` for
    workers that marked themselves preempted -- the path is returned so
    the driver can delete EXACTLY the markers it consumed (deleting by
    glob would race a marker written between read and cleanup).  The KV
    transport is read through the driver's own store
    (:meth:`ElasticDriver._read_preempted`)."""
    import glob

    out: Dict[str, str] = {}
    for p in glob.glob(path + ".preempted.*"):
        try:
            with open(p) as f:
                wid = f.read().strip()
            if wid:
                out[wid] = p
        except OSError:  # pragma: no cover - racing cleanup
            pass
    return out
