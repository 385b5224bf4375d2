"""Pre-launch driver/task probe (reference ``runner/driver_service.py`` +
``task_service.py`` handshake).

The port's copy of ``horovod_tpu/run/probe.py``.  Before it spawns the
workers, ``python -m horovod_tpu_torch.run --probe`` starts one small
task probe a slot; each reports its hostname, the port's version, torch's
and CUDA's, Python's and the addresses it can serve on, over the
HMAC-signed KV store (``run/http_kv.py``); the driver collects the
reports and fails fast on version skew -- the reference's "same build
everywhere" check, which otherwise surfaces hours later as a hanging
collective.  The report carries ``torch_version`` and ``cuda``
(``torch.version.cuda``) where the JAX package's carries
``jax_version``.

Task side: ``python -m horovod_tpu_torch.run.probe <worker id> <url>``
with the job's secret in ``HVD_TPU_SECRET_KEY``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .http_kv import KVClient, RendezvousServer
from .secret import SECRET_ENV, make_secret_key

PROBE_SCOPE = "probe"
# The report fields that must agree across the probes.
MATCHED_FIELDS = ("framework_version", "torch_version", "cuda", "python")


def probe_report() -> dict:
    """What one task probe reports (runs on the worker host)."""
    import torch

    import horovod_tpu_torch

    return {
        "hostname": socket.gethostname(),
        "framework_version": horovod_tpu_torch.__version__,
        "torch_version": torch.__version__,
        "cuda": torch.version.cuda,
        "python": "%d.%d" % sys.version_info[:2],
        "addresses": _local_addresses(),
    }


def _local_addresses() -> List[str]:
    addrs = {"127.0.0.1"}
    try:
        host = socket.gethostname()
        for info in socket.getaddrinfo(host, None):
            addrs.add(info[4][0])
    except OSError:     # an unresolvable hostname: loopback only
        pass
    return sorted(addrs)


def run_task_probe(worker_id: str, url: str, secret: str) -> None:
    """Task side: publish this host's report."""
    kv = KVClient.from_url(url, secret)
    kv.put(PROBE_SCOPE, worker_id, json.dumps(probe_report()).encode())


def _probe_main() -> int:
    run_task_probe(sys.argv[1], sys.argv[2], os.environ[SECRET_ENV])
    return 0


class DriverProbe:
    """Driver side: collect per-host reports and validate compatibility.
    Owns a :class:`RendezvousServer` thread until :meth:`stop`."""

    def __init__(self, secret: Optional[str] = None):
        self.secret = secret or make_secret_key()
        self._server = RendezvousServer(self.secret)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.port}"

    def spawn_local_probe(self, worker_id: str) -> subprocess.Popen:
        env = dict(os.environ)
        env[SECRET_ENV] = self.secret
        return subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run.probe", worker_id,
             self.url], env=env)

    def collect(self, worker_ids: List[str],
                timeout_s: float = 60.0) -> Dict[str, dict]:
        """Wait for every probe's report; raises on timeout."""
        kv = KVClient.from_url(self.url, self.secret)
        reports: Dict[str, dict] = {}
        deadline = time.monotonic() + timeout_s
        while len(reports) < len(worker_ids):
            if time.monotonic() > deadline:
                missing = [w for w in worker_ids if w not in reports]
                raise TimeoutError(
                    f"no probe report from {missing} within {timeout_s}s")
            for wid in worker_ids:
                if wid in reports:
                    continue
                raw = kv.get(PROBE_SCOPE, wid)
                if raw is not None:
                    reports[wid] = json.loads(raw)
            time.sleep(0.1)
        return reports

    def validate(self, reports: Dict[str, dict]) -> None:
        """Fail fast on build skew (the reference's same-build check)."""
        for field in MATCHED_FIELDS:
            values = {r[field] for r in reports.values()}
            if len(values) > 1:
                detail = {w: r[field] for w, r in reports.items()}
                raise RuntimeError(
                    f"incompatible worker environments: {field} differs "
                    f"across hosts: {detail} -- a mixed-build job would "
                    "fail mid-run with hanging collectives")

    def stop(self) -> None:
        self._server.stop()


if __name__ == "__main__":
    sys.exit(_probe_main())
