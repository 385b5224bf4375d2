"""Subprocess execution with rank-tagged output streaming; the port's
copy of ``horovod_tpu/run/exec_util.py``.

Analogue of the reference launcher's ``safe_shell_exec`` + stream
multiplexing (``horovod/runner/common/util/safe_shell_exec.py`` /
``util/streams``): every worker's stdout/stderr is forwarded line-by-line
to the launcher's streams prefixed ``[rank]<stdout>`` so interleaved
multi-process logs stay attributable.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence


def _pump(stream, out, prefix: str, lock: threading.Lock) -> None:
    for line in iter(stream.readline, b""):
        with lock:
            out.write(f"{prefix}{line.decode(errors='replace')}")
            out.flush()
    stream.close()


class TaggedProcess:
    """A worker subprocess whose output is forwarded with a rank tag."""

    def __init__(self, rank: int, cmd: Sequence[str], env: Dict[str, str],
                 lock: Optional[threading.Lock] = None, tag: bool = True):
        self.rank = rank
        self.proc = subprocess.Popen(
            list(cmd), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, start_new_session=True)
        lock = lock or threading.Lock()
        p_out = f"[{rank}]<stdout>" if tag else ""
        p_err = f"[{rank}]<stderr>" if tag else ""
        self._threads = [
            threading.Thread(target=_pump, daemon=True,
                             args=(self.proc.stdout, sys.stdout, p_out, lock)),
            threading.Thread(target=_pump, daemon=True,
                             args=(self.proc.stderr, sys.stderr, p_err, lock)),
        ]
        for t in self._threads:
            t.start()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        for t in self._threads:
            t.join(timeout=5)
        return code

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def terminate(self) -> None:
        """SIGTERM the worker's whole process group."""
        if self.proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass

    def kill(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


def wait_all(procs: List[TaggedProcess], poll_s: float = 0.2,
             term_grace_s: float = 15.0) -> int:
    """Wait for all workers; on first failure terminate the rest, escalating
    to SIGKILL after a grace period (a peer wedged in a blocking collective
    may ignore SIGTERM).

    Returns the first non-zero exit code, or 0.  Mirrors the reference
    launcher's all-or-nothing process supervision.
    """
    import time
    pending = list(procs)
    first_bad = 0
    kill_deadline = None
    while pending:
        for p in list(pending):
            code = p.poll()
            if code is None:
                continue
            pending.remove(p)
            p.wait()
            if code != 0 and first_bad == 0:
                first_bad = code
                kill_deadline = time.monotonic() + term_grace_s
                for other in pending:
                    other.terminate()
        if kill_deadline is not None and time.monotonic() > kill_deadline:
            for p in pending:
                p.kill()
            kill_deadline = None
        if pending:
            pending[0].wait(timeout=poll_s)
    return first_bad
