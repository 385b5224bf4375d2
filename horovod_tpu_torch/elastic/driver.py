"""Elastic driver: discovery polling, worker supervision, re-rendezvous.

Reference: ``horovod/runner/elastic/driver.py`` (+ ``registration.py``
blacklisting): poll the discovery script; on host-set change notify
workers (-> ``HostsUpdatedInterrupt``), spawn workers on new hosts,
blacklist failing slots, gate on ``--min-np``, and re-rendezvous.

The port's copy of ``horovod_tpu/elastic/driver.py``.  Each membership
epoch gets a fresh rendezvous published through the assignment document
(see ``notify.py``): a ``FileStore`` under the driver's directory (no
port to race for), with a fresh port beside it; workers rebuild their
process group against it without being respawned.  Worker processes are
spawned locally, one a slot (one GPU each, or the CPU under ``--cpu``).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ..run.exec_util import TaggedProcess
from ..run.launch import free_port, worker_env
from .discovery import HostDiscoveryScript
from .notify import (ASSIGNMENT_ENV, EPOCH_ENV, WORKER_ID_ENV,
                     write_assignment)

logger = logging.getLogger("horovod_tpu_torch.elastic")


class ElasticDriver:
    def __init__(self, command: List[str], discovery_script: str,
                 min_np: int = 1, max_np: Optional[int] = None,
                 cpu: bool = False, slots: int = 1, verbose: int = 0,
                 poll_interval_s: float = 1.0,
                 elastic_timeout_s: float = 600.0,
                 heartbeat_timeout_s: float = 0.0,
                 rendezvous: bool = False,
                 extra_env: Optional[Dict[str, str]] = None,
                 discovery_timeout_s: float = 10.0):
        self.command = list(command)
        self.discovery = HostDiscoveryScript(discovery_script,
                                             default_slots=slots,
                                             timeout=discovery_timeout_s)
        self.min_np = min_np
        self.max_np = max_np
        self.cpu = cpu
        self.slots = slots
        self.verbose = verbose
        self.poll_interval_s = poll_interval_s
        self.elastic_timeout_s = elastic_timeout_s
        # > 0 enables the process-level stall plane: a worker whose
        # heartbeat file (written by the elastic run loop) goes stale is
        # terminated and blacklisted like any failed worker.
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.extra_env = dict(extra_env or {})
        self.epoch = -1
        self.blacklist: set = set()
        self._preempted_seen: set = set()
        self._preempted_leaving: Dict[str, float] = {}  # wid -> expiry.
        # Graceful leavers: excluded from desired while departing,
        # cleared when their host leaves discovery OR after the expiry
        # (a restarted preemptible VM may rejoin, and an operator SIGTERM
        # whose host never leaves the listing must not lose the slot
        # forever -- departure is not a fault, unlike the blacklist).
        self._ever_spawned: set = set()  # KV preemption markers are
        # keyed by worker id; a reaped worker is gone from self.workers
        # by the time its marker is polled, so remember everyone.
        self._dying: List = []  # (proc, kill_deadline) for removed
        # workers: their SIGTERM may be latched as a preemption notice
        # (or ignored by a wedged collective), so escalate to SIGKILL.
        self.workers: Dict[str, TaggedProcess] = {}  # worker_id -> proc
        # SIGTERM time per evicted worker, for SIGKILL escalation: a worker
        # wedged in a blocking collective (the very case the stall-gated
        # heartbeat detects) may never service SIGTERM.
        self._terminated_at: Dict[str, float] = {}
        self.term_grace_s = 15.0
        # How long a graceful preemption excludes a slot that stays in
        # the discovery listing (~a preemptible VM's restart latency).
        self.preempt_exclusion_s = 120.0
        self._assignment_dir = tempfile.mkdtemp(prefix="hvd_torch_elastic_")
        self.assignment_path = os.path.join(self._assignment_dir,
                                            "assignment.json")
        self._lock = threading.Lock()
        # Network rendezvous (multi-host, no shared FS): serve the
        # assignment doc + worker heartbeats over the HMAC-signed HTTP KV
        # store instead of the assignment file.
        self._rdv = None
        self._kv = None
        self._secret = None
        if rendezvous:
            from ..run.http_kv import KVClient, RendezvousServer
            from ..run.secret import make_secret_key
            self._secret = make_secret_key()
            self._rdv = RendezvousServer(self._secret)
            self._kv = KVClient("127.0.0.1", self._rdv.port, self._secret)

    # -- membership -------------------------------------------------------
    def _desired_workers(self) -> List[str]:
        hosts = self.discovery.find_available_hosts_and_slots()
        # A preemption departure is NOT a fault: the slot is excluded only
        # while leaving.  Once its host vanishes from discovery the entry
        # clears, so a reclaimed VM that comes back under the same name
        # rejoins (unlike the failure blacklist, which is permanent).
        now = time.monotonic()
        for wid in list(self._preempted_leaving):
            if wid in self.workers:
                # Still departing: pruning now would let the removal loop
                # SIGTERM it mid-step in this very iteration (its handler
                # has re-armed SIG_DFL), defeating the commit-boundary
                # exit.  Prune only once the process is gone.
                continue
            if wid.rsplit(":", 1)[0] not in hosts \
                    or now > self._preempted_leaving[wid]:
                del self._preempted_leaving[wid]
                # Re-armed: if the slot is re-spawned and preempted again
                # later, its fresh marker must be honored.
                self._preempted_seen.discard(wid)
        ids = []
        for host in sorted(hosts):
            for slot in range(hosts[host]):
                wid = f"{host}:{slot}"
                if wid not in self.blacklist and \
                        wid not in self._preempted_leaving:
                    ids.append(wid)
        if self.max_np is not None:
            ids = ids[:self.max_np]
        return ids

    def _store(self) -> str:
        """The current epoch's FileStore path."""
        return os.path.join(self._assignment_dir, f"store_{self.epoch}")

    def _publish(self, worker_ids: List[str], port: int) -> Dict[str, int]:
        self.epoch += 1
        ranks = {wid: i for i, wid in enumerate(sorted(worker_ids))}
        write_assignment(self.assignment_path, self.epoch,
                         len(worker_ids), port, ranks, store=self._store())
        if self._kv is not None:
            import json
            from .notify import ASSIGNMENT_KEY
            doc = {"epoch": self.epoch, "size": len(worker_ids),
                   "port": port, "ranks": ranks, "store": self._store()}
            self._kv.put(*ASSIGNMENT_KEY, json.dumps(doc).encode())
        logger.info("elastic epoch %d: %d worker(s), port %d",
                    self.epoch, len(worker_ids), port)
        return ranks

    def _spawn(self, wid: str, rank: int, size: int, port: int) -> None:
        self._ever_spawned.add(wid)
        # A previous incarnation of this slot may have left a heartbeat
        # file behind; its stale mtime would get the fresh worker evicted
        # before it writes its first beat.
        from ..core.stall import heartbeat_path
        try:
            os.unlink(heartbeat_path(self.assignment_path, wid))
        except OSError:
            pass
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(worker_env(rank=rank, size=size, coordinator="127.0.0.1",
                              port=port, cpu=self.cpu, slots=1,
                              local_rank=rank, local_size=size,
                              store=self._store()))
        if self._rdv is not None:
            from ..run.secret import SECRET_ENV
            env[ASSIGNMENT_ENV] = f"http://127.0.0.1:{self._rdv.port}"
            env[SECRET_ENV] = self._secret
            try:
                self._kv.delete("hb", wid)
            except ConnectionError:  # pragma: no cover
                pass
        else:
            env[ASSIGNMENT_ENV] = self.assignment_path
        env[WORKER_ID_ENV] = wid
        env[EPOCH_ENV] = str(self.epoch)
        self._terminated_at.pop(wid, None)
        if self.verbose:
            env["HOROVOD_LOG_LEVEL"] = "info"
        self.workers[wid] = TaggedProcess(rank, self.command, env,
                                          lock=self._lock)

    def _check_heartbeats(self) -> None:
        """Terminate workers whose heartbeat went stale (they then reap as
        failures -> blacklist -> rescale, like the reference's stall-based
        shutdown)."""
        if self.heartbeat_timeout_s <= 0:
            return
        from ..core.stall import heartbeat_age, heartbeat_path
        now = time.monotonic()
        for wid, proc in list(self.workers.items()):
            terminated = self._terminated_at.get(wid)
            if terminated is not None:
                if now - terminated > self.term_grace_s:
                    logger.warning("worker %s ignored SIGTERM for %.1fs; "
                                   "killing", wid, now - terminated)
                    proc.kill()
                continue
            age = self._kv_heartbeat_age(wid) if self._kv is not None else \
                heartbeat_age(heartbeat_path(self.assignment_path, wid))
            if age is not None and age > self.heartbeat_timeout_s:
                logger.warning(
                    "worker %s heartbeat stale for %.1fs "
                    "(> %.1fs); terminating", wid, age,
                    self.heartbeat_timeout_s)
                proc.terminate()
                self._terminated_at[wid] = now

    def _read_preempted(self) -> set:
        """Worker ids newly self-marked as preempted (graceful leavers).

        A preempted worker exits rc 0 AND its host usually vanishes from
        discovery at the same time, so neither the failure path nor the
        desired-vs-current comparison would trigger a republish -- the
        marker forces one so survivors get a fresh epoch.  Consumed
        markers are deleted (the id may be re-spawned and legitimately
        preempted again later).
        """
        from .notify import read_preempted_markers

        markers = read_preempted_markers(self.assignment_path)
        marked = set(markers)
        if self._kv is not None:
            for wid in self._ever_spawned - self._preempted_seen:
                try:
                    if self._kv.get("preempted", wid):
                        marked.add(wid)
                except ConnectionError:  # pragma: no cover
                    pass
        new = marked - self._preempted_seen - self.blacklist
        # Consume EVERY marker read this round (each is either newly
        # processed, or from a seen/blacklisted wid that will never be
        # processed and would otherwise be re-read every poll); deleting
        # only what was read cannot race a marker written after the read.
        # A blacklisted wid's stale marker counts as seen so the KV loop
        # stops polling for it.
        for wid in marked:
            if wid in self.blacklist:
                self._preempted_seen.add(wid)
            if self._kv is not None:
                try:
                    self._kv.delete("preempted", wid)
                except ConnectionError:  # pragma: no cover
                    pass
            p = markers.get(wid)
            if p is not None:
                try:
                    os.unlink(p)
                except OSError:  # pragma: no cover
                    pass
        return new

    def _kv_heartbeat_age(self, wid: str) -> Optional[float]:
        """Age of a worker's KV heartbeat (None: no beat yet)."""
        import time as _time
        try:
            raw = self._kv.get("hb", wid)
        except ConnectionError:  # pragma: no cover - own server gone
            return None
        if raw is None:
            return None
        try:
            return max(0.0, _time.time() - float(raw))
        except ValueError:
            return None

    # -- main loop --------------------------------------------------------
    def run(self) -> int:
        try:
            return self._run()
        finally:
            # Whatever the exit path (all-finished, min-np abort, error,
            # an exception out of publish/spawn), neither a removed
            # worker parked in _dying nor a live tracked worker may
            # outlive the driver as an orphan (SIGTERM may be latched by
            # the preemption handler, or ignored by a wedged collective).
            for proc, _deadline in self._dying:
                if proc.poll() is None:
                    proc.kill()
            for proc in self.workers.values():
                if proc.poll() is None:
                    proc.kill()
            if self._rdv is not None:
                self._rdv.stop()
            shutil.rmtree(self._assignment_dir, ignore_errors=True)

    def _run(self) -> int:
        deadline = time.monotonic() + self.elastic_timeout_s
        desired: List[str] = []
        while len(desired) < self.min_np:
            desired = self._desired_workers()
            if len(desired) >= self.min_np:
                break
            if time.monotonic() > deadline:
                logger.error("min-np=%d not reached before elastic timeout",
                             self.min_np)
                return 1
            time.sleep(self.poll_interval_s)

        port = free_port()
        ranks = self._publish(desired, port)
        for wid in desired:
            self._spawn(wid, ranks[wid], len(desired), port)

        while True:
            time.sleep(self.poll_interval_s)
            self._check_heartbeats()
            # 0. Escalate removed-but-still-alive workers to SIGKILL.
            for proc, deadline in list(self._dying):
                if proc.poll() is not None:
                    self._dying.remove((proc, deadline))
                elif time.monotonic() > deadline:
                    proc.kill()
                    self._dying.remove((proc, deadline))
            # 1. Reap exits.
            finished_ok = []
            failed = []
            for wid, proc in list(self.workers.items()):
                code = proc.poll()
                if code is None:
                    continue
                proc.wait()
                del self.workers[wid]
                self._terminated_at.pop(wid, None)
                (finished_ok if code == 0 else failed).append((wid, code))
            for wid, code in failed:
                logger.warning("worker %s failed (exit %d); blacklisting",
                               wid, code)
                self.blacklist.add(wid)
            if not self.workers and (finished_ok or failed):
                # Everyone exited: success only if nothing failed.
                return failed[0][1] if failed else 0
            # 1b. Graceful preemption leavers: they exit rc 0 and usually
            # vanish from discovery simultaneously, so neither the
            # failure path nor desired-vs-current would republish --
            # without this the survivors wait on the old epoch forever.
            preempted = self._read_preempted()
            for wid in preempted:
                logger.warning("worker %s is leaving after a preemption "
                               "notice; republishing without it", wid)
                self._preempted_leaving[wid] = \
                    time.monotonic() + self.preempt_exclusion_s
                self._preempted_seen.add(wid)
            if finished_ok and self.workers and not preempted:
                # Graceful finish is collective; stragglers follow shortly.
                continue

            # 2. Discover the desired set.
            desired = self._desired_workers()
            current = set(self.workers)
            if failed or preempted or set(desired) != current:
                alive = [wid for wid in desired if wid in current]
                newcomers = [wid for wid in desired if wid not in current]
                removed = [wid for wid in current if wid not in desired]
                next_set = alive + newcomers
                if len(next_set) < self.min_np:
                    logger.error("%d worker(s) < min-np=%d; aborting",
                                 len(next_set), self.min_np)
                    for proc in self.workers.values():
                        # Terminal abort: SIGKILL outright -- workers'
                        # SIGTERM handlers would latch the signal as a
                        # preemption notice and keep training forever.
                        proc.kill()
                    return 1
                port = free_port()
                ranks = self._publish(next_set, port)
                for wid in removed:
                    proc = self.workers.pop(wid)
                    if wid not in self._preempted_leaving:
                        # Plain eviction: SIGTERM.  An announced graceful
                        # leaver is NOT signalled -- its handler already
                        # re-armed SIG_DFL after the platform's notice,
                        # so a driver SIGTERM would kill it mid-step
                        # before its commit-boundary exit.
                        proc.terminate()
                    # Either way, escalate to SIGKILL after the grace so
                    # a wedged or latched worker cannot leak as an
                    # orphan.
                    self._dying.append((proc, time.monotonic()
                                        + self.term_grace_s))
                for wid in newcomers:
                    self._spawn(wid, ranks[wid], len(next_set), port)
                # Survivors pick the new epoch up from the assignment file
                # at their next commit boundary.
