"""``python -m horovod_tpu_torch.run``: the launcher (``horovodrun``).

The port's counterpart of ``horovod_tpu/run/launch.py`` (reference:
``horovod/runner/launch.py``, the arg surface, + ``gloo_run.py``, the
per-slot environment).  It starts one worker process per slot on this
host and hands each its identity (``HOROVOD_RANK/SIZE/LOCAL_*``) and the
rendezvous of its process group: a ``FileStore`` under the launcher's
temporary directory (``HVD_TPU_RENDEZVOUS_FILE``), which no other process
can take from it, with ``MASTER_ADDR``/``MASTER_PORT`` beside it for
``env://``.  With ``--host-discovery-script`` the elastic driver
(:mod:`horovod_tpu_torch.elastic.driver`) supervises the workers instead.

Workers run on the GPU (NCCL), one a GPU; ``--cpu`` is the caller asking
for the CPU (gloo): workers get ``HVD_TPU_FORCE_CPU=1``.  Without it, a
worker on a machine without a GPU raises.

Usage::

    python -m horovod_tpu_torch.run -np 2 --cpu python train.py
    python -m horovod_tpu_torch.run --host-discovery-script d.sh \\
        --min-np 1 python -m horovod_tpu_torch.examples.elastic_train

``--timeline-filename PATH`` gives each worker a Chrome-trace timeline
of its own (``HOROVOD_TIMELINE=PATH.<rank>``; under the elastic driver
``PATH.<worker id>``, since ranks change across a re-rendezvous), which
``python -m horovod_tpu_torch.timeline --merge DIR`` merges.

``--autotune`` exports ``HOROVOD_AUTOTUNE=1`` to every worker (the
elastic driver's included).  ``--probe`` runs the pre-launch handshake
first (``run/probe.py``): one task probe a slot, whose reports must agree
on the port's, torch's, CUDA's and Python's versions.  Inside an LSF job
(``LSB_JOBID``) with neither ``-np`` nor ``-H``/``--hostfile``, ``-np``
is the allocation's slot count (``run/lsf.py``); an allocation that spans
several hosts is a usage error, as in the JAX launcher.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
from typing import List, Optional

from .exec_util import TaggedProcess, wait_all


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Launch a horovod_tpu_torch job: one worker process "
                    "per slot, meeting in one torch.distributed group.")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="number of worker processes to launch "
                        "(default: total slots of -H/--hostfile, else 1)")
    p.add_argument("-H", "--hosts", default=None,
                   help="comma-separated host[:slots] list (reference "
                        "-H h1:4,h2:4 syntax)")
    p.add_argument("--hostfile", default=None,
                   help="file with one 'host [slots=N]' or host:N per line")
    p.add_argument("--cpu", action="store_true",
                   help="run the workers on the CPU (gloo): they get "
                        "HVD_TPU_FORCE_CPU=1")
    p.add_argument("--slots", type=int, default=1,
                   help="slots per discovered host when the discovery "
                        "script names none")
    p.add_argument("--coordinator", default="127.0.0.1",
                   help="MASTER_ADDR handed to the workers")
    p.add_argument("--coordinator-port", type=int, default=0,
                   help="MASTER_PORT handed to the workers (0 = a free one)")
    p.add_argument("--timeline-filename", default=None,
                   help="write a Chrome-trace timeline per rank "
                        "(PATH.<rank>; HOROVOD_TIMELINE)")
    p.add_argument("--timeline-mark-cycles", action="store_true",
                   help="mark cycles in the timeline "
                        "(HOROVOD_TIMELINE_MARK_CYCLES)")
    p.add_argument("--autotune", action="store_true",
                   help="online autotuning of the exchange knobs in every "
                        "worker (HOROVOD_AUTOTUNE=1)")
    p.add_argument("--fusion-threshold-mb", type=int, default=None,
                   help="override HOROVOD_FUSION_THRESHOLD (MiB)")
    p.add_argument("--verbose", "-v", action="count", default=0)
    p.add_argument("--log-level", default=None,
                   choices=("trace", "debug", "info", "warning", "error",
                            "fatal"),
                   help="worker HOROVOD_LOG_LEVEL (overrides -v mapping)")
    p.add_argument("--check-build", action="store_true",
                   help="print the build (torch, CUDA, NCCL/gloo, the "
                        "kernels) and exit")
    p.add_argument("--explain-plan", action="store_true",
                   help="render the exchange planner's bucket decision "
                        "for a synthetic parameter set (honours "
                        "HOROVOD_FUSION_THRESHOLD / HOROVOD_COMPRESSION) "
                        "and exit")
    p.add_argument("--no-tag-output", action="store_true",
                   help="do not prefix worker output with [rank]<stream>")
    p.add_argument("--probe", action="store_true",
                   help="before launching, run one task probe a slot and "
                        "fail on version skew across them")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None,
                   help="executable printing one host[:slots] per line; "
                        "enables elastic mode")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="evict elastic workers whose heartbeat goes stale "
                        "for this many seconds (default: "
                        "HOROVOD_HEARTBEAT_TIMEOUT, else disabled)")
    p.add_argument("--network-rendezvous", action="store_true",
                   help="elastic mode: publish membership + heartbeats "
                        "over the HMAC-signed HTTP KV store instead of a "
                        "shared assignment file")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program and args to launch per worker")
    return p


def check_build() -> str:
    """The port's build: torch, CUDA, the collective backends and the
    hand-written kernels (built with ``nvcc`` on first use)."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch
    from ..ops import _build

    def mark(ok: bool) -> str:
        return "X" if ok else " "

    nccl = dist.is_available() and dist.is_nccl_available()
    gloo = dist.is_available() and dist.is_gloo_available()
    nccl_version = ""
    if nccl:
        try:
            nccl_version = " " + ".".join(
                str(v) for v in torch.cuda.nccl.version())
        except Exception:  # noqa: BLE001 - a CPU-only build
            nccl_version = ""
    nvcc = _build.nvcc_path()
    lines = [
        f"horovod_tpu_torch v{horovod_tpu_torch.__version__}",
        f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}"
        f", {torch.cuda.device_count()} visible GPU(s)",
        "",
        "Available backends:",
        f"    [{mark(nccl)}] NCCL{nccl_version}",
        f"    [{mark(gloo)}] gloo",
        "    [ ] MPI",
        "Available features:",
        "    [X] fused allreduce / grouped ops / allgather / broadcast /",
        "        alltoall / reducescatter / barrier / process sets",
        "    [X] Adasum, fp16/bf16/fp8, PowerSGD and top-k error feedback",
        "    [X] ZeRO-1, hierarchical and chunked allreduce",
        "    [X] elastic (commit/restore/resize, chaos injection)",
        "    [X] checkpointing (rank-0 npz, sharded npz a rank)",
        "    [X] timeline (Chrome trace, runtime start/stop, merge CLI),",
        "        /metrics, straggler monitor, SDC guard and tripwire",
        "    [X] autotune (GP Bayesian search), pre-launch probe, LSF",
        f"Kernels (sm_90a, nvcc {'at ' + nvcc if os.path.exists(nvcc) else 'not found'}):",
    ]
    lines += [f"    {name}.cu" for name in _build.SOURCES]
    return "\n".join(lines)


def explain_plan_cli() -> str:
    """``--explain-plan``: the planner's decision for a synthetic
    ResNet-ish parameter mix under the configured threshold and codec;
    ``explain_plan`` needs no ``init()``."""
    import torch

    from ..controller import fusion
    from ..core.config import load_config

    cfg = load_config()
    shapes = [(1000, 1000), (512, 512), (4096, 256), (256,), (1000,),
              (64, 3, 7, 7), (512,)]
    leaves = [torch.empty(s, dtype=torch.float32, device="meta")
              for s in shapes]
    rows = fusion.explain_plan(leaves, threshold_bytes=cfg.fusion_threshold,
                               compression=cfg.compression, register=False)
    header = (f"# exchange plan: {len(leaves)} synthetic f32 leaves, "
              f"threshold {cfg.fusion_threshold} bytes, "
              f"codec {cfg.compression or 'none'}")
    return header + "\n" + fusion.render_plan(rows)


def apply_timeline_env(env: dict, suffix,
                       cli_filename: Optional[str] = None) -> None:
    """Point this worker's timeline at a file of its own: every worker
    opening one shared path would truncate and interleave the others'
    traces.  The CLI flag wins (and clears an inherited
    ``HVD_TPU_TIMELINE``, which the config reads first); otherwise an
    inherited ``HOROVOD_TIMELINE`` / ``HVD_TPU_TIMELINE`` gets the
    suffix.  The static launch suffixes by rank, the elastic driver by
    the stable worker id (the JAX launcher's function)."""
    if cli_filename:
        env.pop("HVD_TPU_TIMELINE", None)
        env["HOROVOD_TIMELINE"] = f"{cli_filename}.{suffix}"
        return
    for var in ("HOROVOD_TIMELINE", "HVD_TPU_TIMELINE"):
        if env.get(var):
            env[var] = f"{env[var]}.{suffix}"


def _log_env(opts) -> dict:
    """The worker environment the CLI's flags set (the static spawn's
    and the elastic driver's ``extra_env``)."""
    env = {}
    if opts.autotune:
        env["HOROVOD_AUTOTUNE"] = "1"
    if opts.timeline_mark_cycles:
        env["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    if opts.fusion_threshold_mb is not None:
        env["HOROVOD_FUSION_THRESHOLD"] = str(opts.fusion_threshold_mb << 20)
    if opts.log_level:
        env["HOROVOD_LOG_LEVEL"] = opts.log_level
    elif opts.verbose:
        env["HOROVOD_LOG_LEVEL"] = "debug" if opts.verbose > 1 else "info"
    return env


def run_command(args: Optional[List[str]] = None) -> int:
    parser = build_parser()
    opts = parser.parse_args(args)
    if opts.check_build:
        print(check_build())
        return 0
    if opts.explain_plan:
        print(explain_plan_cli())
        return 0
    if opts.timeline_mark_cycles and not (
            opts.timeline_filename or os.environ.get("HOROVOD_TIMELINE")
            or os.environ.get("HVD_TPU_TIMELINE")):
        print("# warning: --timeline-mark-cycles has no effect without "
              "--timeline-filename (or HOROVOD_TIMELINE)", file=sys.stderr)

    cmd = list(opts.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given")

    np_ = opts.num_proc
    if opts.hosts or opts.hostfile:
        if opts.host_discovery_script:
            parser.error("-H/--hostfile is a static host list; it cannot "
                         "be combined with --host-discovery-script "
                         "(elastic membership comes from the script)")
        from .hosts import (all_local, parse_host_spec, parse_hostfile,
                            total_slots)
        try:
            hosts = parse_host_spec(opts.hosts) if opts.hosts else \
                parse_hostfile(opts.hostfile)
        except (ValueError, OSError) as e:
            parser.error(str(e))
        if not all_local(hosts):
            parser.error(
                "remote hosts in -H/--hostfile: this launcher spawns "
                "processes locally; run it on each host with -np <local "
                "slots>, a shared --coordinator and HOROVOD_RANK offsets. "
                f"Got: {', '.join(h for h, _ in hosts)}")
        if np_ is None:
            np_ = total_slots(hosts)
    elif np_ is None and not opts.host_discovery_script:
        # Inside an LSF allocation, the process count is the scheduler's
        # (as the reference's horovodrun derives it); an explicit -np
        # always wins, so per-host launches stay possible.
        from .lsf import get_compute_hosts, using_lsf
        if using_lsf():
            from .hosts import all_local, total_slots
            try:
                hosts = get_compute_hosts()
            except ValueError as e:
                parser.error(str(e))
            if not all_local(hosts):
                parser.error(
                    "LSF allocation spans multiple hosts: run the launcher "
                    "on each host with -np <local slots> and a shared "
                    "--coordinator. Hosts: "
                    f"{', '.join(h for h, _ in hosts)}")
            np_ = total_slots(hosts)
    if np_ is None:
        np_ = 1
    if opts.host_discovery_script:
        from ..core.config import load_config
        from ..elastic.driver import ElasticDriver
        heartbeat = opts.heartbeat_timeout
        if heartbeat is None:
            heartbeat = load_config().heartbeat_timeout
        driver = ElasticDriver(
            command=cmd,
            discovery_script=opts.host_discovery_script,
            min_np=opts.min_np or 1,
            max_np=opts.max_np,
            cpu=opts.cpu,
            slots=opts.slots,
            verbose=opts.verbose,
            heartbeat_timeout_s=heartbeat,
            rendezvous=opts.network_rendezvous,
            extra_env=_log_env(opts),
            timeline=opts.timeline_filename,
        )
        return driver.run()

    if opts.probe:
        _run_probe(np_, opts.verbose)
    port = opts.coordinator_port or free_port()
    job_dir = tempfile.mkdtemp(prefix="hvd_torch_run_")
    store = os.path.join(job_dir, "store")
    lock = threading.Lock()
    procs: List[TaggedProcess] = []
    try:
        for rank in range(np_):
            env = dict(os.environ)
            env.update(worker_env(
                rank=rank, size=np_, coordinator=opts.coordinator,
                port=port, cpu=opts.cpu, store=store))
            env.update(_log_env(opts))
            apply_timeline_env(env, rank, opts.timeline_filename)
            procs.append(TaggedProcess(rank, cmd, env, lock=lock,
                                       tag=not opts.no_tag_output))
        return wait_all(procs)
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(job_dir, ignore_errors=True)


def _run_probe(np_: int, verbose: int) -> None:
    """The pre-launch handshake: one local task probe a slot, their
    reports collected and validated (raises on skew or a missing
    report); the probes are reaped and the KV server stopped either
    way."""
    from .probe import DriverProbe
    probe = DriverProbe()
    wids = [f"slot{r}" for r in range(np_)]
    children = []
    try:
        for w in wids:
            children.append(probe.spawn_local_probe(w))
        reports = probe.collect(wids)
        probe.validate(reports)
        if verbose:
            for w, r in reports.items():
                print(f"# probe {w}: {r['hostname']} "
                      f"hvd={r['framework_version']} "
                      f"torch={r['torch_version']} cuda={r['cuda']}")
    finally:
        for child in children:
            try:
                child.wait(timeout=10)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        probe.stop()


def worker_env(rank: int, size: int, coordinator: str, port: int,
               cpu: bool, slots: int = 1, local_rank: Optional[int] = None,
               local_size: Optional[int] = None,
               store: Optional[str] = None) -> dict:
    """Per-worker environment (the ``gloo_run`` per-slot env): its
    identity, ``MASTER_ADDR``/``MASTER_PORT`` (``env://``) beside the JAX
    launcher's coordinator names, the ``FileStore`` when ``store`` names
    one, and ``HVD_TPU_FORCE_CPU=1`` under ``cpu``.  ``slots`` is
    accepted for the JAX signature (one device a worker here)."""
    env = {
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_rank if local_rank is not None
                                  else rank),
        "HOROVOD_LOCAL_SIZE": str(local_size if local_size is not None
                                  else size),
        "HOROVOD_CROSS_RANK": "0",
        "HOROVOD_CROSS_SIZE": "1",
        "MASTER_ADDR": coordinator,
        "MASTER_PORT": str(port),
        "HVD_TPU_COORDINATOR_ADDR": coordinator,
        "HVD_TPU_COORDINATOR_PORT": str(port),
    }
    if store is not None:
        env["HVD_TPU_RENDEZVOUS_FILE"] = store
    if cpu:
        env["HVD_TPU_FORCE_CPU"] = "1"
    return env


def main() -> None:  # console entry
    sys.exit(run_command())
