"""Offline cross-rank timeline merge + straggler report.

The port's copy of ``horovod_tpu/timeline/__main__.py``.

Usage::

    python -m horovod_tpu_torch.timeline --merge <dir> [--out merged.json]

``<dir>`` holds one Chrome-trace JSON per rank (each written by
:class:`~horovod_tpu_torch.timeline.Timeline`, which stamps a ``clock_anchor``
metadata event -- ``epoch_unix_us``, ``rank``, ``hostname`` -- at open).
The merge aligns every file onto the lowest rank's clock via the
anchors (no live KV handshake needed), assigns ONE pid per rank (the
original per-track pids become tids), and writes a single
Perfetto-loadable JSON.

It then prints the straggler/critical-path report: per-rank host-time
attribution across compute / exchange / fence / dispatch-gap span
categories, and the :class:`~horovod_tpu_torch.timeline.straggler.
StragglerMonitor` verdict over the per-step span summaries recovered
from the tagged events.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from .straggler import StragglerMonitor

#: Span/phase name -> attribution category.  Eager phases are upper-case
#: (ALLREDUCE, NEGOTIATE_*...), span-layer kinds lower-case.
_CATEGORIES = (
    ("fence", ("fence", "FENCE")),
    ("exchange", ("exchange", "bucket")),
    ("negotiate", ("negotiate",)),
    ("dispatch_gap", ("dispatch_gap",)),
    ("compute", ("dispatch", "compute")),
)


def classify(name: str) -> str:
    for cat, names in _CATEGORIES:
        if name in names:
            return cat
    if name.startswith("NEGOTIATE_"):
        return "negotiate"
    if name.isupper():  # eager collective execution phases
        return "exchange"
    return "compute"


#: Dominant category -> the report's "-bound" label.
_BOUND = {"compute": "compute-bound", "exchange": "exchange-bound",
          "negotiate": "exchange-bound", "fence": "fence-bound",
          "dispatch_gap": "host-bound (late dispatch / input pipeline)"}


def load_trace(path: str) -> Tuple[Optional[dict], List[dict]]:
    """``(clock_anchor_args_or_None, events)`` for one trace file."""
    with open(path) as f:
        events = json.load(f)
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome-trace event array")
    anchor = None
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "clock_anchor":
            anchor = ev.get("args") or {}
            break
    return anchor, events


def _pair_durations(events: List[dict]
                    ) -> Dict[Tuple[int, str], Dict[str, float]]:
    """Recover per-(step, category) host seconds from B/E pairs.
    Events whose args carry no step aggregate under step -1."""
    stacks: Dict[Tuple, List[Tuple[str, float, dict]]] = {}
    out: Dict[Tuple[int, str], Dict[str, float]] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":  # retroactive complete event (dispatch gap)
            args = ev.get("args") or {}
            step = int(args.get("step", -1))
            cat = classify(ev.get("name", ""))
            bucket = out.setdefault((step, cat), {})
            bucket["secs"] = bucket.get("secs", 0.0) + \
                max(0.0, float(ev.get("dur", 0.0))) / 1e6
            continue
        if ph not in ("B", "E"):
            continue
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(
                (ev["name"], float(ev["ts"]), ev.get("args") or {}))
            continue
        stack = stacks.get(key) or []
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == ev["name"]:
                name, ts0, args = stack.pop(i)
                step = int(args.get("step", -1))
                cat = classify(name)
                bucket = out.setdefault((step, cat), {})
                bucket["secs"] = bucket.get("secs", 0.0) + \
                    max(0.0, float(ev["ts"]) - ts0) / 1e6
                break
    return out


def merge(trace_dir: str, out_path: Optional[str] = None) -> dict:
    """Merge every per-rank trace under ``trace_dir``; returns the report
    dict (also printed by :func:`main`)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json")))
    ranks: List[Tuple[int, dict, List[dict], str]] = []
    skipped = []
    for p in paths:
        if out_path and os.path.abspath(p) == os.path.abspath(out_path):
            continue
        try:
            anchor, events = load_trace(p)
        except (ValueError, json.JSONDecodeError, OSError) as e:
            skipped.append((p, str(e)))
            continue
        if anchor is None:
            skipped.append((p, "no clock_anchor metadata (pre-merge-era "
                               "trace?)"))
            continue
        ranks.append((int(anchor.get("rank", len(ranks))), anchor,
                      events, p))
    if not ranks:
        raise SystemExit(
            f"no mergeable traces under {trace_dir!r} "
            f"({len(skipped)} file(s) skipped)")
    ranks.sort(key=lambda t: t[0])
    ref_rank, ref_anchor = ranks[0][0], ranks[0][1]
    ref_epoch = float(ref_anchor["epoch_unix_us"])

    merged: List[dict] = []
    per_rank: Dict[int, dict] = {}
    monitor = StragglerMonitor(world=len(ranks), stall_check_time=0.0)
    for rank, anchor, events, path in ranks:
        offset_us = float(anchor["epoch_unix_us"]) - ref_epoch
        pid = rank + 1
        track_names: Dict[int, str] = {}
        first_ts = last_ts = None
        merged.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": f"rank {rank} "
                             f"({anchor.get('hostname', '?')})"}})
        for ev in events:
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    track_names[ev.get("pid")] = \
                        (ev.get("args") or {}).get("name", "")
                continue
            ts = float(ev.get("ts", 0.0)) + offset_us
            if first_ts is None or ts < first_ts:
                first_ts = ts
            if last_ts is None or ts > last_ts:
                last_ts = ts
            nev = dict(ev)
            nev["ts"] = ts
            nev["tid"] = ev.get("pid", 0)  # track -> thread
            nev["pid"] = pid               # ONE pid per rank
            merged.append(nev)
        for tid, tname in track_names.items():
            merged.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        durs = _pair_durations(events)
        cats: Dict[str, float] = {}
        steps: Dict[int, Dict[str, float]] = {}
        for (step, cat), d in durs.items():
            cats[cat] = cats.get(cat, 0.0) + d["secs"]
            if step >= 0:
                steps.setdefault(step, {})[cat] = \
                    steps.get(step, {}).get(cat, 0.0) + d["secs"]
        wall = ((last_ts - first_ts) / 1e6
                if first_ts is not None and last_ts is not None else 0.0)
        per_rank[rank] = {"categories": cats, "wall_s": wall,
                          "path": path, "steps": len(steps)}
        for step, kinds in sorted(steps.items()):
            monitor.observe({
                "rank": rank, "step": step,
                "t0_us": float(anchor["epoch_unix_us"]),
                "wall_s": sum(kinds.values()),
                "spans": kinds})

    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    rep = monitor.report()
    return {"ranks": len(ranks), "events": len(merged),
            "out": out_path, "skipped": skipped,
            "per_rank": per_rank, "straggler": rep,
            "render": monitor.render()}


def _print_report(rep: dict) -> None:
    print(f"merged {rep['ranks']} rank trace(s), "
          f"{rep['events']} events -> {rep['out']}")
    for p, why in rep["skipped"]:
        print(f"  skipped {p}: {why}")
    print("\nper-rank host-time attribution:")
    for rank in sorted(rep["per_rank"]):
        info = rep["per_rank"][rank]
        cats = info["categories"]
        total = sum(cats.values()) or 1.0
        parts = "  ".join(
            f"{c} {100.0 * s / total:5.1f}%"
            for c, s in sorted(cats.items(), key=lambda kv: -kv[1]))
        dominant = max(cats, key=cats.get) if cats else "compute"
        print(f"  rank {rank}: busy {total:8.4f}s  {parts}  -> "
              f"{_BOUND.get(dominant, 'compute-bound')}")
    print()
    print(rep["render"])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.timeline",
        description="merge per-rank timeline JSONs and report stragglers")
    p.add_argument("--merge", metavar="DIR", required=True,
                   help="directory of per-rank Chrome-trace JSON files")
    p.add_argument("--out", metavar="PATH", default=None,
                   help="merged trace output "
                        "(default: <DIR>/merged_timeline.json)")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.merge, "merged_timeline.json")
    rep = merge(args.merge, out)
    _print_report(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
