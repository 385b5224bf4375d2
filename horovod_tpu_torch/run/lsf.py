"""LSF cluster detection for the launcher.

The port's copy of ``horovod_tpu/run/lsf.py`` (reference:
``horovod/runner/util/lsf.py``): when ``python -m horovod_tpu_torch.run``
starts inside an LSF job with neither ``-np`` nor ``-H``/``--hostfile``,
the process count comes from the scheduler's environment --

- ``LSB_DJOB_RANKFILE``: one hostname per allocated slot (repeats mean
  several slots on that host); preferred when present, because it is
  the rank layout ``jsrun``/``blaunch`` would use.
- ``LSB_MCPU_HOSTS``: ``"host1 n1 host2 n2 ..."``, alternating host and
  core count.

The reference execs ``jsrun`` to fan out; this launcher spawns local
processes, so an allocation that spans several hosts runs the launcher
on each with its local slots and a shared ``--coordinator``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Tuple


def using_lsf() -> bool:
    """True when running inside an LSF job (``LSB_JOBID`` set)."""
    return "LSB_JOBID" in os.environ


def get_compute_hosts() -> List[Tuple[str, int]]:
    """``(host, slots)`` list from the LSF environment.

    Slot counts come from the scheduler itself (rank-file line repeats /
    MCPU core counts).  Raises ``ValueError`` if no usable LSF host
    information is found or the format is malformed.
    """
    rankfile = os.environ.get("LSB_DJOB_RANKFILE")
    if rankfile and os.path.exists(rankfile):
        with open(rankfile) as f:
            hosts = [h for h in (raw.strip() for raw in f) if h]
        # On CSM/jsrun systems the first line is the slotless batch/launch
        # node; on plain LSF (bsub -n N) every line is a compute slot.
        # Drop the first line when it is clearly the launch node: it never
        # recurs AND (it matches LSB_SUB_HOST, or later hosts hold multiple
        # slots while it holds one -- the CSM signature).  A one-slot-per-
        # host allocation (span[ptile=1]) has no recurring hosts at all, so
        # nothing is dropped there.  The residual ambiguity (a slotless
        # launch node heading an otherwise ptile=1 rankfile) is
        # undecidable from the file alone; pass -H explicitly in that case.
        rest = hosts[1:]
        sub_host = os.environ.get("LSB_SUB_HOST")

        def _stem(h):  # FQDN vs short-name tolerant compare
            return h.split(".", 1)[0].lower()

        # The slot-shape fallback only applies when LSB_SUB_HOST is absent
        # or matches (by hostname stem): when it IS set and names a
        # different machine, hosts[0] is a genuine compute host (e.g. an
        # uneven plain-LSF spread from a login node), not the launch node.
        sub_matches = sub_host is None or _stem(hosts[0]) == _stem(sub_host)
        first_is_launch = (
            len(hosts) > 1 and hosts[0] not in rest and sub_matches
            and (sub_host is not None
                 or any(rest.count(h) > 1 for h in set(rest))))
        if first_is_launch:
            hosts = rest
        counts: "OrderedDict[str, int]" = OrderedDict()
        for host in hosts:
            counts[host] = counts.get(host, 0) + 1
        if counts:
            return list(counts.items())

    # Non-CSM fallback: every LSB_MCPU_HOSTS entry carries an allocated
    # core count, so all entries (including the submission host's) are
    # genuine compute slots; jsrun-style systems with a slotless batch
    # node provide the rankfile above, which is preferred.
    mcpu = os.environ.get("LSB_MCPU_HOSTS", "").split()
    if mcpu:
        if len(mcpu) % 2:
            raise ValueError(
                f"malformed LSB_MCPU_HOSTS (odd token count): {mcpu!r}")
        out: "OrderedDict[str, int]" = OrderedDict()
        for host, n in zip(mcpu[::2], mcpu[1::2]):
            try:
                slots = int(n)
            except ValueError:
                raise ValueError(
                    f"malformed LSB_MCPU_HOSTS slot count {n!r}")
            if slots > 0:
                out[host] = out.get(host, 0) + slots
        if out:
            return list(out.items())

    raise ValueError("LSF job detected (LSB_JOBID set) but neither "
                     "LSB_DJOB_RANKFILE nor LSB_MCPU_HOSTS is usable")
