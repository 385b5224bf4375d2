"""Host discovery for elastic jobs (the port's copy of
``horovod_tpu/elastic/discovery.py``).

Reference: ``horovod/runner/elastic/discovery.py`` -- the driver polls a
user-supplied ``--host-discovery-script`` whose stdout lists one
``host[:slots]`` per line; the set may change at any time (scale-up,
scale-down, preemption).  A host is a machine of GPUs, one slot a GPU;
locally it is an alias for test worker processes.
"""

from __future__ import annotations

import subprocess
from typing import Dict


class HostDiscoveryScript:
    def __init__(self, script: str, default_slots: int = 1,
                 timeout: float = 10.0):
        self.script = script
        self.default_slots = default_slots
        self.timeout = timeout
        self._last: Dict[str, int] = {}

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """Run the script; returns {host: slots}.

        A FAILING script (crash, nonzero exit, timeout) returns the last
        successful result: one transient discovery hiccup (e.g. a slow
        cluster API) must not read as "all hosts gone" and tear down a
        healthy job below min-np.  Only a successful empty listing means
        no hosts.
        """
        try:
            out = subprocess.run([self.script], capture_output=True,
                                 text=True, timeout=self.timeout)
        except (OSError, subprocess.TimeoutExpired):
            return dict(self._last)
        if out.returncode != 0:
            return dict(self._last)
        hosts: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            host, slots = self._parse_line(line)
            hosts[host] = slots
        self._last = dict(hosts)
        return hosts

    def _parse_line(self, line: str):
        # One canonical host[:slots] splitter (IPv6-aware), shared with
        # the launcher's -H/--hostfile parsing; lenient mode because a
        # discovery script's transient garbage must not kill the driver.
        from ..run.hosts import split_host_slots
        return split_host_slots(line, self.default_slots, strict=False)
