"""Host-list parsing (reference ``horovod/runner/common/util/hosts.py``);
the port's copy of ``horovod_tpu/run/hosts.py``.

``horovodrun -H h1:4,h2:4`` / ``--hostfile`` name the hosts and their
slot counts; a slot is one worker process driving one GPU, and slots
default to 1, as in the JAX launcher.

:func:`split_host_slots` is the one canonical ``host[:slots]`` splitter
(IPv6-aware); elastic discovery shares it in lenient mode.
"""

from __future__ import annotations

from typing import List, Tuple

LOCAL_ALIASES = ("localhost", "127.0.0.1", "::1")


class _NotSlots(Exception):
    """Lenient-mode signal: the suffix was not a slot count."""


def _parse_slots(text: str, item: str, strict: bool,
                 default_slots: int) -> int:
    try:
        n = int(text)
    except ValueError:
        if strict:
            raise ValueError(f"bad host spec {item!r}: slots must be an "
                             f"integer (host[:slots])")
        raise _NotSlots()
    if n < 1:
        if strict:
            raise ValueError(f"bad host spec {item!r}: slots must be >= 1")
        # Lenient (elastic discovery): "host:0" means a DRAINED host --
        # zero slots removes its workers; it must not be reparsed as a
        # phantom hostname with default slots.
        return max(n, 0)
    return n


def split_host_slots(item: str, default_slots: int = 1,
                     strict: bool = False) -> Tuple[str, int]:
    """``host | host:slots | [ipv6] | [ipv6]:slots`` -> ``(host, slots)``.

    A bare IPv6 address (two or more colons, e.g. ``::1``) is a host with
    default slots; only a single-colon suffix (or the bracketed form)
    carries a slot count.  ``strict=True`` raises on malformed input;
    lenient mode (elastic discovery) falls back to the default.
    """
    if item.startswith("["):
        addr, _, rest = item.partition("]")
        host = addr[1:]
        if not host:
            if strict:
                raise ValueError(f"bad host spec {item!r}: empty host")
            return item, default_slots
        if rest.startswith(":"):
            try:
                return host, _parse_slots(rest[1:], item, strict,
                                          default_slots)
            except _NotSlots:
                return item, default_slots
        if rest and strict:
            raise ValueError(f"bad host spec {item!r}: junk after ']'")
        return host, default_slots
    if item.count(":") == 1:
        host, _, slots = item.partition(":")
        if not host:
            if strict:
                raise ValueError(f"bad host spec {item!r}: empty host")
            return item, default_slots
        try:
            return host, _parse_slots(slots, item, strict, default_slots)
        except _NotSlots:
            # Lenient: a non-count suffix means the colon is part of the
            # hostname ("host:gpu" stays one opaque host token).
            return item, default_slots
    return item, default_slots


def parse_host_spec(spec: str, default_slots: int = 1
                    ) -> List[Tuple[str, int]]:
    """``"h1:4,h2:4,h3"`` -> ``[("h1", 4), ("h2", 4), ("h3", 1)]``."""
    out: List[Tuple[str, int]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        out.append(split_host_slots(item, default_slots, strict=True))
    if not out:
        raise ValueError(f"no hosts in spec {spec!r}")
    return out


def parse_hostfile(path: str, default_slots: int = 1
                   ) -> List[Tuple[str, int]]:
    """One ``host [slots=N | :N]`` per line; ``#`` comments allowed.

    Accepts both the reference's hostfile dialect (``host slots=N``, the
    mpirun convention) and the compact ``host:N``.  Slot counts are
    validated like ``-H`` (integer, >= 1).
    """
    out: List[Tuple[str, int]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            host, n = split_host_slots(parts[0], default_slots, strict=True)
            for p in parts[1:]:
                if p.startswith("slots="):
                    n = _parse_slots(p[len("slots="):], line, True,
                                     default_slots)
            out.append((host, n))
    if not out:
        raise ValueError(f"hostfile {path!r} has no hosts")
    return out


def total_slots(hosts: List[Tuple[str, int]]) -> int:
    return sum(n for _, n in hosts)


def all_local(hosts: List[Tuple[str, int]]) -> bool:
    import socket
    local = set(LOCAL_ALIASES) | {socket.gethostname()}
    return all(h in local for h, _ in hosts)
