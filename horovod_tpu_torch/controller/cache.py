"""Bounded LRU: the cache behind the bucket planner.

Counterpart of ``horovod_tpu/controller/cache.py::ExecutableCache`` (the
reference's ResponseCache analogue).  There it holds compiled
executables; here it holds bucket plans, which are pure in (shapes,
dtypes, threshold).  The planner keeps one of 1024 entries (the reference's
``HOROVOD_CACHE_CAPACITY`` default); nothing on the port's path sets
another bound.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Hashable, Tuple


class LRUCache:
    """Bounded LRU mapping keys -> built values, with hit/miss/eviction
    counters."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, int(capacity))
        self._od: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                self.hits += 1
                return self._od[key]
        # Build outside the lock: build() must not deadlock against other
        # cache users.
        value = build()
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                self.hits += 1
                return self._od[key]
            self.misses += 1
            self._od[key] = value
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1
            return value

    def stats(self) -> Tuple[int, int, int]:
        return self.hits, self.misses, self.evictions

    def __len__(self) -> int:
        return len(self._od)
