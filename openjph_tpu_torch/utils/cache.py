"""A bounded map, least recently used entries out first, safe across
threads: the port's caches of header geometry, plan skeletons and burst
runners."""
from __future__ import annotations

import threading
from collections import OrderedDict


class Cache:
    """``get(key, make)`` returns ``key``'s entry, made by ``make()`` on
    a miss; past ``size`` entries the least recently used one goes."""

    def __init__(self, size: int):
        self.size = size
        self._entries: 'OrderedDict' = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, make):
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                value = self._entries[key] = make()
                while len(self._entries) > self.size:
                    self._entries.popitem(last=False)
            else:
                self._entries.move_to_end(key)
            return value
