"""Simulated ("ghost") cache for the memory tuner (§5.3, after DB2 STMM).

Stores only page IDs. Page ids evicted from the real buffer cache are added
here; when a page is about to be read from disk, a hit in the ghost cache
means the read *would have been saved* had the buffer cache been bigger by
``sim`` bytes. Query and merge reads are attributed separately (saved_q /
saved_m).
"""
from __future__ import annotations

from collections import OrderedDict


class GhostCache:
    def __init__(self, capacity_pages: int):
        self.capacity = max(0, int(capacity_pages))
        self._pages: OrderedDict = OrderedDict()
        self.saved_q = 0
        self.saved_m = 0

    def __len__(self):
        return len(self._pages)

    def resize(self, capacity_pages: int) -> None:
        self.capacity = max(0, int(capacity_pages))
        while len(self._pages) > self.capacity:
            self._pages.popitem(last=False)

    def add_evicted(self, pid) -> None:
        if self.capacity == 0:
            return
        self._pages[pid] = True
        self._pages.move_to_end(pid)
        if len(self._pages) > self.capacity:
            self._pages.popitem(last=False)

    def on_disk_read(self, pid, *, merge: bool) -> None:
        """Called when the buffer cache missed and a real read happens."""
        if self._pages.pop(pid, None) is not None:
            if merge:
                self.saved_m += 1
            else:
                self.saved_q += 1

    def invalidate_many(self, pids) -> None:
        for pid in pids:
            self._pages.pop(pid, None)

    def take_counters(self):
        q, m = self.saved_q, self.saved_m
        self.saved_q = self.saved_m = 0
        return q, m
