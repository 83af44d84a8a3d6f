"""Disk levels with dynamic level add/delete (§4.1.3).

Partitioned leveling: each level L1..LN holds disjoint SSTables; the last
level is always treated as full, which fixes the max sizes of the other
levels downward (|L_{N-1}|max = |L_N|/T, ...). Levels are added/deleted at L1
as the tree's write memory share changes:

  add  L1  when  a*Mw*T <  |L1|max           (write memory became too small)
  drop L1  when  a*Mw*T >  f*|L2|max, f=1.5  (write memory became too big)

While L1 is being deleted, L0 merges go *directly* into L2 (together with all
overlapping L1 SSTables — Figure 4), and low-priority L1→L2 merges drain the
remainder; when L1 empties it is removed.
"""
from __future__ import annotations

from .memtable import _insert_disjoint, _overlap_slice
from .sstable import SSTable


class DiskLevels:
    def __init__(self, *, size_ratio: int = 10, shrink_factor: float = 1.5,
                 dynamic: bool = True, static_num_levels: int | None = None):
        self.T = size_ratio
        self.f = shrink_factor
        self.dynamic = dynamic
        self.levels: list[list[SSTable]] = []    # L1 .. LN
        self.deleting_l1 = False
        if not dynamic:
            assert static_num_levels is not None and static_num_levels >= 1
            self.levels = [[] for _ in range(static_num_levels)]

    # -- geometry -------------------------------------------------------------
    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def level_bytes(self, i: int) -> int:
        return sum(s.size_bytes for s in self.levels[i])

    @property
    def total_bytes(self) -> int:
        return sum(self.level_bytes(i) for i in range(self.num_levels))

    def level_max_bytes(self, i: int) -> float:
        """Max size of levels[i], derived from a full last level (§2.1)."""
        if not self.levels:
            return 0.0
        last = self.level_bytes(self.num_levels - 1)
        # The last level is treated as full; walk max sizes upward from it.
        return max(last, 1.0) / (self.T ** (self.num_levels - 1 - i))

    # -- dynamic level count (§4.1.3) ------------------------------------------
    def adjust(self, write_mem_bytes: float) -> None:
        if not self.dynamic:
            return
        if not self.levels:
            self.levels.append([])
            return
        # Add an empty L1 while the write memory is too small for |L1|max.
        while (self.num_levels >= 1 and self.level_bytes(self.num_levels - 1) > 0
               and write_mem_bytes * self.T < self.level_max_bytes(0)
               and self.num_levels < 24):
            self.levels.insert(0, [])
            self.deleting_l1 = False
        # Mark L1 for deletion when the write memory grew past f*|L2|max.
        if self.num_levels >= 2:
            if write_mem_bytes * self.T > self.f * self.level_max_bytes(1):
                self.deleting_l1 = True
            elif write_mem_bytes * self.T < self.level_max_bytes(0):
                self.deleting_l1 = False
        if self.deleting_l1 and self.num_levels >= 2 and not self.levels[0]:
            self.levels.pop(0)                  # L1 drained: remove it
            self.deleting_l1 = False

    # -- merge bookkeeping -----------------------------------------------------
    def l0_target_level(self) -> int:
        """Level index that L0 merges should feed (L2 while deleting L1)."""
        return 1 if (self.deleting_l1 and self.num_levels >= 2) else 0

    def over_full(self):
        """Indices of levels above their max size (never the last level)."""
        out = []
        for i in range(self.num_levels - 1):
            if self.level_bytes(i) > self.level_max_bytes(i):
                out.append(i)
        return out

    def greedy_victim(self, i: int) -> SSTable:
        """Min overlap-ratio SSTable of levels[i] w.r.t. levels[i+1]."""
        nxt = self.levels[i + 1]
        best, best_ratio = None, None
        for s in self.levels[i]:
            a, b = _overlap_slice(nxt, s.min_key, s.max_key)
            ratio = sum(t.size_bytes for t in nxt[a:b]) / s.size_bytes
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = s, ratio
        return best

    def overlapping_in(self, i: int, lo: int, hi: int):
        a, b = _overlap_slice(self.levels[i], lo, hi)
        return self.levels[i][a:b]

    def replace(self, i: int, olds, news) -> None:
        """Swap ``olds`` for ``news`` (disjoint) in levels[i]."""
        ids = {id(t) for t in olds}
        self.levels[i][:] = [s for s in self.levels[i] if id(s) not in ids]
        _insert_disjoint(self.levels[i], news)

    def remove_from(self, i: int, olds) -> None:
        ids = {id(t) for t in olds}
        self.levels[i][:] = [s for s in self.levels[i] if id(s) not in ids]

    # -- reads ---------------------------------------------------------------
    def lookup_tiers(self):
        """Disjoint, sorted table lists in probe order (L1 .. LN); each
        tier holds at most one candidate per key. Used by the batched read
        path."""
        return list(self.levels)

    def tables_covering(self, key: int):
        """One candidate SSTable per level (levels are disjoint), top-down."""
        out = []
        for lvl in self.levels:
            a, b = _overlap_slice(lvl, key, key)
            out.extend(lvl[a:b])                 # at most one
        return out

    def tables_overlapping(self, lo: int, hi: int):
        out = []
        for lvl in self.levels:
            a, b = _overlap_slice(lvl, lo, hi)
            out.extend(lvl[a:b])
        return out
