"""Memory component structures (§4.1).

``PartitionedMemComponent`` is the paper's contribution: the write memory of
one LSM-tree is itself an in-memory partitioned-leveling LSM-tree — an active
SSTable M0 plus memory levels M1..Mk of immutable, range-partitioned
SSTables. It supports *partial* flushes (one last-level SSTable at a time,
round-robin), min-LSN flushes (the SSTable with the smallest LSN plus all
overlapping SSTables at newer levels, to facilitate log truncation), and
*full* flushes (merge-sort everything).

Baseline components (monolithic B+-tree, Accordion) live in
``core.lsm.baselines``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine import get_backend
from .sstable import (SSTable, partition_run, probe_tier,
                      sstable_from_run)


@dataclass
class MemStats:
    entries_merged: int = 0       # memory-merge CPU proxy
    entries_sealed: int = 0
    merges: int = 0


class MemComponentBase:
    """Interface shared by all memory-component structures.

    LSNs are *log byte offsets*: entry ``i`` of a batch written at log
    position ``lsn0`` carries LSN ``lsn0 + i * entry_bytes``, so one batch
    of n entries is indistinguishable from n batches of one (the
    differential suite relies on this).
    """

    def write(self, keys, vals, lsn0):
        raise NotImplementedError

    def ingest_batch(self, keys, vals, lsn0):
        """Batched write: semantics identical to ``write`` entry-by-entry
        (last occurrence of a duplicated key wins, with its own LSN).
        Structures override this to vectorize; the default defers to the
        scalar path."""
        self.write(keys, vals, lsn0)

    def upkeep_step(self) -> bool:
        """One unit of write-path upkeep that the maintenance scheduler
        runs *before* flush enforcement (e.g. Accordion's seal + pipeline
        merge). Returns True if work was done."""
        return False

    @property
    def used_bytes(self) -> int:
        raise NotImplementedError

    @property
    def min_lsn(self) -> int:
        """Smallest LSN still buffered (inf if empty)."""
        raise NotImplementedError

    def lookup(self, key: int):
        raise NotImplementedError

    def scan_runs(self, lo: int, hi: int):
        """Sorted (keys, vals) runs sliced to [lo, hi] inclusive, newest
        first."""
        raise NotImplementedError

    def lookup_batch(self, keys):
        """Batched point lookups; returns (found bool[n], vals int64[n]).

        Default: scalar fallback loop (monolithic baselines override or
        inherit this; the partitioned component vectorizes it).
        """
        keys = np.asarray(keys, np.int64)
        found = np.zeros(len(keys), bool)
        vals = np.zeros(len(keys), np.int64)
        for i, k in enumerate(keys.tolist()):
            f, v = self.lookup(int(k))
            if f:
                found[i] = True
                vals[i] = v
        return found, vals

    def is_empty(self) -> bool:
        raise NotImplementedError


def _slice_run(keys, vals, lo, hi):
    """Slice a sorted (keys, vals) run to [lo, hi] inclusive; None if the
    slice is empty."""
    i = int(np.searchsorted(keys, lo))
    j = int(np.searchsorted(keys, hi, side="right"))
    return (keys[i:j], vals[i:j]) if j > i else None


def _insert_disjoint(level, ssts):
    """Insert disjoint SSTables into a partitioned level, keep sorted order."""
    level.extend(ssts)
    level.sort(key=lambda s: s.min_key)


def _overlap_slice(level, lo, hi):
    """Return (start, end) index range of SSTables overlapping [lo, hi]."""
    i = 0
    while i < len(level) and level[i].max_key < lo:
        i += 1
    j = i
    while j < len(level) and level[j].min_key <= hi:
        j += 1
    return i, j


class PartitionedMemComponent(MemComponentBase):
    """§4.1.1: in-memory partitioned-leveling LSM-tree."""

    def __init__(self, *, entry_bytes: int, page_bytes: int,
                 active_bytes_max: int, size_ratio: int = 10, backend=None):
        self.entry_bytes = entry_bytes
        self.page_bytes = page_bytes
        self.active_bytes_max = active_bytes_max
        self.T = size_ratio
        self.backend = backend or get_backend()
        self.active: dict = {}            # key -> (val, lsn)
        self.active_lsn_min: int | None = None
        self.levels: list[list[SSTable]] = []   # M1..Mk
        self.rr_key: int = -(2**62)       # round-robin flush cursor (by min_key)
        self.stats = MemStats()

    # -- bookkeeping ---------------------------------------------------------
    @property
    def active_bytes(self) -> int:
        return len(self.active) * self.entry_bytes

    @property
    def used_bytes(self) -> int:
        return self.active_bytes + sum(s.size_bytes
                                       for lvl in self.levels for s in lvl)

    @property
    def min_lsn(self) -> int:
        lsns = [s.lsn_min for lvl in self.levels for s in lvl]
        if self.active_lsn_min is not None:
            lsns.append(self.active_lsn_min)
        return min(lsns) if lsns else 2**62

    def is_empty(self) -> bool:
        return not self.active and not any(self.levels)

    def level_max_bytes(self, i: int) -> int:
        """Max size of memory level M_{i+1} (0-indexed)."""
        return self.active_bytes_max * (self.T ** (i + 1))

    # -- write path ----------------------------------------------------------
    def write(self, keys, vals, lsn0: int) -> None:
        if self.active_lsn_min is None:
            self.active_lsn_min = lsn0
        a = self.active
        e = self.entry_bytes
        for i, k in enumerate(keys):
            a[int(k)] = (int(vals[i]), lsn0 + i * e)

    def ingest_batch(self, keys, vals, lsn0: int) -> None:
        """Vectorized write: one backend sort+dedup call per batch, then a
        single bulk dict update -- bit-identical active state to the
        scalar loop."""
        n = len(keys)
        if n == 0:
            return
        if self.active_lsn_min is None:
            self.active_lsn_min = lsn0
        ks, vs, src = self.backend.ingest_run(
            np.asarray(keys, np.int64), np.asarray(vals, np.int64))
        lsns = lsn0 + src * self.entry_bytes
        self.active.update(
            zip(ks.tolist(), zip(vs.tolist(), lsns.tolist())))

    def over_active_limit(self) -> bool:
        return self.active_bytes >= self.active_bytes_max

    def seal_active(self) -> None:
        """Freeze M0 into an SSTable and merge it into M1 (memory merge)."""
        if not self.active:
            return
        keys = np.fromiter(self.active.keys(), np.int64, len(self.active))
        order = np.argsort(keys)
        keys = keys[order]
        vv = np.array([self.active[int(k)] for k in keys], np.int64)
        vals, lsns = vv[:, 0], vv[:, 1]
        self.stats.entries_sealed += len(keys)
        sst = sstable_from_run(keys, vals, int(lsns.min()), int(lsns.max()),
                               self.entry_bytes, self.page_bytes)
        self.active = {}
        self.active_lsn_min = None
        if not self.levels:
            self.levels.append([])
        self._merge_into_level(0, [sst])

    def _merge_into_level(self, li: int, newer: list[SSTable]) -> None:
        """Merge ``newer`` SSTables (newest-first precedence) into level li."""
        if li >= len(self.levels):
            self.levels.append([])
        lvl = self.levels[li]
        lo = min(s.min_key for s in newer)
        hi = max(s.max_key for s in newer)
        i, j = _overlap_slice(lvl, lo, hi)
        olds = lvl[i:j]
        del lvl[i:j]
        runs = [(s.keys, s.vals) for s in newer] + [(s.keys, s.vals) for s in olds]
        keys, vals = self.backend.merge_runs(runs)
        self.stats.entries_merged += sum(len(r[0]) for r in runs)
        self.stats.merges += 1
        lsn_min = min(s.lsn_min for s in newer + olds)
        lsn_max = max(s.lsn_max for s in newer + olds)
        outs = partition_run(keys, vals, lsn_min, lsn_max, self.entry_bytes,
                             self.page_bytes, self.active_bytes_max)
        _insert_disjoint(lvl, outs)

    def maintain_step(self) -> bool:
        """One memory-merge unit (§4.1.1: greedy min-overlap-ratio victim
        pushed down from the shallowest over-full level; a new last level
        grows when needed). Returns True if a merge ran; once every level
        respects its max size, drops empty trailing levels and returns
        False."""
        for li in range(len(self.levels)):
            lvl = self.levels[li]
            if sum(s.size_bytes for s in lvl) > self.level_max_bytes(li):
                victim = self._greedy_victim(li)
                lvl.remove(victim)
                self._merge_into_level(li + 1, [victim])
                return True
        # Drop empty trailing levels so flush targets the true last level.
        while self.levels and not self.levels[-1]:
            self.levels.pop()
        return False

    def maintain(self) -> None:
        """Run memory merges until every level respects its max size."""
        guard = 0
        while guard < 10_000 and self.maintain_step():
            guard += 1

    def merge_debt(self) -> int:
        """Pending memory-merge units (scheduler ranking signal)."""
        debt = 1 if self.over_active_limit() else 0
        return debt + sum(
            1 for li, lvl in enumerate(self.levels)
            if sum(s.size_bytes for s in lvl) > self.level_max_bytes(li))

    def _greedy_victim(self, li: int) -> SSTable:
        """Pick the SSTable at level li minimizing the overlapping ratio with
        level li+1 (size of overlapping SSTables / size of the victim)."""
        lvl = self.levels[li]
        nxt = self.levels[li + 1] if li + 1 < len(self.levels) else []
        best, best_ratio = None, None
        for s in lvl:
            i, j = _overlap_slice(nxt, s.min_key, s.max_key)
            ov = sum(t.size_bytes for t in nxt[i:j])
            ratio = ov / s.size_bytes
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = s, ratio
        return best

    # -- flush paths ---------------------------------------------------------
    def flush_partial(self):
        """§4.1.1 memory-triggered: round-robin one SSTable off the last level.

        Returns a list with one (keys, vals, lsn_min, lsn_max) run.
        """
        if not any(self.levels):
            self.seal_active()
            self.maintain()
        if not any(self.levels):
            return []
        last = max(i for i, lvl in enumerate(self.levels) if lvl)
        lvl = self.levels[last]
        # round-robin by key: first SSTable with min_key > cursor, else wrap
        pick = next((s for s in lvl if s.min_key > self.rr_key), lvl[0])
        self.rr_key = pick.min_key
        lvl.remove(pick)
        while self.levels and not self.levels[-1]:
            self.levels.pop()
        return [(pick.keys, pick.vals, pick.lsn_min, pick.lsn_max)]

    def flush_min_lsn(self):
        """§4.1.1 log-triggered: flush the min-LSN SSTable plus all
        overlapping SSTables at newer (higher) levels, merged as one run."""
        if not any(self.levels):
            self.seal_active()
            self.maintain()
        if not any(self.levels):
            return []
        best_li, best = None, None
        for li, lvl in enumerate(self.levels):
            for s in lvl:
                if best is None or s.lsn_min < best.lsn_min:
                    best_li, best = li, s
        group = [best]
        self.levels[best_li].remove(best)
        for li in range(best_li - 1, -1, -1):   # newer levels
            lvl = self.levels[li]
            i, j = _overlap_slice(lvl, best.min_key, best.max_key)
            group = lvl[i:j] + group            # newer first
            del lvl[i:j]
        while self.levels and not self.levels[-1]:
            self.levels.pop()
        keys, vals = self.backend.merge_runs([(s.keys, s.vals)
                                              for s in group])
        self.stats.entries_merged += sum(s.num_entries for s in group)
        return [(keys, vals, min(s.lsn_min for s in group),
                 max(s.lsn_max for s in group))]

    def flush_full(self):
        """§4.1.4: merge-sort the entire component into one sorted run."""
        self.seal_active()
        ssts = [s for lvl in self.levels for s in lvl]
        if not ssts:
            return []
        runs = []
        for lvl in self.levels:                  # newer levels first
            runs.extend((s.keys, s.vals) for s in lvl)
        keys, vals = self.backend.merge_runs(runs)
        self.stats.entries_merged += sum(s.num_entries for s in ssts)
        self.levels = []
        return [(keys, vals, min(s.lsn_min for s in ssts),
                 max(s.lsn_max for s in ssts))]

    # -- reads ----------------------------------------------------------------
    def lookup(self, key: int):
        hit = self.active.get(key)
        if hit is not None:
            return True, hit[0]
        for lvl in self.levels:                  # newest level first
            i, j = _overlap_slice(lvl, key, key)
            for s in lvl[i:j]:
                found, val, _ = s.lookup(key)
                if found:
                    return True, val
        return False, 0

    def lookup_batch(self, keys):
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        found = np.zeros(n, bool)
        vals = np.zeros(n, np.int64)
        if self.active:
            a = self.active
            for i, k in enumerate(keys.tolist()):
                hit = a.get(k)
                if hit is not None:
                    found[i] = True
                    vals[i] = hit[0]
        unresolved = ~found
        for lvl in self.levels:                  # newest level first
            if not unresolved.any():
                break
            probe_tier(lvl, keys, found, vals, unresolved,
                       self.backend.lookup_batch)
        return found, vals

    def scan_runs(self, lo: int, hi: int):
        """All in-memory (keys, vals) runs *sliced to* [lo,hi], newest
        first."""
        out = []
        if self.active:
            ks = np.array([k for k in self.active if lo <= k <= hi], np.int64)
            if len(ks):
                ks.sort()
                vs = np.array([self.active[int(k)][0] for k in ks], np.int64)
                out.append((ks, vs))
        for lvl in self.levels:                  # newest level first
            i, j = _overlap_slice(lvl, lo, hi)
            for s in lvl[i:j]:
                r = _slice_run(s.keys, s.vals, lo, hi)
                if r is not None:
                    out.append(r)
        return out
