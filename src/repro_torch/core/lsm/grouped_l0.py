"""Grouped L0 structure (§4.1.2).

L0 SSTables are organized into *groups* of mutually disjoint SSTables.
Groups are recency-ordered (``groups[0]`` is the oldest); keys in newer
groups override keys in older groups.

Insertion rule (paper): a flushed SSTable goes into the oldest group such
that no *newer* group contains an overlapping SSTable (and the target group
stays disjoint); otherwise a new (newest) group is created. Equivalently:
find the newest group with an overlap at index ``m`` and insert at ``m+1``.

Merge selection (paper): take the group with the fewest SSTables; among its
SSTables choose the one minimizing |overlapping L1 bytes| / |merged L0
bytes|, where the merged L0 set is the recency-downward closure (every
overlapping SSTable in *older* groups, transitively) — this closure is what
keeps reconciliation correct when the merge output lands in L1.
"""
from __future__ import annotations

from .memtable import _overlap_slice
from .sstable import SSTable


class GroupedL0:
    def __init__(self):
        self.groups: list[list[SSTable]] = []   # oldest .. newest

    # -- bookkeeping ----------------------------------------------------------
    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def num_tables(self) -> int:
        return sum(len(g) for g in self.groups)

    @property
    def total_bytes(self) -> int:
        return sum(s.size_bytes for g in self.groups for s in g)

    @property
    def min_lsn(self) -> int:
        lsns = [s.lsn_min for g in self.groups for s in g]
        return min(lsns) if lsns else 2**62

    def all_tables(self):
        return [s for g in self.groups for s in g]

    # -- insertion (flush arrival) ---------------------------------------------
    def insert(self, sst: SSTable) -> None:
        m = -1
        for gi, g in enumerate(self.groups):
            i, j = _overlap_slice(g, sst.min_key, sst.max_key)
            if j > i:
                m = gi
        target = m + 1
        if target >= len(self.groups):
            self.groups.append([])
        g = self.groups[target]
        g.append(sst)
        g.sort(key=lambda s: s.min_key)

    # -- merge selection ---------------------------------------------------------
    def _closure_down(self, s: SSTable, gi: int):
        """Recency-downward transitive closure of overlapping SSTables.

        Returns a list of (group_index, sst) including (gi, s).
        """
        chosen = {(gi, id(s)): (gi, s)}
        work = [(gi, s)]
        while work:
            g, t = work.pop()
            for g2 in range(g):                  # strictly older groups
                i, j = _overlap_slice(self.groups[g2], t.min_key, t.max_key)
                for t2 in self.groups[g2][i:j]:
                    k = (g2, id(t2))
                    if k not in chosen:
                        chosen[k] = (g2, t2)
                        work.append((g2, t2))
        return list(chosen.values())

    def pick_merge(self, l1: list[SSTable], *, greedy: bool = True):
        """Choose the L0 merge set.

        Returns (l0_tables_newest_group_first, overlapping_l1_slice_bounds).
        ``greedy=False`` reproduces the paper's 'Grouped' baseline: leftmost
        SSTable of the oldest group, closure over *all* groups.
        """
        if not self.groups:
            return [], (0, 0)
        if greedy:
            # fewest-SSTables group; tie broken towards the oldest group
            counts = [(len(g), gi) for gi, g in enumerate(self.groups) if g]
            _, gi = min(counts)
            best_set, best_ratio = None, None
            for s in self.groups[gi]:
                group_set = self._closure_down(s, gi)
                lo = min(t.min_key for _, t in group_set)
                hi = max(t.max_key for _, t in group_set)
                i, j = _overlap_slice(l1, lo, hi)
                l1_bytes = sum(t.size_bytes for t in l1[i:j])
                l0_bytes = sum(t.size_bytes for _, t in group_set)
                ratio = l1_bytes / l0_bytes
                if best_ratio is None or ratio < best_ratio:
                    best_set, best_ratio = group_set, ratio
            chosen = best_set
        else:
            oldest = next(g for g in self.groups if g)
            s = oldest[0]
            gi = self.groups.index(oldest)
            # closure over all groups (always reconciliation-safe)
            chosen = [(gi, s)]
            seen = {id(s)}
            changed = True
            while changed:
                changed = False
                lo = min(t.min_key for _, t in chosen)
                hi = max(t.max_key for _, t in chosen)
                for g2, g in enumerate(self.groups):
                    i, j = _overlap_slice(g, lo, hi)
                    for t in g[i:j]:
                        if id(t) not in seen:
                            seen.add(id(t))
                            chosen.append((g2, t))
                            changed = True
        # newest group first for reconciliation precedence
        chosen.sort(key=lambda gt: -gt[0])
        tables = [t for _, t in chosen]
        lo = min(t.min_key for t in tables)
        hi = max(t.max_key for t in tables)
        return tables, _overlap_slice(l1, lo, hi)

    def remove(self, tables) -> None:
        ids = {id(t) for t in tables}
        for g in self.groups:
            g[:] = [s for s in g if id(s) not in ids]
        self.groups = [g for g in self.groups if g]

    # -- reads ---------------------------------------------------------------
    def lookup_tiers(self):
        """Disjoint, sorted table lists in probe order (newest group
        first); each tier holds at most one candidate per key. Used by the
        batched read path."""
        return list(reversed(self.groups))

    def tables_covering(self, key: int):
        """SSTables possibly containing ``key``, newest group first."""
        out = []
        for g in reversed(self.groups):
            i, j = _overlap_slice(g, key, key)
            out.extend(g[i:j])
        return out

    def tables_overlapping(self, lo: int, hi: int):
        out = []
        for g in reversed(self.groups):
            i, j = _overlap_slice(g, lo, hi)
            out.extend(g[i:j])
        return out


class FlatL0:
    """The original LSM-tree L0 (recency list of possibly-overlapping runs).

    Used by the 'Original' baseline in the grouped-L0 experiment and by the
    monolithic (B+-tree) memory-component baselines, whose full flushes emit
    one run at a time.
    """

    def __init__(self):
        self.runs: list[SSTable] = []            # oldest .. newest

    @property
    def num_groups(self) -> int:                 # each run behaves as a group
        return len(self.runs)

    num_tables = num_groups

    @property
    def total_bytes(self) -> int:
        return sum(s.size_bytes for s in self.runs)

    @property
    def min_lsn(self) -> int:
        return min((s.lsn_min for s in self.runs), default=2**62)

    def all_tables(self):
        return list(self.runs)

    def insert(self, sst: SSTable) -> None:
        self.runs.append(sst)

    def pick_merge(self, l1: list[SSTable], **_):
        """Merge all L0 runs at once (newest first)."""
        if not self.runs:
            return [], (0, 0)
        tables = list(reversed(self.runs))
        lo = min(t.min_key for t in tables)
        hi = max(t.max_key for t in tables)
        return tables, _overlap_slice(l1, lo, hi)

    def remove(self, tables) -> None:
        ids = {id(t) for t in tables}
        self.runs = [s for s in self.runs if id(s) not in ids]

    def lookup_tiers(self):
        """Each run is its own tier (runs may overlap each other), newest
        first -- matching the scalar probe order."""
        return [[s] for s in reversed(self.runs)]

    def tables_covering(self, key: int):
        return [s for s in reversed(self.runs) if s.covers(key)]

    def tables_overlapping(self, lo: int, hi: int):
        return [s for s in reversed(self.runs) if s.overlaps(lo, hi)]
