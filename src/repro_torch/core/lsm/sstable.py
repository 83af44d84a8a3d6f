"""SSTable: immutable sorted run + page/Bloom accounting.

An SSTable stores a sorted, de-duplicated run of (key, value) pairs. In the
real system the value payload lives in disk pages; here we carry values as an
int64 "payload checksum" array so correctness (newest-wins reconciliation) is
fully testable, while I/O is accounted at page granularity exactly as
AsterixDB does (entry_bytes per entry, page_bytes per page, one Bloom filter
per SSTable at ~10 bits/key for a 1% false-positive rate).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

_SST_IDS = itertools.count()

# Reserved payload marking a deleted key. Deletes are writes of this value:
# newest-wins reconciliation carries the tombstone down the tree shadowing
# older versions; reads and scans filter it out. The value is the
# reference package's, so both store the same bytes.
TOMBSTONE = -(2**31) + 1


def reset_sst_ids() -> None:
    """Reset the global SSTable id counter (tests/benchmarks isolation)."""
    global _SST_IDS
    _SST_IDS = itertools.count()


# Reference k-way merge, kept with the execution backends and re-exported
# here for callers of the sstable module.
from ..engine.numpy_backend import merge_runs_numpy as merge_runs  # noqa: E402


def assign_queries(tables, qkeys):
    """Map each query key to the table covering it within a *disjoint,
    min_key-sorted* table list (one memory/disk level, or one L0 group).

    Returns (table_idx, covered): per-query table index (clipped) and a
    bool mask of queries that fall inside some table's key range.
    """
    if not tables:
        return (np.zeros(len(qkeys), np.int64),
                np.zeros(len(qkeys), bool))
    starts = np.fromiter((t.min_key for t in tables), np.int64, len(tables))
    ends = np.fromiter((t.max_key for t in tables), np.int64, len(tables))
    ti = np.searchsorted(starts, qkeys, side="right") - 1
    ok = ti >= 0
    ti = np.clip(ti, 0, len(tables) - 1)
    ok &= qkeys <= ends[ti]
    return ti, ok


def assign_ranges(tables, los, his):
    """Vectorized seek for *range* queries over a disjoint, min_key-sorted
    table list: the tables overlapping range q -- [los[q], his[q]] both
    inclusive -- are exactly ``tables[a[q]:b[q]]``.

    The batched companion of ``assign_queries``: two searchsorted calls
    over sorted table bounds serve the whole batch instead of a per-range
    Python sweep of the table list.
    """
    n = len(los)
    if not tables:
        z = np.zeros(n, np.int64)
        return z, z.copy()
    starts = np.fromiter((t.min_key for t in tables), np.int64, len(tables))
    ends = np.fromiter((t.max_key for t in tables), np.int64, len(tables))
    a = np.searchsorted(ends, los, side="left")      # first table ending >= lo
    b = np.searchsorted(starts, his, side="right")   # tables starting <= hi
    return a.astype(np.int64), np.maximum(a, b).astype(np.int64)


def probe_tier(tables, keys, found, vals, unresolved, lookup_batch, *,
               bloom_gate=None, post_lookup=None):
    """Probe one disjoint, sorted tier with every still-unresolved key,
    scattering hits into ``found``/``vals``/``unresolved`` in place.

    The single home of the batched probe-and-scatter dance (vectorized
    table assignment, per-table backend lookup, double-indexed hit
    scatter) shared by the tree's disk tiers and the partitioned memory
    component's levels. Hooks carry the disk-only concerns:

      bloom_gate(tables, visit, q, ti, ok) -> gate, called once per tier
        with the tables the loop will visit (``visit``, ascending), the
        probed keys and their assignment (the tree probes every visited
        table's filter here in one backend call); then, per visited
        table, gate(sst, sel) -> bool mask over ``q[sel]`` of probes worth
        a binary search (the tree pins Bloom pages here);
      post_lookup(sst, pos, hit) (the tree pins leaf pages here).
    """
    idx_un = np.flatnonzero(unresolved)
    if not len(idx_un) or not tables:
        return
    q = keys[idx_un]
    ti, ok = assign_queries(tables, q)
    visit = np.unique(ti[ok])
    if not len(visit):
        return
    gate = None if bloom_gate is None else bloom_gate(tables, visit, q, ti,
                                                      ok)
    for t_i in visit:
        sst = tables[t_i]
        sel = np.flatnonzero(ok & (ti == t_i))
        if gate is not None:
            positive = gate(sst, sel)
            if not positive.any():
                continue
            sel = sel[positive]
        pos, hit = lookup_batch(sst.keys, q[sel])
        if post_lookup is not None:
            post_lookup(sst, pos, hit)
        gidx = idx_un[sel[hit]]
        found[gidx] = True
        vals[gidx] = sst.vals[pos[hit]]
        unresolved[gidx] = False


@dataclass(eq=False)  # identity equality: SSTables live in Python lists
class SSTable:
    """Immutable sorted run with LSN bookkeeping."""

    keys: np.ndarray
    vals: np.ndarray
    lsn_min: int
    lsn_max: int
    entry_bytes: int
    page_bytes: int
    sst_id: int = field(default_factory=lambda: next(_SST_IDS))
    # Lazily built, backend-owned Bloom filter: (backend_name, filter).
    bloom: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        assert len(self.keys) == len(self.vals)
        assert len(self.keys) > 0, "empty SSTable"

    # -- geometry -----------------------------------------------------------
    @property
    def num_entries(self) -> int:
        return int(len(self.keys))

    @property
    def size_bytes(self) -> int:
        return self.num_entries * self.entry_bytes

    @property
    def min_key(self) -> int:
        return int(self.keys[0])

    @property
    def max_key(self) -> int:
        return int(self.keys[-1])

    @property
    def entries_per_page(self) -> int:
        return max(1, self.page_bytes // max(1, self.entry_bytes))

    @property
    def num_pages(self) -> int:
        return -(-self.num_entries // self.entries_per_page)

    def bloom_pages(self, bits_per_key: int = 10) -> int:
        return max(1, -(-(self.num_entries * bits_per_key // 8) // self.page_bytes))

    # -- key ops ------------------------------------------------------------
    def overlaps(self, lo: int, hi: int) -> bool:
        return self.min_key <= hi and lo <= self.max_key

    def covers(self, key: int) -> bool:
        return self.min_key <= key <= self.max_key

    def lookup(self, key: int):
        """Return (found, value, page_index)."""
        i = int(np.searchsorted(self.keys, key))
        if i < len(self.keys) and int(self.keys[i]) == key:
            return True, int(self.vals[i]), i // self.entries_per_page
        return False, 0, min(i, self.num_entries - 1) // self.entries_per_page


def sstable_from_run(keys, vals, lsn_min, lsn_max, entry_bytes, page_bytes):
    return SSTable(np.asarray(keys, np.int64), np.asarray(vals, np.int64),
                   int(lsn_min), int(lsn_max), int(entry_bytes), int(page_bytes))


def partition_run(keys, vals, lsn_min, lsn_max, entry_bytes, page_bytes,
                  target_bytes):
    """Split a big sorted run into SSTables of ~target_bytes each."""
    n = len(keys)
    if n == 0:
        return []
    per = max(1, target_bytes // max(1, entry_bytes))
    return [sstable_from_run(keys[s:min(n, s + per)], vals[s:min(n, s + per)],
                             lsn_min, lsn_max, entry_bytes, page_bytes)
            for s in range(0, n, per)]


def total_bytes(tables) -> int:
    return sum(t.size_bytes for t in tables)


def overlapping(tables, lo: int, hi: int):
    """Subset of ``tables`` whose key range intersects [lo, hi]."""
    return [t for t in tables if t.overlaps(lo, hi)]
