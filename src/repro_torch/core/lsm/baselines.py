"""Baseline memory-component structures evaluated in §6.

- ``BTreeMemComponent``: monolithic updatable B+-tree memory component, as in
  RocksDB/HBase/AsterixDB. ~2/3 page utilization (internal fragmentation,
  Yao 1978), always flushed in full.
- ``AccordionMemComponent``: Accordion's multi-level memory structure
  (pipeline of immutable flat segments + in-memory compactions). The
  *index* variant merges only the key index (the value log keeps obsolete
  versions, so memory is not reclaimed); the *data* variant rewrites the
  data too, but a big merge temporarily doubles that component's footprint,
  which can force flushes (§6.2.1).
"""
from __future__ import annotations

import numpy as np

from ..engine import get_backend
from .memtable import MemComponentBase, MemStats, _slice_run

_INF = 2**62


class BTreeMemComponent(MemComponentBase):
    B_TREE_UTILIZATION = 2.0 / 3.0

    def __init__(self, *, entry_bytes: int, backend=None, **_):
        self.entry_bytes = entry_bytes
        self.backend = backend or get_backend()
        self.data: dict = {}
        self.lsn_min_: int = _INF
        self.lsn_max_: int = 0
        self.stats = MemStats()

    def write(self, keys, vals, lsn0: int) -> None:
        d = self.data
        for i, k in enumerate(keys):
            d[int(k)] = int(vals[i])
        self.lsn_min_ = min(self.lsn_min_, lsn0)
        self.lsn_max_ = max(self.lsn_max_, lsn0 + len(keys) * self.entry_bytes)

    def ingest_batch(self, keys, vals, lsn0: int) -> None:
        # A dict is already last-occurrence-wins and _seal sorts at flush
        # time, so a bulk update of the raw batch is bit-identical to a
        # backend sort+dedup -- no kernel call needed here.
        n = len(keys)
        if n == 0:
            return
        self.data.update(zip(np.asarray(keys, np.int64).tolist(),
                             np.asarray(vals, np.int64).tolist()))
        self.lsn_min_ = min(self.lsn_min_, lsn0)
        self.lsn_max_ = max(self.lsn_max_, lsn0 + n * self.entry_bytes)

    @property
    def used_bytes(self) -> int:
        # fragmentation: pages are ~2/3 full in an updatable B+-tree
        return int(len(self.data) * self.entry_bytes / self.B_TREE_UTILIZATION)

    @property
    def min_lsn(self) -> int:
        return self.lsn_min_ if self.data else _INF

    def is_empty(self) -> bool:
        return not self.data

    def lookup(self, key: int):
        v = self.data.get(key)
        return (True, v) if v is not None else (False, 0)

    def flush_full(self):
        if not self.data:
            return []
        keys = np.fromiter(self.data.keys(), np.int64, len(self.data))
        order = np.argsort(keys)
        keys = keys[order]
        vals = np.array([self.data[int(k)] for k in keys], np.int64)
        out = [(keys, vals, self.lsn_min_, self.lsn_max_)]
        self.data = {}
        self.lsn_min_, self.lsn_max_ = _INF, 0
        return out

    # monolithic structures only support full flushes
    flush_partial = flush_full
    flush_min_lsn = flush_full

    def scan_runs(self, lo: int, hi: int):
        ks = np.array([k for k in self.data if lo <= k <= hi], np.int64)
        if not len(ks):
            return []
        ks.sort()
        vs = np.array([self.data[int(k)] for k in ks], np.int64)
        return [(ks, vs)]


class AccordionMemComponent(MemComponentBase):
    INDEX_ENTRY_BYTES = 16           # key + offset in the value log

    def __init__(self, *, entry_bytes: int, active_bytes_max: int,
                 merge_data: bool, pipeline_threshold: int = 4,
                 backend=None, **_):
        self.backend = backend or get_backend()
        self.entry_bytes = entry_bytes
        self.active_bytes_max = active_bytes_max
        self.merge_data = merge_data            # Accordion-data vs -index
        self.pipeline_threshold = pipeline_threshold
        self.active: dict = {}
        self.segments: list = []                # newest last: (keys, vals, raw_bytes, lsn_min, lsn_max)
        self.lsn_min_: int = _INF
        self.lsn_max_: int = 0
        self.stats = MemStats()
        self.request_flush = False              # set when a data-merge peak blows the budget
        self.budget_hint_bytes: int = _INF      # set by the store before maintenance

    # -- write path ------------------------------------------------------------
    def write(self, keys, vals, lsn0: int) -> None:
        # Seal + pipeline merges are *not* inline: the maintenance
        # scheduler drives them through ``upkeep_step`` at tick time.
        a = self.active
        for i, k in enumerate(keys):
            a[int(k)] = int(vals[i])
        self.lsn_min_ = min(self.lsn_min_, lsn0)
        self.lsn_max_ = max(self.lsn_max_, lsn0 + len(keys) * self.entry_bytes)

    def ingest_batch(self, keys, vals, lsn0: int) -> None:
        # As in BTreeMemComponent: the active dict is last-wins and _seal
        # sorts, so a bulk update beats a backend sort+dedup round-trip.
        n = len(keys)
        if n == 0:
            return
        self.active.update(zip(np.asarray(keys, np.int64).tolist(),
                               np.asarray(vals, np.int64).tolist()))
        self.lsn_min_ = min(self.lsn_min_, lsn0)
        self.lsn_max_ = max(self.lsn_max_, lsn0 + n * self.entry_bytes)

    def over_active_limit(self) -> bool:
        return len(self.active) * self.entry_bytes >= self.active_bytes_max

    def upkeep_step(self) -> bool:
        if self.over_active_limit():
            self._seal()
            return True
        if len(self.segments) > self.pipeline_threshold:
            self._merge_pipeline()
            return True
        return False

    def _seal(self) -> None:
        if not self.active:
            return
        keys = np.fromiter(self.active.keys(), np.int64, len(self.active))
        order = np.argsort(keys)
        keys = keys[order]
        vals = np.array([self.active[int(k)] for k in keys], np.int64)
        raw = len(keys) * self.entry_bytes
        self.segments.append((keys, vals, raw, self.lsn_min_, self.lsn_max_))
        self.stats.entries_sealed += len(keys)
        self.active = {}

    def _merge_pipeline(self) -> None:
        runs = [(s[0], s[1]) for s in reversed(self.segments)]  # newest first
        keys, vals = self.backend.merge_runs(runs)
        self.stats.entries_merged += sum(len(r[0]) for r in runs)
        self.stats.merges += 1
        lsn_min = min(s[3] for s in self.segments)
        lsn_max = max(s[4] for s in self.segments)
        if self.merge_data:
            # data rewrite: obsolete values reclaimed, but the merge itself
            # transiently holds both old and new copies.
            peak = (sum(s[2] for s in self.segments)
                    + len(keys) * self.entry_bytes)
            if peak > self.budget_hint_bytes:
                self.request_flush = True
            raw = len(keys) * self.entry_bytes
        else:
            # index-only merge: the value log keeps obsolete versions
            raw = sum(s[2] for s in self.segments)
        self.segments = [(keys, vals, raw, lsn_min, lsn_max)]

    # -- bookkeeping -------------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        seg = sum(s[2] + len(s[0]) * self.INDEX_ENTRY_BYTES
                  for s in self.segments)
        return seg + len(self.active) * self.entry_bytes

    @property
    def min_lsn(self) -> int:
        lsns = [s[3] for s in self.segments]
        if self.active:
            lsns.append(self.lsn_min_)
        return min(lsns) if lsns else _INF

    def is_empty(self) -> bool:
        return not self.active and not self.segments

    def lookup(self, key: int):
        v = self.active.get(key)
        if v is not None:
            return True, v
        for keys, vals, *_ in reversed(self.segments):
            i = int(np.searchsorted(keys, key))
            if i < len(keys) and int(keys[i]) == key:
                return True, int(vals[i])
        return False, 0

    def lookup_batch(self, qkeys):
        qkeys = np.asarray(qkeys, np.int64)
        n = len(qkeys)
        found = np.zeros(n, bool)
        vals = np.zeros(n, np.int64)
        a = self.active
        for i, k in enumerate(qkeys.tolist()):
            v = a.get(k)
            if v is not None:
                found[i] = True
                vals[i] = v
        for keys, segvals, *_ in reversed(self.segments):
            unresolved = np.flatnonzero(~found)
            if not len(unresolved):
                break
            if not len(keys):
                continue
            pos, hit = self.backend.lookup_batch(keys, qkeys[unresolved])
            gidx = unresolved[hit]
            found[gidx] = True
            vals[gidx] = segvals[pos[hit]]
        return found, vals

    def scan_runs(self, lo: int, hi: int):
        out = []
        ks = np.array([k for k in self.active if lo <= k <= hi], np.int64)
        if len(ks):
            ks.sort()
            out.append((ks, np.array([self.active[int(k)] for k in ks],
                                     np.int64)))
        for keys, vals, *_ in reversed(self.segments):
            r = _slice_run(keys, vals, lo, hi)
            if r is not None:
                out.append(r)
        return out

    # -- flush (whole component, HBase-style) --------------------------------------
    def flush_full(self):
        self._seal()
        if not self.segments:
            return []
        runs = [(s[0], s[1]) for s in reversed(self.segments)]
        keys, vals = self.backend.merge_runs(runs)
        if len(runs) > 1:
            self.stats.entries_merged += sum(len(r[0]) for r in runs)
        lsn_min = min(s[3] for s in self.segments)
        lsn_max = max(s[4] for s in self.segments)
        self.segments = []
        self.request_flush = False
        self.lsn_min_, self.lsn_max_ = _INF, 0
        return [(keys, vals, lsn_min, lsn_max)]

    flush_partial = flush_full
    flush_min_lsn = flush_full
