"""LSMTree: one tree = memory component + grouped L0 + disk levels (§4).

All disk I/O is accounted through the shared ``Disk`` (page pins via the
buffer cache, flush/merge writes). Point lookups are batched end-to-end:
``lookup_batch`` probes the memory component, L0 groups, and disk levels
with vectorized range assignment and issues one Bloom-probe kernel call
per (tier, batch) through the configured execution backend; compaction
merges dispatch through the same backend (``core.engine``). Per-tree
statistics feed the flush policies (§4.2) and the memory tuner (§5).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine import get_backend
from .cache import Disk
from .grouped_l0 import FlatL0, GroupedL0
from .levels import DiskLevels
from .memtable import MemComponentBase, PartitionedMemComponent
from .sstable import TOMBSTONE, assign_ranges, partition_run, probe_tier


@dataclass
class TreeStats:
    """Per-tree counters over the lifetime (window deltas taken by callers)."""

    entries_written: int = 0
    bytes_written: int = 0
    merge_pages_written: int = 0
    merge_pages_read: int = 0
    bytes_flushed_mem: int = 0
    bytes_flushed_log: int = 0
    lookups: int = 0


class LSMTree:
    def __init__(self, name: str, *, disk: Disk, entry_bytes: int,
                 mem_component: MemComponentBase,
                 sstable_bytes: int,
                 size_ratio: int = 10,
                 l0_max_groups: int = 4,
                 l0_target_groups: int = 2,
                 l0_greedy: bool = True,
                 l0_grouped: bool = True,
                 dynamic_levels: bool = True,
                 static_num_levels: int | None = None,
                 backend=None,
                 fused_scope: str = "store",
                 manifest=None, shard_id: int = 0, workers=None):
        self.name = name
        self.backend = backend or get_backend()
        # Background prepare pool (engine/workers.py; None or disabled =
        # every merge/Bloom compute runs inline). Only pure computation is
        # ever offloaded: all side effects stay on the foreground path.
        self.workers = workers
        self.disk = disk
        # "store": try the one-launch cross-tier probe first, falling back
        # to per-tier fused, then staged. "tier": per-tier fused only.
        self.fused_scope = fused_scope
        # Durability: every on-disk SSTable this tree writes or retires is
        # recorded as a versioned manifest edit (None for bare fixtures).
        self.manifest = manifest
        self.shard_id = shard_id
        self.entry_bytes = entry_bytes
        self.mem = mem_component
        self.sstable_bytes = sstable_bytes
        self.l0 = GroupedL0() if l0_grouped else FlatL0()
        self.l0_max_groups = l0_max_groups
        self.l0_target_groups = l0_target_groups
        self.l0_greedy = l0_greedy
        self.levels = DiskLevels(size_ratio=size_ratio,
                                 dynamic=dynamic_levels,
                                 static_num_levels=static_num_levels)
        self.stats = TreeStats()
        # Memoized per-SSTable Bloom filters, keyed by sst_id: built once
        # per table lifetime (not per probed batch) and invalidated when
        # flush/merge retires the table through _manifest_remove.
        self._bloom_cache: dict = {}
        # §4.1.4 adaptive flush window: (log_pos, bytes) of recent partial flushes
        self.partial_flush_window: list = []

    # -- properties used by policies/tuner -------------------------------------
    @property
    def mem_bytes(self) -> int:
        return self.mem.used_bytes

    @property
    def min_lsn(self) -> int:
        # Log truncation only needs the *memory* component's min LSN: data in
        # L0/levels is already durable on disk.
        return self.mem.min_lsn

    @property
    def last_level_bytes(self) -> int:
        if self.levels.num_levels == 0:
            return 0
        return self.levels.level_bytes(self.levels.num_levels - 1)

    @property
    def disk_bytes(self) -> int:
        return self.levels.total_bytes + self.l0.total_bytes

    # -- durability hooks -------------------------------------------------------
    def _manifest_add(self, sst, kind: str) -> None:
        if self.manifest is not None:
            self.manifest.add_sstable(self.shard_id, self.name, sst, kind)

    def _manifest_remove(self, sst) -> None:
        # The manifest edit marks the table's retirement: its memoized
        # Bloom filter dies with it (the device pool learns through
        # Disk.drop_sst at the same call sites).
        self._bloom_cache.pop(sst.sst_id, None)
        if self.manifest is not None:
            self.manifest.remove_sstable(self.shard_id, self.name, sst)

    # -- write path -------------------------------------------------------------
    def write_batch(self, keys, vals, lsn0: int) -> None:
        """Batched ingest into the memory component (one backend sort+dedup
        call); entry i carries LSN lsn0 + i*entry_bytes, so a batch of n is
        indistinguishable from n scalar writes.

        Batches of one take the component's scalar ``write`` path: that
        keeps the reference loop alive, and the differential suite (which
        replays every batch both ways) pins it bit-identical to
        ``ingest_batch``."""
        n = len(keys)
        if n == 1:
            self.mem.write(keys, vals, lsn0)
        else:
            self.mem.ingest_batch(keys, vals, lsn0)
        self.stats.entries_written += n
        self.stats.bytes_written += n * self.entry_bytes

    # -- flushes (§4.1.1 / §4.1.4) -----------------------------------------------
    def _emit_flush(self, runs, *, trigger: str, log_pos: int) -> int:
        """Partition runs into disk SSTables, write them, insert into L0.

        Returns bytes flushed.
        """
        total = 0
        for keys, vals, lsn_min, lsn_max in runs:
            if len(keys) == 0:
                continue
            for sst in partition_run(keys, vals, lsn_min, lsn_max,
                                     self.entry_bytes, self.disk.page_bytes,
                                     self.sstable_bytes):
                self.disk.write_sst(sst, flush=True)
                self._manifest_add(sst, "flush")
                self.l0.insert(sst)
                self._prepare_bloom(sst)
                total += sst.size_bytes
        if trigger == "mem":
            self.stats.bytes_flushed_mem += total
            self.disk.stats.bytes_flushed_mem += total
            self.disk.stats.flushes_mem += 1
        else:
            self.stats.bytes_flushed_log += total
            self.disk.stats.bytes_flushed_log += total
            self.disk.stats.flushes_log += 1
        return total

    def flush(self, *, trigger: str, log_pos: int, max_log_bytes: int,
              total_write_mem: int, beta: float = 0.5,
              forced_kind: str | None = None) -> int:
        """Flush per §4.1: memory-triggered → partial round-robin; log-
        triggered → adaptive partial(min-LSN)/full via the β window."""
        if isinstance(self.mem, PartitionedMemComponent):
            if forced_kind is None:
                if trigger == "mem":
                    kind = "partial"
                else:
                    # §4.1.4: window of recently partially-flushed bytes
                    self.partial_flush_window = [
                        (p, b) for p, b in self.partial_flush_window
                        if p > log_pos - max_log_bytes]
                    recent = sum(b for _, b in self.partial_flush_window)
                    kind = ("partial" if recent > beta * total_write_mem
                            else "full")
            else:
                kind = forced_kind
            if kind == "partial":
                runs = (self.mem.flush_partial() if trigger == "mem"
                        else self.mem.flush_min_lsn())
            elif kind == "partial_rr":
                runs = self.mem.flush_partial()
            elif kind == "partial_oldest":
                runs = self.mem.flush_min_lsn()
            else:
                runs = self.mem.flush_full()
            flushed = self._emit_flush(runs, trigger=trigger, log_pos=log_pos)
            if kind != "full" and flushed:
                self.partial_flush_window.append((log_pos, flushed))
            return flushed
        # Monolithic components: always a full flush.
        runs = self.mem.flush_full()
        return self._emit_flush(runs, trigger=trigger, log_pos=log_pos)

    # -- merges (maintenance) -----------------------------------------------------
    def _merge_key(self, read):
        """Identity of one merge computation: the sst_ids of the tables it
        reads, in run order. SSTables are immutable and ids are never
        reused within a store, so equal keys imply identical inputs --
        which is what lets a worker-prepared ``merge_runs`` result stand
        in for the inline one bit-for-bit."""
        return ("merge", self.shard_id, self.name,
                tuple(t.sst_id for t in read))

    def _merge_compute(self, read, runs):
        """The merge's pure compute: consume a worker-prepared result for
        these exact inputs, or run ``merge_runs`` inline (always inline
        with workers off -- today's behavior, bit-identical)."""
        w = self.workers
        if w is None or not w.enabled:
            return self.backend.merge_runs(runs)
        return w.take(self._merge_key(read),
                      lambda: self.backend.merge_runs(runs))

    def _prepare_bloom(self, sst) -> None:
        """Speculatively build a fresh table's Bloom filter off-thread
        (the read path will want it; ``_bloom`` consumes it)."""
        w = self.workers
        if w is not None and w.enabled:
            w.submit(("bloom", self.backend.name, sst.sst_id),
                     lambda k=sst.keys, b=self.backend: b.bloom_build(k))

    def _merge_write_out(self, keys, vals, lsn_min, lsn_max):
        outs = partition_run(keys, vals, lsn_min, lsn_max, self.entry_bytes,
                             self.disk.page_bytes, self.sstable_bytes)
        for sst in outs:
            self.disk.write_sst(sst, flush=False)
            self._manifest_add(sst, "merge")
            self.stats.merge_pages_written += sst.num_pages + sst.bloom_pages()
            self._prepare_bloom(sst)
        return outs

    def _purge_tombstones_at_bottom(self, keys, vals, target: int):
        """Drop TOMBSTONE entries when the merge output lands in the
        bottommost level: no older version can exist below it, so the
        tombstone has nothing left to shadow. Keeps delete-heavy
        workloads from accumulating dead entries (and merge bandwidth)
        forever."""
        if target == self.levels.num_levels - 1:
            live = vals != TOMBSTONE
            if not live.all():
                return keys[live], vals[live]
        return keys, vals

    def merge_l0_once(self) -> bool:
        if self.l0.num_groups == 0:
            return False
        ti = self.levels.l0_target_level()
        if self.levels.num_levels == 0:
            self.levels.adjust(self.mem_bytes)
            ti = self.levels.l0_target_level()
        target = self.levels.levels[ti]
        l0_tables, (a, b) = self.l0.pick_merge(target, greedy=self.l0_greedy)
        if not l0_tables:
            return False
        runs = [(t.keys, t.vals) for t in l0_tables]
        read = list(l0_tables)
        lo = min(t.min_key for t in l0_tables)
        hi = max(t.max_key for t in l0_tables)
        # Figure 4: while deleting L1, pull overlapping L1 SSTables along.
        mid_tables = []
        if ti == 1:
            mid_tables = self.levels.overlapping_in(0, lo, hi)
            runs += [(t.keys, t.vals) for t in mid_tables]
            read += mid_tables
            lo = min([lo] + [t.min_key for t in mid_tables])
            hi = max([hi] + [t.max_key for t in mid_tables])
        olds = self.levels.overlapping_in(ti, lo, hi)
        runs += [(t.keys, t.vals) for t in olds]
        read += olds
        for t in read:
            self.disk.merge_read_sst(t)
        keys, vals = self._merge_compute(read, runs)
        keys, vals = self._purge_tombstones_at_bottom(keys, vals, ti)
        self.disk.stats.entries_merged_disk += sum(len(r[0]) for r in runs)
        lsn_min = min(t.lsn_min for t in read)
        lsn_max = max(t.lsn_max for t in read)
        outs = self._merge_write_out(keys, vals, lsn_min, lsn_max)
        self.levels.replace(ti, olds, outs)
        if mid_tables:
            self.levels.remove_from(0, mid_tables)
        self.l0.remove(l0_tables)
        for t in read:
            self.disk.drop_sst(t)
            self._manifest_remove(t)
        return True

    def merge_level_once(self, i: int) -> None:
        victim = self.levels.greedy_victim(i)
        olds = self.levels.overlapping_in(i + 1, victim.min_key, victim.max_key)
        for t in [victim] + olds:
            self.disk.merge_read_sst(t)
        runs = [(victim.keys, victim.vals)] + [(t.keys, t.vals) for t in olds]
        keys, vals = self._merge_compute([victim] + olds, runs)
        keys, vals = self._purge_tombstones_at_bottom(keys, vals, i + 1)
        self.disk.stats.entries_merged_disk += sum(len(r[0]) for r in runs)
        outs = self._merge_write_out(
            keys, vals, min(t.lsn_min for t in [victim] + olds),
            max(t.lsn_max for t in [victim] + olds))
        self.levels.replace(i + 1, olds, outs)
        self.levels.remove_from(i, [victim])
        for t in [victim] + olds:
            self.disk.drop_sst(t)
            self._manifest_remove(t)

    def _l0_needs_merge(self, write_mem_share: float) -> bool:
        l0_bytes_budget = max(write_mem_share, 4 * self.sstable_bytes)
        return (self.l0.num_groups >= max(2, self.l0_target_groups)
                or self.l0.total_bytes > l0_bytes_budget)

    def maintenance_step(self, write_mem_share: float) -> bool:
        """One unit of maintenance work (simulated background threads, in
        priority order: memory seal, memory merge, L0 merge, level merge,
        L1-drain merge). Returns True if work was done; the scheduler's
        per-tick budget counts these units."""
        if isinstance(self.mem, PartitionedMemComponent):
            if self.mem.over_active_limit():
                self.mem.seal_active()
                return True
            if self.mem.maintain_step():
                return True
        self.levels.adjust(write_mem_share)
        if self._l0_needs_merge(write_mem_share) and self.merge_l0_once():
            return True
        over = self.levels.over_full()
        if over:
            self.merge_level_once(over[0])
            return True
        # low-priority drain of L1 while it is being deleted (§4.1.3)
        if self.levels.deleting_l1 and self.levels.num_levels >= 2 \
                and self.levels.levels[0]:
            self.merge_level_once(0)
            self.levels.adjust(write_mem_share)
            return True
        return False

    def merge_debt(self, write_mem_share: float) -> int:
        """Pending maintenance units -- the scheduler's cross-tree ranking
        signal. Zero iff ``maintenance_step`` would find no work (up to a
        ``levels.adjust`` the step itself applies)."""
        debt = 0
        if isinstance(self.mem, PartitionedMemComponent):
            debt += self.mem.merge_debt()
        if self._l0_needs_merge(write_mem_share):
            debt += self.l0.num_groups
        debt += len(self.levels.over_full())
        if self.levels.deleting_l1 and self.levels.num_levels >= 2 \
                and self.levels.levels[0]:
            debt += 1
        return debt

    def preview_merge(self, write_mem_share: float):
        """Best-effort pure preview of the disk merge the next
        ``maintenance_step`` would run: ``(key, runs)`` for the worker
        pool, or None when the next step is not a disk merge (memory
        work first, nothing to merge).

        Mirrors ``maintenance_step``'s selection WITHOUT mutating
        anything -- in particular it does not run ``levels.adjust``, so a
        step whose adjust changes the level structure simply yields a
        stale key. Pending *memory* work (seal, in-memory merges) does
        not block the preview: it never touches L0 or the levels, so the
        disk merge that follows it still reads the previewed tables.
        Staleness is safe by construction: a prepared result is only
        ever consumed when the apply step derives the *same* key from
        the tables it actually reads; a mismatch is just an inline
        compute plus wasted worker cycles."""
        if self.levels.num_levels == 0:
            return None
        if self._l0_needs_merge(write_mem_share) and self.l0.num_groups > 0:
            ti = self.levels.l0_target_level()
            target = self.levels.levels[ti]
            l0_tables, _ = self.l0.pick_merge(target, greedy=self.l0_greedy)
            if not l0_tables:
                return None
            runs = [(t.keys, t.vals) for t in l0_tables]
            read = list(l0_tables)
            lo = min(t.min_key for t in l0_tables)
            hi = max(t.max_key for t in l0_tables)
            if ti == 1:
                mid = self.levels.overlapping_in(0, lo, hi)
                runs += [(t.keys, t.vals) for t in mid]
                read += mid
                lo = min([lo] + [t.min_key for t in mid])
                hi = max([hi] + [t.max_key for t in mid])
            olds = self.levels.overlapping_in(ti, lo, hi)
            runs += [(t.keys, t.vals) for t in olds]
            read += olds
            return self._merge_key(read), runs
        over = self.levels.over_full()
        if over:
            i = over[0]
        elif self.levels.deleting_l1 and self.levels.num_levels >= 2 \
                and self.levels.levels[0]:
            i = 0                            # low-priority L1 drain
        else:
            return None
        victim = self.levels.greedy_victim(i)
        olds = self.levels.overlapping_in(i + 1, victim.min_key,
                                          victim.max_key)
        runs = [(victim.keys, victim.vals)] + [(t.keys, t.vals)
                                               for t in olds]
        return self._merge_key([victim] + olds), runs

    def merge_debt(self, write_mem_share: float) -> int:
        """Pending maintenance units -- the scheduler's cross-tree ranking
        signal. Zero iff ``maintenance_step`` would find no work (up to a
        ``levels.adjust`` the step itself applies)."""
        debt = 0
        if isinstance(self.mem, PartitionedMemComponent):
            debt += self.mem.merge_debt()
        if self._l0_needs_merge(write_mem_share):
            debt += self.l0.num_groups
        debt += len(self.levels.over_full())
        if self.levels.deleting_l1 and self.levels.num_levels >= 2 \
                and self.levels.levels[0]:
            debt += 1
        return debt

    # -- reads ---------------------------------------------------------------
    def _bloom(self, sst):
        """Backend-built Bloom filter of one SSTable, memoized per sst_id
        for the table's lifetime (rebuilt if a differently-named backend
        owns the cached one; invalidated at the manifest edit sites)."""
        ent = self._bloom_cache.get(sst.sst_id)
        if ent is None or ent[0] != self.backend.name:
            w = self.workers
            if w is not None and w.enabled:
                fil = w.take(("bloom", self.backend.name, sst.sst_id),
                             lambda: self.backend.bloom_build(sst.keys))
            else:
                fil = self.backend.bloom_build(sst.keys)
            ent = (self.backend.name, fil)
            self._bloom_cache[sst.sst_id] = ent
        return ent[1]

    def _bloom_gate(self, tables, visit, q, ti, ok):
        """bloom_gate hook of ``probe_tier``: the Bloom probe of every
        table the tier's loop visits, as one backend call (each covered
        key against its own table's filter). The per-table gate it returns
        pins the table's Bloom pages (one pin per probed key, as in the
        scalar path) and hands back the table's part of the mask."""
        sel = np.flatnonzero(ok)
        mask = np.zeros(len(q), bool)
        mask[sel] = self.backend.bloom_probe_tier(
            [self._bloom(tables[t]) for t in visit], q[sel],
            np.searchsorted(visit, ti[sel]))

        def gate(sst, rows):
            self.disk.query_pin_many(sst.sst_id, [-1] * len(rows))
            return mask[rows]
        return gate

    def _leaf_pins(self, sst, pos, hit):
        """post_lookup hook: touch the leaf page of every Bloom positive."""
        epp = sst.entries_per_page
        pages = np.where(hit, pos,
                         np.minimum(pos, sst.num_entries - 1)) // epp
        self.disk.query_pin_many(sst.sst_id, pages)

    @staticmethod
    def _pin_meta(view, rr, tier):
        """Per-table geometry vectors (sst_id, entries_per_page,
        num_entries) of one tier, memoized on the pooled view -- the view
        is dropped whenever the tier's membership changes, so the memo
        can never go stale."""
        memo = getattr(view, "_pin_meta", None)
        if memo is None:
            memo = view._pin_meta = {}
        m = memo.get(rr)
        if m is None:
            n = len(tier)
            m = (np.fromiter((s.sst_id for s in tier), np.int64, n),
                 np.fromiter((s.entries_per_page for s in tier),
                             np.int64, n),
                 np.fromiter((s.num_entries for s in tier), np.int64, n))
            memo[rr] = m
        return m

    def _replay_tier_pins(self, meta, tis, starts, positive, pos, hit):
        """Issue one tier's staged-order pin sequence -- per visited
        table: one Bloom-unit pin per probed query, then the leaf page of
        every Bloom positive -- built as flat arrays and executed through
        ``Disk.pin_run``, accounting-identical to the per-group
        ``query_pin_many``/``_leaf_pins`` loop. All inputs are in visit
        order (stable-sorted by table, query order within a table)."""
        sst_ids, epp, nent = meta
        bounds = np.append(starts, len(tis))
        nq = np.diff(bounds)                       # Bloom pins per group
        nl = np.add.reduceat(positive.astype(np.intp), starts)
        tot = nq + nl
        gs = np.concatenate(([0], np.cumsum(tot)[:-1]))
        S = np.empty(int(tot.sum()), np.int64)
        P = np.empty(len(S), np.int64)
        G = len(starts)
        grp_b = np.repeat(np.arange(G), nq)
        intra_b = np.arange(int(nq.sum())) - np.repeat(np.cumsum(nq) - nq,
                                                       nq)
        db = gs[grp_b] + intra_b
        S[db] = sst_ids[tis[starts]][grp_b]
        P[db] = -1
        psel = np.flatnonzero(positive)
        if len(psel):
            t_p = tis[psel]
            pp, hh = pos[psel], hit[psel]
            lp = np.where(hh, pp,
                          np.minimum(pp, nent[t_p] - 1)) // epp[t_p]
            grp_l = np.repeat(np.arange(G), nl)
            intra_l = np.arange(len(psel)) - np.repeat(np.cumsum(nl) - nl,
                                                       nl)
            dl = gs[grp_l] + nq[grp_l] + intra_l
            S[dl] = sst_ids[t_p]
            P[dl] = lp
        self.disk.pin_run(S.tolist(), P.tolist())

    def _probe_tier_fused(self, tier, keys, found, vals, unresolved) -> bool:
        """Fused twin of ``probe_tier``: one kernel launch for the whole
        tier through the pooled ``TierView``, then a host
        replay of the staged path's exact per-table pin sequence -- so
        results, page pins and IOStats are bit-identical to the staged
        loop. Returns False when this tier must take the staged path for
        this call (pool disabled or cold).
        """
        pool = self.disk.device_pool
        if pool is None or not pool.enabled:
            return False
        idx_un = np.flatnonzero(unresolved)
        if not len(idx_un) or not tier:
            return True                    # the staged loop would no-op too
        view = pool.acquire(tier, self._bloom)
        if view is None:
            return False
        r = self.backend.lookup_fused(view, keys[idx_un])
        st = self.disk.stats
        st.fused_launches += 1
        st.fused_tiers += 1
        okidx = np.flatnonzero(r.ok)
        if not len(okidx):
            st.fused_tier_misses += 1
            return True
        # Group by table with ONE stable sort: ascending table order, and
        # ascending query order within a table -- exactly the staged loop's
        # (np.unique, flatnonzero) visit order without T full-batch scans.
        order = okidx[np.argsort(r.ti[okidx], kind="stable")]
        tis = r.ti[order]
        starts = np.flatnonzero(np.r_[True, tis[1:] != tis[:-1]])
        self._replay_tier_pins(self._pin_meta(view, 0, tier), tis, starts,
                               r.positive[order], r.pos[order],
                               r.hit[order])
        sel = np.flatnonzero(r.hit)            # hit implies ok & positive
        gidx = idx_un[sel]
        found[gidx] = True
        vals[gidx] = r.vals[sel]
        unresolved[gidx] = False
        if r.hit.any():
            st.fused_tier_hits += 1
        else:
            st.fused_tier_misses += 1
        return True

    def _probe_store_fused(self, tiers, keys, found, vals, unresolved):
        """One-launch twin of the whole tier loop: a single fused probe of
        every lookup tier through the pooled ``StoreView`` (Bloom stack +
        ranged search + on-device newest-wins argmin), then a host replay
        of the staged path's exact per-tier, per-table pin sequence. The
        replay visits tier r only for the queries the staged loop would
        still have had unresolved there (``win`` == -1 or >= r), so page
        pins and IOStats stay bit-identical. Returns False when the batch
        must fall back to the per-tier (and from there staged) path (pool
        disabled or cold)."""
        pool = self.disk.device_pool
        if pool is None or not pool.enabled:
            return False
        idx_un = np.flatnonzero(unresolved)
        tiers = [t for t in tiers if t]
        if not len(idx_un) or not tiers:
            return True                    # the tier loop would no-op too
        view = pool.acquire_store(tiers, self._bloom)
        if view is None:
            return False
        r = self.backend.lookup_store_fused(view, keys[idx_un])
        st = self.disk.stats
        st.fused_launches += 1
        st.fused_tiers += len(tiers)
        win = r.win
        for rr, tier in enumerate(tiers):
            # Staged-order activity: a query reaches tier rr iff no newer
            # tier resolved it.
            active = (win == -1) | (win >= rr)
            sel0 = np.flatnonzero(r.ok[rr] & active)
            if len(sel0):
                order = sel0[np.argsort(r.ti[rr][sel0], kind="stable")]
                tis = r.ti[rr][order]
                starts = np.flatnonzero(np.r_[True, tis[1:] != tis[:-1]])
                self._replay_tier_pins(self._pin_meta(view, rr, tier),
                                       tis, starts, r.positive[rr][order],
                                       r.pos[rr][order], r.hit[rr][order])
            if (win == rr).any():
                st.fused_tier_hits += 1
            else:
                st.fused_tier_misses += 1
        res = np.flatnonzero(win >= 0)
        gidx = idx_un[res]
        found[gidx] = True
        vals[gidx] = r.vals[win[res], res]
        unresolved[gidx] = False
        return True

    def lookup_batch(self, keys):
        """Batched point lookups; returns (found bool[n], vals int64[n]).

        Probe order matches the scalar semantics: memory component, then L0
        newest-group-first, then disk levels top-down; a key stops probing
        once resolved. With the device pool on, the whole store is probed
        in one launch, or each resident tier in one; otherwise (and for a
        cold tier) the staged path runs one Bloom probe per (tier, batch)
        and one sorted probe per (SSTable, batch)."""
        keys = np.asarray(keys, np.int64)
        self.stats.lookups += len(keys)
        found, vals = self.mem.lookup_batch(keys)
        unresolved = ~found
        tiers = self.l0.lookup_tiers() + self.levels.lookup_tiers()
        # Whole-store hot path first: ONE device launch for every tier.
        # Any miss (cold pool) falls back to the per-tier
        # fused loop -- whose own cold ``acquire`` calls admit pages, so
        # the store stack is typically resident by the next batch.
        if unresolved.any() and self.fused_scope == "store" \
                and self._probe_store_fused(tiers, keys, found, vals,
                                            unresolved):
            tiers = []
        for tier in tiers:
            if not unresolved.any():
                break
            # Device-resident hot path first: one fused probe per tier.
            # Any miss (cold pool) stays on the staged loop
            # for this call with identical results and pin accounting.
            if self._probe_tier_fused(tier, keys, found, vals, unresolved):
                continue
            probe_tier(tier, keys, found, vals, unresolved,
                       self.backend.lookup_batch,
                       bloom_gate=self._bloom_gate,
                       post_lookup=self._leaf_pins)
        # A tombstone *resolves* its key (it shadows older versions, so
        # probing stopped at it) but reads back as absent.
        dead = found & (vals == TOMBSTONE)
        found[dead] = False
        vals[dead] = 0
        return found, vals

    def lookup(self, key: int):
        """Scalar lookup: a batch of one (same probe path and accounting)."""
        found, vals = self.lookup_batch(np.array([key], np.int64))
        return bool(found[0]), int(vals[0])

    def scan_batch(self, los, ns):
        """Batched range scans with reconciliation; returns live-entry
        counts int64[q].

        The *seek* is vectorized: for every disjoint tier (L0 groups, disk
        levels), the overlapping-table span of all ranges comes from one
        ``assign_ranges`` call (two searchsorted passes over the tier
        bounds) instead of a per-range sweep of the table lists. Per range,
        page pins, run slicing and the newest-first reconciliation merge
        then run exactly as the scalar ``scan`` did, so a batch of q scans
        is bit-identical -- counts, pins, IOStats -- to q scalar calls."""
        los = np.asarray(los, np.int64)
        ns = np.asarray(ns, np.int64)
        nq = len(los)
        self.stats.lookups += nq
        counts = np.zeros(nq, np.int64)
        if nq == 0:
            return counts
        his = los + ns       # key-space width proxy (uniform key density)
        tiers = self.l0.lookup_tiers() + self.levels.lookup_tiers()
        spans = [assign_ranges(tier, los, his - 1) for tier in tiers]
        for q in range(nq):
            lo, hi = int(los[q]), int(his[q])
            # every memory-component structure provides sliced scan runs
            runs = list(self.mem.scan_runs(lo, hi - 1))
            for tier, (a, b) in zip(tiers, spans):
                for sst in tier[a[q]:b[q]]:
                    i = int(np.searchsorted(sst.keys, lo))
                    j = int(np.searchsorted(sst.keys, hi))
                    if j <= i:
                        continue
                    epp = sst.entries_per_page
                    self.disk.query_pin_many(
                        sst.sst_id, np.arange(i // epp, (j - 1) // epp + 1))
                    runs.append((sst.keys[i:j], sst.vals[i:j]))
            if runs:
                keys, vals = self.backend.merge_runs(runs)
                counts[q] = np.count_nonzero(vals != TOMBSTONE)
        return counts

    def scan(self, lo: int, n_entries: int):
        """Scalar range scan: a batch of one (same seek path, pins and
        accounting as ``scan_batch``)."""
        return int(self.scan_batch(np.array([lo], np.int64),
                                   np.array([n_entries], np.int64))[0])
