"""Buffer cache (clock replacement) + disk I/O accounting.

The buffer cache stores immutable disk pages of SSTables and their Bloom
filters for *all* LSM-trees, exactly as in AsterixDB (§3 of the paper). Pages
are identified by (sst_id, page_index); Bloom pages use page_index -1.
Evicted page ids are forwarded to the tuner's simulated (ghost) cache so the
memory tuner can estimate the marginal utility of a bigger cache (§5.3).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class IOStats:
    """Page-granularity disk I/O counters (the paper's measured quantities)."""

    pages_flushed: int = 0          # flush writes
    pages_merge_written: int = 0    # merge (compaction) writes
    pages_merge_read: int = 0       # merge reads that missed the cache
    pages_query_read: int = 0       # query reads that missed the cache
    merge_pins: int = 0             # merge page requests (hit or miss)
    query_pins: int = 0             # query page requests (hit or miss)
    flushes_mem: int = 0            # memory-triggered flush events
    flushes_log: int = 0            # log-triggered flush events
    bytes_flushed_mem: int = 0      # write memory flushed by high memory usage
    bytes_flushed_log: int = 0      # write memory flushed by log truncation
    entries_merged_mem: int = 0     # in-memory merge CPU proxy (entries)
    entries_merged_disk: int = 0    # disk merge CPU proxy (entries)
    entries_written: int = 0
    ops: int = 0                    # logical operations observed
    write_stalls: int = 0           # write admission deferrals (service
                                    # backpressure: L0 stall / mem pressure)
    fsyncs: int = 0                 # physical fsync calls (files medium:
                                    # WAL commits + SSTable/manifest writes;
                                    # always 0 on the in-memory medium)
    fused_launches: int = 0         # fused read-path device launches
                                    # (one per store probe, or one per
                                    # tier on the per-tier fused path)
    fused_tiers: int = 0            # lookup tiers covered by those
                                    # launches: tiers/launches is the
                                    # launch-collapse factor BENCH rows
                                    # report as fused_tiers_per_launch
    fused_tier_hits: int = 0        # covered tiers that resolved >= 1
    fused_tier_misses: int = 0      # query vs. those that resolved none
    jit_compiles: int = 0           # backend jit shape-bucket compiles
    jit_cache_hits: int = 0         # backend jit shape-bucket cache hits
                                    # (both 0 on store paths; benchmark
                                    # windows populate them from
                                    # ExecutionBackend.jit_stats deltas)
    lat_p50_us: float = 0.0         # request-latency tail of a measurement
    lat_p99_us: float = 0.0         # window -- 0.0 on store paths;
    lat_p999_us: float = 0.0        # benchmark windows populate them from
    max_stall_us: float = 0.0       # the service's LatencyHistogram deltas
                                    # (max_stall = longest maintenance
                                    # pause inside one submit/drain call)
    bg_segments: int = 0            # maintenance prepare units (merge
                                    # sort/dedup, Bloom builds) consumed
                                    # from a background worker instead of
                                    # computed inline (0 with workers off)
    bg_overlap_us: float = 0.0      # worker compute time those consumed
                                    # units took off the foreground path
    fsync_wait_us: float = 0.0      # foreground time blocked on WAL
                                    # durability: inline fsyncs when
                                    # blocking, only the seal/sync
                                    # barrier waits when async
    flush_slices: int = 0           # proactive paced partial flushes
                                    # released below the hard memory
                                    # threshold (pacer_flush_threshold)

    def copy(self) -> "IOStats":
        return IOStats(**vars(self))

    def delta(self, prev: "IOStats") -> "IOStats":
        return IOStats(**{k: getattr(self, k) - getattr(prev, k)
                          for k in vars(self)})

    @property
    def pages_written(self) -> int:
        return self.pages_flushed + self.pages_merge_written

    @property
    def pages_read(self) -> int:
        return self.pages_merge_read + self.pages_query_read


class ClockCache:
    """Clock (second-chance) page cache with O(1) amortized eviction.

    Slots form a circular buffer; a dict maps page-id -> slot. The hand
    sweeps slots clearing reference bits until it finds a victim.
    """

    _TOMB = None

    def __init__(self, capacity_pages: int, on_evict=None):
        self.capacity = max(0, int(capacity_pages))
        self._slot_of: dict = {}    # pid -> slot index
        self._pids: list = []       # slot -> pid (or _TOMB)
        self._ref: list = []        # slot -> referenced bit
        self._free: list = []       # tombstone slots available for reuse
        self._hand = 0
        self.on_evict = on_evict
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._slot_of)

    def __contains__(self, pid):
        return pid in self._slot_of

    def resize(self, capacity_pages: int) -> None:
        self.capacity = max(0, int(capacity_pages))
        while len(self._slot_of) > self.capacity:
            self._evict_one()

    def _evict_one(self) -> None:
        n = len(self._pids)
        while True:
            self._hand = (self._hand + 1) % n
            pid = self._pids[self._hand]
            if pid is self._TOMB:
                continue
            if self._ref[self._hand]:
                self._ref[self._hand] = 0
            else:
                del self._slot_of[pid]
                self._pids[self._hand] = self._TOMB
                self._free.append(self._hand)
                if self.on_evict is not None:
                    self.on_evict(pid)
                return

    def _install(self, pid) -> None:
        if self._free:
            s = self._free.pop()
            self._pids[s] = pid
            self._ref[s] = 1
        else:
            s = len(self._pids)
            self._pids.append(pid)
            self._ref.append(1)
        self._slot_of[pid] = s
        if len(self._slot_of) > self.capacity:
            self._evict_one()

    def pin(self, pid) -> bool:
        """Request a page. Returns True on hit, False on (simulated) disk read."""
        s = self._slot_of.get(pid)
        if s is not None:
            self._ref[s] = 1
            self.hits += 1
            return True
        self.misses += 1
        if self.capacity > 0:
            self._install(pid)
        return False

    def insert(self, pid) -> None:
        """Install a freshly written page (e.g. merge output) without a miss."""
        if self.capacity > 0 and pid not in self._slot_of:
            self._install(pid)

    def invalidate_many(self, pids) -> None:
        for pid in pids:
            s = self._slot_of.pop(pid, None)
            if s is not None:
                self._pids[s] = self._TOMB
                self._free.append(s)


@dataclass
class Disk:
    """Byte-accounted 'device': tracks I/O through the buffer cache."""

    page_bytes: int
    cache: ClockCache
    ghost: object = None                # tuner's GhostCache (optional)
    stats: IOStats = field(default_factory=IOStats)
    device_pool: object = None          # DevicePagePool (optional): device
                                        # residency for fused tier lookups
    page_store: object = None           # storage_io.FilePageStore (optional):
                                        # cache misses become real preads,
                                        # flush/merge writes become real files

    def query_pin(self, sst_id: int, page_index: int) -> None:
        self.stats.query_pins += 1
        if not self.cache.pin((sst_id, page_index)):
            self.stats.pages_query_read += 1
            if self.ghost is not None:
                self.ghost.on_disk_read((sst_id, page_index), merge=False)
            if self.page_store is not None:
                self.page_store.read_page(sst_id, page_index)

    def query_pin_many(self, sst_id: int, page_indices) -> None:
        """Batched query pins: one pin (hit-or-miss accounted) per entry.

        Accounting is identical to issuing ``query_pin`` per page in order,
        so batched reads and the scalar loop produce the same I/O counters;
        repeated pins of one page within a batch hit the cache after the
        first miss, exactly as in the scalar path.

        Fast path: a *consecutive* repeat pin is always a hit (nothing can
        evict the page between two adjacent pins of it, and the re-pin
        leaves the reference bit set exactly as the first did), so runs of
        repeats collapse to one real pin plus counter bumps. Duplicate-free
        batches pay one vectorized comparison; Bloom-page batches (all the
        same page) skip the Python loop almost entirely. Requires a real
        cache: with capacity 0 every pin misses, including repeats.
        """
        pages = np.asarray(page_indices, np.int64)
        n = len(pages)
        if n > 1 and self.cache.capacity > 0:
            keep = np.empty(n, bool)
            keep[0] = True
            np.not_equal(pages[1:], pages[:-1], out=keep[1:])
            reps = n - int(keep.sum())
            if reps:
                for p in pages[keep]:
                    self.query_pin(sst_id, int(p))
                self.stats.query_pins += reps
                self.cache.hits += reps
                return
        for p in pages:
            self.query_pin(sst_id, int(p))

    def pin_run(self, sst_ids, pages) -> None:
        """Ordered bulk query pins across possibly many tables -- the
        fused replay's hot path. Accounting is identical to calling
        ``query_pin(sst_ids[i], pages[i])`` for every i in sequence; the
        loop just binds the cache's hit path locally so a replay of a few
        hundred pins does not pay four attribute lookups and two call
        frames per page. Callers pass plain int sequences (``.tolist()``)
        so installed pids stay python-int keyed like the scalar path's.
        """
        cache = self.cache
        slot_of = cache._slot_of
        ref = cache._ref
        self.stats.query_pins += len(sst_ids)
        hits = 0
        for pid in zip(sst_ids, pages):
            s = slot_of.get(pid)
            if s is not None:
                ref[s] = 1
                hits += 1
                continue
            cache.misses += 1
            if cache.capacity > 0:
                cache._install(pid)
            self.stats.pages_query_read += 1
            if self.ghost is not None:
                self.ghost.on_disk_read(pid, merge=False)
            if self.page_store is not None:
                self.page_store.read_page(pid[0], pid[1])
        cache.hits += hits

    def merge_pin(self, sst_id: int, page_index: int) -> None:
        self.stats.merge_pins += 1
        if not self.cache.pin((sst_id, page_index)):
            self.stats.pages_merge_read += 1
            if self.ghost is not None:
                self.ghost.on_disk_read((sst_id, page_index), merge=True)
            if self.page_store is not None:
                self.page_store.read_page(sst_id, page_index)

    def merge_read_sst(self, sst) -> None:
        for p in range(sst.num_pages):
            self.merge_pin(sst.sst_id, p)

    def write_sst(self, sst, *, flush: bool) -> None:
        n = sst.num_pages + sst.bloom_pages()
        if flush:
            self.stats.pages_flushed += n
        else:
            self.stats.pages_merge_written += n
        for p in range(sst.num_pages):
            self.cache.insert((sst.sst_id, p))
        self.cache.insert((sst.sst_id, -1))  # bloom pages pinned as one unit
        if self.page_store is not None:
            self.page_store.write(sst)

    def ensure_sst(self, sst) -> None:
        """Make a restored table's file exist without touching counters
        (checkpoint restore re-keys tables to fresh sst_ids; the write
        was already accounted when the original id flushed)."""
        if self.page_store is not None:
            self.page_store.ensure(sst)

    def drop_sst(self, sst) -> None:
        pids = [(sst.sst_id, p) for p in range(-1, sst.num_pages)]
        self.cache.invalidate_many(pids)
        if self.ghost is not None:
            self.ghost.invalidate_many(pids)
        if self.device_pool is not None:
            self.device_pool.drop_sst(sst)
        if self.page_store is not None:
            self.page_store.mark_dropped(sst.sst_id)
