"""DevicePagePool: the device-resident half of the buffer cache.

The paper's buffer cache is an accounting model (``ClockCache`` pins over
simulated disk pages). This pool makes residency *physical* for the read
hot path: the same clock replacement, over the same (sst_id, page) ids --
key/val pages ``0..num_pages-1`` plus the Bloom unit at ``-1`` -- decides
which SSTables' pages stay device-resident, and a tier whose pages are all
resident is probed through the backend's fused ``lookup_fused`` (one
kernel launch per tier), and a tree whose every tier is resident through
``lookup_store_fused`` (one launch per lookup batch), instead of the
per-SSTable staged calls.

Lifecycle per lookup tier:

  * tier fully resident  -> pin (refresh) its pages, hand back the cached
    ``TierView``; the tree runs the fused probe.
  * any page absent      -> count a tier miss, *admit* the pages (clock
    installs, possibly evicting another tier's pages), and return None;
    this call is served by the staged path with its usual pin accounting,
    the next one finds the tier resident.
  * tier wider than pool -> miss, nothing admitted (it could never fit).

Evicting any page of an SSTable drops the prepared views containing that
table (a view is only valid while the whole tier is resident); SSTables
retired by flush/merge are invalidated through ``Disk.drop_sst`` exactly
like their buffer-cache pages. The pool's byte budget is set through
``MemoryArena.set_device_pool_bytes`` -- the governor's ``MemoryPlan``
actuator -- and a budget of 0 disables the pool entirely (every store
behaves bit-identically to the staged-only engine).

The budget counts logical pages (``budget_bytes // page_bytes``), exactly
as the reference package's pool does, so pins, residency and ``stats()``
are bit-identical to it. The device bytes the prepared views hold (int64
keys and values, one byte per Bloom slot) are not the budget.

Residency is derived state: nothing here is checkpointed, recovery starts
with a cold pool and identical lookup results.
"""
from __future__ import annotations

from .cache import ClockCache


class DevicePagePool:
    """Clock-managed device page pool backing fused tier lookups."""

    def __init__(self, backend, page_bytes: int, budget_bytes: int = 0):
        self.backend = backend
        self.page_bytes = max(1, int(page_bytes))
        self.cache = ClockCache(0, on_evict=self._on_evict)
        self._views: dict = {}        # view key -> TierView/StoreView
        self._views_of: dict = {}     # sst_id -> set of view keys
        self.tier_hits = 0            # tiers served fused
        self.tier_misses = 0          # tiers that fell back to staged
        self.store_hits = 0           # whole stores served one-launch
        self.store_misses = 0         # stores that fell back per-tier
        self._gen = 0                 # budget generation: bumped by every
                                      # set_budget_bytes so an in-flight
                                      # prepare races a shrink safely
        self.set_budget_bytes(budget_bytes)

    # -- budget (the governor's knob) ---------------------------------------
    @property
    def enabled(self) -> bool:
        return self.cache.capacity > 0

    @property
    def budget_bytes(self) -> int:
        return self._budget_bytes

    def set_budget_bytes(self, budget_bytes: int) -> None:
        self._gen += 1
        self._budget_bytes = max(0, int(budget_bytes))
        self.cache.resize(self._budget_bytes // self.page_bytes)
        if not self.enabled:
            self._views.clear()
            self._views_of.clear()

    # -- invalidation -------------------------------------------------------
    @staticmethod
    def _key_ssts(key):
        """sst_ids of a view key: a flat tuple (tier view) or a tuple of
        per-tier tuples (store view)."""
        for s in key:
            if isinstance(s, tuple):
                yield from s
            else:
                yield s

    def _on_evict(self, pid) -> None:
        self._drop_views(pid[0])

    def _drop_views(self, sst_id) -> None:
        for key in self._views_of.pop(sst_id, ()):
            self._views.pop(key, None)
            for s in self._key_ssts(key):
                if s != sst_id and s in self._views_of:
                    self._views_of[s].discard(key)

    def drop_sst(self, sst) -> None:
        """Retire an SSTable (flush/merge replaced it): its pages leave the
        pool and every view over it dies."""
        self.cache.invalidate_many(
            (sst.sst_id, p) for p in range(-1, sst.num_pages))
        self._drop_views(sst.sst_id)

    # -- the read hot path --------------------------------------------------
    def acquire(self, tables, bloom_fn):
        """Return a resident ``TierView`` over ``tables`` (a disjoint,
        min_key-sorted lookup tier) or None when the caller must stay on
        the staged path this call."""
        if not self.enabled or not tables:
            return None
        key = tuple(t.sst_id for t in tables)
        view = self._views.get(key)
        if view is not None:
            # A live view PROVES residency: it was built with every member
            # page in the pool, and every removal path (clock eviction,
            # budget shrink, drop_sst) drops the views over the departed
            # SSTable first. So the hot path is one dict probe -- no
            # per-page walk. Reference bits are not refreshed here; a hot
            # tier the clock nonetheless evicts re-admits on its next miss.
            self.tier_hits += 1
            return view
        pids = [(t.sst_id, p) for t in tables
                for p in range(-1, t.num_pages)]
        if len(pids) > self.cache.capacity:
            self.tier_misses += 1
            return None
        if not all(pid in self.cache for pid in pids):
            # Cold: admit (clock decides what yields) and serve staged.
            self.tier_misses += 1
            for pid in pids:
                self.cache.pin(pid)
            return None
        for pid in pids:          # resident: refresh every reference bit
            self.cache.pin(pid)
        gen = self._gen
        view = self.backend.prepare_tier(tables, bloom_fn)
        if self._gen != gen:
            # A budget change (e.g. governor shrink) raced the prepare:
            # residency may no longer hold, so do not cache or serve the
            # view -- this call stays staged and re-evaluates next batch.
            self.tier_misses += 1
            return None
        self._views[key] = view
        for s in key:
            self._views_of.setdefault(s, set()).add(key)
        self.tier_hits += 1
        return view

    def acquire_store(self, tiers, bloom_fn):
        """Return a resident ``StoreView`` over every lookup tier of one
        tree (newest-first), or None when the caller must fall back to
        the per-tier path this batch. Same lifecycle as ``acquire``, with
        residency judged over the union of every tier's pages: fully
        resident -> refresh + serve (preparing and caching the stacked
        view on first touch); anything absent -> admit and fall back."""
        if not self.enabled or not tiers:
            return None
        key = tuple(tuple(t.sst_id for t in tier) for tier in tiers)
        view = self._views.get(key)
        if view is not None:
            self.store_hits += 1
            return view
        pids = [(t.sst_id, p) for tier in tiers for t in tier
                for p in range(-1, t.num_pages)]
        if len(pids) > self.cache.capacity:
            self.store_misses += 1
            return None
        if not all(pid in self.cache for pid in pids):
            self.store_misses += 1
            for pid in pids:
                self.cache.pin(pid)
            return None
        for pid in pids:
            self.cache.pin(pid)
        gen = self._gen
        view = self.backend.prepare_store(tiers, bloom_fn)
        if self._gen != gen:      # budget shrink raced the prepare
            self.store_misses += 1
            return None
        self._views[key] = view
        for s in self._key_ssts(key):
            self._views_of.setdefault(s, set()).add(key)
        self.store_hits += 1
        return view

    # -- reporting ----------------------------------------------------------
    def stats(self) -> dict:
        return {
            "tier_hits": self.tier_hits,
            "tier_misses": self.tier_misses,
            "store_hits": self.store_hits,
            "store_misses": self.store_misses,
            "page_hits": self.cache.hits,
            "page_misses": self.cache.misses,
            "resident_pages": len(self.cache),
            "capacity_pages": self.cache.capacity,
            "budget_bytes": self._budget_bytes,
        }
