"""Paged KV-cache management — the paper's memory walls on the device, as
in the reference (``repro.runtime.kvcache``), on the port's clock and
ghost caches.

Device memory regions:
  * **KV page pool** = the paper's *write memory*: fixed-size KV pages,
    allocated on demand per request stream ("tree"), no static per-stream
    limit. When pool pressure is high, a victim stream is chosen by the
    §4.2 flush policies (max-memory / min-LSN / optimal write-rate) and its
    oldest pages are *flushed* (offloaded to host / dropped for recompute).
  * **Prefix cache** = the *buffer cache*: immutable KV pages of shared
    prompt prefixes, clock-replaced, hit = prefill FLOPs saved.

The HBM tuner (hbm_tuner.py) moves the boundary between the two regions
with the paper's §5 machinery (ghost cache + cost derivatives).

Device tensors hold the page pool; this module is the host-side metadata
layer (page tables, LSNs, policies) — exactly the split AsterixDB uses
between its buffer pool and Java metadata.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core.lsm.cache import ClockCache
from ..core.tuner.simcache import GhostCache


@dataclass
class KVPoolConfig:
    page_tokens: int = 64               # tokens per KV page
    total_pages: int = 4096             # HBM budget in pages (both regions)
    pool_pages: int = 2048              # "write memory" share (tunable)
    sim_pages: int = 256                # ghost cache
    policy: str = "opt"                 # mem | lsn | opt
    rate_window: int = 4096             # page-allocations window for OPT


@dataclass
class Stream:
    """One request stream / tenant (the 'LSM-tree' analogue)."""
    name: str
    pages: deque = field(default_factory=deque)   # (page_id, lsn)
    tokens: int = 0
    allocated: int = 0                  # lifetime pages allocated
    offloaded: int = 0                  # pages flushed out of the pool


class PagedKVPool:
    """Host-side page-table layer over a device page-pool tensor."""

    def __init__(self, cfg: KVPoolConfig):
        self.cfg = cfg
        self.free: list[int] = list(range(cfg.total_pages))
        # Monotonic page-id source: region GROWTH (set_regions) mints ids
        # that never collide with any id ever handed out before.
        self._page_id_seq = cfg.total_pages
        self.streams: dict[str, Stream] = {}
        self.lsn = 0
        self._alloc_window: deque = deque()
        # prefix cache: page_id keyed by (hash of prefix chunk)
        self.ghost = GhostCache(cfg.sim_pages)
        self.prefix = ClockCache(cfg.total_pages - cfg.pool_pages,
                                 on_evict=self._on_prefix_evict)
        self.prefix_store: dict = {}     # chunk_hash -> page_id
        self.stats = {"pool_flushes": 0, "prefix_hits": 0,
                      "prefix_misses": 0, "recompute_tokens": 0,
                      "offload_pages": 0, "ops": 0}

    # -- region sizing (the tuner's actuator) --------------------------------
    @property
    def pool_pages_used(self) -> int:
        return sum(len(s.pages) for s in self.streams.values())

    def set_pool_pages(self, n: int) -> None:
        n = int(np.clip(n, 64, self.cfg.total_pages - 64))
        self.cfg.pool_pages = n
        self.prefix.resize(self.cfg.total_pages - n)
        self._enforce_pool()

    def set_regions(self, pool_pages: int, prefix_pages: int) -> None:
        """Resize the pool's TOTAL footprint (the HBM arbiter's lease
        actuator): unlike ``set_pool_pages``, which only moves the
        internal pool/prefix boundary, this grows or shrinks the whole
        region to ``pool_pages + prefix_pages`` device pages.

        Growth mints fresh page ids from a monotonic sequence (never
        reusing an id that may still name a resident device page);
        shrink flushes streams until enough free pages exist, then
        retires ids from the free list. Shrink is clamped to what the
        free list can yield -- live pages are never invalidated out from
        under a stream.
        """
        pool_pages = max(64, int(pool_pages))
        prefix_pages = max(64, int(prefix_pages))
        total = pool_pages + prefix_pages
        if total > self.cfg.total_pages:          # grow: mint fresh ids
            grow = total - self.cfg.total_pages
            self.free.extend(range(self._page_id_seq,
                                   self._page_id_seq + grow))
            self._page_id_seq += grow
        elif total < self.cfg.total_pages:        # shrink: drain free ids
            need = self.cfg.total_pages - total
            guard = 0
            while len(self.free) < need and guard < 10_000:
                guard += 1
                live = [s for s in self.streams.values() if s.pages]
                if not live:
                    break
                self._flush_stream(self._pick_victim(), pages=1)
            drop = min(need, len(self.free))
            if drop:
                del self.free[:drop]
            total = self.cfg.total_pages - drop
            pool_pages = min(pool_pages, total - 64)
        self.cfg.total_pages = total
        self.cfg.pool_pages = int(np.clip(pool_pages, 64, total - 64))
        self.prefix.resize(total - self.cfg.pool_pages)
        self._enforce_pool()

    @property
    def total_pages(self) -> int:
        return self.cfg.total_pages

    # -- stream management -----------------------------------------------------
    def stream(self, name: str) -> Stream:
        if name not in self.streams:
            self.streams[name] = Stream(name)
        return self.streams[name]

    def append_tokens(self, name: str, n_tokens: int) -> None:
        """Decode/prefill appended n_tokens to a stream; allocate pages."""
        s = self.stream(name)
        self.stats["ops"] += 1
        s.tokens += n_tokens
        need = -(-s.tokens // self.cfg.page_tokens) - len(s.pages) \
            - s.offloaded
        for _ in range(max(0, need)):
            self.lsn += 1
            self._alloc_window.append((self.lsn, name))
            if len(self._alloc_window) > self.cfg.rate_window:
                self._alloc_window.popleft()
            if not self.free:
                self._enforce_pool(force_one=True)
            pid = self.free.pop() if self.free else None
            if pid is None:
                self._flush_stream(self._pick_victim(), pages=1)
                pid = self.free.pop()
            s.pages.append((pid, self.lsn))
            s.allocated += 1
        self._enforce_pool()

    def finish_stream(self, name: str) -> None:
        s = self.streams.pop(name, None)
        if s:
            self.free.extend(pid for pid, _ in s.pages)

    # -- §4.2 flush policies ------------------------------------------------------
    def _pick_victim(self) -> Stream:
        live = [s for s in self.streams.values() if s.pages]
        assert live, "no pages to flush"
        pol = self.cfg.policy
        if pol == "mem":
            return max(live, key=lambda s: len(s.pages))
        if pol == "lsn":
            return min(live, key=lambda s: s.pages[0][1])
        # opt: page share proportional to allocation rate
        rates = {s.name: 0 for s in live}
        for _, name in self._alloc_window:
            if name in rates:
                rates[name] += 1
        total_r = max(1, sum(rates.values()))
        total_u = max(1, sum(len(s.pages) for s in live))
        return max(live, key=lambda s: len(s.pages) / total_u
                   - rates[s.name] / total_r)

    def _flush_stream(self, s: Stream, pages: int = 1) -> None:
        """Offload the oldest pages of a stream (partial flush)."""
        for _ in range(min(pages, len(s.pages))):
            pid, _ = s.pages.popleft()
            s.offloaded += 1
            self.free.append(pid)
            self.stats["offload_pages"] += 1
        self.stats["pool_flushes"] += 1

    def _enforce_pool(self, force_one: bool = False) -> None:
        guard = 0
        while (self.pool_pages_used > self.cfg.pool_pages
               or (force_one and not self.free)) and guard < 10_000:
            guard += 1
            live = [s for s in self.streams.values() if s.pages]
            if not live:
                break
            self._flush_stream(self._pick_victim(), pages=1)
            force_one = False

    # -- prefix cache ("buffer cache") ------------------------------------------
    def lookup_prefix(self, chunk_hash: int) -> bool:
        """One prompt chunk: hit avoids page_tokens of prefill recompute."""
        self.stats["ops"] += 1
        hit = self.prefix.pin(chunk_hash)
        if hit:
            self.stats["prefix_hits"] += 1
        else:
            self.stats["prefix_misses"] += 1
            self.stats["recompute_tokens"] += self.cfg.page_tokens
            self.ghost.on_disk_read(chunk_hash, merge=False)
        return hit

    def _on_prefix_evict(self, chunk_hash) -> None:
        self.ghost.add_evicted(chunk_hash)
