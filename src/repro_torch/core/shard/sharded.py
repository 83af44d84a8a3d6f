"""ShardedStore: the data plane as N StorageShards behind one memory arena,
as the reference's ``repro.core.shard.sharded``.

``StorageService -> ShardRouter -> N StorageShard`` replaces the direct
``StorageService -> LSMStore`` plumbing at scale. Each shard is a full
``LSMStore`` (its own trees, L0s, levels, flush bookkeeping and
``MaintenanceScheduler``), but the *memory walls stay global*: every shard
draws from ONE ``MemoryArena`` -- one write-memory pool, one clock buffer
cache, one ghost cache, one transaction log, one ``Disk``/``IOStats`` --
and a single ``ShardedMaintenanceScheduler`` arbitrates flushes and merges
across all (shard, tree) pairs under the shared budgets. The governor and
tuner therefore keep adapting ONE boundary, exactly as in the paper, while
the keyspace scales out.

``ShardedStore`` exposes the exact batched ``LSMStore`` surface
(``write_batch`` / ``read_batch`` / ``delete_batch`` / ``scan`` /
``scan_batch``): each batch splits per shard through the deterministic
router, executes per-shard vectorized calls, and scatters results back in
input order. With ``shards=1`` the store is bit-identical -- state,
results, IOStats -- to a bare ``LSMStore`` (enforced differentially); with
``shards=N`` the per-shard key sets partition the input and the shared
counters conserve across shards.
"""
from __future__ import annotations

import numpy as np

from ..engine.scheduler import ShardedMaintenanceScheduler
from ..lsm.arena import MemoryArena
from ..lsm.storage import LSMStore, StoreConfig
from .router import ShardRouter


class StorageShard:
    """One shard of the data plane: an ``LSMStore`` whose memory, cache,
    log and I/O accounting live in the shared arena."""

    __slots__ = ("index", "store")

    def __init__(self, index: int, store: LSMStore):
        self.index = index
        self.store = store

    def __repr__(self):  # pragma: no cover
        return f"StorageShard({self.index}, trees={list(self.store.trees)})"


class ShardedStore:
    """N ``StorageShard``s sharing one ``MemoryArena``, driven by one
    global maintenance scheduler. Drop-in for ``LSMStore`` behind the
    ``StorageService`` front door."""

    def __init__(self, cfg: StoreConfig, *, shards: int | None = None,
                 router: ShardRouter | None = None,
                 wal=None, manifest=None):
        if router is None:
            router = ShardRouter(1 if shards is None else int(shards))
        elif shards is not None and router.n_shards != int(shards):
            raise ValueError(
                f"shards={shards} disagrees with router.n_shards="
                f"{router.n_shards}; pass one or make them match")
        self.cfg = cfg.validate()
        self.router = router
        # ``wal``/``manifest`` adopt an existing durability plane (crash
        # recovery); by default the arena creates a fresh one. The router
        # spec is recorded in the manifest, so a replay of the ONE shared log
        # re-partitions keys through the identical deterministic router.
        self.arena = MemoryArena(cfg, wal=wal, manifest=manifest)
        self.arena.manifest.set_router(
            (router.kind, router.n_shards, router.boundaries))
        # Every shard shares the SAME StoreConfig instance, so a governor
        # flipping cfg.flush_policy steers all shards at once.
        self.shards = [StorageShard(i, LSMStore(cfg, arena=self.arena))
                       for i in range(router.n_shards)]
        self.scheduler = ShardedMaintenanceScheduler(
            [sh.store for sh in self.shards], self.arena,
            merge_budget=cfg.merge_budget)
        self._trees_view: dict | None = None    # cached flat observer view
        self.recovery_info: dict | None = None  # set by durability.recover

    # -- geometry / shared-state views -----------------------------------------
    @property
    def n_shards(self) -> int:
        return self.router.n_shards

    @property
    def disk(self):
        return self.arena.disk

    @property
    def ghost(self):
        return self.arena.ghost

    @property
    def cache(self):
        return self.arena.cache

    @property
    def log_pos(self) -> int:
        return self.arena.log_pos

    @property
    def wal(self):
        """The ONE shared write-ahead log all shards append to."""
        return self.arena.wal

    @property
    def manifest(self):
        """The shared versioned manifest (SSTable edits + checkpoints)."""
        return self.arena.manifest

    def checkpoint(self):
        """Force a durable checkpoint now and truncate the WAL below the
        global min-LSN (the scheduler also checkpoints automatically)."""
        from ..durability.checkpoint import checkpoint_now
        return checkpoint_now(self.arena, self.scheduler)

    @property
    def write_memory_bytes(self) -> int:
        return self.arena.write_memory_bytes

    def set_write_memory(self, x: int) -> None:
        self.arena.set_write_memory(x)

    @property
    def device_pool(self):
        """The shared device page pool behind fused reads (one per arena)."""
        return self.arena.device_pool

    def set_device_pool_bytes(self, budget_bytes: int) -> None:
        self.arena.set_device_pool_bytes(budget_bytes)

    def write_memory_used(self) -> int:
        return sum(sh.store.write_memory_used() for sh in self.shards)

    def min_lsn(self) -> int:
        return self.scheduler._min_lsn()

    @property
    def log_length(self) -> int:
        return self.scheduler._log_length()

    @property
    def trees(self):
        """Flat observer view over every shard's trees, keyed
        ``name@shard`` -- what the tuner/governor iterates to see
        per-shard memory shares and flush/merge counters. Data-path
        callers address trees by bare name; keys route to shards. Cached:
        the view only changes on ``create_tree``."""
        if self._trees_view is None:
            self._trees_view = {f"{name}@{sh.index}": t
                                for sh in self.shards
                                for name, t in sh.store.trees.items()}
        return self._trees_view

    def tree_names(self) -> list[str]:
        return list(self.shards[0].store.trees)

    def shard_tree(self, shard: int, name: str):
        return self.shards[shard].store.trees[name]

    # -- schema ----------------------------------------------------------------
    def create_tree(self, name: str, *, dataset: str | None = None,
                    entry_bytes: int | None = None) -> list:
        """Create the tree in every shard; returns the per-shard trees."""
        self._trees_view = None
        return [sh.store.create_tree(name, dataset=dataset,
                                     entry_bytes=entry_bytes)
                for sh in self.shards]

    # -- write path -------------------------------------------------------------
    def write_batch(self, tree_name: str, keys, vals=None, *, op: bool = True,
                    tick: bool = True) -> None:
        """Batched writes, split per shard in routing order; ONE global
        scheduler tick amortized over all shards (no per-shard ticks)."""
        keys = np.asarray(keys, np.int64)
        if vals is None:
            vals = keys
        vals = np.asarray(vals, np.int64)
        for si, sel in self.router.split(keys):
            self.shards[si].store.write_batch(tree_name, keys[sel],
                                              vals[sel], op=op, tick=False)
        if tick:
            self.scheduler.tick()

    def delete_batch(self, tree_name: str, keys, *, op: bool = True,
                     tick: bool = True) -> None:
        keys = np.asarray(keys, np.int64)
        for si, sel in self.router.split(keys):
            self.shards[si].store.delete_batch(tree_name, keys[sel],
                                               op=op, tick=False)
        if tick:
            self.scheduler.tick()

    def write(self, tree_name: str, keys, vals=None, *, op: bool = True) -> None:
        """Legacy scalar-semantics entry point (ONE logical op per call)."""
        self.write_batch(tree_name, keys, vals, op=False)
        if op:
            self.arena.disk.stats.ops += 1

    def note_ops(self, n: int = 1) -> None:
        self.arena.disk.stats.ops += n

    # -- reads -----------------------------------------------------------------
    def read_batch(self, tree_name: str, keys, *, op: bool = True):
        """Batched point lookups: split per shard, per-shard vectorized
        probes, results scattered back in input order."""
        keys = np.asarray(keys, np.int64)
        found = np.zeros(len(keys), bool)
        vals = np.zeros(len(keys), np.int64)
        for si, sel in self.router.split(keys):
            f, v = self.shards[si].store.read_batch(tree_name, keys[sel],
                                                    op=op)
            found[sel] = f
            vals[sel] = v
        return found, vals

    def lookup(self, tree_name: str, key: int, *, op: bool = True):
        si = self.router.shard_of(int(key))
        return self.shards[si].store.lookup(tree_name, int(key), op=op)

    def scan(self, tree_name: str, lo: int, n: int, *, op: bool = True):
        """Range scan: every shard holds a disjoint key subset, so the
        global count is the sum of per-shard counts -- ONE logical op."""
        if op:
            self.arena.disk.stats.ops += 1
        return int(sum(sh.store.scan(tree_name, int(lo), int(n), op=False)
                       for sh in self.shards))

    def scan_batch(self, tree_name: str, los, ns, *, op: bool = True):
        """Batched range scans: ONE op per range (same contract as the
        unsharded store), counts summed across the shard partition."""
        los = np.asarray(los, np.int64)
        ns = np.asarray(ns, np.int64)
        if op:
            self.arena.disk.stats.ops += len(los)
        counts = np.zeros(len(los), np.int64)
        for sh in self.shards:
            counts += sh.store.scan_batch(tree_name, los, ns, op=False)
        return counts

    # -- reporting ----------------------------------------------------------------
    def sync_mem_stats(self) -> None:
        self.arena.disk.stats.entries_merged_mem = sum(
            t.mem.stats.entries_merged
            for sh in self.shards for t in sh.store.trees.values()
            if hasattr(t.mem, "stats"))

    def shard_tree_stats(self) -> list[dict]:
        """Per-shard sums of the per-tree counters. Because all shards
        write through ONE shared ``Disk``, these must conserve: summed
        over shards they equal the corresponding global ``IOStats``
        fields (tested in the cross-shard conservation suite)."""
        out = []
        for sh in self.shards:
            agg = dict(entries_written=0, bytes_flushed_mem=0,
                       bytes_flushed_log=0, merge_pages_written=0,
                       mem_bytes=0)
            for t in sh.store.trees.values():
                agg["entries_written"] += t.stats.entries_written
                agg["bytes_flushed_mem"] += t.stats.bytes_flushed_mem
                agg["bytes_flushed_log"] += t.stats.bytes_flushed_log
                agg["merge_pages_written"] += t.stats.merge_pages_written
                agg["mem_bytes"] += t.mem_bytes
            out.append(agg)
        return out

    def elapsed(self):
        return self.cfg.time_model.elapsed(self.arena.disk.stats,
                                           scheme=self.cfg.scheme)

    def throughput(self, prev_stats=None) -> float:
        stats = self.arena.disk.stats if prev_stats is None \
            else self.arena.disk.stats.delta(prev_stats)
        io, cpu = self.cfg.time_model.elapsed(stats, scheme=self.cfg.scheme)
        return stats.ops / max(io, cpu, 1e-9)
