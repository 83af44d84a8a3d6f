"""MemoryArena: the shared memory pool one or more LSM stores draw from.

The paper's architecture (§3) pools write memory and the buffer cache so
the tuner can move memory to where the workload needs it. ``MemoryArena``
is that pool as an object: it owns the tunable write-memory size ``x``,
the clock buffer cache of ``total - x - sim`` pages, the ghost (simulated)
cache feeding the tuner, the byte-accounted ``Disk`` (and therefore the
global ``IOStats``), and the *durability plane*: one typed
``WriteAheadLog`` (the transaction log whose byte offsets are the LSNs)
and one versioned ``Manifest`` (the durable record of on-disk SSTable
state, carrying checkpoints). Write-memory resizes are logged as control
records so crash recovery can re-apply them by value.

A standalone ``LSMStore`` creates a private arena; a ``ShardedStore``
creates ONE arena and hands it to every shard, which is how the paper's
memory walls become *cross-shard* walls: all shards compete for the same
write memory and buffer cache, append to the same log, and the
governor/tuner arbitrates the boundary globally by resizing this arena.

``log_pos`` remains the canonical name for the log's byte position --
kept as a compat property over ``wal.head_lsn`` (the setter moves the WAL
head without a payload record; observability-only, used by nothing in the
engine itself).
"""
from __future__ import annotations

from ..durability.manifest import Manifest
from ..durability.wal import WriteAheadLog
from ..engine.workers import MaintenanceWorkerPool
from ..storage_io import create_plane
from ..tuner.simcache import GhostCache
from .cache import ClockCache, Disk
from .device_pool import DevicePagePool


class MemoryArena:
    """Shared write-memory pool + buffer cache + WAL/manifest for member
    stores."""

    def __init__(self, cfg, *, wal: WriteAheadLog | None = None,
                 manifest: Manifest | None = None):
        self.cfg = cfg
        self.write_memory_bytes = cfg.write_memory_bytes
        self.ghost = GhostCache(cfg.sim_cache_bytes // cfg.page_bytes)
        cache_pages = max(
            0, (cfg.total_memory_bytes - cfg.write_memory_bytes
                - cfg.sim_cache_bytes) // cfg.page_bytes)
        self.cache = ClockCache(cache_pages, on_evict=self.ghost.add_evicted)
        self.disk = Disk(cfg.page_bytes, self.cache, self.ghost)
        # Durability plane: adopted (recovery) or fresh. The manifest's
        # identity guardrail rejects a config that contradicts the one the
        # durable state was written under. The StorageMedium seam lives
        # here: "memory" builds the RAM-backed plane; "files" builds the
        # physical plane under cfg.storage_dir (core/storage_io), whose
        # wal/manifest subclass the in-memory ones -- everything above
        # this line is medium-agnostic.
        if wal is None and manifest is None \
                and cfg.storage_medium == "files":
            wal, manifest = create_plane(cfg)
        self.wal = wal if wal is not None else WriteAheadLog()
        self.manifest = manifest if manifest is not None else Manifest()
        self.manifest.bind(cfg)
        # Physical plumbing (no-ops on the memory medium): cache misses /
        # flush writes reach the page store, fsync counts reach IOStats.
        page_store = getattr(self.manifest, "pages", None)
        if page_store is not None:
            self.disk.page_store = page_store
        self.wal.bind_stats(self.disk.stats)
        if hasattr(self.manifest, "bind_stats"):
            self.manifest.bind_stats(self.disk.stats)
        self.members: list = []             # stores drawing from this arena
        # Device page pool (device residency for fused reads): created by
        # the first member store to register -- the pool needs the store's
        # execution backend. Residency is derived state, so it is never
        # checkpointed.
        self.device_pool = None
        # Background maintenance workers (engine/workers.py), shared by
        # every member store: speculative prepares of merge/Bloom compute.
        # With maintenance_workers=0 (default) the pool is inert -- no
        # threads exist and every compute runs inline, bit-identically.
        self.workers = MaintenanceWorkerPool(cfg.maintenance_workers,
                                             stats=self.disk.stats)

    def register(self, store) -> int:
        """Add a member store; returns its index (== shard index for a
        sharded store, 0 for a standalone one)."""
        if self.device_pool is None:
            self.device_pool = DevicePagePool(
                store.backend, self.cfg.page_bytes,
                self.cfg.device_pool_bytes)
            self.disk.device_pool = self.device_pool
        self.members.append(store)
        return len(self.members) - 1

    def set_device_pool_bytes(self, budget_bytes: int) -> None:
        """Resize the device page pool (the governor's fused-read knob).
        Unlike ``set_write_memory`` this is not WAL-logged: residency is
        reconstructible and lookup results never depend on it."""
        if self.device_pool is not None:
            self.device_pool.set_budget_bytes(budget_bytes)

    @property
    def stats(self):
        return self.disk.stats

    @property
    def log_pos(self) -> int:
        """Transaction-log byte offset (compat name for ``wal.head_lsn``)."""
        return self.wal.head_lsn

    @log_pos.setter
    def log_pos(self, v: int) -> None:
        # Compat shim for the pre-WAL bare counter; see WriteAheadLog.set_head.
        self.wal.set_head(v)

    def used_bytes(self) -> int:
        """Write memory held across every member store."""
        return sum(s.write_memory_used() for s in self.members)

    def set_write_memory(self, x: int) -> None:
        """Apply a new write-memory size (the tuner's actuator): the
        buffer cache gives up (or reclaims) the complementary pages. The
        applied value is WAL-logged so recovery replays the decision."""
        cfg = self.cfg
        x = int(min(max(x, 1 << 20), cfg.total_memory_bytes
                    - cfg.sim_cache_bytes - (1 << 20)))
        self.write_memory_bytes = x
        pages = max(0, (cfg.total_memory_bytes - x - cfg.sim_cache_bytes)
                    // cfg.page_bytes)
        self.cache.resize(pages)
        self.wal.append_set_write_memory(x)

    def restore_write_memory(self, x: int) -> None:
        """Checkpoint restore: re-apply a captured write-memory size
        verbatim (it was either the config value or a past
        ``set_write_memory`` result, so it is already clamped -- clamping
        again would move a below-floor config value)."""
        self.write_memory_bytes = int(x)
        pages = max(0, (self.cfg.total_memory_bytes - x
                        - self.cfg.sim_cache_bytes) // self.cfg.page_bytes)
        self.cache.resize(pages)
