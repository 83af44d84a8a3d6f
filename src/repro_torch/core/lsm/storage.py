"""LSMStore: the adaptive memory-management architecture of §3.

One store = many LSM-trees (grouped into *datasets*: a primary tree plus its
secondary-index trees) sharing

  * a write-memory region ``x`` (shared pool, no per-component limits),
  * a buffer cache of ``total - x - sim`` bytes (clock replacement),
  * a transaction log (length-capped; log-triggered flushes),
  * a ghost cache of ``sim`` bytes feeding the memory tuner.

Flush policies (§4.2): ``mem`` (max-memory), ``lsn`` (min-LSN), ``opt``
(write-rate-proportional). Memory-management schemes (§6):
``partitioned`` (this paper), ``btree-dynamic``, ``btree-static``,
``btree-static-tuned``, ``accordion-index``, ``accordion-data``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..engine import available_backends, get_backend
from ..engine.scheduler import MaintenanceScheduler
from ..engine.torch_backend import resolve_device
from ..storage_io.wal_files import ASYNC_FSYNC_REFUSED, FSYNC_POLICIES
from .arena import MemoryArena
from .baselines import AccordionMemComponent, BTreeMemComponent
from .memtable import PartitionedMemComponent
from .sstable import TOMBSTONE
from .tree import LSMTree

_INF = 2**62

SCHEMES = ("partitioned", "btree-dynamic", "btree-static",
           "btree-static-tuned", "accordion-index", "accordion-data")
POLICIES = ("mem", "lsn", "opt")
STORAGE_MEDIA = ("memory", "files")


@dataclass
class TimeModel:
    """Throughput proxy: simulated wall time from I/O bytes + CPU work.

    Bandwidths follow the paper's testbed (NVMe: 250 MB/s write, 500 MB/s
    read). CPU constants are calibrated so that the *relative* overheads
    match the paper's measurements (e.g. Fig. 8's 20-40% in-memory overhead
    of Partitioned vs B+-dynamic at ~11x memory write amplification).
    """

    write_bw: float = 250e6
    read_bw: float = 500e6
    cpu_insert_btree: float = 0.80e-6     # dict/B+-tree point insert
    cpu_insert_append: float = 0.30e-6    # append to the active SSTable
    cpu_seal_sort: float = 0.15e-6        # per entry, sort at seal
    cpu_merge_mem: float = 0.10e-6        # per entry per memory-merge pass
    cpu_merge_disk: float = 0.05e-6       # per entry per disk-merge pass
    cpu_lookup: float = 1.00e-6           # per point lookup / scan seek

    def elapsed(self, stats, *, scheme: str) -> tuple[float, float]:
        page = 16 * 1024
        io = ((stats.pages_flushed + stats.pages_merge_written) * page
              / self.write_bw
              + (stats.pages_merge_read + stats.pages_query_read) * page
              / self.read_bw)
        if scheme.startswith("partitioned"):
            ins = stats.entries_written * self.cpu_insert_append \
                + stats.entries_written * self.cpu_seal_sort
        else:
            ins = stats.entries_written * self.cpu_insert_btree
        cpu = (ins + stats.entries_merged_mem * self.cpu_merge_mem
               + stats.entries_merged_disk * self.cpu_merge_disk)
        return io, cpu


@dataclass
class StoreConfig:
    total_memory_bytes: int = 512 << 20
    write_memory_bytes: int = 128 << 20        # the tunable x
    sim_cache_bytes: int = 16 << 20
    page_bytes: int = 16 << 10
    entry_bytes: int = 1024
    size_ratio: int = 10
    active_sstable_bytes: int = 1 << 20        # scaled-down 32MB
    sstable_bytes: int = 2 << 20               # disk SSTable partition target
    max_log_bytes: int = 256 << 20
    # Force a durable checkpoint whenever the WAL head has advanced this
    # many bytes past the last checkpoint's watermark, bounding the replay
    # tail (and therefore recovery time) independently of flush activity.
    # None = checkpoint only when log truncation requires one (the min-LSN
    # watermark passing the last checkpoint).
    checkpoint_interval_bytes: int | None = None
    mem_flush_threshold: float = 0.95
    scheme: str = "partitioned"
    flush_policy: str = "opt"                  # mem | lsn | opt
    max_active_datasets: int = 8               # D for the static schemes
    beta: float = 0.5                          # §4.1.4 partial-vs-full
    l0_target_groups: int = 2
    l0_max_groups: int = 4
    l0_greedy: bool = True
    l0_grouped: bool = True
    dynamic_levels: bool = True
    static_num_levels: int | None = None
    forced_flush_kind: str | None = None       # for the Fig. 9 ablation
    accordion_pipeline: int = 4
    # Execution backend for merges/Bloom/batched lookups: "torch", the
    # only one registered; None means "torch". No environment variable is
    # read.
    backend: str | None = None
    # Device the backend runs on: "cuda" (the default; opening a store
    # without a GPU raises) or "cpu" (the kernels' plain versions).
    device: str = "cuda"
    # Device page-pool budget for the fused read hot path; 0 keeps the
    # pool disabled and every lookup on the staged per-SSTable path.
    # Governors resize it at runtime via MemoryPlan.device_pool_bytes. It
    # counts logical pages (budget // page_bytes), as the reference does.
    device_pool_bytes: int = 0
    # Fused-read launch scope once the pool holds a tier resident:
    # "store" collapses the whole lookup (every tier) into ONE kernel
    # launch per batch, falling back per-tier then staged; "tier" keeps
    # one launch per tier. Results, page pins and IOStats are
    # bit-identical across all three paths.
    fused_scope: str = "store"
    # Max discretionary maintenance units per scheduler tick (None = drain
    # all merge debt every tick). Mandatory memory/log enforcement is never
    # budgeted.
    merge_budget: int | None = None
    # Paced maintenance (engine/pacer.py): with an interval set, the
    # service replaces the per-submit stop-the-world tick with a paced
    # schedule -- mandatory segments every submit, merges released in
    # bounded slices of ``pacer_segment_budget`` steps, one slice per
    # ``pacer_interval_bytes`` of ingested payload. None = pacing off.
    pacer_interval_bytes: int | None = None
    pacer_segment_budget: int = 8
    # Paced partial-flush slices: with a threshold set, every "mem"
    # segment releases at most ONE extra partial flush once shared write
    # memory crosses threshold * write_memory_bytes -- BELOW the hard
    # mem_flush_threshold -- so a paced schedule drains memory in bounded
    # chunks instead of a burst of flushes at the hard bound. The decision
    # reads only store state + config (never pacer state), so segments
    # stay replay-deterministic. None = off (bit-identical to before).
    pacer_flush_threshold: float | None = None
    # StallGovernor (core/service/governor.py): auto-nudge the pacer's
    # interval/budget knobs from the observed stall histogram (deadband +
    # dwell). Requires pacing to be on.
    pacer_autotune: bool = False
    # Background maintenance workers (engine/workers.py): threads running
    # the compute-heavy, side-effect-free part of merge slices (run
    # sort/dedup through K1, Bloom builds through K2) speculatively off
    # the foreground path. All side effects still commit inline at the
    # logged segment boundaries, so store state is bit-identical for ANY
    # worker count; 0 (default) creates no threads at all.
    maintenance_workers: int = 0
    # Physical storage plane (core/storage_io): "memory" keeps the WAL /
    # SSTables as byte-accounted RAM buffers (nothing is fsynced); "files"
    # backs them with real files under storage_dir -- segmented WAL, one
    # file per SSTable, manifest frame log -- with process-kill crash
    # safety, byte-compatible with the reference's files.
    storage_medium: str = "memory"
    storage_dir: str | None = None
    # Commit durability policy on the files medium: "per_record" fsyncs
    # every WAL append, "per_batch" fsyncs at every commit point (store
    # batch / scheduler tick), "group" batches concurrent commits until
    # group_commit_bytes of frames are pending or the oldest commit has
    # waited group_commit_max_wait_s (leader-follower: one fsync serves
    # the whole queue). Ignored (no fsyncs at all) on the memory medium.
    fsync_policy: str = "per_batch"
    wal_segment_bytes: int = 1 << 20
    group_commit_bytes: int = 64 << 10
    group_commit_max_wait_s: float = 1e-3
    # Async group commit (a durability worker thread owning the fsyncs):
    # the reference's knob, refused until the port's async-commit slice;
    # False, the default, is the only accepted value.
    wal_async_fsync: bool = False
    time_model: TimeModel = field(default_factory=TimeModel)

    def validate(self):
        # ValueErrors, not asserts: config mistakes must fail loudly even
        # under ``python -O``, with a message saying how to fix them.
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; "
                             f"expected one of {SCHEMES}")
        if self.flush_policy not in POLICIES:
            raise ValueError(f"unknown flush_policy {self.flush_policy!r}; "
                             f"expected one of {POLICIES}")
        if self.backend is not None \
                and self.backend not in available_backends():
            raise ValueError(
                f"unknown backend {self.backend!r}; registered backends: "
                f"{sorted(available_backends())} (or leave None for "
                f"'torch')")
        resolve_device(self.device)
        if self.entry_bytes <= 0:
            raise ValueError(f"entry_bytes must be positive, got "
                             f"{self.entry_bytes}")
        if self.device_pool_bytes < 0:
            raise ValueError(
                f"device_pool_bytes must be >= 0 (0 disables the device "
                f"page pool), got {self.device_pool_bytes}")
        if self.fused_scope not in ("store", "tier"):
            raise ValueError(
                f"fused_scope must be 'store' (one launch per lookup "
                f"batch) or 'tier' (one per tier), got "
                f"{self.fused_scope!r}")
        if self.merge_budget is not None and self.merge_budget < 0:
            raise ValueError(
                f"merge_budget must be >= 0 (or None to drain all debt "
                f"every tick), got {self.merge_budget}")
        if self.max_log_bytes <= 0:
            raise ValueError(
                f"max_log_bytes must be positive (the transaction-log cap "
                f"that triggers min-LSN flushes), got {self.max_log_bytes}")
        if self.checkpoint_interval_bytes is not None \
                and self.checkpoint_interval_bytes <= 0:
            raise ValueError(
                f"checkpoint_interval_bytes must be positive (or None to "
                f"checkpoint only when log truncation requires it), got "
                f"{self.checkpoint_interval_bytes}")
        if self.pacer_interval_bytes is not None \
                and self.pacer_interval_bytes <= 0:
            raise ValueError(
                f"pacer_interval_bytes must be positive (or None to run "
                f"stop-the-world ticks instead of paced maintenance), got "
                f"{self.pacer_interval_bytes}")
        if self.pacer_segment_budget <= 0:
            raise ValueError(
                f"pacer_segment_budget must be positive (merge steps per "
                f"paced slice), got {self.pacer_segment_budget}")
        if self.pacer_flush_threshold is not None \
                and not 0.0 < self.pacer_flush_threshold < 1.0:
            raise ValueError(
                f"pacer_flush_threshold must be in (0, 1) -- the fraction "
                f"of write memory at which paced partial-flush slices "
                f"start, below mem_flush_threshold -- or None to disable "
                f"flush slices, got {self.pacer_flush_threshold}")
        if self.pacer_autotune and self.pacer_interval_bytes is None:
            raise ValueError(
                f"pacer_autotune requires paced maintenance: set "
                f"pacer_interval_bytes (got pacer_interval_bytes="
                f"{self.pacer_interval_bytes})")
        if self.maintenance_workers < 0:
            raise ValueError(
                f"maintenance_workers must be >= 0 (0 runs all maintenance "
                f"inline), got {self.maintenance_workers}")
        if self.wal_async_fsync and self.fsync_policy != "group":
            raise ValueError(
                f"wal_async_fsync requires fsync_policy='group' (the "
                f"durability worker batches group commits), got "
                f"fsync_policy={self.fsync_policy!r}")
        if self.wal_async_fsync:
            raise ValueError(ASYNC_FSYNC_REFUSED)
        if self.storage_medium not in STORAGE_MEDIA:
            raise ValueError(
                f"unknown storage_medium {self.storage_medium!r}; "
                f"expected one of {STORAGE_MEDIA}")
        if self.storage_medium == "files" and not self.storage_dir:
            raise ValueError(
                f"storage_dir must name a directory when storage_medium="
                f"'files', got {self.storage_dir!r}")
        if self.fsync_policy not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync_policy {self.fsync_policy!r}; expected "
                f"one of {FSYNC_POLICIES}")
        if self.wal_segment_bytes <= 0:
            raise ValueError(
                f"wal_segment_bytes must be positive (the fixed WAL "
                f"segment-file size), got {self.wal_segment_bytes}")
        if self.group_commit_bytes <= 0:
            raise ValueError(
                f"group_commit_bytes must be positive (pending WAL bytes "
                f"that trigger a group fsync), got "
                f"{self.group_commit_bytes}")
        if self.group_commit_max_wait_s <= 0:
            raise ValueError(
                f"group_commit_max_wait_s must be positive (max age of a "
                f"queued commit before the group fsyncs), got "
                f"{self.group_commit_max_wait_s}")
        if self.write_memory_bytes + self.sim_cache_bytes \
                > self.total_memory_bytes:
            raise ValueError(
                f"write_memory_bytes ({self.write_memory_bytes}) + "
                f"sim_cache_bytes ({self.sim_cache_bytes}) exceed "
                f"total_memory_bytes ({self.total_memory_bytes}); shrink "
                f"the write memory or simulated cache")
        return self


class LSMStore:
    def __init__(self, cfg: StoreConfig, *, arena: MemoryArena | None = None):
        """``arena=None`` (standalone store) builds a private memory pool;
        a ``ShardedStore`` passes ONE shared arena to every shard so all
        shards compete for the same write memory, buffer cache and log."""
        self.cfg = cfg.validate()
        self.backend = get_backend(cfg.backend, cfg.device)
        self.arena = arena if arena is not None else MemoryArena(cfg)
        self.shard_id = self.arena.register(self)
        self.ghost = self.arena.ghost
        self.cache = self.arena.cache
        self.disk = self.arena.disk
        self.trees: dict[str, LSMTree] = {}
        self.datasets: dict[str, list[str]] = {}
        self.tree_dataset: dict[str, str] = {}
        # per-tree write-rate windows for the OPT policy (§4.2)
        self._rate_win: dict[str, deque] = {}
        # LRU order of active datasets for the static schemes; evicted
        # datasets queue here and are flushed by the scheduler tick
        self._active_ds: list[str] = []
        self._pending_evict: list[str] = []
        self._share_ewma: dict[str, float] = {}
        # Sole owner of flush/merge work: the write path appends and ticks.
        self.scheduler = MaintenanceScheduler(
            self, merge_budget=cfg.merge_budget)

    # -- schema ------------------------------------------------------------------
    def create_tree(self, name: str, *, dataset: str | None = None,
                    entry_bytes: int | None = None) -> LSMTree:
        cfg = self.cfg
        e = entry_bytes or cfg.entry_bytes
        if cfg.scheme == "partitioned":
            mem = PartitionedMemComponent(
                entry_bytes=e, page_bytes=cfg.page_bytes,
                active_bytes_max=cfg.active_sstable_bytes,
                size_ratio=cfg.size_ratio, backend=self.backend)
        elif cfg.scheme.startswith("btree"):
            mem = BTreeMemComponent(entry_bytes=e, backend=self.backend)
        else:
            mem = AccordionMemComponent(
                entry_bytes=e, active_bytes_max=cfg.active_sstable_bytes,
                merge_data=cfg.scheme == "accordion-data",
                pipeline_threshold=cfg.accordion_pipeline,
                backend=self.backend)
        tree = LSMTree(
            name, disk=self.disk, entry_bytes=e, mem_component=mem,
            sstable_bytes=cfg.sstable_bytes, size_ratio=cfg.size_ratio,
            l0_max_groups=cfg.l0_max_groups,
            l0_target_groups=cfg.l0_target_groups,
            l0_greedy=cfg.l0_greedy, l0_grouped=cfg.l0_grouped,
            dynamic_levels=cfg.dynamic_levels,
            static_num_levels=cfg.static_num_levels,
            backend=self.backend, fused_scope=cfg.fused_scope,
            manifest=self.arena.manifest, shard_id=self.shard_id,
            workers=self.arena.workers)
        self.trees[name] = tree
        # Schema record: one TreeCreate per logical tree (the WAL dedups
        # the per-shard creates of a sharded store).
        self.arena.wal.append_tree_create(name, dataset=dataset,
                                          entry_bytes=entry_bytes)
        ds = dataset or name
        self.datasets.setdefault(ds, []).append(name)
        self.tree_dataset[name] = ds
        self._rate_win[name] = deque()
        self._share_ewma[name] = 0.0
        return tree

    # -- memory accounting ----------------------------------------------------------
    def write_memory_used(self) -> int:
        return sum(t.mem_bytes for t in self.trees.values())

    def min_lsn(self) -> int:
        return min((t.min_lsn for t in self.trees.values()), default=_INF)

    @property
    def write_memory_bytes(self) -> int:
        """The tunable ``x``: lives in the (possibly shared) arena."""
        return self.arena.write_memory_bytes

    @property
    def log_pos(self) -> int:
        """Transaction-log byte offset (shared across a sharded store)."""
        return self.arena.log_pos

    @log_pos.setter
    def log_pos(self, v: int) -> None:
        self.arena.log_pos = v

    @property
    def log_length(self) -> int:
        m = self.min_lsn()
        return self.log_pos - (m if m < _INF else self.log_pos)

    def set_write_memory(self, x: int) -> None:
        """Apply a new write-memory size (tuner's actuator)."""
        self.arena.set_write_memory(x)

    @property
    def device_pool(self):
        """The device page pool behind fused reads."""
        return self.arena.device_pool

    def set_device_pool_bytes(self, budget_bytes: int) -> None:
        """Resize the device page pool (governor's fused-read actuator)."""
        self.arena.set_device_pool_bytes(budget_bytes)

    # -- durability plane -------------------------------------------------------
    @property
    def wal(self):
        """The (possibly shared) typed write-ahead log."""
        return self.arena.wal

    @property
    def manifest(self):
        """The (possibly shared) versioned manifest."""
        return self.arena.manifest

    def checkpoint(self):
        """Force a durable checkpoint now and truncate the WAL below the
        global min-LSN. The scheduler also checkpoints automatically when
        truncation or ``checkpoint_interval_bytes`` requires one."""
        from ..durability.checkpoint import checkpoint_now
        return checkpoint_now(self.arena, self.scheduler)

    # -- write path ------------------------------------------------------------------
    def _ingest(self, tree_name: str, keys, vals, *, op: bool,
                tick: bool, delete: bool = False) -> None:
        tree = self.trees[tree_name]
        # Write-ahead: the batch is logged (assigning lsn0 = the current
        # log position and advancing the head by the payload bytes) before
        # it touches the memory component. During crash-recovery replay
        # the same call hands back the record's original LSN instead.
        lsn0 = self.arena.wal.append_batch(
            tree_name, keys, None if delete else vals,
            entry_bytes=tree.entry_bytes, op=op, delete=delete)
        tree.write_batch(keys, vals, lsn0)
        nbytes = len(keys) * tree.entry_bytes
        self.disk.stats.entries_written += len(keys)
        if op:
            self.disk.stats.ops += len(keys)
        win = self._rate_win[tree_name]
        win.append((lsn0, nbytes))
        self._trim_rate_windows()
        self._dataset_touch(tree_name)
        if tick:
            self.scheduler.tick()

    def write_batch(self, tree_name: str, keys, vals=None, *, op: bool = True,
                    tick: bool = True) -> None:
        """Batched writes: one logical op per key, ingested through the
        tree's execution backend (vectorized sort+dedup), then one
        maintenance-scheduler tick. No flush or merge runs inline here.

        ``tick=False`` defers all maintenance; callers then drive
        ``self.scheduler.tick()`` explicitly (differential tests, drivers
        that amortize one tick over several batches).
        """
        keys = np.asarray(keys, np.int64)
        if vals is None:
            vals = keys  # payload checksum defaults to the key
        vals = np.asarray(vals, np.int64)
        # the tombstone payload is reserved for delete_batch -- accepting
        # it here would make a legitimate write behave as a silent delete
        if (vals == TOMBSTONE).any():
            raise ValueError(
                f"payload {TOMBSTONE} is reserved for deletes; "
                f"use delete_batch")
        self._ingest(tree_name, keys, vals, op=op, tick=tick)
        # Commit point: the batch is durable when this returns (under the
        # configured fsync policy). With tick=True the scheduler already
        # committed; this is then a no-op.
        self.arena.wal.commit(len(keys))

    def write(self, tree_name: str, keys, vals=None, *, op: bool = True) -> None:
        """Legacy entry point: a write_batch counted as ONE logical op per
        call (scalar semantics), whatever the array length."""
        self.write_batch(tree_name, keys, vals, op=False)
        if op:
            self.disk.stats.ops += 1

    def delete_batch(self, tree_name: str, keys, *, op: bool = True,
                     tick: bool = True) -> None:
        """Batched deletes: tombstone writes (newest-wins reconciliation
        shadows older versions; reads and scans filter them)."""
        keys = np.asarray(keys, np.int64)
        self._ingest(tree_name, keys,
                     np.full(len(keys), TOMBSTONE, np.int64),
                     op=op, tick=tick, delete=True)
        self.arena.wal.commit(len(keys))    # commit point (see write_batch)

    def note_ops(self, n: int = 1) -> None:
        self.disk.stats.ops += n

    def _trim_rate_windows(self):
        lo = self.log_pos - self.cfg.max_log_bytes
        for win in self._rate_win.values():
            while win and win[0][0] < lo:
                win.popleft()

    # -- dataset activation (static schemes, §2.2) --------------------------------------
    def _dataset_touch(self, tree_name: str) -> None:
        if not self.cfg.scheme.startswith("btree-static"):
            return
        ds = self.tree_dataset[tree_name]
        if ds in self._pending_evict:
            # re-activated before the tick flushed it: never flush an
            # active dataset
            self._pending_evict.remove(ds)
        if ds in self._active_ds:
            self._active_ds.remove(ds)
            self._active_ds.append(ds)
            return
        D = self.cfg.max_active_datasets
        if len(self._active_ds) >= D:
            # evict LRU dataset: the scheduler tick flushes it (nothing
            # flushes inline in the write path, even under tick=False)
            self._pending_evict.append(self._active_ds.pop(0))
        self._active_ds.append(ds)

    # -- flush bookkeeping (read by the scheduler) --------------------------------------
    def _pre_flush_sample(self, tree: LSMTree) -> None:
        e = self._share_ewma[tree.name]
        self._share_ewma[tree.name] = 0.7 * e + 0.3 * tree.mem_bytes

    def _tree_share(self, tree: LSMTree) -> float:
        return max(self._share_ewma[tree.name], tree.mem_bytes,
                   self.cfg.active_sstable_bytes)

    def _pick_flush_tree(self) -> LSMTree | None:
        """§4.2 flush policies (delegates to the scheduler's ranking)."""
        return self.scheduler.pick_flush_tree()

    # -- reads -----------------------------------------------------------------------
    def lookup(self, tree_name: str, key: int, *, op: bool = True):
        if op:
            self.disk.stats.ops += 1
        return self.trees[tree_name].lookup(int(key))

    def read_batch(self, tree_name: str, keys, *, op: bool = True):
        """Batched point lookups: one logical op per key, probes vectorized
        end-to-end through the tree's execution backend.

        Returns (found bool[n], vals int64[n]).
        """
        keys = np.asarray(keys, np.int64)
        if op:
            self.disk.stats.ops += len(keys)
        return self.trees[tree_name].lookup_batch(keys)

    def scan(self, tree_name: str, lo: int, n: int, *, op: bool = True):
        if op:
            self.disk.stats.ops += 1
        return self.trees[tree_name].scan(int(lo), int(n))

    def scan_batch(self, tree_name: str, los, ns, *, op: bool = True):
        """Batched range scans: ONE op per range (the same contract as a
        loop of scalar ``scan`` calls), executed with a vectorized seek
        through the tree. Returns live-entry counts int64[n]."""
        los = np.asarray(los, np.int64)
        ns = np.asarray(ns, np.int64)
        if op:
            self.disk.stats.ops += len(los)
        return self.trees[tree_name].scan_batch(los, ns)

    # -- reporting ----------------------------------------------------------------------
    def sync_mem_stats(self) -> None:
        """Mirror per-component memory-merge work into the global counters
        (CPU cost of §4.1 memory merges — Fig. 8's overhead)."""
        self.disk.stats.entries_merged_mem = sum(
            t.mem.stats.entries_merged for t in self.trees.values()
            if hasattr(t.mem, "stats"))

    def elapsed(self):
        return self.cfg.time_model.elapsed(self.disk.stats,
                                           scheme=self.cfg.scheme)

    def throughput(self, prev_stats=None) -> float:
        stats = self.disk.stats if prev_stats is None \
            else self.disk.stats.delta(prev_stats)
        io, cpu = self.cfg.time_model.elapsed(stats, scheme=self.cfg.scheme)
        t = max(io, cpu, 1e-9)
        return stats.ops / t
