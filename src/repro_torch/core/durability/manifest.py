"""Versioned manifest: the durable record of on-disk SSTable state.

Every flush and merge emits typed edits (``AddSSTable`` / ``RemoveSSTable``)
and the scheduler's log-enforcement phase records the advancing min-LSN
``Watermark``, so at any instant the manifest's *live set* is exactly the
SSTables reachable from the trees' L0s and levels -- maintained
incrementally by edits, never rebuilt by scanning the store (the
consistency the recovery tests assert).

A **checkpoint** is a snapshot anchored to a manifest version: the live
set at that version plus the write-memory image and the auxiliary
flush-decision state (see ``checkpoint.py``), stamped with the WAL
sequence/LSN watermark replay resumes from. ``latest_checkpoint`` is what
``recover`` restores before replaying the WAL tail; the scheduler keeps
``checkpoint_watermark >= truncated_to`` so the tail needed for replay is
never truncated away.

The edit log itself is bounded (old edits are observability, not recovery
state -- recovery needs only the latest checkpoint and the live set).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["LiveSSTable", "ManifestEdit", "Manifest"]


@dataclass(frozen=True, eq=False)
class LiveSSTable:
    """Durable payload of one on-disk SSTable (arrays are immutable and
    shared with the live object -- the engine never mutates run arrays in
    place)."""

    shard: int
    tree: str
    keys: object
    vals: object
    lsn_min: int
    lsn_max: int
    entry_bytes: int
    page_bytes: int
    kind: str                 # "flush" | "merge" | "restored"


@dataclass(frozen=True)
class ManifestEdit:
    """One versioned manifest mutation. ``kind`` is one of
    ``add-flush`` / ``add-merge`` / ``remove`` / ``watermark``."""

    version: int
    kind: str
    shard: int = -1
    tree: str = ""
    sst_id: int = -1
    n_entries: int = 0
    lsn: int = 0              # lsn_min of the table, or the watermark LSN


class Manifest:
    """Edit-versioned live-SSTable set + checkpoints + store identity."""

    MAX_EDITS = 4096          # retained edit history (observability bound)
    MAX_CHECKPOINTS = 2       # latest is load-bearing; one spare for debug

    def __init__(self):
        self.version = 0
        self.edits: list[ManifestEdit] = []
        self.live: dict[int, LiveSSTable] = {}     # sst_id -> payload
        self.checkpoints: list = []                # Checkpoint, oldest first
        self.watermark = 0                         # last recorded min-LSN
        self.router_spec: tuple | None = None      # (kind, n, boundaries)
        self.store_meta: dict | None = None        # cfg guardrail fields

    # -- identity guardrails ----------------------------------------------------
    # Every StoreConfig field that shapes durable structure or replay
    # determinism. Deliberately absent: ``backend`` (numpy and torch are
    # bit-identical by design -- recovering on the other backend is
    # supported) and ``time_model`` (reporting only).
    _META_FIELDS = (
        "scheme", "flush_policy", "entry_bytes", "page_bytes",
        "size_ratio", "active_sstable_bytes", "sstable_bytes",
        "total_memory_bytes", "write_memory_bytes", "sim_cache_bytes",
        "max_log_bytes", "checkpoint_interval_bytes",
        "mem_flush_threshold", "merge_budget", "beta",
        "l0_grouped", "l0_greedy", "l0_max_groups", "l0_target_groups",
        "dynamic_levels", "static_num_levels", "forced_flush_kind",
        "max_active_datasets", "accordion_pipeline",
    )

    @classmethod
    def _meta_of(cls, cfg) -> dict:
        return {k: getattr(cfg, k) for k in cls._META_FIELDS}

    def bind(self, cfg) -> None:
        """Record (or verify) the store identity this manifest belongs to:
        recovering with a mismatched config would silently re-route or
        re-partition persisted data."""
        meta = self._meta_of(cfg)
        if self.store_meta is None:
            self.store_meta = meta
        elif self.store_meta != meta:
            raise ValueError(
                f"manifest belongs to a store with {self.store_meta}, "
                f"but the config says {meta}; recover with the original "
                f"StoreConfig")

    def set_router(self, spec: tuple) -> None:
        if self.router_spec is None:
            self.router_spec = spec
        elif self.router_spec != spec:
            raise ValueError(
                f"manifest was written under router {self.router_spec}, "
                f"got {spec}; a persisted store must be recovered with "
                f"the router that placed its keys")

    # -- edits --------------------------------------------------------------------
    def _append(self, edit: ManifestEdit) -> None:
        self.edits.append(edit)
        if len(self.edits) > self.MAX_EDITS:
            del self.edits[:-self.MAX_EDITS]

    def add_sstable(self, shard: int, tree: str, sst, kind: str) -> None:
        """AddSSTable edit: a flush or merge wrote ``sst``."""
        self.version += 1
        self.live[sst.sst_id] = LiveSSTable(
            shard, tree, sst.keys, sst.vals, sst.lsn_min, sst.lsn_max,
            sst.entry_bytes, sst.page_bytes, kind)
        self._append(ManifestEdit(self.version, f"add-{kind}", shard, tree,
                                  sst.sst_id, sst.num_entries, sst.lsn_min))

    def remove_sstable(self, shard: int, tree: str, sst) -> None:
        """RemoveSSTable edit: a merge consumed ``sst``."""
        self.version += 1
        self.live.pop(sst.sst_id, None)
        self._append(ManifestEdit(self.version, "remove", shard, tree,
                                  sst.sst_id, sst.num_entries, sst.lsn_min))

    def note_watermark(self, lsn: int) -> None:
        """Record the advancing global min-LSN the log truncates below."""
        if lsn <= self.watermark:
            return
        self.version += 1
        self.watermark = lsn
        self._append(ManifestEdit(self.version, "watermark", lsn=lsn))

    # -- checkpoints ---------------------------------------------------------------
    @property
    def latest_checkpoint(self):
        return self.checkpoints[-1] if self.checkpoints else None

    @property
    def checkpoint_watermark(self) -> int:
        ck = self.latest_checkpoint
        return 0 if ck is None else ck.watermark

    def add_checkpoint(self, ck) -> None:
        self.checkpoints.append(ck)
        if len(self.checkpoints) > self.MAX_CHECKPOINTS:
            del self.checkpoints[:-self.MAX_CHECKPOINTS]

    def reset_to_checkpoint(self, ck, live: dict[int, LiveSSTable]) -> None:
        """Recovery rebase: drop edits past the checkpoint version and
        install the restored live set (re-keyed to the recovered store's
        SSTable ids). Replay then re-emits the tail's edits, converging
        the manifest to its pre-crash equivalent."""
        self.edits = [e for e in self.edits if e.version <= ck.version]
        self.version = ck.version
        self.live = dict(live)
        self.watermark = ck.man_watermark

    # -- crash simulation ------------------------------------------------------------
    def clone(self) -> "Manifest":
        """Durable-state snapshot at a crash point (payload arrays are
        immutable and shared; bookkeeping copied)."""
        m = Manifest()
        m.version = self.version
        m.edits = list(self.edits)
        m.live = dict(self.live)
        m.checkpoints = list(self.checkpoints)
        m.watermark = self.watermark
        m.router_spec = self.router_spec
        m.store_meta = None if self.store_meta is None \
            else dict(self.store_meta)
        return m
