"""Checkpoints: manifest-anchored snapshots bit-identical recovery resumes
from.

A checkpoint captures, at one maintenance-tick boundary:

  * the **manifest live set** at its current version (the on-disk SSTable
    payloads) plus each tree's *placement* (which tables sit in which L0
    group / disk level, ``deleting_l1``);
  * the **write-memory image** per (shard, tree) -- the paper's flush
    policies drain memory by key range, not LSN order, so the memory
    component's internal structure is history-dependent and must be
    captured, not re-derived (a fuzzy checkpoint with a memory image,
    rather than a sharp flush-everything checkpoint that would perturb
    the very flush behavior §4 studies);
  * the **flush-decision state** replay determinism depends on: per-tree
    OPT rate windows, share EWMAs, partial-flush windows, round-robin
    cursors, static-scheme LRU dataset state;
  * the durable counters (IOStats write-path fields) and the WAL
    sequence/LSN watermark replay resumes from.

Everything captured is either copied (mutable containers) or immutable
and shared (numpy run arrays -- the engine never mutates them in place),
so a checkpoint stays valid while the live store keeps running: exactly
what stable storage would hold at a crash.

``restore_checkpoint`` rebuilds a fresh store from a checkpoint; the WAL
tail replayed on top (see ``recovery.py``) then reproduces the crashed
store's structure bit-for-bit, because scheduler ticks are deterministic
functions of store state.

Volatile by design (NOT captured): the clock buffer cache and the ghost
cache. A recovered store starts cold, so cache-dependent read counters
(``pages_query_read`` / ``pages_merge_read``) and read-op counts are
observability, not durable state -- ``RECOVERY_EXACT_COUNTERS`` names the
IOStats fields the recovery contract guarantees bit-identical.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from ..lsm.baselines import AccordionMemComponent, BTreeMemComponent
from ..lsm.grouped_l0 import GroupedL0
from ..lsm.memtable import PartitionedMemComponent
from ..lsm.sstable import sstable_from_run
from .manifest import LiveSSTable

# IOStats fields that are pure functions of the (replayed) write-path
# history: the recovery contract guarantees these match the uncrashed
# store exactly. Cache-dependent read-miss counters and read-op counts are
# excluded (reads are not logged; the page cache is volatile).
RECOVERY_EXACT_COUNTERS = (
    "entries_written", "pages_flushed", "pages_merge_written",
    "flushes_mem", "flushes_log", "bytes_flushed_mem", "bytes_flushed_log",
    "entries_merged_mem", "entries_merged_disk", "merge_pins",
)


@dataclass
class Checkpoint:
    """One recovery point. ``wal_seq``/``watermark`` anchor the replay
    tail; everything else is the state image at that boundary."""

    version: int                 # manifest version at capture
    wal_seq: int                 # last WAL record folded into this image
    watermark: int               # WAL head LSN at capture (replay start)
    man_watermark: int           # manifest's min-LSN watermark at capture
    write_memory_bytes: int
    iostats: dict
    schema: list                 # [(tree, dataset, entry_bytes), ...]
    shards: list                 # per-shard image dicts, shard order
    payloads: dict               # sst_id -> LiveSSTable at capture
    scheduler: dict              # ticks / carried_debt


# --------------------------- capture -----------------------------------------
def _mem_image(mem) -> dict:
    if isinstance(mem, PartitionedMemComponent):
        return {
            "kind": "partitioned",
            "active": list(mem.active.items()),
            "active_lsn_min": mem.active_lsn_min,
            "levels": [[(s.keys, s.vals, s.lsn_min, s.lsn_max)
                        for s in lvl] for lvl in mem.levels],
            "rr_key": mem.rr_key,
            "stats": vars(mem.stats).copy(),
        }
    if isinstance(mem, BTreeMemComponent):
        return {"kind": "btree", "data": list(mem.data.items()),
                "lsn_min": mem.lsn_min_, "lsn_max": mem.lsn_max_,
                "stats": vars(mem.stats).copy()}
    if isinstance(mem, AccordionMemComponent):
        return {"kind": "accordion", "active": list(mem.active.items()),
                "segments": list(mem.segments),
                "lsn_min": mem.lsn_min_, "lsn_max": mem.lsn_max_,
                "request_flush": mem.request_flush,
                "budget_hint": mem.budget_hint_bytes,
                "stats": vars(mem.stats).copy()}
    raise TypeError(f"unknown memory component {type(mem).__name__}")


def _payload_of(sst, manifest, shard: int, tree: str) -> LiveSSTable:
    """Durable payload of one on-disk table: from the manifest live set
    when the table arrived through a flush/merge edit, else captured
    directly (bulk-loaded fixtures bypass the edit path)."""
    p = manifest.live.get(sst.sst_id)
    if p is not None:
        return p
    return LiveSSTable(shard, tree, sst.keys, sst.vals, sst.lsn_min,
                       sst.lsn_max, sst.entry_bytes, sst.page_bytes,
                       "restored")


def _tree_image(tree, manifest, shard: int, payloads: dict) -> dict:
    def ref(sst):
        payloads[sst.sst_id] = _payload_of(sst, manifest, shard, tree.name)
        return sst.sst_id

    if isinstance(tree.l0, GroupedL0):
        l0 = {"groups": [[ref(s) for s in g] for g in tree.l0.groups]}
    else:
        l0 = {"runs": [ref(s) for s in tree.l0.runs]}
    return {
        "mem": _mem_image(tree.mem),
        "l0": l0,
        "levels": [[ref(s) for s in lvl] for lvl in tree.levels.levels],
        "deleting_l1": tree.levels.deleting_l1,
        "partial_flush_window": list(tree.partial_flush_window),
        "stats": vars(tree.stats).copy(),
    }


def capture_checkpoint(arena, scheduler) -> Checkpoint:
    """Snapshot the full recoverable state of every store drawing from
    ``arena`` (one member for a standalone store, one per shard for a
    sharded one; ``arena.members`` is shard order)."""
    members = arena.members
    wal, manifest = arena.wal, arena.manifest
    payloads: dict[int, LiveSSTable] = {}
    shards = []
    for si, s in enumerate(members):
        shards.append({
            "trees": {name: _tree_image(t, manifest, si, payloads)
                      for name, t in s.trees.items()},
            "rate_win": {n: list(w) for n, w in s._rate_win.items()},
            "share_ewma": dict(s._share_ewma),
            "active_ds": list(s._active_ds),
            "pending_evict": list(s._pending_evict),
        })
    first = members[0]
    schema = [(name, first.tree_dataset[name], t.entry_bytes)
              for name, t in first.trees.items()]
    return Checkpoint(
        version=manifest.version,
        wal_seq=wal.next_seq - 1,
        watermark=wal.head_lsn,
        man_watermark=manifest.watermark,
        write_memory_bytes=arena.write_memory_bytes,
        iostats=vars(arena.disk.stats).copy(),
        schema=schema,
        shards=shards,
        payloads=payloads,
        scheduler={"ticks": scheduler.ticks,
                   "segments": scheduler.segments,
                   "carried_debt": scheduler.carried_debt},
    )


def take_checkpoint(arena, scheduler) -> Checkpoint:
    """Capture and install a checkpoint in the arena's manifest.

    The WAL is synced first: the checkpoint anchors its replay tail to
    ``wal_seq``/``watermark``, so every record it references must be
    durable before the (fsynced) checkpoint frame can point at it --
    otherwise a crash in between leaves a durable checkpoint whose
    anchor records died in the group-commit buffer. No-op on the
    in-memory medium."""
    arena.wal.sync()
    ck = capture_checkpoint(arena, scheduler)
    arena.manifest.add_checkpoint(ck)
    return ck


def global_min_lsn(arena) -> int:
    """Arena-wide truncation point: the smallest LSN still buffered in
    any member's write memory, clamped to the log head when every memory
    component is empty."""
    m = min((s.min_lsn() for s in arena.members), default=2**62)
    return min(m, arena.wal.head_lsn)


def truncate_below_min_lsn(arena) -> int:
    """The ONE truncation path (scheduler phase 5 and explicit
    checkpoints both end here): record the min-LSN watermark in the
    manifest and physically truncate the WAL below it, never dropping
    records newer than the latest checkpoint -- they are the replay tail,
    including zero-span control records sitting exactly at the
    watermark. Returns records dropped."""
    wal, man = arena.wal, arena.manifest
    trunc = global_min_lsn(arena)
    ck = man.latest_checkpoint
    man.note_watermark(trunc)
    return wal.truncate(trunc,
                        keep_after_seq=-1 if ck is None else ck.wal_seq)


def checkpoint_now(arena, scheduler) -> Checkpoint:
    """Explicit checkpoint: capture, install, and physically truncate the
    WAL below the arena-global min-LSN."""
    ck = take_checkpoint(arena, scheduler)
    truncate_below_min_lsn(arena)
    return ck


# --------------------------- restore -----------------------------------------
def _restore_mem(mem, image: dict) -> None:
    kind = image["kind"]
    if kind == "partitioned":
        assert isinstance(mem, PartitionedMemComponent)
        mem.active = dict(image["active"])
        mem.active_lsn_min = image["active_lsn_min"]
        mem.levels = [
            [sstable_from_run(k, v, lmin, lmax, mem.entry_bytes,
                              mem.page_bytes)
             for k, v, lmin, lmax in lvl] for lvl in image["levels"]]
        mem.rr_key = image["rr_key"]
    elif kind == "btree":
        assert isinstance(mem, BTreeMemComponent)
        mem.data = dict(image["data"])
        mem.lsn_min_ = image["lsn_min"]
        mem.lsn_max_ = image["lsn_max"]
    else:
        assert isinstance(mem, AccordionMemComponent)
        mem.active = dict(image["active"])
        mem.segments = list(image["segments"])
        mem.lsn_min_ = image["lsn_min"]
        mem.lsn_max_ = image["lsn_max"]
        mem.request_flush = image["request_flush"]
        mem.budget_hint_bytes = image["budget_hint"]
    vars(mem.stats).update(image["stats"])


def _restore_tree(tree, image: dict, payloads: dict, shard: int,
                  live_out: dict) -> None:
    def build(sst_id):
        p = payloads[sst_id]
        sst = sstable_from_run(p.keys, p.vals, p.lsn_min, p.lsn_max,
                               p.entry_bytes, p.page_bytes)
        live_out[sst.sst_id] = LiveSSTable(
            shard, tree.name, p.keys, p.vals, p.lsn_min, p.lsn_max,
            p.entry_bytes, p.page_bytes, p.kind)
        # Files medium: the restored table gets a fresh sst_id, so its
        # pages must exist under that id for reads to have a file to hit
        # (counters untouched -- the original write was already accounted).
        tree.disk.ensure_sst(sst)
        return sst

    _restore_mem(tree.mem, image["mem"])
    if "groups" in image["l0"]:
        tree.l0.groups = [[build(i) for i in g]
                          for g in image["l0"]["groups"]]
    else:
        tree.l0.runs = [build(i) for i in image["l0"]["runs"]]
    tree.levels.levels = [[build(i) for i in lvl]
                          for lvl in image["levels"]]
    tree.levels.deleting_l1 = image["deleting_l1"]
    tree.partial_flush_window = list(image["partial_flush_window"])
    vars(tree.stats).update(image["stats"])


def restore_checkpoint(store, ck: Checkpoint) -> None:
    """Rebuild a fresh (empty) sharded store to the checkpoint image.
    Runs under WAL replay mode, so nothing here re-logs. The manifest is
    rebased to the checkpoint version with the restored live set; the
    subsequent tail replay re-emits the post-checkpoint edits."""
    if len(store.shards) != len(ck.shards):
        raise ValueError(
            f"checkpoint holds {len(ck.shards)} shard images but the "
            f"store has {len(store.shards)} shards; recover with the "
            f"original router")
    for name, ds, e in ck.schema:
        store.create_tree(name, dataset=ds, entry_bytes=e)
    live: dict[int, LiveSSTable] = {}
    for si, image in enumerate(ck.shards):
        s = store.shards[si].store
        for name, ti in image["trees"].items():
            _restore_tree(s.trees[name], ti, ck.payloads, si, live)
        s._rate_win = {n: deque(w) for n, w in image["rate_win"].items()}
        s._share_ewma = dict(image["share_ewma"])
        s._active_ds = list(image["active_ds"])
        s._pending_evict = list(image["pending_evict"])
    arena = store.arena
    arena.restore_write_memory(ck.write_memory_bytes)
    vars(arena.disk.stats).update(ck.iostats)
    store.scheduler.ticks = ck.scheduler["ticks"]
    store.scheduler.segments = ck.scheduler.get("segments", 0)
    store.scheduler.carried_debt = ck.scheduler["carried_debt"]
    arena.manifest.reset_to_checkpoint(ck, live)
