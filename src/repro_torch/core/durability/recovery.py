"""Crash recovery: rebuild a sharded store from (WAL, manifest) alone.

``recover(cfg, wal, manifest)`` reconstructs a ``ShardedStore`` that is
*bit-identical* -- memory-component structure, L0 groups, disk levels,
``log_pos``, write-memory size, and the write-path IOStats counters
(``checkpoint.RECOVERY_EXACT_COUNTERS``) -- to the store that crashed:

  1. restore the manifest's latest checkpoint (disk placement + memory
     images + flush-decision state);
  2. replay the WAL tail above the checkpoint's sequence watermark, in
     order, **re-partitioning the one shared log through the
     deterministic ShardRouter**: each write/delete record's keys hash to
     exactly one shard (per-shard sub-batches were logged separately), and
     the replayed ingest flows through the same ``ingest_run`` batched
     path -- K1 on the card, its plain version on the CPU -- the original
     writes took;
  3. replayed ``TickRecord``s re-run the maintenance scheduler at the
     original trigger points. Ticks are pure functions of store state, so
     every flush, memory merge and compaction re-executes identically,
     and ``SetWriteMemoryRecord``s re-apply tuner decisions by value (no
     volatile ghost-cache state needed).

During replay the WAL is in *replay mode*: the ingest path receives the
original LSNs from the replay cursor (verified record-by-record, so any
divergence fails loudly) and nothing is re-logged. A recovered store is a
full citizen -- it keeps appending to the same WAL/manifest and can crash
and recover again.

The one thing recovery deliberately does NOT rebuild is volatile cache
state (buffer cache, ghost cache): a recovered store serves reads cold.
"""
from __future__ import annotations

from .checkpoint import restore_checkpoint
from .wal import (DeleteBatchRecord, SetWriteMemoryRecord, TickRecord,
                  TreeCreateRecord, WriteBatchRecord)


def router_from_spec(spec):
    """Rebuild the deterministic router a manifest was written under."""
    from ..shard.router import ShardRouter
    if spec is None:
        return ShardRouter(1)
    kind, n_shards, boundaries = spec
    return ShardRouter(n_shards, kind=kind, boundaries=boundaries)


def _apply(store, rec, wal) -> None:
    """Re-execute one WAL record against the recovering store."""
    if isinstance(rec, TreeCreateRecord):
        store.create_tree(rec.tree, dataset=rec.dataset,
                          entry_bytes=rec.entry_bytes)
    elif isinstance(rec, (WriteBatchRecord, DeleteBatchRecord)):
        sid = store.router.shard_of_batch(rec.keys)
        si = int(sid[0]) if len(sid) else 0
        if len(sid) and not (sid == si).all():
            raise RuntimeError(
                f"WAL record at lsn {rec.lsn0} spans shards "
                f"{sorted(set(sid.tolist()))}: the log was written under "
                f"a different router")
        wal.expect(rec)
        s = store.shards[si].store
        if isinstance(rec, WriteBatchRecord):
            s.write_batch(rec.tree, rec.keys, rec.vals, op=rec.op,
                          tick=False)
        else:
            s.delete_batch(rec.tree, rec.keys, op=rec.op, tick=False)
    elif isinstance(rec, TickRecord):
        b = rec.merge_budget
        kw = {} if b == "default" \
            else {"merge_budget": None if b == "drain" else int(b)}
        if rec.segment == "full":
            store.scheduler.tick(**kw)
        else:
            # Paced schedules log one record per tick segment; replay
            # re-runs exactly the logged segment at the logged point, so
            # interleaved maintenance recovers bit-identically.
            store.scheduler.run_segment(rec.segment, **kw)
    elif isinstance(rec, SetWriteMemoryRecord):
        store.arena.set_write_memory(rec.write_memory_bytes)
    else:                                         # pragma: no cover
        raise TypeError(f"unknown WAL record {rec!r}")


def recover(cfg, wal, manifest, *, router=None):
    """Rebuild a ``ShardedStore`` from the durable plane.

    ``cfg`` must be the ``StoreConfig`` the crashed store ran with (the
    manifest's identity guardrail verifies the load-bearing fields).
    ``router=None`` rebuilds the router recorded in the manifest; a bare
    (unsharded) ``LSMStore``'s log recovers as the bit-identical one-shard
    store. The store runs on ``cfg.device``, as any store does. Returns a
    live store with replay statistics attached as ``store.recovery_info``
    ({replayed_records, replayed_keys, tail_bytes, replayed_bytes,
    from_checkpoint})."""
    from ..shard.sharded import ShardedStore
    cfg = cfg.validate()
    if router is None:
        router = router_from_spec(manifest.router_spec)
    store = ShardedStore(cfg, router=router, wal=wal, manifest=manifest)
    ck = manifest.latest_checkpoint
    if ck is None and wal.truncated_to > 0:
        raise RuntimeError(
            "WAL was truncated but the manifest holds no checkpoint: the "
            "durable state cannot cover the dropped prefix")
    after_seq = -1 if ck is None else ck.wal_seq
    start_lsn = 0 if ck is None else ck.watermark
    tail = wal.tail_records(after_seq)
    tail_bytes = wal.tail_bytes
    replayed_bytes = wal.head_lsn - start_lsn
    wal.begin_replay(start_lsn)
    try:
        if ck is not None:
            restore_checkpoint(store, ck)
        for _, rec in tail:
            _apply(store, rec, wal)
    except BaseException:
        # keep the real divergence error as the diagnostic; end_replay's
        # completeness check would mask it with "replay incomplete"
        wal.abort_replay()
        raise
    wal.end_replay()
    store.recovery_info = {
        "replayed_records": len(tail),
        "replayed_keys": sum(len(r.keys) for _, r in tail
                             if hasattr(r, "keys")),
        # LSN-space log length at crash (the paper's quantity) vs the
        # span replay actually walked (head - checkpoint watermark; what
        # checkpoint_interval_bytes bounds)
        "tail_bytes": tail_bytes,
        "replayed_bytes": replayed_bytes,
        "from_checkpoint": ck is not None,
    }
    # Files medium: replayed flushes re-wrote their tables under fresh
    # sst_ids, so the crashed run's files are orphans now -- reconcile
    # the page directory against the converged live set (checkpoint-
    # pinned files are spared inside gc).
    page_store = getattr(store.arena.disk, "page_store", None)
    if page_store is not None:
        store.recovery_info["gc_ssts"] = len(page_store.gc(manifest.live))
        wal.sync()                # recovery effects are durable on return
    return store
