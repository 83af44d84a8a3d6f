"""The process-kill workload of ``kill_workload.py``, for the port.

``kill_workload.py`` imports the reference's ``StoreConfig``, which loads
jax, so a port child cannot import it. This module is its twin over
``repro_torch``: the same config (plus ``device``), the same seeded
``drive()`` and the same boundaries, so boundary ``k`` means the same
store state in a port child, a port oracle and the reference's oracle.
``test_torch_crash_kill.py`` holds the constants to the reference's, and
``test_torch_storage_io.py`` holds the planes both workloads write to be
byte-identical. ``wal_async_fsync`` is left out: the port refuses it
until its async-commit slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lsm.storage import StoreConfig

KB = 1024

# ordered maintenance segments of the paced scheduler
SEGMENTS = ("upkeep", "mem", "log", "merge", "wal")

TREES = ("alpha", "beta")
N_BATCHES = 4
BATCH = 256                       # keys per batch => 64 KB of LSN each

# one boundary after each batch, then one after each segment of the
# batch's maintenance pass
N_BOUNDARIES = N_BATCHES * (1 + len(SEGMENTS))


def kill_config(shards: int, *, medium: str, root=None,
                fsync_policy: str = "per_batch", mode: str = "full",
                workers: int = 0, device: str = "cpu") -> StoreConfig:
    """``kill_workload.kill_config`` on ``device``: 8 KB WAL segments
    (many rollovers), 512 KB log cap (truncation + min-LSN flushes),
    256 KB checkpoint interval (multiple checkpoints)."""
    seg = 64 * KB if mode == "group" else 8 * KB
    return StoreConfig(
        total_memory_bytes=8192 * KB, write_memory_bytes=256 * KB,
        sim_cache_bytes=64 * KB, page_bytes=4 * KB, entry_bytes=256,
        active_sstable_bytes=32 * KB, sstable_bytes=64 * KB,
        max_log_bytes=512 * KB, checkpoint_interval_bytes=256 * KB,
        scheme="partitioned", flush_policy="lsn",
        storage_medium=medium, storage_dir=root,
        fsync_policy=fsync_policy, wal_segment_bytes=seg,
        # group mode: a large byte threshold + effectively-infinite wait
        # keeps whole commit groups buffered across kill points
        group_commit_bytes=12 * KB, group_commit_max_wait_s=3600.0,
        maintenance_workers=workers, device=device)


def drive(store, on_boundary=None, *, mode: str = "full"):
    """``kill_workload.drive``: the deterministic mixed workload.

    ``on_boundary(i)`` fires after boundary ``i`` completes (0-based).
    ``mode="group"`` drives writes only (no maintenance segments) so the
    userspace group-commit buffer stays the lone durability variable.
    """
    rng = np.random.default_rng(1234)
    boundary = 0
    for t in TREES:
        store.create_tree(t)

    def hit():
        nonlocal boundary
        if on_boundary is not None:
            on_boundary(boundary)
        boundary += 1

    if mode == "group":
        store.create_tree("gamma")
        for i in range(10):
            keys = rng.integers(0, 4096, size=BATCH)
            store.write_batch("gamma", keys, keys * 3 + i, tick=False)
            hit()
        return boundary

    for i in range(N_BATCHES):
        for t in TREES:
            keys = rng.integers(0, 4096, size=BATCH)
            if i % 3 == 2 and t == "beta":
                store.delete_batch(t, keys, tick=False)
            else:
                store.write_batch(t, keys, keys * 7 + i, tick=False)
        hit()
        for seg in SEGMENTS:
            store.scheduler.run_segment(seg)
            hit()
    return boundary
