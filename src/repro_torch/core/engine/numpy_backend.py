"""Host helpers of the engine: pure numpy.

Carries the engine's original semantics (the k-way merge extracted from
``sstable.merge_runs``), the canonical ingest order of a write batch, the
double-hashed Bloom slot math (Knuth multipliers, int32 wraparound,
floor-mod slots) that the torch backend's kernels reproduce bit for bit.
"""
from __future__ import annotations

import numpy as np

# Golden-ratio multipliers as int32.
C1 = np.int32(0x9E3779B1 - 2**32)
C2 = np.int32(0x85EBCA77 - 2**32)


def merge_runs_numpy(runs):
    """Merge sorted (keys, vals) runs with newest-wins reconciliation.

    ``runs`` is ordered newest-first. Returns a single sorted, unique run.
    """
    runs = [r for r in runs if len(r[0])]
    if not runs:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if len(runs) == 1:
        return runs[0]
    keys = np.concatenate([r[0] for r in runs])
    vals = np.concatenate([r[1] for r in runs])
    # Stable sort by key keeps the newest occurrence first within equal keys
    # because runs are concatenated newest-first.
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    keep = np.ones(len(keys), bool)
    keep[1:] = keys[1:] != keys[:-1]
    return keys[keep], vals[keep]


def ingest_order(keys) -> np.ndarray:
    """Canonical ingest ordering of a write batch: positions sorted by key,
    newest (highest batch position) first among equal keys.

    The torch backend orders a batch with it before the merge kernel, so
    which duplicate survives is the reference's.
    """
    n = len(keys)
    rev = np.argsort(keys[::-1], kind="stable")
    return (n - 1) - rev


def _bloom_slots(keys, n_slots: int, k_hashes: int) -> np.ndarray:
    """[K, k] slot indices: the key truncated to int32, products wrapping
    in int32, floor-mod by ``n_slots``."""
    k32 = np.asarray(keys).astype(np.int32)
    h1 = (k32 * C1) % np.int32(n_slots)
    h2 = ((k32 * C2) | np.int32(1)) % np.int32(n_slots)
    j = np.arange(k_hashes, dtype=np.int64)
    return (h1.astype(np.int64)[:, None] + j[None, :]
            * h2.astype(np.int64)[:, None]) % n_slots

