"""ShardRouter: deterministic key -> shard placement.

Routing must be a pure function of (key, router config) -- NO process
state, no Python ``hash()`` (which is salted per process) -- so that any
client, worker or replica computes the same placement, and a persisted
store reopened by another process routes identically. Two disciplines:

  * ``hash``  -- Fibonacci multiplicative hashing on the 64-bit key
    (golden-ratio constant, top bits), then modulo ``n_shards``. Spreads
    hot *ranges* across shards; any single hot key still lands on one
    shard (its "hot shard").
  * ``range`` -- ``n_shards - 1`` sorted split points partition the key
    space into contiguous half-open buckets: shard i serves keys in
    ``[boundaries[i-1], boundaries[i])`` (a boundary key opens the next
    shard). Preserves locality, so skewed key ranges produce a hot shard
    by construction -- the adversarial case the shared memory arena must
    absorb.

``n_shards=1`` routes everything to shard 0 under either discipline (the
degenerate router of the single-store deployment).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Golden-ratio (Fibonacci hashing) multiplier, the reference's; fixed forever
# (a store written by either package routes alike) -- changing it
# would re-route every persisted key.
_FIB = np.uint64(0x9E3779B97F4A7C15)
_SHIFT = np.uint64(33)

KINDS = ("hash", "range")


@dataclass(frozen=True)
class ShardRouter:
    """Deterministic hash/range router over ``n_shards`` shards."""

    n_shards: int = 1
    kind: str = "hash"                       # "hash" | "range"
    boundaries: tuple[int, ...] | None = None  # range: n_shards-1 splits

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown router kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "range":
            b = self.boundaries
            if b is None or len(b) != self.n_shards - 1:
                raise ValueError(
                    f"range routing over {self.n_shards} shards needs "
                    f"exactly {self.n_shards - 1} boundaries, got "
                    f"{None if b is None else len(b)}")
            object.__setattr__(self, "boundaries", tuple(int(x) for x in b))
            if list(self.boundaries) != sorted(set(self.boundaries)):
                raise ValueError("range boundaries must be strictly "
                                 f"increasing, got {self.boundaries}")
        elif self.boundaries is not None:
            raise ValueError("boundaries are only valid with kind='range'")

    @classmethod
    def ranges(cls, n_shards: int, key_max: int) -> "ShardRouter":
        """Equal-width range router over the key space [0, key_max);
        ``n_shards=1`` builds the degenerate single-range router."""
        bounds = tuple(int(key_max * (i + 1) / n_shards)
                       for i in range(n_shards - 1))
        return cls(n_shards, kind="range", boundaries=bounds)

    # -- routing --------------------------------------------------------------
    def shard_of_batch(self, keys) -> np.ndarray:
        """Vectorized placement: int64 shard index per key."""
        keys = np.asarray(keys, np.int64)
        if self.n_shards == 1:
            return np.zeros(len(keys), np.int64)
        if self.kind == "hash":
            h = (keys.astype(np.uint64) * _FIB) >> _SHIFT
            return (h % np.uint64(self.n_shards)).astype(np.int64)
        return np.searchsorted(np.asarray(self.boundaries, np.int64),
                               keys, side="right").astype(np.int64)

    def shard_of(self, key: int) -> int:
        return int(self.shard_of_batch(np.array([key], np.int64))[0])

    def split(self, keys):
        """Partition a key batch per shard.

        Yields ``(shard_index, positions)`` for every shard that received
        at least one key; ``positions`` (int64, ascending) index into the
        input batch, so per-shard sub-batches preserve submission order --
        the property that keeps duplicate keys within one batch resolving
        last-wins exactly as in the unsharded store.
        """
        sid = self.shard_of_batch(keys)
        for si in range(self.n_shards):
            sel = np.flatnonzero(sid == si)
            if len(sel):
                yield si, sel
