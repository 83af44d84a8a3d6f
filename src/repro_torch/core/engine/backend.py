"""Execution-backend interface for the LSM engine's hot loops.

A backend supplies the engine's data-parallel primitives:

  * ``merge_runs(runs)``     -- k-way newest-wins merge (compaction)
  * ``ingest_run(keys, vals)`` -- sort+dedup of one write batch (ingest)
  * ``bloom_build(keys)``    -- per-SSTable Bloom filter construction
  * ``bloom_probe(f, keys)`` -- batched membership probes
  * ``bloom_probe_tier(fs, keys, tidx)`` -- the same, each key against
    its own table's filter ``fs[tidx[i]]``, for every table of a tier
  * ``lookup_batch(sorted_keys, queries)`` -- batched binary search in a run
  * ``prepare_tier(tables, bloom_fn)`` / ``lookup_fused(view, queries)``
    and ``prepare_store(tiers, bloom_fn)`` / ``lookup_store_fused(view,
    queries)`` -- the device-resident fused read path over a pooled tier
    (one launch per tier) or a whole store (one launch per lookup batch).

``TorchBackend`` routes these primitives through hand-written CUDA
kernels (their plain PyTorch versions on a CPU device). It uses the
reference's Bloom geometry (hash family, slot count, size bucketing), so
its probe results -- false positives included -- are bit-identical to the
reference's.

Selection: ``get_backend(name, device)`` takes the explicit ``name``
(``StoreConfig.backend``) and defaults to ``"torch"``; no environment
variable is consulted.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...kernels.sizing import next_pow2, slots_for

# Shared Bloom geometry (matches kernels/bloom: 10 bits/key, 7 hashes).
BLOOM_BITS_PER_KEY = 10
BLOOM_K_HASHES = 7


def bloom_sizing(n_keys: int, bits_per_key: int = BLOOM_BITS_PER_KEY):
    """(padded_key_count, n_slots) for a filter over ``n_keys`` keys.

    Filters are sized from the *bucketed* key count, as in the reference,
    so a filter has the reference's geometry (and false-positive set).
    """
    n_pad = next_pow2(max(1, n_keys), lo=256)
    return n_pad, slots_for(n_pad, bits_per_key)


@dataclass
class TierView:
    """One disjoint, min_key-sorted tier of SSTables prepared for fused
    probing (built by ``ExecutionBackend.prepare_tier``).

    The host-side metadata is backend-independent; ``payload`` carries the
    backend's resident representation of the tier's key/val/Bloom pages
    (the torch backend's ``kernels.lookup.View`` -- the part a
    ``DevicePagePool`` keeps device-resident).
    """

    backend: str
    sst_ids: tuple                 # view identity (pool cache key)
    starts: np.ndarray             # int64 [T] per-table min_key
    ends: np.ndarray               # int64 [T] per-table max_key
    offs: np.ndarray               # int64 [T] entry offset of each table
    lens: np.ndarray               # int64 [T] entries per table
    payload: object                # backend-owned resident arrays

    @property
    def num_tables(self) -> int:
        return len(self.sst_ids)

    @property
    def num_entries(self) -> int:
        return int(self.offs[-1] + self.lens[-1]) if len(self.lens) else 0


@dataclass
class FusedLookup:
    """Per-query results of one fused tier probe, shaped so the caller can
    replicate the staged path's page-pin accounting exactly:

      ti/ok     -- table assignment (``assign_queries`` semantics);
      positive  -- Bloom membership of each query against its table's
                   filter (valid where ``ok``);
      pos/hit   -- binary-search insertion position *relative to the
                   table's run* and whether it is an exact match (valid
                   where ``ok & positive``);
      vals      -- the matched payload (valid where ``hit``).
    """

    ti: np.ndarray                 # int64 [K]
    ok: np.ndarray                 # bool  [K]
    positive: np.ndarray           # bool  [K]
    pos: np.ndarray                # int64 [K]
    hit: np.ndarray                # bool  [K]
    vals: np.ndarray               # int64 [K]


@dataclass
class StoreView:
    """Every lookup tier of one tree (newest-first: L0 groups, then disk
    levels top-down) prepared for a single fused probe (built by
    ``ExecutionBackend.prepare_store``).

    Per-tier metadata mirrors ``TierView`` -- tuples indexed by tier rank
    ``r`` -- except that ``tier_offs`` are offsets into the *store-wide*
    key/val concatenation (tier-major, table order within a tier).
    ``payload`` is the backend's resident representation of the whole
    stack; the ``DevicePagePool`` accounts its pages exactly like a
    per-tier view's.
    """

    backend: str
    key: tuple                     # tuple of per-tier sst_id tuples
    tier_starts: tuple             # per tier: int64 [T_r] min_key
    tier_ends: tuple               # per tier: int64 [T_r] max_key
    tier_offs: tuple               # per tier: int64 [T_r] GLOBAL offsets
    tier_lens: tuple               # per tier: int64 [T_r] entries/table
    payload: object                # backend-owned resident arrays

    @property
    def num_tiers(self) -> int:
        return len(self.key)

    @property
    def num_tables(self) -> int:
        return sum(len(k) for k in self.key)


@dataclass
class StoreLookup:
    """Per-(tier, query) results of one fused store probe. Every [R, K]
    field carries, for tier rank ``r``, exactly what a per-tier
    ``FusedLookup`` would have carried for that tier (``ti`` is
    tier-local), so the caller can replay the staged path's pin sequence
    tier by tier. ``win`` is the on-device newest-wins resolution: the
    first (newest) tier rank whose probe hit, -1 when no tier did."""

    ti: np.ndarray                 # int64 [R, K] tier-local table index
    ok: np.ndarray                 # bool  [R, K]
    positive: np.ndarray           # bool  [R, K]
    pos: np.ndarray                # int64 [R, K] relative to the table's run
    hit: np.ndarray                # bool  [R, K]
    vals: np.ndarray               # int64 [R, K]
    win: np.ndarray                # int64 [K] first tier rank with a hit


def assign_bounds(starts, ends, qkeys):
    """Array-level twin of ``sstable.assign_queries``: map each query to
    the covering table of a disjoint, min_key-sorted tier described by its
    bound arrays. The fused kernels (``kernels.lookup``) compute exactly
    this on the device; the tests and ``chip_smoke.py`` hold them to it."""
    ti = np.searchsorted(starts, qkeys, side="right") - 1
    ok = ti >= 0
    ti = np.clip(ti, 0, len(starts) - 1)
    ok &= qkeys <= ends[ti]
    return ti.astype(np.int64), ok


class ExecutionBackend:
    """Interface of the engine's batched primitives."""

    name: str = "abstract"

    def merge_runs(self, runs):
        """Merge sorted (keys, vals) runs, ordered newest-first, into one
        sorted unique run with newest-wins reconciliation.

        Returns (keys, vals) as int64 numpy arrays.
        """
        raise NotImplementedError

    def ingest_run(self, keys, vals):
        """Sort an *unsorted* write batch into one sorted unique run with
        last-occurrence-wins dedup (the write-ingest mirror of
        ``merge_runs``).

        Returns (keys, vals, src) as int64 numpy arrays: the sorted unique
        keys, the value of each key's newest occurrence, and ``src`` -- the
        original batch position of that occurrence (callers derive exact
        per-entry LSNs from it).
        """
        raise NotImplementedError

    def bloom_build(self, keys):
        """Build a Bloom filter over ``keys``; returns an opaque filter."""
        raise NotImplementedError

    def bloom_probe(self, filt, keys):
        """Probe ``filt`` for ``keys``; returns a bool membership mask
        (no false negatives). The staged read path probes a tier at a
        time (``bloom_probe_tier``); this one-filter form stays because
        the interface mirrors the reference package's method for method,
        whose staged path calls it per table."""
        raise NotImplementedError

    def bloom_probe_tier(self, filts, keys, tidx):
        """Probe each ``keys[i]`` against ``filts[tidx[i]]`` in one call;
        returns a bool membership mask, bit-identical to one
        ``bloom_probe`` call per filter."""
        raise NotImplementedError

    def lookup_batch(self, sorted_keys, queries):
        """Batched binary search of ``queries`` in a sorted unique run.

        Returns (pos, found): the insertion position of each query (int64)
        and whether ``sorted_keys[pos] == query`` (bool).
        """
        raise NotImplementedError

    def prepare_tier(self, tables, bloom_fn):
        """Build a resident ``TierView`` over one disjoint, min_key-sorted
        tier of SSTables. ``bloom_fn(sst)`` returns the backend's (cached)
        Bloom filter of a table. Never returns ``None``: a backend that
        cannot serve the fused path raises."""
        raise NotImplementedError

    def lookup_fused(self, view: TierView, queries):
        """Fused tier probe: Bloom probe + per-table sorted probe of every
        query against the whole tier in one (or few) device invocations.

        Must be bit-identical -- assignment, Bloom membership (including
        false positives), insertion positions, matches, values -- to the
        staged loop of per-table ``bloom_probe`` + ``lookup_batch`` calls.
        Returns a ``FusedLookup``."""
        raise NotImplementedError

    def prepare_store(self, tiers, bloom_fn):
        """Build a resident ``StoreView`` over every non-empty lookup tier
        of one tree, ordered newest-first. Each element of ``tiers`` is a
        disjoint, min_key-sorted table list (what ``prepare_tier`` takes).
        Never returns ``None``."""
        raise NotImplementedError

    def lookup_store_fused(self, view: StoreView, queries):
        """Fused cross-tier probe: every query against every tier of the
        store in ONE device launch -- stacked Bloom probe, ranged sorted
        probe over the store-wide concatenation, and the newest-wins tier
        argmin.

        Field-for-field per tier, results must be bit-identical to R
        independent ``lookup_fused`` calls (which are themselves
        bit-identical to the staged loop). Returns a ``StoreLookup``."""
        raise NotImplementedError


_FACTORIES: dict = {}
_INSTANCES: dict = {}


def register_backend(name: str, factory) -> None:
    """Register ``factory(device=...)`` under ``name``."""
    _FACTORIES[name] = factory


def available_backends() -> tuple:
    """Registered backend names (the registry is the source of truth)."""
    return tuple(sorted(_FACTORIES))


def get_backend(name: str | None = None,
                device: str = "cuda") -> ExecutionBackend:
    """Resolve a backend by name (default ``"torch"``) for ``device``.

    Instances are cached per (name, device): a backend holds only its
    device and its launch counters.
    """
    resolved = name or "torch"
    if resolved not in _FACTORIES:
        raise ValueError(
            f"unknown LSM backend {resolved!r}; expected one of "
            f"{sorted(_FACTORIES)}")
    key = (resolved, str(device))
    if key not in _INSTANCES:
        _INSTANCES[key] = _FACTORIES[resolved](device=device)
    return _INSTANCES[key]
