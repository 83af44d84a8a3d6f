"""Typed request/result vocabulary of the ``StorageService`` front door.

A request names a tree and carries a *batch* of keys (and values): the
service's unit of admission and planning is the request, the unit of
execution is the vectorized backend call the planner groups requests into.
Results mirror requests one-to-one, in submission order; a request the
service could not admit comes back as ``Deferred`` (explicit backpressure)
carrying the original request so the caller can retry after ``drain()``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _as_keys(keys) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(keys, np.int64))
    if arr.ndim != 1:
        raise ValueError(f"keys must be a scalar or 1-D array, got shape "
                         f"{arr.shape}")
    return arr


@dataclass(frozen=True, eq=False)
class Put:
    """Upsert ``vals[i]`` under ``keys[i]``; ``vals=None`` defaults the
    payload to the key (checksum convention of ``LSMStore.write_batch``)."""

    tree: str
    keys: np.ndarray
    vals: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "keys", _as_keys(self.keys))
        if self.vals is not None:
            vals = np.atleast_1d(np.asarray(self.vals, np.int64))
            if vals.shape != self.keys.shape:
                raise ValueError("vals must match keys in shape")
            object.__setattr__(self, "vals", vals)


@dataclass(frozen=True, eq=False)
class Get:
    """Batched point lookup."""

    tree: str
    keys: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "keys", _as_keys(self.keys))


@dataclass(frozen=True, eq=False)
class Delete:
    """Batched delete (tombstone writes; reads and scans filter them)."""

    tree: str
    keys: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "keys", _as_keys(self.keys))


@dataclass(frozen=True)
class Scan:
    """Range scan of ``n`` key-space slots starting at ``lo``; resolves to
    the number of live entries in the range."""

    tree: str
    lo: int
    n: int


Request = Put | Get | Delete | Scan


# --------------------------------- results -----------------------------------
@dataclass(frozen=True)
class WriteAck:
    """A Put/Delete request fully ingested (``n`` keys). ``durable``
    reports whether the WAL records covering this submit had reached
    stable storage when the ack was built: always True on the in-memory
    medium and under per_record/per_batch fsync policies; under group
    commit an ack may return before its group's fsync (the deferred-
    durability window group commit trades for fewer fsyncs)."""

    tree: str
    n: int
    durable: bool = True


@dataclass(frozen=True, eq=False)
class GetResult:
    tree: str
    found: np.ndarray       # bool[n]
    vals: np.ndarray        # int64[n]


@dataclass(frozen=True)
class ScanResult:
    tree: str
    count: int


@dataclass(frozen=True, eq=False)
class Deferred:
    """Backpressure: the request was *not* executed. ``reason`` is one of
    ``"l0-stall"`` (too many L0 groups on the target tree),
    ``"memory-pressure"`` (shared write memory over its admission slack) or
    ``"session-quota"`` (the session's outstanding-work cap). Retry via
    ``StorageService.drain()`` + resubmit (or ``submit_all``).

    Over a sharded store the gate is per shard, so ``request`` may be
    *narrowed* to the keys routed to the stalled shard(s); keys on healthy
    shards executed and are not re-carried."""

    request: Request
    reason: str


Result = WriteAck | GetResult | ScanResult | Deferred


def request_kind(req: Request) -> str:
    """Stable op-kind tag used by the planner's (tree, kind) grouping."""
    if isinstance(req, Put):
        return "put"
    if isinstance(req, Delete):
        return "delete"
    if isinstance(req, Get):
        return "get"
    if isinstance(req, Scan):
        return "scan"
    raise TypeError(f"not a storage request: {req!r}")
