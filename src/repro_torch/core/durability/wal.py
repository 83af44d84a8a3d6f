"""Typed write-ahead log: the physical transaction log behind ``log_pos``.

Before this module the shared "transaction log" was a bare byte counter
(``MemoryArena.log_pos``): min-LSN flush policies and log-triggered flushes
(§4) were enforced against a log that did not exist, so nothing could ever
be replayed or truncated. ``WriteAheadLog`` makes the log real while
preserving the LSN semantics the whole engine (and the differential test
suite) is built on **exactly**:

  * an LSN is a *payload byte offset*: a batch of ``n`` keys appended at
    log position ``L`` spans LSNs ``[L, L + n * entry_bytes)`` and entry
    ``i`` carries LSN ``L + i * entry_bytes`` -- bit-identical to the old
    counter, so a batch of n is still indistinguishable from n batches of
    one;
  * control records (scheduler ticks, tuner resizes, tree creation) have
    a zero LSN footprint: they order the replay without consuming log
    bytes, so ``log_pos`` advances only by ingested payload.

Records are encoded to flat byte buffers through numpy (``Record.encode``
/ ``decode_record`` are exact inverses -- property-tested round-trip), so
what the WAL retains is a genuine serialized log, not live object graphs.

Physical truncation: ``truncate(min_lsn)`` drops every whole record below
the global min-LSN watermark (the §4 invariant: log bytes below the
smallest LSN still buffered in write memory are dead weight) and the
retained *tail* is ``tail_bytes = log_pos - truncated_to`` -- equal to the
store's ``log_length`` whenever truncation is driven by the maintenance
scheduler's log-enforcement phase.

Replay mode: during recovery the log is *consumed*, not appended. The
engine's ingest path calls the same ``append_batch`` API; in replay mode
it hands back the next expected LSN (verified against the record being
replayed) instead of growing the log, so one code path serves both normal
operation and crash recovery.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_INF = 2**62

# Record kinds (wire tags -- fixed forever, a persisted log must decode).
K_WRITE = 1
K_DELETE = 2
K_TREE_CREATE = 3
K_TICK = 4
K_SET_WRITE_MEMORY = 5

_HEADER_FIELDS = 8          # int64 header words per record
_NONE = -(2**31)            # wire encoding of "None" for small int fields


# --------------------------- typed records -----------------------------------
@dataclass(frozen=True, eq=False)
class WriteBatchRecord:
    """One ingested write batch: ``keys[i] -> vals[i]`` at LSN
    ``lsn0 + i * entry_bytes``."""

    tree: str
    lsn0: int
    entry_bytes: int
    keys: np.ndarray
    vals: np.ndarray
    op: bool = True            # whether the batch was counted in IOStats.ops

    kind = K_WRITE

    @property
    def lsn_end(self) -> int:
        return self.lsn0 + len(self.keys) * self.entry_bytes


@dataclass(frozen=True, eq=False)
class DeleteBatchRecord:
    """One tombstone batch. Deletes carry *no* values on the wire -- the
    tombstone payload is an engine constant, reconstructed at replay."""

    tree: str
    lsn0: int
    entry_bytes: int
    keys: np.ndarray
    op: bool = True

    kind = K_DELETE

    @property
    def lsn_end(self) -> int:
        return self.lsn0 + len(self.keys) * self.entry_bytes


@dataclass(frozen=True, eq=False)
class TreeCreateRecord:
    """Schema record: a tree created with the given ``create_tree`` args
    (``None`` means the store-config default applied)."""

    tree: str
    dataset: str | None = None
    entry_bytes: int | None = None
    lsn0: int = 0

    kind = K_TREE_CREATE
    lsn_end = property(lambda self: self.lsn0)


@dataclass(frozen=True, eq=False)
class TickRecord:
    """Control record: one maintenance-scheduler tick -- or one resumable
    tick *segment* -- ran here, with the given merge-budget override
    (``"default"`` = the scheduler's own budget, ``"drain"`` = explicit
    None, or an int). ``segment`` is ``"full"`` for a one-shot tick or a
    ``scheduler.SEGMENTS`` name for a paced schedule's individual phase;
    segment-granular records are what keep interleaved maintenance
    replay-deterministic (recovery re-runs exactly the logged segment at
    exactly the logged point)."""

    lsn0: int = 0
    merge_budget: object = "default"     # "default" | "drain" | int
    segment: str = "full"                # "full" | a SEGMENTS name

    kind = K_TICK
    lsn_end = property(lambda self: self.lsn0)


@dataclass(frozen=True, eq=False)
class SetWriteMemoryRecord:
    """Control record: the tuner/governor resized the shared write memory.
    The *decision value* is durable so replay never needs the (volatile)
    ghost-cache statistics that produced it."""

    write_memory_bytes: int
    lsn0: int = 0

    kind = K_SET_WRITE_MEMORY
    lsn_end = property(lambda self: self.lsn0)


Record = (WriteBatchRecord | DeleteBatchRecord | TreeCreateRecord
          | TickRecord | SetWriteMemoryRecord)


# --------------------------- wire encoding -----------------------------------
def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def encode_record(rec: Record) -> bytes:
    """Serialize one record to a flat byte buffer (numpy int64 header +
    utf-8 names + int64 key/val arrays). Exact inverse of
    ``decode_record``."""
    name = rec.tree.encode() if hasattr(rec, "tree") else b""
    ds = b""
    ds_len = _NONE
    flag = 0
    extra = 0
    entry_bytes = getattr(rec, "entry_bytes", None)
    if rec.kind in (K_WRITE, K_DELETE):
        n = len(rec.keys)
        flag = 1 if rec.op else 0
    elif rec.kind == K_TREE_CREATE:
        n = 0
        if rec.dataset is not None:
            ds = rec.dataset.encode()
            ds_len = len(ds)
    elif rec.kind == K_TICK:
        n = 0
        b = rec.merge_budget
        flag = {"default": -2, "drain": -1}.get(b, 1)
        extra = 0 if isinstance(b, str) else int(b)
        if rec.segment != "full":        # name slot carries the segment;
            name = rec.segment.encode()  # empty name decodes as "full"
    else:                                    # K_SET_WRITE_MEMORY
        n = 0
        extra = int(rec.write_memory_bytes)
    header = np.array(
        [rec.kind, rec.lsn0,
         _NONE if entry_bytes is None else int(entry_bytes),
         n, len(name), ds_len, flag, extra], np.int64)
    body = name + ds
    body += b"\x00" * (_pad8(len(body)) - len(body))
    parts = [header.tobytes(), body]
    if rec.kind in (K_WRITE, K_DELETE):
        parts.append(np.ascontiguousarray(rec.keys, np.int64).tobytes())
        if rec.kind == K_WRITE:
            parts.append(np.ascontiguousarray(rec.vals, np.int64).tobytes())
    return b"".join(parts)


def decode_record(buf: bytes) -> Record:
    """Deserialize one record (exact inverse of ``encode_record``)."""
    header = np.frombuffer(buf[:_HEADER_FIELDS * 8], np.int64)
    kind, lsn0, entry_bytes, n, name_len, ds_len, flag, extra = \
        (int(x) for x in header)
    off = _HEADER_FIELDS * 8
    name = buf[off:off + name_len].decode()
    ds = None if ds_len == _NONE \
        else buf[off + name_len:off + name_len + ds_len].decode()
    off += _pad8(name_len + max(ds_len, 0))
    if kind == K_WRITE:
        keys = np.frombuffer(buf[off:off + n * 8], np.int64).copy()
        vals = np.frombuffer(buf[off + n * 8:off + 2 * n * 8],
                             np.int64).copy()
        return WriteBatchRecord(name, lsn0, entry_bytes, keys, vals,
                                op=bool(flag))
    if kind == K_DELETE:
        keys = np.frombuffer(buf[off:off + n * 8], np.int64).copy()
        return DeleteBatchRecord(name, lsn0, entry_bytes, keys,
                                 op=bool(flag))
    if kind == K_TREE_CREATE:
        return TreeCreateRecord(
            name, dataset=ds,
            entry_bytes=None if entry_bytes == _NONE else entry_bytes,
            lsn0=lsn0)
    if kind == K_TICK:
        budget = {-2: "default", -1: "drain"}.get(flag, extra)
        return TickRecord(lsn0=lsn0, merge_budget=budget,
                          segment=name or "full")
    if kind == K_SET_WRITE_MEMORY:
        return SetWriteMemoryRecord(write_memory_bytes=extra, lsn0=lsn0)
    raise ValueError(f"unknown WAL record kind {kind}")


# --------------------------- the log ------------------------------------------
@dataclass
class _Stored:
    """One retained record: its sequence number, LSN span, and encoded
    bytes. ``seq`` orders records absolutely (control records share LSN
    boundaries, so LSNs alone cannot anchor a replay start)."""

    seq: int
    lsn0: int
    lsn_end: int
    buf: bytes


class _ReplayState:
    __slots__ = ("cursor", "expect")

    def __init__(self, cursor: int):
        self.cursor = cursor     # the LSN the next replayed append receives
        self.expect = None       # record being replayed (verified)


class WriteAheadLog:
    """Append-only typed log with LSN = payload byte offset, physical
    truncation below the min-LSN watermark, and a replay mode that feeds
    recovered ingests their original LSNs."""

    def __init__(self):
        self._records: list[_Stored] = []
        self._head = 0               # authoritative log_pos
        self.truncated_to = 0        # LSN watermark physically dropped below
        self.next_seq = 0
        self._trees_logged: set[str] = set()
        self._replay: _ReplayState | None = None

    # -- geometry -------------------------------------------------------------
    @property
    def head_lsn(self) -> int:
        """The current log position. During replay this is the *replay
        cursor*, so ``log_pos``-dependent engine decisions (flush windows,
        rate trimming) see exactly the values they saw originally."""
        if self._replay is not None:
            return self._replay.cursor
        return self._head

    @property
    def tail_bytes(self) -> int:
        """Retained log tail in LSN (payload byte) space. Under
        scheduler-driven truncation this equals the store's
        ``log_length`` after every tick."""
        return self._head - self.truncated_to

    @property
    def num_records(self) -> int:
        return len(self._records)

    @property
    def encoded_bytes(self) -> int:
        """Physical size of the retained encoded records (headers, names
        and padding included)."""
        return sum(len(r.buf) for r in self._records)

    @property
    def replaying(self) -> bool:
        return self._replay is not None

    # -- durability hooks -------------------------------------------------------
    # The in-memory medium is "durable" the instant it appends (clone()
    # models stable storage), so these are no-ops here; the file-backed
    # ``storage_io.FileWAL`` overrides them with real buffering + fsync.
    fsyncs = 0                   # physical fsync calls issued
    commit_hist = None           # LatencyHistogram of commit waits (files)

    def commit(self, n: int = 1) -> None:
        """A commit point: ``n`` logical ops want durability here (store
        batch end, scheduler tick/segment end). No-op in memory."""

    def sync(self) -> None:
        """Force everything durable now. No-op in memory."""

    def bind_stats(self, stats) -> None:
        """Mirror fsync counts into an ``IOStats``. No-op in memory."""

    @property
    def durable_lsn(self) -> int:
        """Highest LSN guaranteed to survive a process kill."""
        return self._head

    @property
    def all_durable(self) -> bool:
        """True when no appended record is still waiting for its fsync."""
        return True

    # -- appends ---------------------------------------------------------------
    def _push(self, rec: Record) -> None:
        self._records.append(_Stored(self.next_seq, rec.lsn0, rec.lsn_end,
                                     encode_record(rec)))
        self.next_seq += 1

    def append_batch(self, tree: str, keys, vals, *, entry_bytes: int,
                     op: bool, delete: bool = False) -> int:
        """Log one write/delete batch; returns the assigned ``lsn0``.
        In replay mode no record is written: the replay cursor supplies
        (and verifies) the original LSN instead."""
        n = len(keys)
        span = n * entry_bytes
        if self._replay is not None:
            lsn0 = self._replay.cursor
            exp = self._replay.expect
            if exp is not None:
                want_kind = K_DELETE if delete else K_WRITE
                if (exp.kind != want_kind or exp.tree != tree
                        or len(exp.keys) != n or exp.lsn0 != lsn0):
                    raise RuntimeError(
                        f"WAL replay diverged: expected {exp.kind}@"
                        f"{exp.lsn0} ({exp.tree}, {len(exp.keys)} keys), "
                        f"got {'delete' if delete else 'write'}@{lsn0} "
                        f"({tree}, {n} keys)")
                self._replay.expect = None
            self._replay.cursor += span
            return lsn0
        lsn0 = self._head
        if delete:
            rec = DeleteBatchRecord(tree, lsn0, entry_bytes,
                                    np.asarray(keys, np.int64), op=op)
        else:
            rec = WriteBatchRecord(tree, lsn0, entry_bytes,
                                   np.asarray(keys, np.int64),
                                   np.asarray(vals, np.int64), op=op)
        self._push(rec)
        self._head += span
        return lsn0

    def append_tree_create(self, tree: str, *, dataset: str | None,
                           entry_bytes: int | None) -> None:
        """Log a tree creation once per logical tree (a sharded store
        creates the tree in every shard; only the first create logs)."""
        if tree in self._trees_logged:
            return
        self._trees_logged.add(tree)
        if self._replay is not None:
            return
        self._push(TreeCreateRecord(tree, dataset=dataset,
                                    entry_bytes=entry_bytes,
                                    lsn0=self._head))

    def append_tick(self, merge_budget, *, segment: str = "full") -> None:
        """Log a maintenance tick (``merge_budget``: "default" | "drain" |
        int) or one resumable tick segment (``segment`` = a
        ``scheduler.SEGMENTS`` name). Ticks and segments are deterministic
        functions of store state, so logging the trigger point (not its
        effects) is enough to replay them."""
        if self._replay is not None:
            return
        self._push(TickRecord(lsn0=self._head, merge_budget=merge_budget,
                              segment=segment))

    def append_set_write_memory(self, x: int) -> None:
        if self._replay is not None:
            return
        self._push(SetWriteMemoryRecord(write_memory_bytes=int(x),
                                        lsn0=self._head))

    def set_head(self, v: int) -> None:
        """Compat shim for the legacy ``log_pos`` *setter* (the old bare
        counter could be assigned). Moves the head without a payload
        record -- observability-only; a log advanced this way carries no
        replayable data for the skipped span."""
        self._head = int(v)

    # -- truncation -------------------------------------------------------------
    def truncate(self, min_lsn: int, *, keep_after_seq: int = -1) -> int:
        """Physical truncation. Returns the number of records dropped.

        ``keep_after_seq`` is the replay-tail barrier -- the latest
        checkpoint's WAL sequence. Records at or below it are fully
        folded into that checkpoint's state image and recovery never
        replays them, so the whole covered prefix is dropped -- including
        records above ``min_lsn`` that a min-LSN-only rule would retain
        forever when flushes stall (the ``checkpoint_interval_bytes``
        knob bounds physical log size through exactly this path).
        Records *after* the barrier are NEVER dropped, whatever their
        LSN: zero-span control records (ticks, tuner resizes) logged at
        exactly the checkpoint watermark belong to the replay tail.

        ``truncated_to`` (and so ``tail_bytes = head - truncated_to``)
        advances in LSN space to ``min_lsn``, tracking the paper's
        ``log_length`` exactly whatever the physical drops."""
        keep = 0
        while keep < len(self._records) \
                and self._records[keep].seq <= keep_after_seq:
            keep += 1
        if keep:
            del self._records[:keep]
        if min_lsn > self.truncated_to:
            self.truncated_to = min_lsn
        return keep

    # -- reads / replay ----------------------------------------------------------
    def records(self):
        """Decoded retained records, oldest first."""
        return [decode_record(r.buf) for r in self._records]

    def tail_records(self, after_seq: int):
        """Decoded ``(seq, record)`` pairs with ``seq > after_seq`` --
        the replay tail above a checkpoint's sequence watermark."""
        return [(r.seq, decode_record(r.buf)) for r in self._records
                if r.seq > after_seq]

    def begin_replay(self, start_lsn: int) -> None:
        if self._replay is not None:
            raise RuntimeError("WAL already in replay mode")
        self._replay = _ReplayState(int(start_lsn))

    def expect(self, rec: Record) -> None:
        """Arm the replay-divergence check for the next ``append_batch``."""
        if self._replay is not None:
            self._replay.expect = rec

    def end_replay(self) -> None:
        """Leave replay mode after a *successful* replay; verifies the
        cursor consumed the tail exactly."""
        if self._replay is None:
            raise RuntimeError("WAL not in replay mode")
        cursor = self._replay.cursor
        self._replay = None
        if cursor != self._head:
            raise RuntimeError(
                f"WAL replay incomplete: cursor {cursor} != head "
                f"{self._head} (the tail was not fully replayed)")

    def abort_replay(self) -> None:
        """Leave replay mode after a failed replay without the
        completeness check, so the original error stays the diagnostic."""
        self._replay = None

    # -- crash simulation ---------------------------------------------------------
    def clone(self) -> "WriteAheadLog":
        """Snapshot of the durable log state -- what stable storage holds
        at a crash point. Encoded buffers are immutable and shared; all
        bookkeeping is copied."""
        w = WriteAheadLog()
        w._records = list(self._records)
        w._head = self._head
        w.truncated_to = self.truncated_to
        w.next_seq = self.next_seq
        w._trees_logged = set(self._trees_logged)
        return w
