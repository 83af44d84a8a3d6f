"""Segmented file-backed WAL with group commit, as the reference's
``repro.core.storage_io.wal_files``, byte for byte in what it writes.

``FileWAL`` subclasses the in-memory ``WriteAheadLog`` -- same LSN
semantics, same replay machinery, same record wire encoding -- and makes
the log physical:

  * **Segments**: records append to fixed-size segment files
    (``seg-<index>.wal``), each a sequence of CRC frames whose tag is
    the record's absolute sequence number. A record never splits across
    segments; a segment seals (flush + fsync, file closed) when the next
    frame would overflow ``segment_bytes``. ``truncate(min_lsn)``
    unlinks whole sealed segments once every record they hold is below
    the retained minimum -- the durable twin of the base class's
    record-list truncation.
  * **META**: a tiny JSON file (rewritten atomically: tmp + fsync +
    rename, *before* any segment unlinks) pinning ``truncated_to``, the
    minimum retained sequence, and the head LSN at truncation time --
    what reopen needs to restart sequence/LSN counters when the log is
    empty or its oldest segment holds already-truncated frames.
  * **Group commit**: appended frames buffer in userspace (``_pending``)
    until the fsync policy releases them, so a SIGKILL loses exactly the
    un-fsynced suffix -- fsync is the real durability boundary, which is
    what the process-kill crash harness measures. ``per_record`` fsyncs
    every append; ``per_batch`` fsyncs at every commit point (store-level
    batch, scheduler tick/segment end); ``group`` defers until
    ``group_bytes`` of frames are pending or the oldest has waited
    ``group_max_wait_s``. Commit points queue leader-follower style:
    whichever commit trips the threshold issues ONE fsync for every
    queued commit, and each queued commit's wait is recorded in
    ``commit_hist`` (a ``LatencyHistogram``, microseconds).

Every fsync runs on the caller's thread. The reference's async group
commit (a durability worker thread, ``async_fsync=True``) comes with the
port's async-commit slice; until then the constructor refuses it.

Reopen (``FileWAL.open``) rescans the segments oldest-first, skipping
frames below the retained minimum; a torn tail is tolerated -- and
physically truncated -- on the LAST segment only (the one a crashed
writer was appending), while unreadable bytes in a sealed segment raise
``CorruptFrameError``. ``set_head`` (the legacy ``log_pos`` setter shim)
moves the in-memory head only; it logs no record, so like the base
class the skipped span is unreplayable -- observability-only.
"""
from __future__ import annotations

import json
import os
import time

from ...runtime.latency import LatencyHistogram
from ..durability.wal import TreeCreateRecord, WriteAheadLog, _Stored, \
    decode_record
from .format import build_frame, read_frames

__all__ = ["FileWAL", "FSYNC_POLICIES", "ASYNC_FSYNC_REFUSED"]

FSYNC_POLICIES = ("per_record", "per_batch", "group")
ASYNC_FSYNC_REFUSED = (
    "async group commit (StoreConfig.wal_async_fsync, FileWAL's "
    "async_fsync) is not supported yet: it comes with the port's "
    "async-commit slice; use wal_async_fsync=False (fsync_policy='group' "
    "then commits inline)")

_META = "META"
_SEG_FMT = "seg-%010d.wal"


class FileWAL(WriteAheadLog):
    """File-backed ``WriteAheadLog``: segment files + group commit."""

    def __init__(self, root: str, *, segment_bytes: int = 1 << 20,
                 fsync_policy: str = "per_batch",
                 group_bytes: int = 64 << 10,
                 group_max_wait_s: float = 1e-3,
                 async_fsync: bool = False):
        if fsync_policy not in FSYNC_POLICIES:
            raise ValueError(f"unknown fsync_policy {fsync_policy!r}; "
                             f"expected one of {FSYNC_POLICIES}")
        if async_fsync and fsync_policy != "group":
            raise ValueError(f"async_fsync requires fsync_policy='group', "
                             f"got {fsync_policy!r}")
        if async_fsync:
            raise ValueError(ASYNC_FSYNC_REFUSED)
        super().__init__()
        self.root = root
        self.segment_bytes = int(segment_bytes)
        self.fsync_policy = fsync_policy
        self.group_bytes = int(group_bytes)
        self.group_max_wait_s = float(group_max_wait_s)
        self.fsyncs = 0
        self.commit_hist = LatencyHistogram()
        self._stats = None
        self._meta_path = os.path.join(root, _META)
        self._min_seq = 0              # oldest retained sequence number
        self._durable_lsn = 0
        self._pending: list[bytes] = []    # frames not yet written to the OS
        self._pending_bytes = 0
        self._pending_t0 = 0.0             # age of the oldest pending frame
        # (enqueue time, n ops, head LSN the commit needs durable)
        self._commit_q: list[tuple[float, int, int]] = []
        self._segments: list[tuple[str, int]] = []     # sealed: (path, last seq)
        self._f = None
        self._seg_index = -1
        self._seg_path = ""
        self._seg_bytes = 0
        self._seg_last_seq = -1

    # -- construction ----------------------------------------------------------
    @classmethod
    def create(cls, root: str, **kw) -> "FileWAL":
        """Start a fresh log in an empty directory."""
        os.makedirs(root, exist_ok=True)
        if os.listdir(root):
            raise FileExistsError(
                f"WAL directory {root!r} is not empty; open the existing "
                f"log with FileWAL.open (then recover)")
        w = cls(root, **kw)
        w._write_meta()
        w._open_segment(0)
        return w

    @classmethod
    def open(cls, root: str, **kw) -> "FileWAL":
        """Reopen a persisted log: rescan segments, drop a torn tail on
        the last one, rebuild heads/sequences, keep appending in place."""
        w = cls(root, **kw)
        with open(w._meta_path) as f:
            meta = json.load(f)
        w.truncated_to = int(meta["truncated_to"])
        w._min_seq = int(meta["min_seq"])
        head = int(meta["head"])
        names = sorted(n for n in os.listdir(root)
                       if n.startswith("seg-") and n.endswith(".wal"))
        last_seq = None
        for i, name in enumerate(names):
            path = os.path.join(root, name)
            is_last = i == len(names) - 1
            frames = read_frames(path, allow_torn_tail=is_last)
            seg_last = -1
            for tag, payload in frames:
                seg_last = tag
                if tag < w._min_seq:      # truncated prefix of a segment
                    continue              # straddling the retention barrier
                rec = decode_record(payload)
                w._records.append(_Stored(tag, rec.lsn0, rec.lsn_end,
                                          payload))
                head = max(head, rec.lsn_end)
                last_seq = tag
                if isinstance(rec, TreeCreateRecord):
                    w._trees_logged.add(rec.tree)
            if not is_last:
                w._segments.append((path, seg_last))
        w._head = head
        w._durable_lsn = head             # everything scanned is on disk
        w.next_seq = w._min_seq if last_seq is None else last_seq + 1
        if names:
            w._seg_index = int(names[-1][4:-4])
            w._seg_path = os.path.join(root, names[-1])
            w._f = open(w._seg_path, "ab", buffering=0)
            w._seg_bytes = os.path.getsize(w._seg_path)
            w._seg_last_seq = -1 if last_seq is None else last_seq
        else:                             # crashed between META and segment 0
            w._open_segment(0)
        return w

    # -- plumbing ---------------------------------------------------------------
    def bind_stats(self, stats) -> None:
        """Mirror fsync counts into the store's ``IOStats``."""
        self._stats = stats

    def _open_segment(self, index: int) -> None:
        self._seg_index = index
        self._seg_path = os.path.join(self.root, _SEG_FMT % index)
        # buffering=0: bytes handed to write() are in the OS immediately,
        # so _pending is the ONLY kill-vulnerable buffer.
        self._f = open(self._seg_path, "ab", buffering=0)
        self._seg_bytes = os.path.getsize(self._seg_path)
        self._seg_last_seq = -1

    def _write_meta(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            # head = the DURABLE head, never self._head: under group
            # commit appended frames may still be buffered in userspace,
            # and a durable META claiming LSNs beyond the surviving
            # frames would make recovery's replay come up short.
            json.dump({"truncated_to": self.truncated_to,
                       "min_seq": self._min_seq,
                       "head": self._durable_lsn}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)

    def _seal_segment(self) -> None:
        self._fsync_now()                  # a sealed file is never torn
        self._f.close()
        self._segments.append((self._seg_path, self._seg_last_seq))
        self._open_segment(self._seg_index + 1)

    def _fsync_now(self) -> None:
        """Write every pending frame and fsync; drain the commit queue
        into the latency histogram (ONE fsync serves all queued commits:
        leader-follower group commit)."""
        if self._pending:
            t0 = time.perf_counter()
            self._f.write(b"".join(self._pending))
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            if self._stats is not None:
                self._stats.fsyncs += 1
                # foreground time blocked on WAL durability: the whole
                # inline fsync
                self._stats.fsync_wait_us += (time.perf_counter() - t0) * 1e6
            self._pending.clear()
            self._pending_bytes = 0
            self._durable_lsn = self._head
        if self._commit_q:
            t1 = time.perf_counter()
            for t0, n, _ in self._commit_q:
                self.commit_hist.record(max((t1 - t0) * 1e6, 1e-3), n=n)
            self._commit_q.clear()

    # -- appends (one override: every record becomes a pending frame) -----------
    def _push(self, rec) -> None:
        seq = self.next_seq
        super()._push(rec)
        frame = build_frame(seq, self._records[-1].buf)
        if self._seg_bytes and self._seg_bytes + len(frame) > self.segment_bytes:
            self._seal_segment()
        if not self._pending:
            self._pending_t0 = time.perf_counter()
        self._pending.append(frame)
        self._pending_bytes += len(frame)
        self._seg_bytes += len(frame)
        self._seg_last_seq = seq
        if self.fsync_policy == "per_record":
            self._commit_q.append((time.perf_counter(), 1, self._head))
            self._fsync_now()

    # -- durability -------------------------------------------------------------
    @property
    def durable_lsn(self) -> int:
        return self._durable_lsn

    @property
    def all_durable(self) -> bool:
        return not self._pending

    def commit(self, n: int = 1) -> None:
        """A commit point: ``n`` logical ops want durability here. Under
        ``per_batch`` this fsyncs now; under ``group`` it queues behind
        the interval/age thresholds (the commit that trips one becomes
        the leader and fsyncs for the whole queue)."""
        if self._replay is not None or self.fsync_policy == "per_record":
            return
        now = time.perf_counter()
        if not self._pending:
            return
        self._commit_q.append((now, max(1, int(n)), self._head))
        if self.fsync_policy == "per_batch" \
                or self._pending_bytes >= self.group_bytes \
                or now - self._pending_t0 >= self.group_max_wait_s:
            self._fsync_now()

    def sync(self) -> None:
        """Force everything durable now (shutdown, tests, benchmarks)."""
        if self._pending or self._commit_q:
            self._fsync_now()

    def close(self) -> None:
        self.sync()
        if self._f is not None:
            self._f.close()
            self._f = None

    # -- truncation --------------------------------------------------------------
    def truncate(self, min_lsn: int, *, keep_after_seq: int = -1) -> int:
        """Logical truncation (base class) + physical: rewrite META first
        (so a crash mid-unlink still reopens consistently), then unlink
        every sealed segment whose records are all below the retained
        minimum. The active segment is never unlinked; frames below the
        barrier inside a retained file are skipped at reopen."""
        dropped = super().truncate(min_lsn, keep_after_seq=keep_after_seq)
        self._min_seq = self._records[0].seq if self._records \
            else self.next_seq
        self._write_meta()
        keep = []
        for path, last_seq in self._segments:
            if last_seq < self._min_seq:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            else:
                keep.append((path, last_seq))
        self._segments = keep
        return dropped

    # -- observability ------------------------------------------------------------
    @property
    def segment_count(self) -> int:
        """Sealed segments + the active one."""
        return len(self._segments) + 1

    def segment_paths(self) -> list[str]:
        return [p for p, _ in self._segments] + [self._seg_path]
