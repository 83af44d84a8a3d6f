"""File-backed SSTable pages: one file per table, page-aligned reads.

Layout of ``sst-<id>.run``::

    +----------------------------------------------+
    | header: magic u32, version u32, n i64,       |
    |         lsn_min i64, lsn_max i64,            |
    |         entry_bytes i64, page_bytes i64,     |
    |         crc32(keys+vals) u32                 |
    +----------------------------------------------+
    | keys: n * int64 LE                           |
    | vals: n * int64 LE                           |
    +----------------------------------------------+

Page ``p`` covers entries ``[p*epp, (p+1)*epp)`` with
``epp = max(1, page_bytes // entry_bytes)`` -- the exact geometry
``lsm/sstable.py`` accounts pins against, so ``Disk.query_pin_many``'s
counters stay bit-identical while every cache miss now issues a real
``pread`` of that page's key/value slices (page ``-1``, the Bloom unit,
reads the header). Files are written whole at flush/merge (tables are
immutable), fsynced, and unlinked at ``drop_sst`` -- except while a
retained checkpoint still references them (``set_pinned``): a
checkpoint frame must never point at an unlinked file, so drops defer
until the pin set moves on. ``gc`` reconciles the directory against the
manifest's live set after recovery (replayed flushes re-write tables
under fresh ids; the crashed run's orphans are removed).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["FilePageStore", "SST_MAGIC"]

SST_MAGIC = 0x4C534D53            # "LSMS"
SST_VERSION = 1
_HEADER = struct.Struct("<IIqqqqqI")


class FilePageStore:
    """Directory of immutable per-SSTable files keyed by ``sst_id``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.stats = None                  # bound IOStats (fsync counter)
        self.fsyncs = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self._pinned: set[int] = set()     # referenced by retained checkpoints
        self._deferred: set[int] = set()   # dropped while pinned

    def bind_stats(self, stats) -> None:
        self.stats = stats

    def path(self, sst_id: int) -> str:
        return os.path.join(self.root, f"sst-{int(sst_id):010d}.run")

    def ids(self) -> set[int]:
        out = set()
        for name in os.listdir(self.root):
            if name.startswith("sst-") and name.endswith(".run"):
                out.add(int(name[4:-4]))
        return out

    # -- writes -----------------------------------------------------------------
    def _write_file(self, sst_id: int, keys, vals, lsn_min: int,
                    lsn_max: int, entry_bytes: int, page_bytes: int) -> None:
        kb = np.ascontiguousarray(keys, np.int64).tobytes()
        vb = np.ascontiguousarray(vals, np.int64).tobytes()
        header = _HEADER.pack(SST_MAGIC, SST_VERSION, len(kb) // 8,
                              int(lsn_min), int(lsn_max), int(entry_bytes),
                              int(page_bytes),
                              zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF)
        with open(self.path(sst_id), "wb") as f:
            f.write(header)
            f.write(kb)
            f.write(vb)
            f.flush()
            os.fsync(f.fileno())
        self.fsyncs += 1
        self.bytes_written += _HEADER.size + len(kb) + len(vb)
        if self.stats is not None:
            self.stats.fsyncs += 1

    def write(self, sst) -> None:
        """Persist a freshly flushed/merged table (whole-file write)."""
        self._write_file(sst.sst_id, sst.keys, sst.vals, sst.lsn_min,
                         sst.lsn_max, sst.entry_bytes, sst.page_bytes)

    def ensure(self, sst) -> None:
        """Persist only if absent (checkpoint restore re-keys tables to
        fresh ids; their bytes may already live under the old id, but the
        recovered store must own files for the ids it actually uses)."""
        if not os.path.exists(self.path(sst.sst_id)):
            self._write_file(sst.sst_id, sst.keys, sst.vals, sst.lsn_min,
                             sst.lsn_max, sst.entry_bytes, sst.page_bytes)

    def ensure_payload(self, sst_id: int, p) -> None:
        """Persist a manifest ``LiveSSTable`` payload if absent (bulk-
        loaded fixtures bypass the flush path; a checkpoint frame must
        not reference a file that was never written)."""
        if not os.path.exists(self.path(sst_id)):
            self._write_file(sst_id, p.keys, p.vals, p.lsn_min, p.lsn_max,
                             p.entry_bytes, p.page_bytes)

    # -- reads ------------------------------------------------------------------
    def read_page(self, sst_id: int, page_index: int) -> int:
        """Physically read one page (both its key and value slices); page
        ``-1`` reads the header (the Bloom unit). Returns bytes read.
        Missing files read 0 bytes: the cache-miss accounting upstream is
        authoritative, and dropped-while-referenced windows (a merge
        dropping a table another thread still pins) must not crash."""
        path = self.path(sst_id)
        try:
            with open(path, "rb") as f:
                hdr = f.read(_HEADER.size)
                if len(hdr) < _HEADER.size:
                    return 0
                magic, _, n, _, _, entry_bytes, page_bytes, _ = \
                    _HEADER.unpack(hdr)
                if magic != SST_MAGIC:
                    raise RuntimeError(f"{path}: bad SSTable magic "
                                       f"{magic:#x}")
                if page_index < 0:
                    self.bytes_read += _HEADER.size
                    return _HEADER.size
                epp = max(1, page_bytes // max(1, entry_bytes))
                lo = page_index * epp
                count = max(0, min(epp, n - lo))
                if count == 0:
                    return 0
                f.seek(_HEADER.size + lo * 8)
                got = len(f.read(count * 8))
                f.seek(_HEADER.size + (n + lo) * 8)
                got += len(f.read(count * 8))
                self.bytes_read += got
                return got
        except FileNotFoundError:
            return 0

    def load(self, sst_id: int) -> dict:
        """Whole-table read with CRC verification (recovery path)."""
        path = self.path(sst_id)
        with open(path, "rb") as f:
            hdr = f.read(_HEADER.size)
            magic, version, n, lsn_min, lsn_max, entry_bytes, page_bytes, \
                crc = _HEADER.unpack(hdr)
            if magic != SST_MAGIC:
                raise RuntimeError(f"{path}: bad SSTable magic {magic:#x}")
            if version != SST_VERSION:
                raise RuntimeError(f"{path}: unsupported SSTable version "
                                   f"{version} (reader speaks "
                                   f"{SST_VERSION})")
            body = f.read(2 * n * 8)
        if len(body) != 2 * n * 8:
            raise RuntimeError(f"{path}: truncated SSTable body "
                               f"({len(body)} of {2 * n * 8} bytes)")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise RuntimeError(f"{path}: SSTable payload CRC mismatch")
        self.bytes_read += _HEADER.size + len(body)
        return {
            "keys": np.frombuffer(body[:n * 8], np.int64).copy(),
            "vals": np.frombuffer(body[n * 8:], np.int64).copy(),
            "lsn_min": lsn_min, "lsn_max": lsn_max,
            "entry_bytes": entry_bytes, "page_bytes": page_bytes,
        }

    # -- lifecycle ---------------------------------------------------------------
    def mark_dropped(self, sst_id: int) -> None:
        """Unlink a merged-away table -- deferred while a retained
        checkpoint frame still references it."""
        if sst_id in self._pinned:
            self._deferred.add(sst_id)
            return
        try:
            os.unlink(self.path(sst_id))
        except FileNotFoundError:
            pass

    def set_pinned(self, ids) -> None:
        """Replace the checkpoint-referenced pin set; tables whose drop
        was deferred and are no longer pinned unlink now."""
        self._pinned = set(ids)
        for sid in sorted(self._deferred - self._pinned):
            self._deferred.discard(sid)
            try:
                os.unlink(self.path(sid))
            except FileNotFoundError:
                pass

    def gc(self, live_ids) -> list[int]:
        """Unlink files neither live in the manifest nor checkpoint-
        pinned (post-recovery orphan sweep). Returns removed ids."""
        keep = set(live_ids) | self._pinned
        removed = []
        for sid in sorted(self.ids() - keep):
            try:
                os.unlink(self.path(sid))
                removed.append(sid)
            except FileNotFoundError:
                pass
        self._deferred -= set(removed)
        return removed
