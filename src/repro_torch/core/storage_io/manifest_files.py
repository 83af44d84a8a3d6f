"""File-backed manifest: an append-only frame log of edits + checkpoints.

One ``MANIFEST`` file holds four frame kinds (``format.py`` framing, tag
= frame kind):

  * ``META`` (json): the store-identity guardrail fields, written once
    at bind time -- reopening verifies the config matches.
  * ``ROUTER`` (pickle): the shard-router spec, written once.
  * ``EDIT`` (fixed int64 header + utf-8 names): one versioned
    ``ManifestEdit`` per flush/merge/watermark -- ``encode_edit`` /
    ``decode_edit`` are exact inverses (property-tested round-trip,
    mirroring the WAL record codec's contract).
  * ``CHECKPOINT`` (pickle): a full recovery point with SSTable payload
    arrays replaced by *references* into the page store (``sst_id`` ->
    geometry); reopening materializes the latest checkpoint frame by
    CRC-verified reads of the referenced ``sst-*.run`` files. The frame
    is fsynced before ``add_checkpoint`` returns, so the WAL-truncation
    that follows a checkpoint never outruns it; referenced page files
    are pinned against unlink until the checkpoint itself is retired.

Reopen tolerates (and physically truncates) a torn tail frame -- a
writer may die mid-append. Edits re-emitted by recovery replay append
duplicate frames with their original version numbers; the rebuild takes
``max`` over versions, so a re-recovered manifest converges.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..durability.checkpoint import Checkpoint
from ..durability.manifest import LiveSSTable, Manifest, ManifestEdit
from ..durability.wal import _pad8
from .format import CorruptFrameError, build_frame, read_frames

__all__ = ["FileManifest", "encode_edit", "decode_edit"]

TAG_META = 1
TAG_ROUTER = 2
TAG_EDIT = 3
TAG_CHECKPOINT = 4

_EDIT_HEADER_WORDS = 8


# --------------------------- edit codec ---------------------------------------
def encode_edit(edit: ManifestEdit) -> bytes:
    """Serialize one manifest edit (int64 header + padded utf-8 names).
    Exact inverse of ``decode_edit`` for any string ``kind``/``tree``."""
    kind = edit.kind.encode()
    tree = edit.tree.encode()
    header = np.array([edit.version, edit.shard, edit.sst_id,
                       edit.n_entries, edit.lsn, len(kind), len(tree), 0],
                      np.int64)
    body = kind + tree
    body += b"\x00" * (_pad8(len(body)) - len(body))
    return header.tobytes() + body


def decode_edit(buf: bytes) -> ManifestEdit:
    """Deserialize one manifest edit (exact inverse of ``encode_edit``)."""
    header = np.frombuffer(buf[:_EDIT_HEADER_WORDS * 8], np.int64)
    version, shard, sst_id, n_entries, lsn, klen, tlen, _ = \
        (int(x) for x in header)
    off = _EDIT_HEADER_WORDS * 8
    kind = buf[off:off + klen].decode()
    tree = buf[off + klen:off + klen + tlen].decode()
    return ManifestEdit(version, kind, shard, tree, sst_id, n_entries, lsn)


# --------------------------- the file manifest --------------------------------
class FileManifest(Manifest):
    """``Manifest`` whose every mutation appends a durable frame."""

    def __init__(self, path: str, pages):
        super().__init__()
        self._path = path
        self.pages = pages                 # FilePageStore holding payloads
        self._f = None
        self._stats = None

    @classmethod
    def create(cls, path: str, pages) -> "FileManifest":
        if os.path.exists(path):
            raise FileExistsError(
                f"manifest {path!r} already exists; open the existing "
                f"plane with open_plane (then recover)")
        m = cls(path, pages)
        m._f = open(path, "ab", buffering=0)
        return m

    @classmethod
    def open(cls, path: str, pages) -> "FileManifest":
        """Rebuild from the frame log. Only the LATEST checkpoint frame
        is materialized (older frames may reference pages already
        retired); the live set stays empty -- ``recover()`` installs it
        from the checkpoint and the replayed tail, exactly as with the
        in-memory manifest."""
        m = cls(path, pages)
        ck_blob = None
        for tag, payload in read_frames(path, allow_torn_tail=True):
            if tag == TAG_META:
                m.store_meta = json.loads(payload.decode())
            elif tag == TAG_ROUTER:
                m.router_spec = pickle.loads(payload)
            elif tag == TAG_EDIT:
                e = decode_edit(payload)
                m.edits.append(e)
                m.version = max(m.version, e.version)
                if e.kind == "watermark" and e.lsn > m.watermark:
                    m.watermark = e.lsn
            elif tag == TAG_CHECKPOINT:
                ck_blob = payload
            else:
                raise CorruptFrameError(
                    f"{path}: unknown manifest frame tag {tag}")
        if len(m.edits) > m.MAX_EDITS:
            del m.edits[:-m.MAX_EDITS]
        if ck_blob is not None:
            ck = m._materialize_checkpoint(ck_blob)
            m.checkpoints = [ck]
            m.version = max(m.version, ck.version)
            pages.set_pinned(set(ck.payloads))
        m._f = open(path, "ab", buffering=0)
        return m

    def _materialize_checkpoint(self, blob: bytes) -> Checkpoint:
        d = pickle.loads(blob)
        payloads = {}
        for sid, (shard, tree, lsn_min, lsn_max, entry_bytes, page_bytes,
                  kind) in d["payload_refs"].items():
            run = self.pages.load(sid)
            payloads[sid] = LiveSSTable(
                shard, tree, run["keys"], run["vals"], lsn_min, lsn_max,
                entry_bytes, page_bytes, kind)
        return Checkpoint(
            version=d["version"], wal_seq=d["wal_seq"],
            watermark=d["watermark"], man_watermark=d["man_watermark"],
            write_memory_bytes=d["write_memory_bytes"],
            iostats=d["iostats"], schema=d["schema"], shards=d["shards"],
            payloads=payloads, scheduler=d["scheduler"])

    # -- frame appends ----------------------------------------------------------
    def bind_stats(self, stats) -> None:
        self._stats = stats
        self.pages.bind_stats(stats)

    def _frame(self, tag: int, payload: bytes, *, fsync: bool = False) -> None:
        self._f.write(build_frame(tag, payload))
        if fsync:
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            if self._stats is not None:
                self._stats.fsyncs += 1

    fsyncs = 0

    # -- Manifest overrides: same state transitions, plus a durable frame -------
    def bind(self, cfg) -> None:
        first = self.store_meta is None
        super().bind(cfg)
        if first:
            self._frame(TAG_META,
                        json.dumps(self.store_meta, sort_keys=True).encode(),
                        fsync=True)

    def set_router(self, spec: tuple) -> None:
        first = self.router_spec is None
        super().set_router(spec)
        if first:
            self._frame(TAG_ROUTER, pickle.dumps(self.router_spec),
                        fsync=True)

    def _append(self, edit: ManifestEdit) -> None:
        super()._append(edit)
        self._frame(TAG_EDIT, encode_edit(edit))

    def add_checkpoint(self, ck: Checkpoint) -> None:
        # Every referenced payload must be a real file before the frame
        # that points at it is durable (bulk-loaded fixtures bypass the
        # flush path that normally writes them).
        for sid, p in ck.payloads.items():
            self.pages.ensure_payload(sid, p)
        super().add_checkpoint(ck)
        refs = {sid: (p.shard, p.tree, int(p.lsn_min), int(p.lsn_max),
                      int(p.entry_bytes), int(p.page_bytes), p.kind)
                for sid, p in ck.payloads.items()}
        blob = pickle.dumps({
            "version": ck.version, "wal_seq": ck.wal_seq,
            "watermark": ck.watermark, "man_watermark": ck.man_watermark,
            "write_memory_bytes": ck.write_memory_bytes,
            "iostats": ck.iostats, "schema": ck.schema,
            "shards": ck.shards, "scheduler": ck.scheduler,
            "payload_refs": refs,
        })
        self._frame(TAG_CHECKPOINT, blob, fsync=True)
        self.pages.set_pinned({sid for c in self.checkpoints
                               for sid in c.payloads})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
