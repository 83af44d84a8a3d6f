"""On-disk frame format shared by every file of the physical storage plane.

One self-delimiting frame wraps every durable unit (a WAL record, a
manifest edit, a checkpoint blob):

    +--------+-------------+-----------+-----------+-----------------+
    | magic  | payload_len | crc32     | tag       | payload bytes   |
    | u32 LE | u32 LE      | u32 LE    | i64 LE    | payload_len     |
    +--------+-------------+-----------+-----------+-----------------+

``tag`` is frame-type-specific: the WAL stores the record's sequence
number there (so a segment scan recovers absolute ordering without a
side index); the manifest stores a small frame-kind discriminant. The
CRC covers the payload only -- a header corrupted anywhere (bad magic,
impossible length) already fails the scan.

Torn-tail rule (the crash contract): a writer appends whole frames and
is allowed to die mid-append, so a scan accepts a file whose *suffix*
fails to parse -- incomplete header, payload running past EOF, or a CRC
mismatch -- and reports the byte offset where the valid prefix ends.
The *caller* decides whether a torn tail is legal: it is on the last
(actively appended) file only; sealed files and interior corruption
must fail loudly. Version bumps change MAGIC (a reader never guesses).
"""
from __future__ import annotations

import struct
import zlib

__all__ = ["FRAME", "MAGIC", "CorruptFrameError", "build_frame",
           "scan_frames", "read_frames"]

FRAME = struct.Struct("<IIIq")       # magic, payload_len, crc32, tag
MAGIC = 0x4C534D31                   # "LSM1" -- bump on format changes
MAX_PAYLOAD = 1 << 30                # sanity bound against garbage lengths


class CorruptFrameError(RuntimeError):
    """Interior (non-tail) frame corruption: the file cannot be trusted."""


def build_frame(tag: int, payload: bytes) -> bytes:
    """One encoded frame, ready to append."""
    return FRAME.pack(MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF,
                      int(tag)) + payload


def scan_frames(data: bytes) -> tuple[list[tuple[int, bytes]], int]:
    """Parse ``data`` into frames. Returns ``(frames, good_end)`` where
    ``frames`` is the ``(tag, payload)`` list of the valid prefix and
    ``good_end`` is the byte offset it ends at. ``good_end < len(data)``
    means the tail is torn (or worse -- the caller applies the rule)."""
    frames: list[tuple[int, bytes]] = []
    off, n = 0, len(data)
    while off + FRAME.size <= n:
        magic, length, crc, tag = FRAME.unpack_from(data, off)
        if magic != MAGIC or length > MAX_PAYLOAD:
            break
        end = off + FRAME.size + length
        if end > n:
            break
        payload = data[off + FRAME.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        frames.append((tag, payload))
        off = end
    return frames, off


def read_frames(path, *, allow_torn_tail: bool):
    """Scan one file. With ``allow_torn_tail`` a trailing unparseable
    suffix is *discarded* (physically truncated away, so the next append
    lands on a clean frame boundary); without it any trailing garbage
    raises ``CorruptFrameError``. Returns the ``(tag, payload)`` list."""
    with open(path, "rb") as f:
        data = f.read()
    frames, good_end = scan_frames(data)
    if good_end < len(data):
        if not allow_torn_tail:
            raise CorruptFrameError(
                f"{path}: unreadable frame at byte {good_end} of "
                f"{len(data)} in a sealed file (interior corruption, "
                f"not a torn tail)")
        with open(path, "r+b") as f:
            f.truncate(good_end)
    return frames
