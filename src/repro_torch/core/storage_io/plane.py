"""Assembly of the file-backed storage plane under one directory, as the
reference's ``repro.core.storage_io.plane``.

Layout of ``cfg.storage_dir``::

    <storage_dir>/
      wal/                segmented WAL (FileWAL: META + seg-*.wal)
      sst/                one sst-*.run file per SSTable (FilePageStore)
      MANIFEST            manifest frame log (FileManifest)

``create_plane`` starts a fresh store (refusing a directory that already
holds a manifest -- stale durable state must be recovered, not silently
shadowed); ``open_plane`` reopens existing state for ``recover()``.
``MemoryArena`` calls ``create_plane`` when ``storage_medium="files"``
and no adopted wal/manifest was passed in; ``recover()`` callers use
``open_plane`` and pass the result through the same adoption seam the
in-memory medium uses -- the media are interchangeable above this line.
"""
from __future__ import annotations

import os

from .manifest_files import FileManifest
from .pages import FilePageStore
from .wal_files import FileWAL

__all__ = ["plane_paths", "create_plane", "open_plane"]


def plane_paths(root: str) -> dict:
    return {"wal": os.path.join(root, "wal"),
            "sst": os.path.join(root, "sst"),
            "manifest": os.path.join(root, "MANIFEST")}


def _wal_kwargs(cfg) -> dict:
    return {"segment_bytes": cfg.wal_segment_bytes,
            "fsync_policy": cfg.fsync_policy,
            "group_bytes": cfg.group_commit_bytes,
            "group_max_wait_s": cfg.group_commit_max_wait_s,
            "async_fsync": cfg.wal_async_fsync}


def create_plane(cfg) -> tuple[FileWAL, FileManifest]:
    """Fresh physical plane under ``cfg.storage_dir``."""
    root = cfg.storage_dir
    if not root:
        raise ValueError(
            "storage_medium='files' requires storage_dir to be set")
    os.makedirs(root, exist_ok=True)
    p = plane_paths(root)
    if os.path.exists(p["manifest"]):
        raise FileExistsError(
            f"{p['manifest']} already exists: this directory holds a "
            f"persisted store; use open_plane + recover instead of "
            f"creating a new one over it")
    pages = FilePageStore(p["sst"])
    manifest = FileManifest.create(p["manifest"], pages)
    wal = FileWAL.create(p["wal"], **_wal_kwargs(cfg))
    return wal, manifest


def open_plane(cfg) -> tuple[FileWAL, FileManifest]:
    """Reopen a persisted plane (crash recovery / restart):
    ``recover(cfg, *open_plane(cfg))``."""
    root = cfg.storage_dir
    if not root:
        raise ValueError(
            "storage_medium='files' requires storage_dir to be set")
    p = plane_paths(root)
    pages = FilePageStore(p["sst"])
    manifest = FileManifest.open(p["manifest"], pages)
    wal = FileWAL.open(p["wal"], **_wal_kwargs(cfg))
    return wal, manifest
