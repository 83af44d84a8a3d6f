"""Physical storage plane: file-backed WAL segments, SSTable pages, and
the manifest frame log, behind the same ``StorageMedium`` seam the
in-memory durability plane uses (``StoreConfig.storage_medium``:
``"memory"`` keeps everything byte-accounted RAM; ``"files"`` moves real
bytes under ``storage_dir`` with CRC framing, group commit, and
process-kill crash safety). Host code in numpy, as the reference's
``repro.core.storage_io``; the files each package writes are byte-
identical, so a plane written by one opens in the other."""
from .format import CorruptFrameError, build_frame, scan_frames
from .manifest_files import FileManifest, decode_edit, encode_edit
from .pages import FilePageStore
from .plane import create_plane, open_plane, plane_paths
from .wal_files import FSYNC_POLICIES, FileWAL

__all__ = [
    "CorruptFrameError", "build_frame", "scan_frames",
    "FileManifest", "encode_edit", "decode_edit",
    "FilePageStore",
    "create_plane", "open_plane", "plane_paths",
    "FileWAL", "FSYNC_POLICIES",
]
