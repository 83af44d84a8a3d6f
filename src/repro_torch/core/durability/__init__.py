# The durability plane: typed write-ahead log (LSN = byte offset,
# physically truncated below the global min-LSN), versioned manifests with
# checkpoints, and bit-identical crash recovery across the sharded store.
#
# ``recover`` is exported lazily: it pulls in the sharded data plane,
# which itself builds on this package (arena -> wal/manifest).
from .wal import (DeleteBatchRecord, Record,  # noqa: F401
                  SetWriteMemoryRecord, TickRecord, TreeCreateRecord,
                  WriteAheadLog, WriteBatchRecord, decode_record,
                  encode_record)
from .manifest import LiveSSTable, Manifest, ManifestEdit  # noqa: F401
from .checkpoint import (Checkpoint, RECOVERY_EXACT_COUNTERS,  # noqa: F401
                         capture_checkpoint, restore_checkpoint,
                         take_checkpoint)


def __getattr__(name):
    if name in ("recover", "router_from_spec"):
        from . import recovery
        return getattr(recovery, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
