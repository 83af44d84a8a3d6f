# The durability plane: typed write-ahead log (LSN = byte offset,
# physically truncated below the global min-LSN), versioned manifests and
# checkpoints. Crash recovery is not in this package yet.
from .wal import (DeleteBatchRecord, Record,  # noqa: F401
                  SetWriteMemoryRecord, TickRecord, TreeCreateRecord,
                  WriteAheadLog, WriteBatchRecord, decode_record,
                  encode_record)
from .manifest import LiveSSTable, Manifest, ManifestEdit  # noqa: F401
from .checkpoint import (Checkpoint, RECOVERY_EXACT_COUNTERS,  # noqa: F401
                         capture_checkpoint, take_checkpoint)
