# Sharded data plane: deterministic key routing + N StorageShards behind
# one shared MemoryArena, arbitrated by one global maintenance scheduler.
from .router import ShardRouter  # noqa: F401
from .sharded import ShardedStore, StorageShard  # noqa: F401
