# The paper's primary contribution: adaptive memory management for
# LSM-based storage (partitioned memory components, flush policies, and the
# write-memory/buffer-cache memory tuner), behind the storage service.
from .engine import ExecutionBackend, get_backend  # noqa: F401
from .lsm.storage import LSMStore, StoreConfig, TimeModel  # noqa: F401
from .lsm.tree import LSMTree  # noqa: F401
from .shard import ShardedStore, ShardRouter, StorageShard  # noqa: F401
from .service import (AdaptiveGovernor, Deferred, Delete, Get,  # noqa: F401
                      GetResult, MemoryGovernor, MemoryPlan, Put, Scan,
                      ScanResult, ServiceConfig, Session, StaticGovernor,
                      StorageService, WriteAck)
from .tuner.derivatives import TunerStats, cost_derivative  # noqa: F401
from .tuner.tuner import (AdaptiveMemoryController, MemoryTuner,  # noqa: F401
                          TunerConfig)
