# The paper's primary contribution: adaptive memory management for
# LSM-based storage (partitioned memory components and flush policies),
# behind the storage service. No tuner is imported here.
from .engine import ExecutionBackend, get_backend  # noqa: F401
from .lsm.storage import LSMStore, StoreConfig, TimeModel  # noqa: F401
from .lsm.tree import LSMTree  # noqa: F401
from .service import (Deferred, Delete, Get, GetResult,  # noqa: F401
                      MemoryGovernor, MemoryPlan, Put, Scan, ScanResult,
                      ServiceConfig, Session, StaticGovernor,
                      StorageService, WriteAck)
