# The unified storage front door (§3 as an API): typed request plans,
# sessions with admission control, and the pluggable MemoryGovernor.
from .governor import (AdaptiveGovernor, DevicePoolGovernor,  # noqa: F401
                       MemoryGovernor, MemoryPlan, StallGovernor,
                       StaticGovernor)
from .planner import ExecutionPlan, PlanStep, build_plan  # noqa: F401
from .requests import (Deferred, Delete, Get, GetResult, Put,  # noqa: F401
                       Request, Result, Scan, ScanResult, WriteAck,
                       request_kind)
from .service import (ServiceConfig, Session, SessionStats,  # noqa: F401
                      StorageService)
