from .derivatives import TunerStats, cost_derivative  # noqa: F401
from .simcache import GhostCache  # noqa: F401
from .tuner import (AdaptiveMemoryController, MemoryTuner,  # noqa: F401
                    TuneRecord, TunerConfig, newton_step)
