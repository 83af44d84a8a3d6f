"""Execution backends for the LSM engine's hot loops.

``get_backend("torch", device)`` (the default) runs compaction merges,
write ingest and Bloom build/probe through the hand-written CUDA kernels
of ``repro_torch.kernels`` on a CUDA device, or through their plain
PyTorch versions on a CPU device.
"""
from .backend import (ExecutionBackend, FusedLookup,  # noqa: F401
                      StoreLookup, StoreView, TierView, available_backends,
                      bloom_sizing, get_backend, next_pow2, register_backend)
from .numpy_backend import ingest_order, merge_runs_numpy  # noqa: F401
from .torch_backend import TorchBackend  # noqa: F401
from .pacer import MaintenancePacer  # noqa: F401
from .scheduler import (SEGMENTS, MaintenanceScheduler,  # noqa: F401
                        TickReport)
