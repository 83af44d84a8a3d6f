"""PyTorch/CUDA port of the adaptive-memory LSM storage system.

``repro_torch.core`` carries the storage service; its hot loops run on
hand-written Hopper CUDA kernels (``repro_torch.kernels``, sources in
``repro_torch/csrc``). Imports torch and numpy only.
"""
