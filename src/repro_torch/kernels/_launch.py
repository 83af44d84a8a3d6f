"""Argument checks and launch counts shared by the kernel wrappers."""
from __future__ import annotations

import threading

import torch

# Kernel launches in this process, one plain integer per kernel. A wrapper
# adds one (``count``) where it launches its kernel and nowhere else, so a
# run that zeroes these first shows which kernels its path went through.
LAUNCHES = {"merge_pair": 0, "bloom_build": 0, "bloom_probe": 0,
            "probe_tier": 0, "probe_store": 0, "flash_attention": 0,
            "flash_attention_bwd_prep": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}
_COUNT_LOCK = threading.Lock()


def count(name: str, counts: dict = LAUNCHES) -> None:
    """Add one to ``counts[name]`` under one lock. The maintenance workers
    launch K1 and K2 from their own threads while the foreground launches
    too, and ``counts[name] += 1`` alone is a read-modify-write that can
    lose one."""
    with _COUNT_LOCK:
        counts[name] += 1


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; raises otherwise. A wrapper launches its kernel
    for the first case and runs its plain version only for the second."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def expect(t: torch.Tensor, name: str, dtype: torch.dtype,
           ndim: int = 1) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)} "
            f"(contiguous={t.is_contiguous()})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s CUDA device, read
    without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
