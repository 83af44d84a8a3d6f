"""K2 and K5: Bloom filter build and probe (``csrc/bloom.cu``).

A filter is a bool tensor ``[128, n_slots // 128]``; slot s is element
``s`` of its flat view. Slot j of a key is ``(h1 + j * h2) mod n_slots``
with ``h1 = key32 * C1 mod n_slots`` and ``h2 = (key32 * C2 | 1) mod
n_slots``: ``key32`` is the key truncated to int32, the products wrap in
int32 and ``mod`` is floor-mod, exactly as the host reference
(``core.engine.numpy_backend._bloom_slots``) computes them.

``bloom_build`` and ``bloom_probe`` are the wrappers: on CUDA tensors they
launch the kernels, on CPU tensors they run the plain versions beside
them.
"""
from __future__ import annotations

import torch

from .. import build
from .._launch import LAUNCHES, expect, on_card, stream_of

C1 = 0x9E3779B1
C2 = 0x85EBCA77
_LOW32 = 0xFFFFFFFF


def _wrap_mul32(u, c: int):
    """``(u * c) mod 2**32`` for uint32 values held in int64, without
    overflowing int64: multiply by 16-bit halves of ``u``."""
    lo = u & 0xFFFF
    hi = u >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _LOW32


def _as_int32(p):
    """Reinterpret uint32 values held in int64 as int32 values."""
    return p - ((p >> 31) << 32)


def bloom_slots_plain(keys, n_slots, k_hashes: int):
    """``[..., k]`` int64 slot indices of int64 ``keys``. ``n_slots`` is
    one slot count, or an int64 tensor of the shape of ``keys`` that gives
    each key its own (the fused read path probes each query against its
    own table's filter)."""
    u = keys & _LOW32
    h1 = torch.remainder(_as_int32(_wrap_mul32(u, C1)), n_slots)
    h2 = torch.remainder(_as_int32(_wrap_mul32(u, C2) | 1), n_slots)
    j = torch.arange(k_hashes, dtype=torch.int64, device=keys.device)
    n = n_slots[..., None] if torch.is_tensor(n_slots) else n_slots
    return (h1[..., None] + j * h2[..., None]) % n


def bloom_build_plain(keys, n_slots: int, k_hashes: int):
    filt = torch.zeros(n_slots, dtype=torch.bool, device=keys.device)
    filt[bloom_slots_plain(keys, n_slots, k_hashes).reshape(-1)] = True
    return filt.reshape(128, n_slots // 128)


def bloom_probe_plain(filt, keys, k_hashes: int):
    slots = bloom_slots_plain(keys, filt.numel(), k_hashes)
    return filt.reshape(-1)[slots].all(dim=-1)


def _check_slots(n_slots: int) -> None:
    if n_slots <= 0 or n_slots % 128 or n_slots >= 2**31:
        raise ValueError(f"n_slots must be a positive multiple of 128 below "
                         f"2**31, got {n_slots}")


def bloom_build(keys, n_slots: int, k_hashes: int):
    """Filter over int64 ``keys``: bool ``[128, n_slots // 128]``."""
    expect(keys, "keys", torch.int64)
    _check_slots(n_slots)
    if not on_card(keys):
        return bloom_build_plain(keys, n_slots, k_hashes)
    filt = torch.zeros((128, n_slots // 128), dtype=torch.bool,
                       device=keys.device)
    if len(keys) == 0:
        return filt
    rc = build.library().bloom_build(keys.data_ptr(), len(keys), n_slots,
                                     k_hashes, filt.data_ptr(),
                                     stream_of(keys))
    build.check(rc, "bloom_build")
    LAUNCHES["bloom_build"] += 1
    return filt


def bloom_probe(filt, keys, k_hashes: int):
    """Membership of int64 ``keys`` in ``filt`` (bool ``[128, W]``): True
    where all ``k_hashes`` slots are set."""
    expect(filt, "filt", torch.bool, ndim=2)
    expect(keys, "keys", torch.int64)
    if filt.shape[0] != 128:
        raise ValueError(f"filt: expected 128 rows, got {tuple(filt.shape)}")
    _check_slots(filt.numel())
    if not on_card(filt, keys):
        return bloom_probe_plain(filt, keys, k_hashes)
    out = torch.empty(len(keys), dtype=torch.bool, device=keys.device)
    if len(keys) == 0:
        return out
    rc = build.library().bloom_probe(filt.data_ptr(), filt.numel(),
                                     k_hashes, keys.data_ptr(), len(keys),
                                     out.data_ptr(), stream_of(keys))
    build.check(rc, "bloom_probe")
    LAUNCHES["bloom_probe"] += 1
    return out
