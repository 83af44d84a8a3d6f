"""K2 and K5: Bloom filter build and probe (``csrc/bloom.cu``).

A filter is a bool tensor ``[128, n_slots // 128]``; slot s is element
``s`` of its flat view. Slot j of a key is ``(h1 + j * h2) mod n_slots``
with ``h1 = key32 * C1 mod n_slots`` and ``h2 = (key32 * C2 | 1) mod
n_slots``: ``key32`` is the key truncated to int32, the products wrap in
int32 and ``mod`` is floor-mod, exactly as the host reference
(``core.engine.numpy_backend._bloom_slots``) computes them.

``bloom_build``, ``bloom_probe`` and ``bloom_probe_tier`` are the
wrappers: on CUDA tensors they launch the kernels, on CPU tensors they
run the plain versions beside them. ``bloom_build`` picks its kernel's
path by the filter's size inside the C entry point. ``bloom_probe_tier``
probes each key against its own table's filter among a tier's filters
in one launch; it counts as a ``bloom_probe`` launch (one kernel, two
entry points).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import build
from .._launch import count, expect, on_card, stream_of

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


def bloom_probe_tier_plain(filts, keys, tidx, k_hashes: int):
    """Each key against filter ``filts[tidx[i]]``, over the filters
    concatenated flat with a per-key slot count and offset."""
    if not filts:
        return torch.zeros(len(keys), dtype=torch.bool, device=keys.device)
    ns = torch.tensor([f.numel() for f in filts], dtype=torch.int64,
                      device=keys.device)
    off = torch.cumsum(ns, 0) - ns
    slots = bloom_slots_plain(keys, ns[tidx], k_hashes) + off[tidx][:, None]
    return torch.cat([f.reshape(-1) for f in filts])[slots].all(dim=-1)


def _check_slots(n_slots: int) -> None:
    if n_slots <= 0 or n_slots % 128 or n_slots >= 2**31:
        raise ValueError(f"n_slots must be a positive multiple of 128 below "
                         f"2**31, got {n_slots}")


def _check_filter(filt, name: str = "filt") -> int:
    """Raise unless ``filt`` is a contiguous bool ``[128, W]`` filter;
    returns its slot count."""
    if filt.dtype != torch.bool or filt.dim() != 2 \
            or filt.shape[0] != 128 or not filt.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous bool [128, W] "
                         f"filter, got {filt.dtype} of shape "
                         f"{tuple(filt.shape)}")
    n = filt.numel()
    _check_slots(n)
    return n


def tier_table(filts) -> list:
    """What ``bloom_probe_tier`` hands its kernel, flattened: the
    filters' addresses, then their slot counts (int64 ``[2, T]``). Reads
    each filter once and checks that it is a contiguous bool ``[128, W]``
    filter on the first one's device (a staged read passes hundreds)."""
    if not filts:
        return []
    dev = filts[0].device
    ptrs, ns = [], []
    for f in filts:
        s = f.shape                    # one read of each attribute
        if f.dtype is not torch.bool or len(s) != 2 or s[0] != 128 \
                or not 0 < 128 * s[1] < 2**31 or not f.is_contiguous() \
                or f.device != dev:
            i = next(i for i, g in enumerate(filts) if g is f)
            _check_filter(f, f"filts[{i}]")
            raise ValueError(f"filts[{i}] lies on {f.device}, filts[0] on "
                             f"{dev}")
        ptrs.append(f.data_ptr())
        ns.append(128 * s[1])
    return ptrs + ns


def bloom_build(keys, n_slots: int, k_hashes: int):
    """Filter over int64 ``keys``: bool ``[128, n_slots // 128]``."""
    expect(keys, "keys", torch.int64)
    _check_slots(n_slots)
    if not on_card(keys):
        return bloom_build_plain(keys, n_slots, k_hashes)
    # Both of the kernel's paths write every byte of the filter.
    filt = torch.empty((128, n_slots // 128), dtype=torch.bool,
                       device=keys.device)
    rc = build.library().bloom_build(keys.data_ptr(), len(keys), n_slots,
                                     k_hashes, filt.data_ptr(),
                                     stream_of(keys))
    build.check(rc, "bloom_build")
    count("bloom_build")
    return filt


def bloom_probe(filt, keys, k_hashes: int):
    """Membership of int64 ``keys`` in ``filt`` (bool ``[128, W]``): True
    where all ``k_hashes`` slots are set."""
    n_slots = _check_filter(filt)
    expect(keys, "keys", torch.int64)
    if not on_card(filt, keys):
        return bloom_probe_plain(filt, keys, k_hashes)
    out = torch.empty(len(keys), dtype=torch.bool, device=keys.device)
    if len(keys) == 0:
        return out
    rc = build.library().bloom_probe(filt.data_ptr(), n_slots, k_hashes,
                                     keys.data_ptr(), len(keys),
                                     out.data_ptr(), stream_of(keys))
    build.check(rc, "bloom_probe")
    count("bloom_probe")
    return out


def bloom_probe_tier(filts, keys, tidx, k_hashes: int):
    """Membership of each int64 key ``keys[i]`` in filter
    ``filts[tidx[i]]`` (a sequence of bool ``[128, W]`` filters, W per
    filter; ``tidx`` int64 in ``[0, len(filts))``), on the filters'
    device.

    With the filters on the card, ``keys`` and ``tidx`` lie there too or
    both on the host: host ones go to the card in one copy together with
    the filters' addresses and slot counts (``tier_table``), as the
    staged read path hands them over; else the table goes alone."""
    expect(keys, "keys", torch.int64)
    expect(tidx, "tidx", torch.int64)
    n = len(keys)
    if n != len(tidx):
        raise ValueError(f"keys has {n} queries, tidx {len(tidx)}")
    if not filts:
        if n:
            raise ValueError("keys to probe but no filters")
        return torch.zeros(0, dtype=torch.bool, device=keys.device)
    table = tier_table(filts)
    host = keys.device.type == "cpu" and tidx.device.type == "cpu"
    if not on_card(filts[0], *(() if host else (keys, tidx))):
        return bloom_probe_tier_plain(filts, keys, tidx, k_hashes)
    dev = filts[0].device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    t = len(table)
    tab = torch.from_numpy(np.array(table, np.int64))
    if host:
        packed = torch.cat([tab, keys, tidx]).to(dev)
        tab, keys, tidx = packed[:t], packed[t:t + n], packed[t + n:]
    else:
        tab = tab.to(dev)
    rc = build.library().bloom_probe_tier(tab.data_ptr(), len(filts),
                                          k_hashes, keys.data_ptr(),
                                          tidx.data_ptr(), n,
                                          out.data_ptr(), stream_of(out))
    build.check(rc, "bloom_probe_tier")
    count("bloom_probe")
    return out
