"""Analytical LSM write-cost model (§2.1, Equation 1), as the reference's
``repro.core.lsm.cost_model``.

    C = e/P + e/P * (T+1) * log_T(|L_N| / (a * Mw))        [pages/entry]

and the §4.2 optimal write-memory allocation, the Lagrange-multiplier
solution of Eq. 2:  a_i_opt = r_i / sum_j r_j.

The reference jits these in float32; the port follows XLA:CPU's float32
arithmetic on the host (``core.tuner.f32``: its ``log``, its fused
multiply-adds and its sums), so results are bit-identical.
"""
from __future__ import annotations

import numpy as np

from ..tuner.f32 import (TOTAL_WRITE_COST_PLANS, F32, dot_sum32, f32, fma32,
                         log32, sum32)


def write_cost_per_entry(entry_bytes, page_bytes, size_ratio, last_level_bytes,
                         write_mem_bytes) -> np.ndarray:
    """Equation 1. All args are scalars (or broadcastable arrays)."""
    with np.errstate(all="ignore"):
        e, P, T = f32(entry_bytes), f32(page_bytes), f32(size_ratio)
        ratio = f32(last_level_bytes) / f32(write_mem_bytes)
        n_levels = log32(np.maximum(ratio, F32(1))) / log32(T)
        eP = e / P
        return fma32(eP * (T + F32(1)), n_levels, eP)


def optimal_allocation(write_rates) -> np.ndarray:
    """§4.2: a_i_opt = r_i / sum_j r_j (0-safe)."""
    r = f32(write_rates)
    s = sum32(r)
    if s > 0:                          # no epsilon floor: subnormal rates
        return (r / s).astype(F32)     # must still normalize to 1
    return np.full(r.shape, F32(1) / F32(r.shape[0]), F32)


def total_write_cost(write_rates, entry_bytes, page_bytes, size_ratio,
                     last_level_bytes, alloc, write_mem_bytes) -> np.float32:
    """Objective of Eq. 2: sum_i (r_i / e_i) * C_i, for a given allocation."""
    with np.errstate(all="ignore"):
        r, e = f32(write_rates), f32(entry_bytes)
        c = write_cost_per_entry(e, page_bytes, size_ratio, last_level_bytes,
                                 f32(alloc) * f32(write_mem_bytes))
        a, c = np.broadcast_arrays(r / e, c)
        return dot_sum32(a, c, TOTAL_WRITE_COST_PLANS)
