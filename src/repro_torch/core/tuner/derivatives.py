"""Memory-tuner cost derivatives (§5.2, §5.3), as the reference's
``repro.core.tuner.derivatives``.

All estimators work from runtime statistics collected over one tuning cycle;
no workload knowledge is required (the paper's "white-box" property).

write'(x):  Eq. 4/5 —
    write'_i(x) = - merge_i(x) / (x * ln(|L_Ni| / (a_i x)))
                  * flush_mem_i / (flush_mem_i + flush_log_i)

read'(x):   Eq. 6 —
    read'(x) = (saved_q + saved_m)/sim + write'(x) * read_m(x)/merge(x)

The reference jits these in float32 on the CPU, and its cost'(x) decides
the next write-memory size, so the port reproduces XLA:CPU's arithmetic
bit for bit (``f32``: its ``log``, its fused multiply-adds and the order
of its sum) instead of calling ``torch.log``. They run on the host in
numpy float32 whatever device the store uses: the inputs are K floats
once per tuning cycle, so a kernel launch and a synchronisation would buy
nothing, and the device's ``logf`` would be one more rounding to match.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .f32 import WRITE_DERIVATIVE_PLANS, F32, dot_sum32, f32, log32

_E = F32(np.e)
_TINY = F32(1e-30)


@dataclass
class TunerStats:
    """Statistics from one tuning cycle (Table 2 of the paper).

    Per-tree arrays (length K): merge_pages_per_op, last_level_bytes, alloc
    (a_i), flush_mem_bytes, flush_log_bytes. Scalars: x (write memory),
    sim_bytes, saved_q/saved_m (pages/op from the ghost cache), read_m
    (merge disk reads per op), merge (merge disk writes per op, all trees).
    """

    x: float
    merge_pages_per_op: np.ndarray
    last_level_bytes: np.ndarray
    alloc: np.ndarray
    flush_mem_bytes: np.ndarray
    flush_log_bytes: np.ndarray
    sim_bytes: float
    saved_q_per_op: float
    saved_m_per_op: float
    read_m_per_op: float
    merge_per_op: float


def write_derivative(x, merge_pages_per_op, last_level_bytes, alloc,
                     flush_mem_bytes, flush_log_bytes) -> np.float32:
    """Equations 4+5 (pages/op per byte of write memory; negative)."""
    with np.errstate(all="ignore"):
        x = f32(x)
        merge = f32(np.ravel(merge_pages_per_op))
        lN = f32(np.ravel(last_level_bytes))
        a = f32(np.ravel(alloc))
        fm = f32(np.ravel(flush_mem_bytes))
        fl = f32(np.ravel(flush_log_bytes))
        # ln(|L_N| / (a*x)); the paper assumes a*x < |L_N|. Clamp to keep
        # the estimate sane when a tree is still tiny.
        ratio = np.maximum(lN / np.maximum(a * x, F32(1)), _E)
        flushed = fm + fl
        scale = np.where(flushed > 0, fm / np.maximum(flushed, _TINY),
                         F32(1)).astype(F32)
        per_tree = (-merge) / (x * log32(ratio))
        # XLA fuses the ``* scale`` into the sum's multiply-adds.
        return dot_sum32(per_tree, scale, WRITE_DERIVATIVE_PLANS)


def read_derivative(write_prime, saved_q_per_op, saved_m_per_op, sim_bytes,
                    read_m_per_op, merge_per_op) -> np.float32:
    """Equation 6 (pages/op per byte of write memory)."""
    with np.errstate(all="ignore"):
        saved = f32(saved_q_per_op) + f32(saved_m_per_op)
        ghost_term = saved / np.maximum(f32(sim_bytes), F32(1))
        merge = f32(merge_per_op)
        merge_term = (f32(write_prime) * f32(read_m_per_op)
                      / np.maximum(merge, _TINY)) if merge > 0 else F32(0)
        return F32(ghost_term + merge_term)


def cost_derivative(stats: TunerStats, omega: float = 1.0,
                    gamma: float = 1.0) -> tuple:
    """cost'(x) = ω·write'(x) + γ·read'(x). Returns (cost', write', read').

    The reference combines its two jitted results with eager float32 ops,
    each rounded on its own (no fusion)."""
    wp = write_derivative(stats.x, stats.merge_pages_per_op,
                          stats.last_level_bytes, stats.alloc,
                          stats.flush_mem_bytes, stats.flush_log_bytes)
    rp = read_derivative(wp, stats.saved_q_per_op, stats.saved_m_per_op,
                         stats.sim_bytes, stats.read_m_per_op,
                         stats.merge_per_op)
    with np.errstate(all="ignore"):
        cp = F32(F32(f32(omega) * wp) + F32(f32(gamma) * rp))
    return (float(cp), float(wp), float(rp))
