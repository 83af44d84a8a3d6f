"""The memory tuner (§5.4): Newton–Raphson on cost'(x) with stability
heuristics, plus the controller that wires it to an ``LSMStore`` or a
``ShardedStore``, as the reference's ``repro.core.tuner.tuner``.

The reference fits cost'(x) in float32 (jax_enable_x64 is off), so the
fit here follows XLA:CPU's float32 arithmetic too (``f32``): a float64
fit would move ``x_next`` and with it every state that follows. Like the
derivatives, it runs on the host whatever device the store uses.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from .derivatives import TunerStats, cost_derivative
from .f32 import F32, fma32

if TYPE_CHECKING:  # avoid a circular import (storage uses the ghost cache)
    from ..lsm.storage import LSMStore


@dataclass
class TunerConfig:
    omega: float = 1.0                 # write-cost weight
    gamma: float = 1.0                 # read-cost weight
    k_samples: int = 3                 # points for the linear cost'(x) fit
    fixed_step_frac: float = 0.05      # fallback step: 5% of total memory
    max_shrink_frac: float = 0.10      # max 10% shrink of either region
    min_step_bytes: int = 32 << 20     # stop: step smaller than this
    min_rel_gain: float = 0.001        # stop: expected gain < 0.1% of cost
    min_write_mem: int = 16 << 20
    ops_cycle: int = 20_000            # timer-equivalent cycle (read-heavy)


def _linear_fit(xs, ys) -> np.float32:
    """Least-squares slope A of ys ≈ A*xs + B in float32 (the step needs
    only A, so B is not computed).

    The arithmetic follows what XLA compiles the reference's fit to on the
    CPU: sums run in order from 0, a mean is the sum times
    ``float32(1 / n)``, and the multiply-adds of the centred sums are
    fused."""
    xs = np.asarray(xs, np.float64).astype(F32)
    ys = np.asarray(ys, np.float64).astype(F32)
    inv_n = F32(1.0 / len(xs))
    sx, sy = F32(0), F32(0)
    for x, y in zip(xs, ys):
        sx, sy = F32(sx + x), F32(sy + y)
    xm, ym = F32(sx * inv_n), F32(sy * inv_n)
    var, cov = F32(0), F32(0)
    for x, y in zip(xs, ys):
        dx = F32(x - xm)
        var = F32(fma32(dx, dx, var))
        cov = F32(fma32(dx, F32(y - ym), cov))
    return F32(cov / max(var, F32(1e-30))) if var > 0 else F32(0)


def newton_step(history_x, history_cp, x, cost_prime, total_mem, sim_bytes,
                cfg: TunerConfig):
    """Propose the next write-memory size (§5.4).

    Newton–Raphson on the fitted line cost'(x) = A x + B when the fit is
    usable (enough samples, A > 0 so the root is a minimum); otherwise a
    fixed 5% step against the sign of cost'(x).
    """
    total = float(total_mem)
    fixed = cfg.fixed_step_frac * total
    use_newton = False
    x_next = x
    if len(history_x) >= cfg.k_samples:
        a = float(_linear_fit(history_x[-cfg.k_samples:],
                              history_cp[-cfg.k_samples:]))
        if a > 0:                       # locally convex: root is a minimum
            x_next = x - cost_prime / a
            use_newton = True
    if not use_newton:
        x_next = x - np.sign(cost_prime) * fixed
    # §5.4 heuristic 2: never shrink a region by more than 10% of itself.
    cache = total - x - sim_bytes
    lo = x - cfg.max_shrink_frac * x                 # write memory shrink cap
    hi = x + cfg.max_shrink_frac * max(cache, 0.0)   # buffer cache shrink cap
    x_next = float(np.clip(x_next, lo, hi))
    x_next = float(np.clip(x_next, cfg.min_write_mem,
                           total - sim_bytes - cfg.min_write_mem))
    return x_next


@dataclass
class TuneRecord:
    step: int
    x: float
    cost_prime: float
    write_prime: float
    read_prime: float
    cost_per_op: float
    x_next: float
    stopped: str = ""


class MemoryTuner:
    """Feedback-control loop of Figure 5."""

    def __init__(self, cfg: TunerConfig, total_mem_bytes: int,
                 sim_bytes: int):
        self.cfg = cfg
        self.total = total_mem_bytes
        self.sim = sim_bytes
        self.hist_x: deque = deque(maxlen=16)
        self.hist_cp: deque = deque(maxlen=16)
        self.records: list[TuneRecord] = []

    def propose(self, stats: TunerStats, cost_per_op: float) -> float:
        cfg = self.cfg
        cp, wp, rp = cost_derivative(stats, cfg.omega, cfg.gamma)
        self.hist_x.append(stats.x)
        self.hist_cp.append(cp)
        x_next = newton_step(list(self.hist_x), list(self.hist_cp), stats.x,
                             cp, self.total, self.sim, cfg)
        stopped = ""
        step = x_next - stats.x
        if abs(step) < cfg.min_step_bytes:
            stopped = "step_too_small"
            x_next = stats.x
        elif cost_per_op > 0 and \
                abs(cp * step) < cfg.min_rel_gain * cost_per_op:
            stopped = "gain_too_small"
            x_next = stats.x
        self.records.append(TuneRecord(len(self.records), stats.x, cp, wp,
                                       rp, cost_per_op, x_next, stopped))
        return x_next


class AdaptiveMemoryController:
    """Wires a MemoryTuner to an LSMStore: collects per-cycle statistics,
    computes the derivatives, and actuates the write-memory size.

    Tuning triggers when the log has accumulated ``max_log_bytes`` since the
    last tuning or after ``ops_cycle`` operations (the paper's timer cycle
    for read-heavy workloads). Over a ``ShardedStore`` the per-tree arrays
    run over every (shard, tree) pair of its flat ``trees`` view.
    """

    def __init__(self, store: "LSMStore", cfg: TunerConfig | None = None):
        self.store = store
        self.cfg = cfg or TunerConfig()
        self.tuner = MemoryTuner(self.cfg, store.cfg.total_memory_bytes,
                                 store.cfg.sim_cache_bytes)
        self._cycle_start_stats = store.disk.stats.copy()
        self._cycle_start_tree = self._tree_counters()
        self._cycle_log_pos = store.log_pos

    def _tree_counters(self) -> dict:
        return {n: (t.stats.merge_pages_written, t.stats.bytes_flushed_mem,
                    t.stats.bytes_flushed_log)
                for n, t in self.store.trees.items()}

    def maybe_tune(self) -> TuneRecord | None:
        s = self.store
        ops = s.disk.stats.ops - self._cycle_start_stats.ops
        log_grown = s.log_pos - self._cycle_log_pos
        if log_grown < s.cfg.max_log_bytes and ops < self.cfg.ops_cycle:
            return None
        return self.tune_now()

    def tune_now(self) -> TuneRecord | None:
        s = self.store
        delta = s.disk.stats.delta(self._cycle_start_stats)
        ops = max(delta.ops, 1)
        names = list(s.trees)
        base = self._cycle_start_tree
        merge_pp = np.array([
            (s.trees[n].stats.merge_pages_written - base.get(n, (0, 0, 0))[0])
            / ops for n in names], np.float64)
        lN = np.array([max(s.trees[n].last_level_bytes, 1.0)
                       for n in names], np.float64)
        used = np.array([max(s.trees[n].mem_bytes, 1.0) for n in names],
                        np.float64)
        alloc = used / used.sum()
        fmem = np.array([s.trees[n].stats.bytes_flushed_mem
                         - base.get(n, (0, 0, 0))[1] for n in names],
                        np.float64)
        flog = np.array([s.trees[n].stats.bytes_flushed_log
                         - base.get(n, (0, 0, 0))[2] for n in names],
                        np.float64)
        saved_q, saved_m = s.ghost.take_counters()
        stats = TunerStats(
            x=float(s.write_memory_bytes),
            merge_pages_per_op=merge_pp,
            last_level_bytes=lN,
            alloc=alloc,
            flush_mem_bytes=fmem,
            flush_log_bytes=flog,
            sim_bytes=float(s.cfg.sim_cache_bytes),
            saved_q_per_op=saved_q / ops,
            saved_m_per_op=saved_m / ops,
            read_m_per_op=delta.pages_merge_read / ops,
            merge_per_op=delta.pages_merge_written / ops,
        )
        cost_per_op = (self.cfg.omega * delta.pages_written
                       + self.cfg.gamma * delta.pages_read) / ops
        x_next = self.tuner.propose(stats, cost_per_op)
        if x_next != s.write_memory_bytes:
            s.set_write_memory(int(x_next))
        # reset cycle
        self._cycle_start_stats = s.disk.stats.copy()
        self._cycle_start_tree = self._tree_counters()
        self._cycle_log_pos = s.log_pos
        return self.tuner.records[-1]
