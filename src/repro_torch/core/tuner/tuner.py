"""The memory tuner's numeric step (§5.4): Newton–Raphson on cost'(x) with
the paper's stability clamps, as ``repro.core.tuner.tuner.newton_step``.

The reference fits cost'(x) in float32 (jax_enable_x64 is off), so the
fit here is torch float32 too: a float64 fit would move ``x_next`` and
with it every state that follows. The rest of the tuner (derivatives,
``MemoryTuner``, the store controller) is not ported yet (ROADMAP Queue 1,
item 4).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def _fma(a, b, c):
    """``a * b + c`` as a float64 multiply-add rounded to float32. The f32
    product is exact in float64, so this equals a fused multiply-add except
    where the float64 sum's rounding lands on a float32 midpoint (double
    rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _linear_fit(xs, ys):
    """Least-squares slope A of ys ≈ A*xs + B in float32 (the step needs
    only A, so B is not computed).

    The arithmetic follows what XLA compiles the reference's fit to on the
    CPU: sums run in order from 0, a mean is the sum times
    ``float32(1 / n)``, and the multiply-adds of the centred sums are
    fused (see ``_fma``)."""
    xs = torch.as_tensor(np.asarray(xs), dtype=torch.float32)
    ys = torch.as_tensor(np.asarray(ys), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    inv_n = torch.tensor(1.0 / len(xs), dtype=torch.float32)
    sx, sy = zero, zero
    for x, y in zip(xs, ys):
        sx, sy = sx + x, sy + y
    xm, ym = sx * inv_n, sy * inv_n
    var, cov = zero, zero
    for x, y in zip(xs, ys):
        dx = x - xm
        var = _fma(dx, dx, var)
        cov = _fma(dx, y - ym, cov)
    return torch.where(var > 0, cov / torch.clamp(var, min=1e-30), zero)


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
