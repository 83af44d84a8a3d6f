"""HBM tuner: the paper's §5 memory tuner driving the KV-pool / prefix-cache
split (the device analogue of write memory vs buffer cache), as in the
reference (``repro.runtime.hbm_tuner``).

cost(x) = ω * offload(x) + γ * recompute(x)   [page-transfers per op]

  offload'(x)   — more pool ⇒ fewer offloads. Estimated from observed
                  offload pages/op with the paper's Eq.4 shape
                  (-offload/(x ln(T/x)) with T the stream's total footprint)
                  — diminishing returns in pool size.
  recompute'(x) — more pool ⇒ smaller prefix cache ⇒ more prefill
                  recompute. Ghost-cache marginal utility, Eq.6 first term.

Newton–Raphson step + clamps reuse the port's ``core.tuner.tuner
.newton_step`` (float32, as the reference's) — the white-box machinery is
identical, only the cost sources changed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.service.governor import MemoryGovernor, MemoryPlan
from ..core.tuner.tuner import TunerConfig, newton_step
from .kvcache import PagedKVPool


@dataclass
class HBMTunerConfig:
    omega: float = 1.0          # offload weight (HBM<->host bytes)
    gamma: float = 1.0          # recompute weight (prefill FLOPs as pages)
    ops_cycle: int = 2048
    min_pool_pages: int = 64


class HBMTuner:
    def __init__(self, pool: PagedKVPool, cfg: HBMTunerConfig | None = None):
        self.pool = pool
        self.cfg = cfg or HBMTunerConfig()
        self._last = dict(pool.stats)
        self.hist_x: list = []
        self.hist_cp: list = []
        self.records: list = []
        base = TunerConfig()
        self.ncfg = TunerConfig(
            omega=self.cfg.omega, gamma=self.cfg.gamma,
            fixed_step_frac=base.fixed_step_frac,
            max_shrink_frac=base.max_shrink_frac,
            min_step_bytes=8,                 # pages, not bytes, here
            min_rel_gain=0.0,
            min_write_mem=self.cfg.min_pool_pages)

    def maybe_tune(self) -> dict | None:
        delta_ops = self.pool.stats["ops"] - self._last["ops"]
        if delta_ops < self.cfg.ops_cycle:
            return None
        return self.tune_now()

    def tune_now(self) -> dict:
        p, st = self.pool, self.pool.stats
        d = {k: st[k] - self._last[k] for k in st}
        ops = max(1, d["ops"])
        x = float(p.cfg.pool_pages)
        total = float(p.cfg.total_pages)
        # offload'(x): Eq.4 shape — footprint T = live + offloaded pages
        offload_per_op = d["offload_pages"] / ops
        footprint = max(sum(len(s.pages) + s.offloaded
                            for s in p.streams.values()), x + 1)
        off_prime = -offload_per_op / (x * np.log(max(footprint / x,
                                                      np.e)))
        # recompute'(x): ghost-cache marginal utility of the prefix cache
        saved_q, _ = p.ghost.take_counters()
        rec_prime = (saved_q / ops) / max(p.cfg.sim_pages, 1)
        cp = self.cfg.omega * off_prime + self.cfg.gamma * rec_prime
        self.hist_x.append(x)
        self.hist_cp.append(cp)
        x_next = newton_step(self.hist_x[-3:], self.hist_cp[-3:], x, cp,
                             total, 0.0, self.ncfg)
        rec = {"x": x, "cost_prime": cp, "offload_prime": off_prime,
               "recompute_prime": rec_prime, "x_next": x_next,
               "offload_per_op": offload_per_op,
               "miss_rate": d["prefix_misses"] / max(1, d["prefix_misses"]
                                                     + d["prefix_hits"])}
        self.records.append(rec)
        if int(x_next) != int(x):
            p.set_pool_pages(int(x_next))
        self._last = dict(st)
        return rec


class HBMGovernor(MemoryGovernor):
    """The HBM split behind the storage-service governor interface: the
    same ``observe() -> MemoryPlan`` contract the LSM ``StorageService``
    uses, driving the KV-pool / prefix-cache boundary instead of write
    memory / buffer cache. Serving loops call ``observe`` per decode step
    (see ``repro_torch.runtime.serving.greedy_generate``).

    ``device_pool_bytes`` optionally rides along: an HBM governor that
    also owns a store's fused-read page pool emits the budget through the
    plan's ``device_pool_bytes`` field -- the exact actuation path
    ``StorageService._apply_plan`` already runs for the serving split."""

    def __init__(self, pool: PagedKVPool, cfg: HBMTunerConfig | None = None,
                 *, device_pool_bytes: int | None = None):
        self.tuner = HBMTuner(pool, cfg)
        self.device_pool_bytes = device_pool_bytes

    @property
    def records(self):
        return self.tuner.records

    def observe(self, service=None) -> MemoryPlan | None:
        rec = self.tuner.maybe_tune()
        if rec is None:
            return None
        # The tuner actuates set_pool_pages itself; the plan only reports
        # the decision. write_memory_bytes stays None -- the quantity here
        # is POOL PAGES, and populating the byte field would make a
        # StorageService mis-actuate it as an LSM write-memory size.
        return MemoryPlan(device_pool_bytes=self.device_pool_bytes,
                          note=f"hbm-pool-pages:{int(rec['x_next'])}")
