"""Unified HBM arbiter: ONE device-byte budget leased across the read and
serving planes (the paper's §5 tuner logic re-targeted at device memory),
as the reference's ``repro.runtime.hbm_arbiter``.

The read path and the serving runtime each carved a private,
independently-governed HBM region -- the lookup-side ``DevicePagePool``
and the serving-side ``PagedKVPool`` (KV pool + prefix cache). That is
exactly the memory wall the paper breaks down between write memory and
the buffer cache: when the workload flips read-heavy -> serving-heavy,
bytes idle on one side while the other thrashes. The arbiter owns the
TOTAL budget and leases it:

    leases = {"device": B_d, "kv": B_k, "prefix": B_p},  B_d+B_k+B_p = B

Every ``ops_cycle`` operations it measures each region's observed
miss pressure per op (device tier/store residency misses, KV offload
pages, prefix-cache misses) and treats marginal hit-rate gain as the
paper's diminishing-returns shape: utility'_i ~ pressure_i / lease_i.
One ``step_frac`` slice of the lowest-utility region's lease moves to the
highest-utility region -- byte-exact by construction (the shift is a
single integer subtracted from one lease and added to another).

Actuation reuses the existing single-writer paths:

    HBMArbiter.observe() --> MemoryPlan.device_pool_bytes
                               --> StorageService._apply_plan
                               --> MemoryArena.set_device_pool_bytes
                         \\-> PagedKVPool.set_regions(kv, prefix)

so the device pool's budget is still only ever written by the service's
plan actuator, and the KV pool's total footprint moves through its own
region actuator (growth mints fresh page ids, shrink drains the free
list -- never invalidating live pages).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.service.governor import MemoryGovernor, MemoryPlan
from .kvcache import PagedKVPool


@dataclass
class HBMArbiterConfig:
    total_bytes: int = 64 << 20     # the one budget all regions share
    kv_page_bytes: int = 16 << 10   # device bytes per KV/prefix page
    ops_cycle: int = 2048           # ops between lease decisions
    step_frac: float = 0.125        # slice of the TOTAL budget per shift
    min_lease_bytes: int = 1 << 20  # no region is ever starved below this
    min_pressure: int = 4           # miss events/window below this = noise
    # A device residency miss is a BATCH-level event (the whole lookup
    # batch falls back to the staged probe), while a KV offload / prefix
    # miss costs one op -- this weight puts them in the same op currency.
    device_weight: float = 64.0
    # Windows a region must stay below min_pressure before it may donate:
    # without this, a just-resident device pool reads as idle, donates,
    # misses, grabs the bytes back -- a lease thrash.
    donate_dwell: int = 2


class HBMArbiter(MemoryGovernor):
    """Marginal-utility lease arbiter over {device, kv, prefix} HBM."""

    REGIONS = ("device", "kv", "prefix")

    def __init__(self, kv_pool: PagedKVPool | None = None,
                 cfg: HBMArbiterConfig | None = None,
                 *, leases: dict | None = None):
        self.kv_pool = kv_pool
        self.cfg = cfg or HBMArbiterConfig()
        total = int(self.cfg.total_bytes)
        if leases is None:
            third = total // 3
            leases = {"device": total - 2 * third, "kv": third,
                      "prefix": third}
        assert sum(leases[r] for r in self.REGIONS) == total, \
            "initial leases must sum byte-exactly to total_bytes"
        self.leases = dict(leases)
        self._last_ops = 0
        self._last_dev: dict = {}
        self._last_kv: dict = {}
        # Consecutive calm (sub-min_pressure) windows per region; regions
        # start calm so a cold-start imbalance corrects immediately.
        self._calm = {r: self.cfg.donate_dwell for r in self.REGIONS}
        self._dev_resident = 0          # device pool's resident bytes
        self.records: list = []
        self.shift_bytes_total = 0      # sum of |shift| over all decisions

    # -- lifecycle -----------------------------------------------------------
    def attach(self, store) -> None:
        pool = store.device_pool
        self._last_dev = dict(pool.stats()) if pool is not None else {}
        if self.kv_pool is not None:
            self._last_kv = dict(self.kv_pool.stats)

    def total_leased(self) -> int:
        return sum(self.leases[r] for r in self.REGIONS)

    # -- pressure measurement ------------------------------------------------
    def _pressures(self, service) -> tuple[dict, int]:
        """Per-region miss pressure over the cycle window, plus the window's
        op count. Each pressure is a count of missed-service events: device
        residency misses, KV pages offloaded, prefix-cache misses."""
        ops = 0
        press = {r: 0.0 for r in self.REGIONS}
        if service is not None:
            pool = service.store.device_pool
            if pool is not None:
                st = pool.stats()
                prev = self._last_dev
                press["device"] = (
                    st["tier_misses"] - prev.get("tier_misses", 0)
                    + st["store_misses"] - prev.get("store_misses", 0))
                self._last_dev = dict(st)
                # The pool's proven working set: bytes currently resident.
                # Donating below this evicts pages the workload is using
                # (a guaranteed regret), so it floors device donations.
                bpp = pool.budget_bytes / max(1, st["capacity_pages"])
                self._dev_resident = int(st["resident_pages"] * bpp)
            ops += service.store.disk.stats.ops - self._last_ops
        if self.kv_pool is not None:
            st = dict(self.kv_pool.stats)
            prev = self._last_kv
            press["kv"] = st["offload_pages"] - prev.get("offload_pages", 0)
            press["prefix"] = (st["prefix_misses"]
                               - prev.get("prefix_misses", 0))
            ops += st["ops"] - prev.get("ops", 0)
            self._last_kv = st
        return press, max(1, ops)

    def _window_ops(self, service) -> int:
        ops = 0
        if service is not None:
            ops += service.store.disk.stats.ops - self._last_ops
        if self.kv_pool is not None:
            ops += (self.kv_pool.stats["ops"]
                    - self._last_kv.get("ops", 0))
        return ops

    # -- the decision --------------------------------------------------------
    def observe(self, service=None) -> MemoryPlan | None:
        if self._window_ops(service) < self.cfg.ops_cycle:
            return None
        press, ops = self._pressures(service)
        if service is not None:
            self._last_ops = service.store.disk.stats.ops
        press["device"] *= self.cfg.device_weight
        for r in self.REGIONS:
            self._calm[r] = self._calm[r] + 1 \
                if press[r] < self.cfg.min_pressure else 0
        # Marginal utility of one more byte in region i: the paper's 1/x
        # diminishing-returns shape scaled by observed miss pressure.
        util = {r: (press[r] / ops) / max(1, self.leases[r])
                for r in self.REGIONS}
        recipient = max(self.REGIONS, key=lambda r: util[r])
        # Donor: lowest utility among regions that have headroom above
        # their floor AND have dwelt calm -- a floored or
        # recently-pressured region cannot donate, but must not block the
        # shift when another idle region still has bytes to give. The
        # device floor includes its resident working set.
        floor = {r: self.cfg.min_lease_bytes for r in self.REGIONS}
        floor["device"] = max(floor["device"], self._dev_resident)
        cands = [r for r in self.REGIONS if r != recipient
                 and self.leases[r] > floor[r]
                 and self._calm[r] >= self.cfg.donate_dwell]
        donor, shift = recipient, 0
        if cands and press[recipient] >= self.cfg.min_pressure:
            donor = min(cands, key=lambda r: (util[r], -self.leases[r]))
            if util[recipient] > util[donor]:
                room = self.leases[donor] - floor[donor]
                # Fixed step relative to the TOTAL budget: a step scaled
                # by the donor's lease decays as the donor drains and
                # stalls convergence toward a large reallocation.
                shift = min(int(self.cfg.step_frac
                                * self.cfg.total_bytes), room)
        if shift > 0:
            # The conservation invariant: one integer moves between two
            # leases -- the sum cannot drift even by a byte.
            self.leases[donor] -= shift
            self.leases[recipient] += shift
            self.shift_bytes_total += shift
        rec = {"leases": dict(self.leases), "pressure": press,
               "utility": util, "donor": donor, "recipient": recipient,
               "shift_bytes": shift}
        self.records.append(rec)
        if shift == 0:
            return None
        # Self-actuate the serving regions through the KV pool's region
        # actuator; the device lease rides the MemoryPlan to the service's
        # single-writer budget path.
        if self.kv_pool is not None:
            self.kv_pool.set_regions(
                self.leases["kv"] // self.cfg.kv_page_bytes,
                self.leases["prefix"] // self.cfg.kv_page_bytes)
        return MemoryPlan(device_pool_bytes=self.leases["device"],
                          note=f"hbm-arbiter:{donor}->{recipient}"
                               f":{shift}")
