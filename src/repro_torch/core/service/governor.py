"""MemoryGovernor: memory adaptation as a first-class, pluggable policy.

The service owns exactly one governor and calls ``observe(service)`` once
per submit. The governor inspects whatever state it cares about (the
store's I/O stats, the ghost cache, the log) and returns a ``MemoryPlan``
describing any reallocation it decided on -- or ``None`` when it has
nothing to say. This unifies the two adaptation mechanisms the paper
scatters across layers:

  * the §5.4 memory tuner (write memory vs buffer cache boundary) --
    ``AdaptiveGovernor``, wrapping ``AdaptiveMemoryController`` unchanged
    in behavior;
  * the §4.2 flush-policy selection -- any governor may switch the store's
    flush policy through ``MemoryPlan.flush_policy``.

``StaticGovernor`` pins a fixed allocation (the baseline schemes) and is
the service's default, as in the reference's code; ``StallGovernor`` tunes
the pacer; ``DevicePoolGovernor`` sizes the device page pool behind fused
reads; ``runtime.hbm_arbiter.HBMArbiter`` leases one device budget across
the read and serving planes.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..tuner.tuner import AdaptiveMemoryController, TunerConfig


@dataclass(frozen=True)
class MemoryPlan:
    """One adaptation decision. ``None`` fields mean "leave unchanged"."""

    write_memory_bytes: int | None = None
    flush_policy: str | None = None
    # Budget of the device page pool behind fused tier lookups; actuated
    # via MemoryArena.set_device_pool_bytes (0 disables the pool).
    device_pool_bytes: int | None = None
    # Pacing knobs (StallGovernor): actuated onto the live MaintenancePacer
    # only -- never written back to StoreConfig, so recovery re-paces from
    # the configured values, not the tuned ones.
    pacer_interval_bytes: int | None = None
    pacer_segment_budget: int | None = None
    note: str = ""


class MemoryGovernor:
    """Strategy interface: ``observe(service) -> MemoryPlan | None``.

    ``attach(store)`` is called once when the governor is handed to a
    service; governors needing per-cycle baselines snapshot them there.
    """

    def attach(self, store) -> None:
        pass

    def observe(self, service) -> MemoryPlan | None:
        raise NotImplementedError


class StaticGovernor(MemoryGovernor):
    """No adaptation: optionally pins an allocation/policy once at attach
    time, then never moves it (the static baseline schemes of §6)."""

    def __init__(self, *, write_memory_bytes: int | None = None,
                 flush_policy: str | None = None):
        self.write_memory_bytes = write_memory_bytes
        self.flush_policy = flush_policy
        self._pinned = False

    def observe(self, service) -> MemoryPlan | None:
        if self._pinned or (self.write_memory_bytes is None
                            and self.flush_policy is None):
            return None
        self._pinned = True
        return MemoryPlan(write_memory_bytes=self.write_memory_bytes,
                          flush_policy=self.flush_policy, note="static-pin")


class AdaptiveGovernor(MemoryGovernor):
    """The §5.4 memory tuner as a governor, behavior-identical to driving
    ``AdaptiveMemoryController.maybe_tune()`` per batch by hand.

    The controller is built at ``attach`` (before any operations run), so
    its tuning cycle baselines match a hand-constructed controller; its
    records stay available at ``governor.controller.tuner.records``.
    """

    def __init__(self, cfg: TunerConfig | None = None):
        self.cfg = cfg or TunerConfig()
        self.controller: AdaptiveMemoryController | None = None

    def attach(self, store) -> None:
        self.controller = AdaptiveMemoryController(store, self.cfg)

    def observe(self, service) -> MemoryPlan | None:
        if self.controller is None:             # governor used store-less
            self.attach(service.store)
        rec = self.controller.maybe_tune()
        if rec is None or rec.x_next == rec.x:
            return None
        return MemoryPlan(write_memory_bytes=int(rec.x_next),
                          note=f"tuner:{rec.stopped or 'step'}")

    @property
    def records(self):
        return self.controller.tuner.records if self.controller else []


class DevicePoolGovernor(MemoryGovernor):
    """Adaptive sizing of the fused-read device page pool from its own
    hit/miss stream, through the standard ``MemoryPlan`` actuation.

    Every ``ops_cycle`` logical store operations it takes the pool's
    hit/miss deltas (tier- and store-level acquires combined): while
    residency keeps failing (cold pool or a budget too small for the
    working tiers) the budget doubles toward ``max_bytes``; when the
    fused path is serving and the clock holds fewer pages than half the
    capacity, the slack is returned (halved, floored at ``min_bytes``).
    Decisions are emitted, not self-actuated: ``StorageService
    ._apply_plan`` -> ``MemoryArena.set_device_pool_bytes`` is the single
    writer of the budget, same as the write-memory split.

    Two stabilizers keep the doubling/halving from oscillating on
    workloads that sit near the decision boundary:

      * deadband -- act only when the cycle's miss fraction leaves
        ``[0.5 - deadband, 0.5 + deadband]``; inside the band the budget
        holds (the raw ``d_miss > d_hit`` rule flapped on ~50/50 mixes);
      * min dwell -- a direction REVERSAL (grow->shrink or shrink->grow)
        needs ``min_dwell`` CONSECUTIVE cycles wanting the opposite
        direction, so neither one anomalous cycle nor a strictly
        alternating workload can bounce the budget back and forth. Held
        reversals are recorded with ``held=True``.
    """

    def __init__(self, *, min_bytes: int = 1 << 20,
                 max_bytes: int = 256 << 20, ops_cycle: int = 2048,
                 deadband: float = 0.15, min_dwell: int = 2):
        self.min_bytes = int(min_bytes)
        self.max_bytes = int(max_bytes)
        self.ops_cycle = int(ops_cycle)
        self.deadband = float(deadband)
        self.min_dwell = int(min_dwell)
        self._last_ops = 0
        self._last: dict | None = None
        self._dir = 0               # last actuated direction (+1/-1)
        self._rev = 0               # consecutive opposite-direction wants
        self.records: list = []

    def attach(self, store) -> None:
        self._last_ops = store.disk.stats.ops
        pool = store.device_pool
        self._last = dict(pool.stats()) if pool is not None else None

    def observe(self, service) -> MemoryPlan | None:
        store = service.store
        pool = store.device_pool
        if pool is None:
            return None
        ops = store.disk.stats.ops
        if ops - self._last_ops < self.ops_cycle:
            return None
        self._last_ops = ops
        st = pool.stats()
        prev = self._last or {k: 0 for k in st}
        self._last = dict(st)
        d_hit = (st["tier_hits"] - prev.get("tier_hits", 0)
                 + st["store_hits"] - prev.get("store_hits", 0))
        d_miss = (st["tier_misses"] - prev.get("tier_misses", 0)
                  + st["store_misses"] - prev.get("store_misses", 0))
        miss_frac = d_miss / (d_hit + d_miss) if d_hit + d_miss else 0.5
        budget = pool.budget_bytes
        if miss_frac > 0.5 + self.deadband:
            want, new = 1, min(self.max_bytes,
                               max(2 * budget, self.min_bytes))
        elif miss_frac < 0.5 - self.deadband \
                and st["resident_pages"] < st["capacity_pages"] // 2:
            want, new = -1, max(self.min_bytes, budget // 2)
        else:
            self._rev = 0           # in-band: the reversal streak breaks
            return None
        held = False
        if self._dir != 0 and want != self._dir:
            self._rev += 1
            held = self._rev < self.min_dwell
        else:
            self._rev = 0
        if not held and new != budget:
            self._dir, self._rev = want, 0
        rec = {"budget": budget, "budget_next": budget if held else new,
               "tier_hits": d_hit, "tier_misses": d_miss,
               "miss_frac": miss_frac, "held": held,
               "resident_pages": st["resident_pages"]}
        if held or new == budget:
            if held:
                self.records.append(rec)
            return None
        self.records.append(rec)
        return MemoryPlan(device_pool_bytes=new,
                          note=f"device-pool:{new}")


class StallGovernor(MemoryGovernor):
    """Auto-nudges the pacer's knobs from the observed stall tail
    (``StoreConfig.pacer_autotune``).

    Every ``ops_cycle`` logical store operations it takes a window of the
    service's maintenance-stall histogram and compares the window's exact
    ``max_value`` against ``target_stall_us``:

      * **over target** -- a pass stalled too long: halve the merge slice
        (``segment_budget``) toward 1; once slices are minimal, double
        ``interval_bytes`` so slices release less often;
      * **under target** -- headroom: undo in reverse order, halving the
        interval toward its floor first (paying debt down sooner), then
        doubling the slice back up.

    Decisions are emitted as ``MemoryPlan``s and actuated by the service
    onto the LIVE pacer only -- ``StoreConfig`` stays at its configured
    values, so a recovered service re-paces from configuration, never
    from a tuned transient. The deadband + min-dwell stabilizers are the
    ``DevicePoolGovernor`` idiom: hold inside
    ``target * [1 - deadband, 1 + deadband]``, and require ``min_dwell``
    consecutive cycles wanting a direction REVERSAL before acting on it
    (held reversals are recorded with ``held=True``).
    """

    def __init__(self, *, target_stall_us: float = 2_000.0,
                 ops_cycle: int = 1024, deadband: float = 0.25,
                 min_dwell: int = 2,
                 min_interval_bytes: int = 4 << 10,
                 max_interval_bytes: int = 4 << 20,
                 min_segment_budget: int = 1,
                 max_segment_budget: int = 64):
        self.target_stall_us = float(target_stall_us)
        self.ops_cycle = int(ops_cycle)
        self.deadband = float(deadband)
        self.min_dwell = int(min_dwell)
        self.min_interval_bytes = int(min_interval_bytes)
        self.max_interval_bytes = int(max_interval_bytes)
        self.min_segment_budget = int(min_segment_budget)
        self.max_segment_budget = int(max_segment_budget)
        self._snap = None           # stall-histogram snapshot (lazy: the
        self._last_ops = 0          # service exists only at observe time)
        self._dir = 0               # last actuated direction (+1 tighten)
        self._rev = 0               # consecutive opposite-direction wants
        self.records: list = []

    def observe(self, service) -> MemoryPlan | None:
        pacer = service.pacer
        if pacer is None:
            return None
        if self._snap is None:
            self._snap = service.stall.copy()
            self._last_ops = service.store.disk.stats.ops
            return None
        ops = service.store.disk.stats.ops
        if ops - self._last_ops < self.ops_cycle:
            return None
        self._last_ops = ops
        win = service.stall.delta(self._snap)
        self._snap = service.stall.copy()
        if win.count == 0:
            return None
        sig = win.max_value
        interval, budget = pacer.interval_bytes, pacer.segment_budget
        if sig > self.target_stall_us * (1.0 + self.deadband):
            want = 1
            if budget > self.min_segment_budget:
                new_i, new_b = interval, max(self.min_segment_budget,
                                             budget // 2)
            else:
                new_i, new_b = min(self.max_interval_bytes,
                                   interval * 2), budget
        elif sig < self.target_stall_us * (1.0 - self.deadband):
            want = -1
            if interval > self.min_interval_bytes:
                new_i, new_b = max(self.min_interval_bytes,
                                   interval // 2), budget
            else:
                new_i, new_b = interval, min(self.max_segment_budget,
                                             budget * 2)
        else:
            self._rev = 0           # in-band: the reversal streak breaks
            return None
        held = False
        if self._dir != 0 and want != self._dir:
            self._rev += 1
            held = self._rev < self.min_dwell
        else:
            self._rev = 0
        changed = (new_i, new_b) != (interval, budget)
        if not held and changed:
            self._dir, self._rev = want, 0
        rec = {"stall_max_us": sig, "window": win.count,
               "interval": interval, "budget": budget,
               "interval_next": interval if held else new_i,
               "budget_next": budget if held else new_b, "held": held}
        if held or not changed:
            if held:
                self.records.append(rec)
            return None
        self.records.append(rec)
        return MemoryPlan(pacer_interval_bytes=new_i,
                          pacer_segment_budget=new_b,
                          note=f"pacer:{'tighten' if want > 0 else 'relax'}")
