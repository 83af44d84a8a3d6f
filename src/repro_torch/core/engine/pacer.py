"""Maintenance pacer: interleave tick segments with the foreground path.

A stop-the-world tick drains *all* merge debt before the next submit runs,
so a submit that lands after a burst of writes pays for every merge the
burst induced -- the classic LSM write-stall tail (Luo & Carey, "On
Performance Stability in LSM-based Storage Systems"). The pacer replaces
the one-shot tick on the service's write path with a *paced schedule*:

  * the mandatory segments (``upkeep`` -> ``mem`` -> ``log`` and the
    closing ``wal`` truncation) still run on every submit -- the memory
    and log bounds are correctness invariants, never deferred;
  * the discretionary merge pass is chopped into bounded **slices** of
    ``segment_budget`` maintenance steps each, released at a rate paced
    against the *observed write rate*: one slice per ``interval_bytes``
    of ingested payload. A write burst earns proportionally many slices
    spread over the submits that follow, instead of one monster pass;
  * slices are **flush-averse**: a pass whose mandatory segments already
    flushed has paid a write stall, so its slice is deferred (the banked
    intervals release on the next flush-free pass). Flush events and
    interval crossings are both driven by ingested bytes, so without
    this the worst-case pass stacks a flush AND a merge slice -- exactly
    the stop-the-world tail the pacer exists to remove. Deferral yields
    to backlog pressure: once ``carried_debt`` exceeds
    ``MAX_DEFER_DEBT_SLICES`` slices' worth of work, slices release on
    every pass, bounding starvation under sustained flush storms.

Between flushes the merge pass is largest-debt-first with stable ties and
maintenance of one tree never changes another tree's debt, so a run of
bounded slices serves exactly the step sequence one draining pass would:
pacing chops *when* merge steps run, never *what* a step does. Deferring
slices across later flushes can re-rank debts (that is the point -- a
burst's work spreads over the submits that follow), so a paced store is
logically equal to the stop-the-world store -- same keys, same answers,
same enforced memory/log bounds -- without being structurally
bit-identical to it. What IS bit-identical is the replay: every segment
is WAL-logged, so the paced schedule itself recovers bit-for-bit. The
deterministic-interleaving fuzzer enforces exactly these invariants.

Every segment the pacer runs is WAL-logged individually (see
``SegmentedScheduler.run_segment``), so a paced schedule replays
deterministically: recovery re-runs the logged segments at the logged
points. The pacer's own accumulator (``_pending``) is deliberately NOT
checkpointed -- pacing is a performance policy; replay follows the logged
records, so correctness never depends on pacer state, and a recovered
service simply resumes pacing from zero.

Knobs (``StoreConfig``): ``pacer_interval_bytes`` (None = pacing off,
the service ticks stop-the-world) and ``pacer_segment_budget`` (merge
steps per slice).
"""
from __future__ import annotations

from .scheduler import TickReport

# Backlog override for flush-averse deferral: once the carried merge debt
# exceeds this many slices' worth of steps, a slice is released even on a
# pass that flushed (latency shaping yields to keeping up with the debt).
MAX_DEFER_DEBT_SLICES = 4


class MaintenancePacer:
    """Releases maintenance in bounded slices paced by write rate."""

    def __init__(self, scheduler, *, segment_budget: int,
                 interval_bytes: int):
        if segment_budget <= 0:
            raise ValueError(
                f"segment_budget must be > 0, got {segment_budget}")
        if interval_bytes <= 0:
            raise ValueError(
                f"interval_bytes must be > 0, got {interval_bytes}")
        self.scheduler = scheduler
        self.segment_budget = int(segment_budget)
        self.interval_bytes = int(interval_bytes)
        self._pending = 0        # ingested bytes not yet paid for in slices
        self.slices = 0          # bounded merge slices released
        self.passes = 0          # on_submit() paced passes run
        self.deferrals = 0       # slices pushed past a pass that flushed

    def on_submit(self, wrote_bytes: int) -> TickReport:
        """One paced maintenance pass after a submit that ingested
        ``wrote_bytes`` of payload. Replaces ``scheduler.tick()`` on the
        service's write path; returns the aggregated ``TickReport``."""
        sched = self.scheduler
        self.passes += 1
        rep = TickReport()

        def add(r: TickReport) -> None:
            rep.flushes += r.flushes
            rep.upkeep_steps += r.upkeep_steps
            rep.merge_steps += r.merge_steps

        # Mandatory phases, canonical order: bounds are never deferred.
        add(sched.run_segment("upkeep"))
        add(sched.run_segment("mem"))
        add(sched.run_segment("log"))

        # Discretionary merges: one bounded slice per interval_bytes of
        # observed writes. Flush-induced debt with no further writes is
        # drained too (a slice per pass once debt exists), so an idle
        # tail still converges to the stop-the-world fixpoint. A pass
        # that flushed defers its slice (banked in _pending) unless the
        # backlog override says the debt is piling up.
        self._pending += int(wrote_bytes)
        due = (self._pending >= self.interval_bytes
               or sched.carried_debt > 0)
        defer = (due and rep.flushes > 0 and sched.carried_debt
                 <= MAX_DEFER_DEBT_SLICES * self.segment_budget)
        if defer:
            self.deferrals += 1
        elif due:
            budget = 0
            while self._pending >= self.interval_bytes:
                self._pending -= self.interval_bytes
                budget += self.segment_budget
            if budget == 0:
                budget = self.segment_budget    # idle drain of leftover debt
            r = sched.run_segment("merge", merge_budget=budget)
            add(r)
            self.slices += 1
            if r.carried_debt == 0:
                self._pending = 0       # debt drained: burst fully paid

        sched.run_segment("wal")
        # Cross-pass overlap: with background workers on, submit the next
        # merge computations now so they run while the foreground handles
        # the next write batches -- including the (flush-averse) passes
        # that release no slice. A pure hint: no store state changes and
        # nothing is WAL-logged, so paced replay is untouched.
        sched.prefetch_merges()
        rep.carried_debt = sched.carried_debt
        return rep
