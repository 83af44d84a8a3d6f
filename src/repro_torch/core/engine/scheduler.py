"""Cross-tree maintenance scheduler: the single owner of flush/merge work.

The paper's architecture (§3-§4) requires flushes and merges to be
arbitrated *across* all LSM-trees sharing the write memory, not run inline
by whichever tree happened to receive a write. ``MaintenanceScheduler``
replaces the store's per-write inline enforcement: the write path only
appends to memory components and then calls ``tick()``, and every flush or
merge anywhere in the store flows through this class.

A tick runs five phases, each of which is also exposed as a *resumable
tick segment* (``run_segment``) so a ``MaintenancePacer`` can interleave
maintenance with foreground write batches instead of stopping the world:

  1. **Memory-component upkeep** (segment ``"upkeep"``) -- structures that
     do write-path-adjacent work (Accordion's seal + pipeline merges,
     which can set ``request_flush`` when a data merge's transient peak
     blows the budget) run their ``upkeep_step`` units, and static-scheme
     LRU dataset evictions queued by the write path are flushed.
  2. **Memory enforcement** (segment ``"mem"``, mandatory) -- while the
     shared write memory exceeds its threshold, pick a flush victim by
     the configured §4.2 flush policy (max-memory / min-LSN /
     write-rate-proportional OPT) and flush it. Runs to completion: the
     memory bound is a correctness invariant, not discretionary work.
  3. **Log enforcement** (segment ``"log"``, mandatory) -- while the log
     exceeds its cap, flush the tree holding the minimum LSN
     (log-triggered flushes facilitate truncation, §4.1.1).
  4. **Merge pass** (segment ``"merge"``, discretionary, budgeted) --
     rank all trees by their ``merge_debt`` (pending memory merges + L0
     groups over target + over-full levels + L1 drains) and execute up to
     ``merge_budget`` maintenance steps, always against the tree with the
     largest debt. Unspent debt carries to the next tick
     (``carried_debt``), modelling bounded background-merge bandwidth;
     ``merge_budget=None`` (default) drains all debt. A bounded merge
     segment is a *slice*: repeated slices serve exactly the same
     largest-debt-first step sequence a single draining pass would
     (maintenance of one tree never changes another tree's debt), which
     is what makes paced schedules bit-identical to stop-the-world ones
     once the debt is drained.
  5. **WAL enforcement** (segment ``"wal"``) -- the durable twin of
     phase 3: physically truncate the write-ahead log below the
     arena-global min-LSN (the bytes the min-LSN flushes just made dead),
     taking a durable checkpoint first whenever the watermark would pass
     the last checkpoint (or the ``checkpoint_interval_bytes`` knob
     demands one), so the retained tail always suffices for bit-identical
     replay. After every tick ``wal.tail_bytes == store.log_length``.

Every tick -- and every individually-run segment -- is WAL-logged as a
``TickRecord`` *before* its phases run (write-ahead): ticks and segments
are pure functions of store state, so recovery re-runs them at the
original trigger points and a crash mid-segment redoes the whole segment
from its logged start. A one-shot ``tick()`` logs ONE record with
``segment="full"``; a paced schedule logs one record per segment, so any
interleaving of segments and write batches replays deterministically.

The scheduler holds no tree state of its own -- it reads candidates from
the store each phase -- so ticks are a pure function of store state, which
the differential test suite exploits: any interleaving of writes producing
the same memory-component state followed by the same tick-segment sequence
yields bit-identical trees.
"""
from __future__ import annotations

from dataclasses import dataclass

_INF = 2**62
_UNSET = object()      # tick(): "no override" vs an explicit None (=drain)

# Resumable tick segments, in the canonical (one-shot tick) order.
SEGMENTS = ("upkeep", "mem", "log", "merge", "wal")


def _budget_tag(merge_budget):
    """WAL encoding of a tick's merge-budget override."""
    if merge_budget is _UNSET:
        return "default"
    if merge_budget is None:
        return "drain"
    return int(merge_budget)


def enforce_wal(arena, scheduler) -> None:
    """Phase 5 (shared by both schedulers): checkpoint if the min-LSN
    watermark passed the last checkpoint (or the interval knob fired),
    then truncate through the one shared path
    (``durability.checkpoint.truncate_below_min_lsn``)."""
    from ..durability.checkpoint import (global_min_lsn, take_checkpoint,
                                         truncate_below_min_lsn)
    wal, man, cfg = arena.wal, arena.manifest, arena.cfg
    trunc = global_min_lsn(arena)
    need = trunc > man.checkpoint_watermark
    interval = cfg.checkpoint_interval_bytes
    if interval is not None:
        need = need or wal.head_lsn - man.checkpoint_watermark >= interval
    if need:
        # Replay determinism: a tick re-run during recovery sees exactly
        # the state the original saw, and the original did not checkpoint
        # here (the restored checkpoint is the latest one).
        assert not wal.replaying, \
            "checkpoint triggered during WAL replay (determinism bug)"
        take_checkpoint(arena, scheduler)
    truncate_below_min_lsn(arena)


@dataclass
class TickReport:
    """What one scheduler tick (or tick segment) did."""

    flushes: int = 0          # flush events executed (mem- or log-triggered)
    upkeep_steps: int = 0     # memory-component upkeep units
    merge_steps: int = 0      # discretionary maintenance units
    carried_debt: int = 0     # debt left unserved by the merge budget


def rank_flush_victim(cands, policy):
    """§4.2 flush-victim ranking over ``(store, tree)`` candidates whose
    memory components are non-empty. The stores may all be one store
    (single-store scheduler) or the shards of one arena (global
    scheduler): the ranking is the same either way, which is what makes a
    one-shard deployment bit-identical to a bare ``LSMStore``.

    Returns the chosen ``(store, tree)`` pair, or None if no candidates.
    """
    if not cands:
        return None
    if policy == "mem":
        return max(cands, key=lambda st: st[1].mem_bytes)
    if policy == "lsn":
        return min(cands, key=lambda st: st[1].min_lsn)
    # opt: flush the tree whose memory ratio most exceeds its optimal
    # write-rate-proportional ratio a_i_opt = r_i / sum_j r_j.
    rates = [sum(b for _, b in s._rate_win[t.name]) for s, t in cands]
    total_rate = sum(rates)
    used = [t.mem_bytes for _, t in cands]
    total_used = sum(used)
    if total_rate == 0 or total_used == 0:
        return min(cands, key=lambda st: st[1].min_lsn)
    best, best_gap = None, None
    for st, r, u in zip(cands, rates, used):
        gap = u / total_used - r / total_rate
        if best_gap is None or gap > best_gap:
            best, best_gap = st, gap
    return best


class SegmentedScheduler:
    """Shared tick/segment machinery of both schedulers.

    Subclasses provide the five phase implementations (``_mem_upkeep`` /
    ``_flush_pending`` / ``_enforce_memory`` / ``_enforce_log`` /
    ``_run_merges``) plus ``_arena``; this base turns them into the
    one-shot ``tick()`` and the resumable ``run_segment()`` -- both
    WAL-logged write-ahead, so a one-shot tick and any interleaved segment
    schedule are equally replay-deterministic.
    """

    merge_budget: int | None

    def _init_counters(self, merge_budget: int | None) -> None:
        self.merge_budget = merge_budget
        self.ticks = 0          # one-shot (full) ticks executed
        self.segments = 0       # individually-run tick segments executed
        self.carried_debt = 0

    def run_segment(self, name: str, *, merge_budget=_UNSET) -> TickReport:
        """Run ONE tick segment. ``merge_budget`` applies to the
        ``"merge"`` segment only (same override contract as ``tick``: an
        explicit ``None`` drains all debt). Each segment is logged
        write-ahead as its own ``TickRecord``, so any interleaving of
        segments with write batches replays deterministically."""
        if name not in SEGMENTS:
            raise ValueError(f"unknown tick segment {name!r}; "
                             f"expected one of {SEGMENTS}")
        arena = self._arena()
        arena.wal.append_tick(
            _budget_tag(merge_budget) if name == "merge" else "default",
            segment=name)
        self.segments += 1
        rep = TickReport()
        if name == "upkeep":
            rep.upkeep_steps = self._mem_upkeep()
            rep.flushes = self._flush_pending()
        elif name == "mem":
            rep.flushes = self._enforce_memory()
        elif name == "log":
            rep.flushes = self._enforce_log()
        elif name == "merge":
            budget = self.merge_budget if merge_budget is _UNSET \
                else merge_budget
            rep.merge_steps = self._run_merges(budget)
        else:                                     # "wal"
            enforce_wal(arena, self)
        rep.carried_debt = self.carried_debt
        # Commit point: the segment's TickRecord (and any still-pending
        # writes) reach stable storage under the configured fsync policy.
        arena.wal.commit()
        return rep

    # -- background prepare (engine/workers.py) -------------------------------
    def _merge_candidates(self):
        """``(debt, store, tree)`` triples with positive merge debt --
        the prefetcher's ranking input (subclasses provide it)."""
        raise NotImplementedError

    def prefetch_merges(self, limit: int | None = None) -> int:
        """Speculatively submit the next merge computations to the
        arena's worker pool, largest debt first (up to ``limit`` jobs,
        default one per worker). Entirely side-effect-free with respect
        to store state: prepares are pure and consumed only when the
        apply step derives the identical input key, so replay -- which
        never prefetches -- recomputes inline bit-identically. Returns
        the number of jobs submitted (0 with workers off)."""
        pool = getattr(self._arena(), "workers", None)
        if pool is None or not pool.enabled:
            return 0
        if limit is None:
            limit = pool.workers
        n = 0
        for _, s, t in sorted(self._merge_candidates(),
                              key=lambda c: -c[0]):
            pv = t.preview_merge(s._tree_share(t))
            if pv is None:
                continue
            key, runs = pv
            if pool.submit(key, lambda b=t.backend, r=runs: b.merge_runs(r)):
                n += 1
            if n >= limit:
                break
        return n

    def tick(self, *, merge_budget=_UNSET) -> TickReport:
        """One stop-the-world maintenance round: all five segments in
        canonical order under ONE ``TickRecord``. ``merge_budget``
        overrides the scheduler's default for this tick only; pass an
        explicit ``None`` to drain all debt regardless of the default."""
        arena = self._arena()
        arena.wal.append_tick(_budget_tag(merge_budget), segment="full")
        self.ticks += 1
        rep = TickReport()
        rep.upkeep_steps = self._mem_upkeep()
        rep.flushes += self._flush_pending()
        rep.flushes += self._enforce_memory()
        rep.flushes += self._enforce_log()
        budget = self.merge_budget if merge_budget is _UNSET else merge_budget
        rep.merge_steps = self._run_merges(budget)
        rep.carried_debt = self.carried_debt
        enforce_wal(arena, self)
        arena.wal.commit()        # commit point (see run_segment)
        return rep


class MaintenanceScheduler(SegmentedScheduler):
    """Arbitrates flush/merge work across every tree of one ``LSMStore``."""

    def __init__(self, store, *, merge_budget: int | None = None):
        self.store = store
        self._init_counters(merge_budget)

    def _arena(self):
        return self.store.arena

    # -- flush candidate ranking (§4.2) --------------------------------------
    def pick_flush_tree(self):
        """Rank non-empty trees by the configured flush policy and return
        the victim (None if all memory components are empty)."""
        s = self.store
        pick = rank_flush_victim(
            [(s, t) for t in s.trees.values() if not t.mem.is_empty()],
            s.cfg.flush_policy)
        return None if pick is None else pick[1]

    # -- flush execution ------------------------------------------------------
    def flush_tree(self, tree, *, trigger: str,
                   forced_kind: str | None = None) -> int:
        """Flush one tree. Returns bytes freed.

        Only the cheap level bookkeeping settles here; the merge work the
        flush induces (L0 merges, level merges) accrues as merge debt and
        is served by the budgeted merge pass."""
        s = self.store
        s._pre_flush_sample(tree)
        freed = tree.flush(trigger=trigger, log_pos=s.log_pos,
                           max_log_bytes=s.cfg.max_log_bytes,
                           total_write_mem=s.write_memory_bytes,
                           beta=s.cfg.beta, forced_kind=forced_kind)
        tree.levels.adjust(s._tree_share(tree))
        return freed

    def flush_dataset(self, ds: str, *, trigger: str) -> int:
        """Flush every tree of one dataset (static-scheme quota/eviction)."""
        freed = 0
        for name in self.store.datasets[ds]:
            t = self.store.trees[name]
            if not t.mem.is_empty():
                freed += self.flush_tree(t, trigger=trigger)
        return freed

    # -- tick phases ----------------------------------------------------------
    def _mem_upkeep(self) -> int:
        steps = 0
        for t in self.store.trees.values():
            while steps < 10_000 and t.mem.upkeep_step():
                steps += 1
        return steps

    def _flush_pending(self) -> int:
        flushes = 0
        while self.store._pending_evict:     # static-scheme LRU evictions
            self.flush_dataset(self.store._pending_evict.pop(0),
                               trigger="mem")
            flushes += 1
        return flushes

    def _enforce_memory(self) -> int:
        s, cfg = self.store, self.store.cfg
        flushes = 0
        if cfg.scheme.startswith("btree-static"):
            # per-dataset quota = write_mem / D; full flush at quota
            D = cfg.max_active_datasets
            quota = s.write_memory_bytes / max(1, D)
            for ds, names in s.datasets.items():
                used = sum(s.trees[n].mem_bytes for n in names)
                if used >= quota:
                    self.flush_dataset(ds, trigger="mem")
                    flushes += 1
            return flushes
        # shared-pool schemes
        budget = cfg.mem_flush_threshold * s.write_memory_bytes
        # Accordion-data: a big in-memory merge may blow the budget
        for t in s.trees.values():
            m = t.mem
            if hasattr(m, "budget_hint_bytes"):
                m.budget_hint_bytes = int(budget)
            if getattr(m, "request_flush", False):
                self.flush_tree(t, trigger="mem")
                m.request_flush = False
                flushes += 1
        guard = 0
        while s.write_memory_used() > budget and guard < 1000:
            guard += 1
            t = self.pick_flush_tree()
            if t is None:
                break
            freed = self.flush_tree(t, trigger="mem",
                                    forced_kind=cfg.forced_flush_kind)
            flushes += 1
            if freed == 0:
                break
        # Paced flush slice: below the hard threshold but above the
        # proactive one, release ONE partial flush so memory pressure is
        # paid down in slices instead of a stop-the-world burst at the
        # threshold. Pure function of store state + config (never of
        # pacer state), so the logged "mem" segment replays it.
        thr = cfg.pacer_flush_threshold
        if thr is not None and flushes == 0 \
                and s.write_memory_used() > thr * s.write_memory_bytes:
            t = self.pick_flush_tree()
            if t is not None:
                self.flush_tree(t, trigger="mem",
                                forced_kind=cfg.forced_flush_kind)
                flushes += 1
                s.disk.stats.flush_slices += 1
        return flushes

    def _enforce_log(self) -> int:
        s, cfg = self.store, self.store.cfg
        flushes = 0
        guard = 0
        while s.log_length > cfg.mem_flush_threshold * cfg.max_log_bytes \
                and guard < 1000:
            guard += 1
            if s.min_lsn() >= _INF:
                break
            tree = min((t for t in s.trees.values()
                        if not t.mem.is_empty() or t.min_lsn < _INF),
                       key=lambda t: t.min_lsn, default=None)
            if tree is None or tree.mem.is_empty():
                break
            freed = self.flush_tree(tree, trigger="log",
                                    forced_kind=cfg.forced_flush_kind)
            flushes += 1
            if freed == 0:
                break
        return flushes

    def _run_merges(self, budget: int | None) -> int:
        """Serve maintenance units to the tree with the largest merge debt
        until the budget (or all debt) is exhausted.

        Debts are cached per tree and re-evaluated only for the tree just
        served: maintenance of one tree never changes another tree's
        structures or share, so the cached ranking stays exact -- and a
        sequence of bounded slices serves exactly the step sequence one
        draining pass would."""
        self.prefetch_merges()
        s = self.store
        steps = 0
        debts = {t.name: t.merge_debt(s._tree_share(t))
                 for t in s.trees.values()}
        guard = 0
        while guard < 20_000 and (budget is None or steps < budget):
            guard += 1
            name = max(debts, key=debts.__getitem__, default=None)
            if name is None or debts[name] <= 0:
                break
            t = s.trees[name]
            if t.maintenance_step(s._tree_share(t)):
                steps += 1
                debts[name] = t.merge_debt(s._tree_share(t))
            else:
                # debt signal was stale (e.g. cleared by levels.adjust)
                debts[name] = 0
        self.carried_debt = sum(debts.values())
        return steps

    def _merge_candidates(self):
        s = self.store
        out = []
        for t in s.trees.values():
            d = t.merge_debt(s._tree_share(t))
            if d > 0:
                out.append((d, s, t))
        return out


class ShardedMaintenanceScheduler(SegmentedScheduler):
    """Global maintenance arbiter of a sharded data plane.

    Each shard keeps its own ``MaintenanceScheduler`` (the flush/upkeep
    executor for that shard's trees), but nothing ticks them individually:
    this class runs the same tick phases *across all shards* under
    ONE write-memory budget, ONE log cap and ONE discretionary merge
    budget -- the paper's cross-tree arbitration lifted to cross-shard:

      * memory enforcement compares the arena-wide usage (every shard's
        trees) against the shared threshold and picks flush victims by
        the §4.2 policy ranked over all (shard, tree) pairs;
      * log enforcement flushes the globally minimal-LSN tree, since all
        shards append to the arena's single transaction log;
      * the merge pass serves ``merge_budget`` maintenance units to the
        (shard, tree) with the largest merge debt, wherever it lives --
        a hot shard therefore drains the whole store's merge bandwidth,
        which is exactly the backpressure the service's per-shard
        admission gate then surfaces as ``Deferred`` on that shard only.

    With one shard every phase degenerates to ``MaintenanceScheduler``'s
    behavior bit-for-bit (the differential suite enforces this).
    """

    def __init__(self, stores, arena, *, merge_budget: int | None = None):
        self.stores = list(stores)
        self.arena = arena
        self._init_counters(merge_budget)

    def _arena(self):
        return self.arena

    # -- global aggregates ----------------------------------------------------
    def _used(self) -> int:
        return sum(s.write_memory_used() for s in self.stores)

    def _min_lsn(self) -> int:
        return min((s.min_lsn() for s in self.stores), default=_INF)

    def _log_length(self) -> int:
        m = self._min_lsn()
        lp = self.arena.log_pos
        return lp - (m if m < _INF else lp)

    def pick_flush_victim(self):
        """Globally ranked §4.2 flush victim: (store, tree) or None."""
        return rank_flush_victim(
            [(s, t) for s in self.stores for t in s.trees.values()
             if not t.mem.is_empty()],
            self.arena.cfg.flush_policy)

    # -- tick phases (global twins of MaintenanceScheduler's) -----------------
    def _mem_upkeep(self) -> int:
        return sum(s.scheduler._mem_upkeep() for s in self.stores)

    def _flush_pending(self) -> int:
        flushes = 0
        for s in self.stores:
            while s._pending_evict:          # static-scheme LRU evictions
                s.scheduler.flush_dataset(s._pending_evict.pop(0),
                                          trigger="mem")
                flushes += 1
        return flushes

    def _enforce_memory(self) -> int:
        cfg = self.arena.cfg
        flushes = 0
        if cfg.scheme.startswith("btree-static"):
            # per-dataset quota against the *global* write memory: a
            # dataset's usage is summed over its per-shard slices and the
            # whole dataset flushes everywhere once it crosses quota.
            quota = self.arena.write_memory_bytes \
                / max(1, cfg.max_active_datasets)
            names: list[str] = []
            for s in self.stores:
                for ds in s.datasets:
                    if ds not in names:
                        names.append(ds)
            for ds in names:
                used = sum(s.trees[n].mem_bytes for s in self.stores
                           for n in s.datasets.get(ds, ()))
                if used >= quota:
                    for s in self.stores:
                        if ds in s.datasets:
                            s.scheduler.flush_dataset(ds, trigger="mem")
                    flushes += 1
            return flushes
        # shared-pool schemes
        budget = cfg.mem_flush_threshold * self.arena.write_memory_bytes
        for s in self.stores:
            for t in s.trees.values():
                m = t.mem
                if hasattr(m, "budget_hint_bytes"):
                    m.budget_hint_bytes = int(budget)
                if getattr(m, "request_flush", False):
                    s.scheduler.flush_tree(t, trigger="mem")
                    m.request_flush = False
                    flushes += 1
        guard = 0
        while self._used() > budget and guard < 1000:
            guard += 1
            pick = self.pick_flush_victim()
            if pick is None:
                break
            s, t = pick
            freed = s.scheduler.flush_tree(
                t, trigger="mem", forced_kind=cfg.forced_flush_kind)
            flushes += 1
            if freed == 0:
                break
        # Paced flush slice (global twin; see MaintenanceScheduler).
        thr = cfg.pacer_flush_threshold
        if thr is not None and flushes == 0 \
                and self._used() > thr * self.arena.write_memory_bytes:
            pick = self.pick_flush_victim()
            if pick is not None:
                s, t = pick
                s.scheduler.flush_tree(t, trigger="mem",
                                       forced_kind=cfg.forced_flush_kind)
                flushes += 1
                self.arena.disk.stats.flush_slices += 1
        return flushes

    def _enforce_log(self) -> int:
        cfg = self.arena.cfg
        flushes = 0
        guard = 0
        while self._log_length() > cfg.mem_flush_threshold * cfg.max_log_bytes \
                and guard < 1000:
            guard += 1
            if self._min_lsn() >= _INF:
                break
            pick = min(((s, t) for s in self.stores
                        for t in s.trees.values()
                        if not t.mem.is_empty() or t.min_lsn < _INF),
                       key=lambda st: st[1].min_lsn, default=None)
            if pick is None or pick[1].mem.is_empty():
                break
            freed = pick[0].scheduler.flush_tree(
                pick[1], trigger="log", forced_kind=cfg.forced_flush_kind)
            flushes += 1
            if freed == 0:
                break
        return flushes

    def _run_merges(self, budget: int | None) -> int:
        """Largest-debt-first allocation of maintenance units across every
        (shard, tree); unspent debt carries to the next tick."""
        self.prefetch_merges()
        steps = 0
        owners: dict = {}
        debts: dict = {}
        for si, s in enumerate(self.stores):
            for t in s.trees.values():
                k = (si, t.name)
                owners[k] = (s, t)
                debts[k] = t.merge_debt(s._tree_share(t))
        guard = 0
        while guard < 20_000 and (budget is None or steps < budget):
            guard += 1
            k = max(debts, key=debts.__getitem__, default=None)
            if k is None or debts[k] <= 0:
                break
            s, t = owners[k]
            if t.maintenance_step(s._tree_share(t)):
                steps += 1
                debts[k] = t.merge_debt(s._tree_share(t))
            else:
                debts[k] = 0
        self.carried_debt = sum(debts.values())
        return steps

    def _merge_candidates(self):
        out = []
        for s in self.stores:
            for t in s.trees.values():
                d = t.merge_debt(s._tree_share(t))
                if d > 0:
                    out.append((d, s, t))
        return out
