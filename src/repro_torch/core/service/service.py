"""StorageService: the single typed front door over an ``LSMStore``.

The §3 architecture is one storage service mediating many LSM-trees behind
shared write memory and a buffer cache. ``StorageService`` is that front
door as an API:

  * ``submit(requests)`` plans a mixed-op batch into vectorized per-(tree,
    kind) steps -- per-(tree, shard, kind) write steps over a sharded
    store (see ``planner``) -- dispatches them through the store's batched
    backend paths (``write_batch`` / ``read_batch`` / ``scan_batch``),
    and returns per-request typed results in submission order;
  * maintenance is amortized: ONE ``MaintenanceScheduler.tick()`` per
    submit that executed writes, instead of one per write call -- or,
    with ``StoreConfig.pacer_interval_bytes`` set, a *paced* schedule
    (``engine/pacer.py``): mandatory segments every submit, merges in
    bounded slices paced against the observed write rate, every segment
    WAL-logged so interleavings replay deterministically. Submit wall
    time and maintenance stall durations stream into two
    ``LatencyHistogram``s (``service.latency`` / ``service.stall``);
  * admission control converts L0 write stalls and write-memory overload
    into explicit ``Deferred`` responses (counted in
    ``IOStats.write_stalls``) instead of silent inline stalls; per-tenant
    ``Session`` handles meter outstanding work on top;
  * memory adaptation is owned by one pluggable ``MemoryGovernor``
    observed once per submit (default: ``StaticGovernor``).

Op accounting is bit-identical to direct store calls: a plan step performs
exactly the batched call a caller would have made on the concatenated keys.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ...runtime.latency import LatencyHistogram
from ..engine.pacer import MaintenancePacer
from ..lsm.storage import LSMStore, POLICIES, StoreConfig
from .governor import MemoryGovernor, MemoryPlan, StallGovernor, \
    StaticGovernor
from .planner import PlanStep, build_plan
from .requests import (Deferred, Delete, Get, GetResult, Put, Result,
                       ScanResult, WriteAck)

_UNSET = object()


@dataclass
class ServiceConfig:
    # Master switch for engine-side backpressure (L0 stall + memory slack).
    admission: bool = True
    # Defer writes to a tree holding >= this many L0 groups (None: the
    # store's l0_max_groups -- the point a real engine stalls flushes).
    l0_stall_groups: int | None = None
    # Defer writes that would push shared write memory past
    # slack * write_memory_bytes (a hard overload bound well above the
    # mem_flush_threshold the scheduler enforces each tick).
    memory_admit_slack: float | None = 2.0   # None disables the gate
    # Safety cap for drain() catch-up ticks.
    max_drain_ticks: int = 200


@dataclass
class SessionStats:
    submitted_keys: int = 0
    executed_keys: int = 0
    deferred_keys: int = 0
    deferred_events: int = 0
    submits: int = 0


class Session:
    """Per-tenant handle metering outstanding work.

    ``max_outstanding_keys`` caps the write keys one submit may admit for
    this tenant (the admission window); excess write steps come back as
    ``Deferred("session-quota")`` without touching the engine. Obtain via
    ``StorageService.session()``; ``session.submit`` is sugar for
    ``service.submit(..., session=session)``.
    """

    def __init__(self, service: "StorageService", tenant: str, *,
                 max_outstanding_keys: int | None = None):
        self.service = service
        self.tenant = tenant
        self.max_outstanding_keys = max_outstanding_keys
        self.stats = SessionStats()
        self._window = 0          # write keys admitted in the current submit

    def _begin_submit(self) -> None:
        self._window = 0
        self.stats.submits += 1

    def _admit(self, n_keys: int) -> bool:
        if self.max_outstanding_keys is not None \
                and self._window + n_keys > self.max_outstanding_keys:
            return False
        self._window += n_keys
        return True

    def submit(self, requests, **kw) -> list[Result]:
        return self.service.submit(requests, session=self, **kw)

    def submit_all(self, requests, **kw) -> list[Result]:
        return self.service.submit_all(requests, session=self, **kw)


class StorageService:
    """Front door over one ``LSMStore`` or ``ShardedStore`` (owned or
    adopted)."""

    def __init__(self, store, *,
                 governor: MemoryGovernor | None = None,
                 config: ServiceConfig | None = None):
        self.store = store
        self.cfg = config or ServiceConfig()
        self.governor = governor or StaticGovernor()
        self.governor.attach(store)
        self.plans: list[MemoryPlan] = []        # applied governor decisions
        self.sessions: dict[str, Session] = {}
        self.submits = 0
        # Tail latency is first-class: every submit records its wall time
        # (once per request) and the duration of its inline maintenance
        # (the foreground stall). Window deltas feed the BENCH_*.json
        # p99/p999/max_stall columns.
        self.latency = LatencyHistogram()        # submit wall time, us
        self.stall = LatencyHistogram()          # maintenance pauses, us
        # Paced maintenance replaces the per-submit stop-the-world tick
        # when the store opts in (StoreConfig.pacer_interval_bytes). The
        # pacer is rebuilt (accumulator zero) on recovery by design:
        # pacing is a performance policy, never replayed state.
        cfg = store.cfg
        self.pacer = None
        if cfg.pacer_interval_bytes is not None:
            self.pacer = MaintenancePacer(
                store.scheduler,
                segment_budget=cfg.pacer_segment_budget,
                interval_bytes=cfg.pacer_interval_bytes)
        # Pacer autotune rides beside the memory governor (it owns a
        # different actuator -- the live pacer's knobs -- so the two never
        # fight over a plan field).
        self.stall_governor = None
        if getattr(cfg, "pacer_autotune", False) and self.pacer is not None:
            self.stall_governor = StallGovernor()

    @classmethod
    def open(cls, store_cfg: StoreConfig, **kw) -> "StorageService":
        return cls(LSMStore(store_cfg), **kw)

    @classmethod
    def recover(cls, store_cfg: StoreConfig, wal, manifest, *,
                router=None, **kw) -> "StorageService":
        """Crash-recovery front door: rebuild the data plane from the
        durable (WAL, manifest) pair and open a fresh service over it, on
        ``store_cfg.device``.

        The recovered store is bit-identical to the crashed one (state and
        write-path counters; see ``repro_torch.core.durability``).
        Requests the old service answered with ``Deferred`` were never
        executed and are therefore *provably absent* from the log --
        admission control refuses a write before it reaches the WAL
        append, so a deferred key appears in no ``WriteBatchRecord`` and
        recovery cannot resurrect it. Replay statistics:
        ``service.store.recovery_info``.
        """
        from ..durability.recovery import recover as _recover
        return cls(_recover(store_cfg, wal, manifest, router=router), **kw)

    # -- schema / passthroughs ------------------------------------------------
    def create_tree(self, name: str, **kw):
        return self.store.create_tree(name, **kw)

    def note_ops(self, n: int = 1) -> None:
        self.store.note_ops(n)

    @property
    def stats(self):
        return self.store.disk.stats

    def session(self, tenant: str, *,
                max_outstanding_keys=_UNSET) -> Session:
        """Get-or-create the tenant's session. Passing
        ``max_outstanding_keys`` (including an explicit ``None`` for
        unlimited) sets the admission window on the session, new or
        existing; omitting it leaves an existing session's window alone."""
        s = self.sessions.get(tenant)
        if s is None:
            s = self.sessions[tenant] = Session(
                self, tenant,
                max_outstanding_keys=(None if max_outstanding_keys is _UNSET
                                      else max_outstanding_keys))
        elif max_outstanding_keys is not _UNSET:
            s.max_outstanding_keys = max_outstanding_keys
        return s

    # -- admission ------------------------------------------------------------
    def _stall_groups(self) -> int:
        return (self.cfg.l0_stall_groups
                if self.cfg.l0_stall_groups is not None
                else self.store.cfg.l0_max_groups)

    def _step_tree(self, step: PlanStep):
        """The one LSMTree a step targets: over a sharded store, a write
        step names a (tree, shard) pair, so admission inspects the hot
        shard's tree only."""
        if step.shard is not None:
            return self.store.shard_tree(step.shard, step.tree)
        return self.store.trees[step.tree]

    def _refuse_write(self, step: PlanStep,
                      session: Session | None) -> str | None:
        """Admission check for one write step, just before execution.
        Returns a Deferred reason, or None to admit.

        Engine-side gates run first: a step the engine refuses must not
        charge the session's admission window (the keys never execute, and
        charging them would spuriously defer later steps of the submit)."""
        if self.cfg.admission:
            tree = self._step_tree(step)
            if tree.l0.num_groups >= self._stall_groups():
                return "l0-stall"
            slack = self.cfg.memory_admit_slack
            if slack is not None:
                incoming = step.n_keys * tree.entry_bytes
                if self.store.write_memory_used() + incoming \
                        > slack * self.store.write_memory_bytes:
                    return "memory-pressure"
        if session is not None and not session._admit(step.n_keys):
            return "session-quota"
        return None

    def stalled_trees(self) -> list[str]:
        """Trees currently refused writes by the L0 admission gate. Over a
        sharded store, entries are per-shard (``name@shard``): only the
        stalled shard refuses writes, the rest keep serving."""
        g = self._stall_groups()
        return [n for n, t in self.store.trees.items()
                if t.l0.num_groups >= g]

    def drain(self, max_ticks: int | None = None) -> int:
        """Catch-up maintenance: tick with an unbounded merge budget until
        no tree is L0-stalled, write memory is back under its threshold
        and no merge debt is carried (paced schedules defer slices, so a
        drain must also pay whatever the pacer left outstanding), or the
        tick cap is hit. Returns ticks executed. The explicit pair to a
        ``Deferred`` response: drain, then resubmit."""
        cap = max_ticks if max_ticks is not None else self.cfg.max_drain_ticks
        s = self.store
        done = 0
        for _ in range(cap):
            over_mem = s.write_memory_used() \
                > s.cfg.mem_flush_threshold * s.write_memory_bytes
            if not over_mem and not self.stalled_trees() \
                    and s.scheduler.carried_debt == 0:
                break
            tm = time.perf_counter()
            s.scheduler.tick(merge_budget=None)   # drain all debt
            self.stall.record((time.perf_counter() - tm) * 1e6)
            done += 1
        return done

    def sync(self) -> None:
        """Make every previously acked write durable now (drains a
        pending group-commit window; no-op on the memory medium)."""
        self.store.wal.sync()

    # -- execution ------------------------------------------------------------
    def _execute_step(self, step: PlanStep, results: list,
                      count_ops: bool) -> None:
        """Dispatch one plan step as ONE batched store call. Write acks
        are assembled by ``submit`` (a request may span several per-shard
        write steps); read/scan steps set their results here."""
        s = self.store
        if step.shard is not None:
            # the planner already routed this write step's keys: dispatch
            # straight to the shard's store instead of re-routing through
            # ShardedStore (every key would be hashed a second time)
            s = self.store.shards[step.shard].store
        if step.kind == "put":
            s.write_batch(step.tree, step.concat_keys(), step.concat_vals(),
                          op=count_ops, tick=False)
        elif step.kind == "delete":
            s.delete_batch(step.tree, step.concat_keys(),
                           op=count_ops, tick=False)
        elif step.kind == "get":
            found, vals = s.read_batch(step.tree, step.concat_keys(),
                                       op=count_ops)
            for i, _, a, b in step.slices():
                results[i] = GetResult(step.tree, found[a:b].copy(),
                                       vals[a:b].copy())
        elif step.kind == "scan":
            los = np.array([r.lo for r in step.requests], np.int64)
            lens = np.array([r.n for r in step.requests], np.int64)
            counts = s.scan_batch(step.tree, los, lens, op=count_ops)
            for j, i in enumerate(step.indices):
                results[i] = ScanResult(step.tree, int(counts[j]))
        else:                                     # pragma: no cover
            raise AssertionError(step.kind)

    @staticmethod
    def _narrow(req, sel: np.ndarray):
        """The sub-request carrying only positions ``sel`` of the keys --
        what a partially-deferred sharded write hands back for retry."""
        if isinstance(req, Put):
            return Put(req.tree, req.keys[sel],
                       None if req.vals is None else req.vals[sel])
        return Delete(req.tree, req.keys[sel])

    def submit(self, requests, *, session: Session | None = None,
               count_ops: bool = True) -> list[Result]:
        """Plan and execute a mixed-op batch; one scheduler tick amortized
        over all writes; governor observed once. Returns per-request
        results in submission order (``Deferred`` for refused writes --
        over a sharded store, refusal is per shard, and a Deferred may
        carry a request narrowed to the keys that did not execute)."""
        t0 = time.perf_counter()
        requests = list(requests)
        plan = build_plan(requests,
                          router=getattr(self.store, "router", None))
        if plan.n_requests == 0:
            return []
        self.submits += 1
        if session is not None:
            session._begin_submit()
        results: list = [None] * plan.n_requests
        wrote = False
        wrote_bytes = 0          # ingested payload, drives the pacer
        # Per write-request bookkeeping: a sharded request spans one step
        # per shard, so acks/deferrals aggregate after all steps ran.
        w_req = {i: r for i, r in enumerate(requests)
                 if isinstance(r, (Put, Delete))}
        w_defer: dict[int, tuple[list, str]] = {}
        for step in plan.steps:
            if step.kind in ("put", "delete"):
                reason = self._refuse_write(step, session)
                if reason is not None:
                    if reason != "session-quota":
                        self.store.disk.stats.write_stalls += 1
                    if session is not None:
                        session.stats.deferred_keys += step.n_keys
                        session.stats.deferred_events += 1
                    sels = step.key_sel if step.key_sel is not None \
                        else [None] * len(step.requests)
                    for i, sel in zip(step.indices, sels):
                        w_defer.setdefault(i, ([], reason))[0].append(sel)
                    continue
                wrote = True
                wrote_bytes += step.n_keys * self._step_tree(step).entry_bytes
            self._execute_step(step, results, count_ops)
            if session is not None:
                session.stats.executed_keys += step.n_keys
        if session is not None:
            session.stats.submitted_keys += sum(s.n_keys for s in plan.steps)
        if wrote:
            tm = time.perf_counter()
            if self.pacer is not None:
                self.pacer.on_submit(wrote_bytes)
            else:
                self.store.scheduler.tick()
            self.stall.record((time.perf_counter() - tm) * 1e6)
        # Acks are built AFTER maintenance so their durability flag sees
        # the tick-end commit point: under group commit the records may
        # still be waiting for their group's fsync, and the ack says so.
        durable = self.store.wal.all_durable
        for i, r in w_req.items():
            d = w_defer.get(i)
            if d is None:
                results[i] = WriteAck(r.tree, len(r.keys), durable=durable)
                continue
            sels, reason = d
            if any(s is None for s in sels) \
                    or sum(len(s) for s in sels) == len(r.keys):
                results[i] = Deferred(r, reason)
            else:
                sel = np.sort(np.concatenate(sels))
                results[i] = Deferred(self._narrow(r, sel), reason)
        mem_plan = self.governor.observe(self)
        if mem_plan is not None:
            self._apply_plan(mem_plan)
        if self.stall_governor is not None:
            pace_plan = self.stall_governor.observe(self)
            if pace_plan is not None:
                self._apply_plan(pace_plan)
        self.latency.record((time.perf_counter() - t0) * 1e6,
                            n=plan.n_requests)
        return results

    def submit_all(self, requests, *, session: Session | None = None,
                   count_ops: bool = True, max_rounds: int = 8) -> list[Result]:
        """``submit`` + automatic retry of deferred requests until all
        complete (or no retry makes progress / ``max_rounds``; remaining
        ``Deferred`` results are then returned as-is). Results keep the
        original submission order.

        Engine-side deferrals (l0-stall, memory-pressure) are drained then
        resubmitted together; session-quota deferrals are resubmitted one
        request per submit (each gets a fresh admission window), so only a
        single request larger than the window itself stays deferred --
        and that terminates the loop rather than spinning."""
        requests = list(requests)
        results = self.submit(requests, session=session, count_ops=count_ops)

        def settle(i, out):
            # A retried Deferred may carry a request narrowed to the keys
            # that had not executed; once it completes, the ack must cover
            # the caller's ORIGINAL request, not just the remainder.
            if isinstance(out, WriteAck) and out.n != len(requests[i].keys):
                out = WriteAck(out.tree, len(requests[i].keys),
                               durable=out.durable)
            results[i] = out
            return not isinstance(out, Deferred)

        for _ in range(max_rounds):
            pending = [(i, r) for i, r in enumerate(results)
                       if isinstance(r, Deferred)]
            if not pending:
                break
            engine = [(i, r.request) for i, r in pending
                      if r.reason != "session-quota"]
            quota = [(i, r.request) for i, r in pending
                     if r.reason == "session-quota"]
            progressed = False
            if engine:
                self.drain()
                retry = self.submit([req for _, req in engine],
                                    session=session, count_ops=count_ops)
                for (i, _), out in zip(engine, retry):
                    progressed |= settle(i, out)
            for i, req in quota:
                out = self.submit([req], session=session,
                                  count_ops=count_ops)[0]
                progressed |= settle(i, out)
            if not progressed:
                break
        return results

    def submit_strict(self, requests, **kw) -> list[Result]:
        """``submit_all`` that raises instead of returning leftover
        ``Deferred`` results: for callers (benchmark drivers, bulk loads)
        where a write that never lands is a bug, not backpressure."""
        results = self.submit_all(requests, **kw)
        dropped = [r for r in results if isinstance(r, Deferred)]
        if dropped:
            reasons = sorted({d.reason for d in dropped})
            raise RuntimeError(
                f"{len(dropped)} request(s) still deferred after "
                f"drain+retry (reasons: {reasons}); writes would be lost. "
                f"Raise the admission limits (ServiceConfig / session "
                f"window) or submit smaller batches.")
        return results

    # -- governor actuation ---------------------------------------------------
    def _apply_plan(self, plan: MemoryPlan) -> None:
        s = self.store
        if plan.write_memory_bytes is not None \
                and plan.write_memory_bytes != s.write_memory_bytes:
            s.set_write_memory(plan.write_memory_bytes)
        if plan.flush_policy is not None \
                and plan.flush_policy != s.cfg.flush_policy:
            if plan.flush_policy not in POLICIES:
                raise ValueError(
                    f"governor proposed unknown flush policy "
                    f"{plan.flush_policy!r}; expected one of {POLICIES}")
            s.cfg.flush_policy = plan.flush_policy
        if plan.device_pool_bytes is not None \
                and s.device_pool is not None \
                and plan.device_pool_bytes != s.device_pool.budget_bytes:
            s.set_device_pool_bytes(plan.device_pool_bytes)
        if self.pacer is not None:
            # Live-pacer knobs only: StoreConfig keeps the configured
            # values, so recovery re-paces from configuration.
            if plan.pacer_interval_bytes is not None:
                self.pacer.interval_bytes = int(plan.pacer_interval_bytes)
            if plan.pacer_segment_budget is not None:
                self.pacer.segment_budget = int(plan.pacer_segment_budget)
        self.plans.append(plan)
        if len(self.plans) > 256:
            del self.plans[:-256]

    # -- convenience sugar (single-request fronts) ----------------------------
    def put(self, tree: str, keys, vals=None) -> Result:
        return self.submit([Put(tree, keys, vals)])[0]

    def get(self, tree: str, keys) -> GetResult:
        return self.submit([Get(tree, keys)])[0]
