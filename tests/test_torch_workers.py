"""The port's maintenance worker pool against the reference, on the CPU.

Twins of the non-files tests of ``tests/test_overlap.py``: the pool's own
behaviour, the prepare/apply determinism contract (any worker count and
any completion order give the inline store's state, results and WAL
bytes, and those equal the reference's), paced flush slices and the
pacer's stall governor. The same seeded schedules go through ``repro``
(numpy backend) and ``repro_torch`` (``device="cpu"``).

Also the kernel wrappers under threads: K1 (``merge_runs``,
``ingest_run``) and K2 (``bloom_build``) called from several threads at
once through one ``TorchBackend`` give what single-threaded calls give,
each thread packs into staging of its own, and the launch counts lose
nothing.
"""
import ctypes
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_differential import KB  # noqa: E402
from test_overlap import TIMING_FIELDS, _StubService  # noqa: E402
from test_scheduler_interleave import TREES, gen_schedule  # noqa: E402
from test_torch_recovery import PKGS, small_config as cfg  # noqa: E402
from test_torch_recovery import state as durable_state  # noqa: E402

from repro.core.service.governor import (  # noqa: E402
    MemoryPlan as RefPlan, StallGovernor as RefStallGovernor)
from repro_torch.core.engine.torch_backend import TorchBackend  # noqa: E402
from repro_torch.core.engine.workers import (  # noqa: E402
    MaintenanceWorkerPool)
from repro_torch.core.service.governor import (  # noqa: E402
    MemoryPlan as PortPlan, StallGovernor as PortStallGovernor)
from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.kernels.bloom import bloom as bloom_k  # noqa: E402
from repro_torch.kernels.merge import merge as merge_k  # noqa: E402
from repro_torch.runtime.latency import (  # noqa: E402
    LatencyHistogram as PortHistogram)

PORT, REF = PKGS["port"], PKGS["ref"]
KEY_SPACE = 2000


def build(P, c, shards):
    P.reset()
    store = P.core.ShardedStore(c, shards=shards)
    for t in TREES:
        store.create_tree(t)
    return store


def apply_event(store, ev, oracle):
    """``test_scheduler_interleave.apply_event``."""
    kind = ev[0]
    if kind in ("write", "delete"):
        _, t, seed, size = ev
        rng = np.random.default_rng(seed)
        ks = rng.integers(0, KEY_SPACE, size)
        if kind == "write":
            vs = rng.integers(0, 2**31, size)
            store.write_batch(t, ks, vs, tick=False)
            oracle[t].update(zip(ks.tolist(), vs.tolist()))
        else:
            store.delete_batch(t, ks, tick=False)
            for k in ks.tolist():
                oracle[t][k] = None
    elif kind == "segment":
        _, name, budget = ev
        if budget == "default":
            store.scheduler.run_segment(name)
        else:
            store.scheduler.run_segment(name, merge_budget=budget)
    else:
        store.set_write_memory(ev[1])


def run_schedule(P, c, events, shards, drain_between=False):
    store = build(P, c, shards)
    oracle = {t: {} for t in TREES}
    for ev in events:
        apply_event(store, ev, oracle)
        if drain_between:
            store.arena.workers.drain()
    return store, oracle


def masked_state(P, store) -> dict:
    """Durable state, every IOStats field but the timing ones, and the
    WAL bytes: what no worker count may change."""
    st = durable_state(P, store)
    st["iostats"] = {k: v for k, v in vars(store.disk.stats).items()
                     if k not in TIMING_FIELDS}
    return st


def reads(store, oracle):
    out = []
    for t, d in oracle.items():
        ks = np.fromiter(d.keys(), np.int64, len(d))
        if len(ks):
            f, v = store.read_batch(t, ks)
            out.append((f.tolist(), v[f].tolist()))
    return out


# ------------------------- worker pool unit behavior --------------------------
def test_pool_workers_zero_is_inert():
    pool = MaintenanceWorkerPool(0)
    assert not pool.enabled
    assert pool.submit("k", lambda: 1) is False
    assert pool.take("k", lambda: 41 + 1) == 42
    assert pool._threads == [] and pool.submitted == 0
    assert pool.hits == 0 and pool.misses == 0


def test_pool_rejects_negative_workers():
    with pytest.raises(ValueError, match="workers"):
        MaintenanceWorkerPool(-1)


def test_pool_prepare_hit_and_stats():
    class FakeStats:
        bg_segments = 0
        bg_overlap_us = 0.0
    st = FakeStats()
    pool = MaintenanceWorkerPool(2, stats=st)
    assert pool.submit("a", lambda: np.arange(5) * 2)
    assert not pool.submit("a", lambda: None)    # dedup by key
    pool.drain()
    out = pool.take("a", lambda: pytest.fail("should consume the prepare"))
    np.testing.assert_array_equal(out, np.arange(5) * 2)
    assert pool.hits == 1 and st.bg_segments == 1
    assert st.bg_overlap_us > 0.0
    assert pool.take("a", lambda: "inline") == "inline"
    assert pool.misses == 1
    pool.close()


def test_pool_cancels_unstarted_and_surfaces_errors_as_misses():
    pool = MaintenanceWorkerPool(1)

    def boom():
        raise RuntimeError("prepare failed")
    pool.submit("bad", boom)
    pool.drain()
    assert pool.take("bad", lambda: "fallback") == "fallback"
    assert pool.misses == 1
    pool.close()
    assert not pool.enabled
    assert pool.take("x", lambda: 7) == 7
    assert pool.submit("x", lambda: 8) is False
    pool.close()                                 # idempotent


def test_pool_eviction_counts_wasted():
    pool = MaintenanceWorkerPool(1, max_prepared=2)
    for i in range(4):
        pool.submit(("k", i), lambda i=i: i)
    pool.drain()
    assert pool.prepared == 4
    assert pool.wasted == 2                      # oldest two evicted
    assert pool.take(("k", 3), lambda: None) == 3
    pool.close()
    assert pool.wasted == 3                      # the unconsumed survivor


def test_store_config_takes_any_worker_count_from_zero():
    for n in (0, 1, 2, 4):
        c = cfg(PORT, maintenance_workers=n).validate()
        store = PORT.core.ShardedStore(c, shards=1)
        assert store.arena.workers.workers == n
        assert store.arena.workers.enabled == (n > 0)
        assert store.shards[0].store.trees == {}
        store.arena.workers.close()
    with pytest.raises(ValueError, match="maintenance_workers must be >= 0"):
        cfg(PORT, maintenance_workers=-1).validate()


# --------------------- fuzzer invariants with workers on ----------------------
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaved_schedule_with_workers_equals_inline(seed, shards):
    """The interleaving fuzzer's schedules with 1, 2 and 4 workers: state,
    WAL bytes, debt, every non-timing IOStats field and every read equal
    the inline run's, which equals the reference's; the WAL of a worker
    run replays bit-identically on a worker-enabled store."""
    events = gen_schedule(seed)
    ref_inline, ref_oracle = run_schedule(REF, cfg(REF), events, shards)
    inline, oracle = run_schedule(PORT, cfg(PORT), events, shards)
    want = masked_state(REF, ref_inline)
    assert masked_state(PORT, inline) == want
    assert oracle == ref_oracle
    want_reads = reads(ref_inline, ref_oracle)
    assert reads(inline, oracle) == want_reads
    ref_w, _ = run_schedule(REF, cfg(REF, maintenance_workers=2), events,
                            shards)
    assert masked_state(REF, ref_w) == want
    ref_w.arena.workers.close()
    for n in (1, 2, 4):
        wc = cfg(PORT, maintenance_workers=n)
        overl, _ = run_schedule(PORT, wc, events, shards)
        assert masked_state(PORT, overl) == want, f"{n} workers"
        rec = PORT.recover(wc, overl.wal.clone(), overl.manifest.clone())
        assert durable_state(PORT, rec) == durable_state(PORT, overl)
        assert reads(overl, oracle) == want_reads
        assert reads(rec, oracle) == want_reads
        overl.arena.workers.close()
        rec.arena.workers.close()


@pytest.mark.parametrize("drain_between", [False, True],
                         ids=["racing", "forced-complete"])
def test_worker_completion_order_is_immaterial(drain_between):
    """Prepares racing the apply step, and every prepare forced to finish
    first, bracket all interleavings; both equal the inline store and the
    reference's."""
    events = gen_schedule(seed=5)
    ref_inline, _ = run_schedule(REF, cfg(REF), events, shards=1)
    store, _ = run_schedule(PORT, cfg(PORT, maintenance_workers=2), events,
                            shards=1, drain_between=drain_between)
    assert masked_state(PORT, store) == masked_state(REF, ref_inline)
    if drain_between:
        assert store.arena.workers.prepared > 0
    store.arena.workers.close()


def _overlap_run(P):
    c = P.core
    conf = cfg(P, maintenance_workers=2, pacer_interval_bytes=16 * KB,
               pacer_segment_budget=1)
    P.reset()
    svc = c.StorageService(c.ShardedStore(conf, shards=1),
                           config=c.ServiceConfig(admission=False))
    for t in TREES:
        svc.create_tree(t)
    rng = np.random.default_rng(3)
    got = []
    for i in range(40):
        ks = rng.integers(0, 2000, 250)
        svc.submit([c.Put(TREES[0], ks, ks + 1)])
        if i % 4 == 3:
            svc.store.arena.workers.drain()      # let prepares land
            f, v = svc.store.read_batch(TREES[0],
                                        rng.integers(0, 2000, 100))
            got.append((f.tolist(), v.tolist()))
    svc.drain()
    svc.store.arena.workers.close()
    return svc, got


def test_worker_overlap_actually_consumed():
    """Bloom builds submitted at flush and merge write-out are taken by the
    read path: bg_segments > 0, bg_overlap_us > 0, hits counted."""
    svc, got = _overlap_run(PORT)
    ref_svc, ref_got = _overlap_run(REF)
    st = svc.store.disk.stats
    pool = svc.store.arena.workers
    assert pool.submitted > 0
    assert st.bg_segments == pool.hits
    assert st.bg_segments > 0, "no prepare was ever consumed"
    assert st.bg_overlap_us > 0.0
    assert got == ref_got
    assert masked_state(PORT, svc.store) == masked_state(REF, ref_svc.store)


# --------------------------- paced flush slices -------------------------------
def fill_to(store, frac, rng):
    """Write until shared write memory exceeds ``frac`` of the budget."""
    guard = 0
    while store.write_memory_used() <= frac * store.write_memory_bytes:
        ks = rng.integers(0, 2000, 60)
        store.write_batch(TREES[0], ks, ks + 1, tick=False)
        guard += 1
        assert guard < 2000


def _slice_between(P):
    c = cfg(P, pacer_flush_threshold=0.5)
    store = build(P, c, 1)
    rng = np.random.default_rng(9)
    rep0 = store.scheduler.run_segment("mem")
    slices0 = store.disk.stats.flush_slices
    fill_to(store, 0.55, rng)
    assert store.write_memory_used() \
        <= c.mem_flush_threshold * store.write_memory_bytes
    rep = store.scheduler.run_segment("mem")
    return {"flushes": (rep0.flushes, rep.flushes),
            "slices": (slices0, store.disk.stats.flush_slices),
            "used": store.write_memory_used(),
            "budget": store.write_memory_bytes,
            "state": masked_state(P, store)}


def test_flush_slice_fires_between_thresholds():
    got, want = _slice_between(PORT), _slice_between(REF)
    assert got["flushes"] == (0, 1) and got["slices"] == (0, 1)
    assert got["used"] < 0.55 * got["budget"]
    assert got == want


def _slice_hard(P):
    store = build(P, cfg(P, pacer_flush_threshold=0.5), 1)
    fill_to(store, 1.0, np.random.default_rng(9))
    rep = store.scheduler.run_segment("mem")
    return rep.flushes, store.disk.stats.flush_slices, \
        masked_state(P, store)


def test_flush_slice_skipped_when_hard_threshold_flushed():
    got = _slice_hard(PORT)
    assert got[0] >= 1 and got[1] == 0
    assert got == _slice_hard(REF)


def test_flush_slices_replay_and_match_inline_workers():
    """Slices read store state only: the schedule replays bit-identically,
    and workers do not change slice counts (flush_slices is not masked)."""
    events = gen_schedule(seed=1)
    store, _ = run_schedule(PORT, cfg(PORT, pacer_flush_threshold=0.3),
                            events, shards=4)
    ref_store, _ = run_schedule(REF, cfg(REF, pacer_flush_threshold=0.3),
                                events, shards=4)
    assert store.disk.stats.flush_slices > 0
    assert masked_state(PORT, store) == masked_state(REF, ref_store)
    c = cfg(PORT, pacer_flush_threshold=0.3)
    rec = PORT.recover(c, store.wal.clone(), store.manifest.clone())
    assert durable_state(PORT, rec) == durable_state(PORT, store)
    assert rec.disk.stats.flush_slices == store.disk.stats.flush_slices
    withw, _ = run_schedule(PORT, cfg(PORT, pacer_flush_threshold=0.3,
                                      maintenance_workers=2),
                            events, shards=4)
    assert masked_state(PORT, withw) == masked_state(PORT, store)
    withw.arena.workers.close()


def _slices_defer(P):
    c = P.core
    conf = cfg(P, pacer_flush_threshold=0.5, pacer_interval_bytes=8 * KB,
               pacer_segment_budget=2)
    P.reset()
    svc = c.StorageService(c.ShardedStore(conf, shards=1),
                           config=c.ServiceConfig(admission=False))
    for t in TREES:
        svc.create_tree(t)
    fill_to(svc.store, 0.55, np.random.default_rng(9))
    before = svc.pacer.deferrals
    rep = svc.pacer.on_submit(64 * KB)
    return (rep.flushes, svc.store.disk.stats.flush_slices,
            svc.pacer.deferrals - before, masked_state(P, svc.store))


def test_flush_slices_defer_like_merge_slices():
    got = _slices_defer(PORT)
    assert got[0] == 1 and got[1] >= 1 and got[2] == 1
    assert got == _slices_defer(REF)


# ----------------------------- pacer autotune ---------------------------------
class _PortStub(_StubService):
    """``test_overlap._StubService`` with the port's histogram."""

    def __init__(self):
        super().__init__()
        self.stall = PortHistogram()


GOVS = {"port": (PortStallGovernor, _PortStub),
        "ref": (RefStallGovernor, _StubService)}


def _tightens(gov_cls, stub_cls):
    svc = stub_cls()
    gov = gov_cls(target_stall_us=1000.0, ops_cycle=8,
                  max_interval_bytes=256 * KB)
    first = svc.cycle(gov, 50_000.0)
    budgets, intervals = [], []
    for _ in range(10):
        svc.cycle(gov, 50_000.0)
        budgets.append(svc.pacer.segment_budget)
        intervals.append(svc.pacer.interval_bytes)
    last = svc.cycle(gov, 50_000.0)
    return first, budgets, intervals, last, gov.records


def test_stall_governor_tightens_to_convergence():
    got = _tightens(*GOVS["port"])
    first, budgets, intervals, last, recs = got
    assert first is None and last is None
    assert budgets[:3] == [4, 2, 1] and budgets[-1] == 1
    assert intervals[-1] == 256 * KB
    assert all(r["stall_max_us"] > 1000 for r in recs)
    assert got == _tightens(*GOVS["ref"])


def _deadband(gov_cls, stub_cls):
    svc = stub_cls()
    gov = gov_cls(target_stall_us=1000.0, ops_cycle=8, deadband=0.25,
                  min_dwell=2)
    knobs = []
    for stall in (2000.0, 2000.0, 1100.0, 500.0, 500.0):
        plan = svc.cycle(gov, stall)
        knobs.append((plan is None, svc.pacer.interval_bytes,
                      svc.pacer.segment_budget,
                      gov.records[-1].get("held") if gov.records else None))
    return knobs, gov.records


def test_stall_governor_deadband_and_dwell():
    got = _deadband(*GOVS["port"])
    knobs, recs = got
    assert knobs[1][2] == 4 and knobs[2][2] == 4    # tighten, then hold
    assert knobs[3][0] and knobs[3][2:] == (4, True)  # reversal #1 held
    assert knobs[4][1:3] != (64 * KB, 4)              # reversal #2 acts
    assert got == _deadband(*GOVS["ref"])


def _relaxes(gov_cls, stub_cls):
    svc = stub_cls()
    gov = gov_cls(target_stall_us=1000.0, ops_cycle=8,
                  min_interval_bytes=16 * KB, max_segment_budget=32)
    knobs = []
    for _ in range(4):
        svc.cycle(gov, 100.0)
        knobs.append((svc.pacer.interval_bytes, svc.pacer.segment_budget))
    return knobs, gov.records


def test_stall_governor_relaxes_interval_before_budget():
    got = _relaxes(*GOVS["port"])
    assert got[0][1:] == [(32 * KB, 8), (16 * KB, 8), (16 * KB, 16)]
    assert got == _relaxes(*GOVS["ref"])


def _autotune_wiring(P, plan_cls):
    c = P.core
    conf = cfg(P, pacer_interval_bytes=32 * KB, pacer_segment_budget=4,
               pacer_autotune=True)
    svc = c.StorageService(c.ShardedStore(conf, shards=1),
                           config=c.ServiceConfig(admission=False))
    off = c.StorageService(c.ShardedStore(cfg(
        P, pacer_interval_bytes=32 * KB), shards=1))
    svc._apply_plan(plan_cls(pacer_interval_bytes=8 * KB,
                             pacer_segment_budget=1, note="test"))
    return (svc.stall_governor is not None, off.stall_governor is None,
            (svc.pacer.interval_bytes, svc.pacer.segment_budget),
            (conf.pacer_interval_bytes, conf.pacer_segment_budget))


def test_autotune_wires_into_service_and_spares_config():
    got = _autotune_wiring(PORT, PortPlan)
    assert got == (True, True, (8 * KB, 1), (32 * KB, 4))
    assert got == _autotune_wiring(REF, RefPlan)


def _autotune_live(P):
    c = P.core
    conf = cfg(P, pacer_interval_bytes=16 * KB, pacer_segment_budget=8,
               pacer_autotune=True)
    P.reset()
    svc = c.StorageService(c.ShardedStore(conf, shards=1),
                           config=c.ServiceConfig(admission=False))
    for t in TREES:
        svc.create_tree(t)
    svc.stall_governor.ops_cycle = 256
    svc.stall_governor.target_stall_us = 50.0
    rng = np.random.default_rng(13)
    for _ in range(60):
        ks = rng.integers(0, 2000, 200)
        svc.submit([c.Put(TREES[0], ks, ks + 3)])
    return svc


def test_autotune_converges_on_live_service():
    """A write-heavy paced run with autotune on emits plans and every
    actuated value stays within the governor's bounds. The plans follow
    measured stall times, so they are not compared with the reference's;
    the store's durable state is (pacing is placement only)."""
    svc = _autotune_live(PORT)
    gov = svc.stall_governor
    assert gov.records, "governor never acted"
    assert any(p.note.startswith("pacer:") for p in svc.plans)
    assert svc.pacer.segment_budget <= 8
    assert gov.min_segment_budget <= svc.pacer.segment_budget
    assert svc.pacer.interval_bytes <= gov.max_interval_bytes
    svc.drain()
    ref_svc = _autotune_live(REF)
    ref_svc.drain()
    assert [r.found.tolist() for r in svc.submit(
        [PORT.core.Get(TREES[0], np.arange(2000))])] \
        == [r.found.tolist() for r in ref_svc.submit(
            [REF.core.Get(TREES[0], np.arange(2000))])]


# ----------------------- the kernel wrappers under threads --------------------
def _merge_inputs(rng, k):
    runs = []
    for _ in range(k):
        n = int(rng.integers(1, 3000))
        keys = np.unique(rng.integers(0, 20_000, n))
        runs.append((keys, rng.integers(0, 2**40, len(keys))))
    return runs


def _calls(seed):
    """A mixed list of the K1 and K2 calls a worker and the foreground make:
    (kind, args)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        kind = ("merge", "ingest", "bloom")[i % 3]
        if kind == "merge":
            out.append((kind, _merge_inputs(rng, int(rng.integers(2, 6)))))
        elif kind == "ingest":
            n = int(rng.integers(1, 5000))
            out.append((kind, (rng.integers(0, 3000, n),
                               rng.integers(0, 2**40, n))))
        else:
            out.append((kind, np.unique(rng.integers(0, 2**40, 2048))))
    return out


def _call(tb, kind, args):
    if kind == "merge":
        return tb.merge_runs(args)
    if kind == "ingest":
        return tb.ingest_run(*args)
    return (tb.bloom_build(args)[1],)


def _as_lists(res):
    return [np.asarray(a).tolist() for a in res]


def _threaded(tb, calls_by_thread):
    results = [None] * len(calls_by_thread)
    staging = [None] * len(calls_by_thread)
    errors = []
    start = threading.Barrier(len(calls_by_thread))

    def work(i):
        try:
            start.wait()
            results[i] = [_as_lists(_call(tb, k, a))
                          for k, a in calls_by_thread[i]]
            staging[i] = tb._staging
        except BaseException as e:      # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(calls_by_thread))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    return results, staging


def test_k1_and_k2_from_several_threads_equal_single_threaded_calls():
    """Four threads run K1 and K2 calls at once through one backend: every
    result equals the same call made alone, and each thread packed into
    staging buffers of its own."""
    tb = TorchBackend(device="cpu")
    calls = [_calls(seed) for seed in range(4)]
    alone = [[_as_lists(_call(TorchBackend(device="cpu"), k, a))
              for k, a in c] for c in calls]
    got, staging = _threaded(tb, calls)
    assert got == alone
    assert len({id(s) for s in staging}) == len(calls)
    assert tb._staging not in staging


class _FakeLibrary:
    """Stands in for the built kernel library on the CPU: computes K1 and
    K2 with their plain versions at the addresses the wrappers pass, so
    the wrappers take their launching branch and count."""

    @staticmethod
    def _i64(ptr, n):
        return torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_int64 * n).from_address(ptr)))

    def merge_runs(self, packed, k, n, out, stream, route):
        words = merge_k.out_words(n)
        res = merge_k.merge_runs_plain(self._i64(packed, k + 1 + 2 * n), k, n)
        self._i64(out, words).copy_(res)
        route._obj.value = 0
        return 0

    def bloom_build(self, keys, n, n_slots, k_hashes, filt, stream):
        res = bloom_k.bloom_build_plain(self._i64(keys, n), n_slots, k_hashes)
        dst = np.ctypeslib.as_array((ctypes.c_bool * n_slots).from_address(
            filt))
        dst[:] = res.reshape(-1).numpy()
        return 0


def test_launch_counts_lose_nothing_under_threads(monkeypatch):
    """Every launch of K1 and K2 from four threads at once is counted, K1's
    routes with it, and the results still equal single-threaded calls."""
    calls = [_calls(seed) for seed in range(4, 8)]
    alone = [[_as_lists(_call(TorchBackend(device="cpu"), k, a))
              for k, a in c] for c in calls]
    fake = _FakeLibrary()
    for mod in (merge_k, bloom_k):
        monkeypatch.setattr(mod, "on_card", lambda *t: True)
        monkeypatch.setattr(mod, "stream_of", lambda t: 0)
        monkeypatch.setattr(mod.build, "library", lambda: fake)
    monkeypatch.setitem(_launch.LAUNCHES, "merge_pair", 0)
    monkeypatch.setitem(_launch.LAUNCHES, "bloom_build", 0)
    routes = dict(merge_k.ROUTES)
    for r in merge_k.ROUTES:
        monkeypatch.setitem(merge_k.ROUTES, r, 0)
    got, _ = _threaded(TorchBackend(device="cpu"), calls)
    assert got == alone
    k1 = sum(1 for c in calls for k, _ in c if k != "bloom")
    k2 = sum(1 for c in calls for k, _ in c if k == "bloom")
    assert _launch.LAUNCHES["merge_pair"] == k1
    assert _launch.LAUNCHES["bloom_build"] == k2
    assert sum(merge_k.ROUTES.values()) == k1
    assert set(routes) == set(merge_k.ROUTES)


def test_count_is_exact_under_contention():
    counts = {"x": 0}
    n_threads, n_each = 8, 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _launch.count("x", counts) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert counts["x"] == n_threads * n_each

