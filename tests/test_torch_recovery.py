"""The port's crash recovery against the reference, on the CPU.

Twins of the memory-medium tests of ``tests/test_recovery.py``. Each
scenario runs twice, once through ``repro`` (its numpy backend) and once
through ``repro_torch`` (``device="cpu"``, the kernels' plain versions),
with the same seeded streams, and collects crash points: clones of the
WAL and the manifest beside the live store's state at that point. At
every crash point both packages recover, and

  * the port's recovered store equals the port's uncrashed store: shard
    fingerprints, ``RECOVERY_EXACT_COUNTERS``, ``log_pos``, write-memory
    size, carried debt and the encoded WAL records;
  * it equals the reference's recovered store in all of that and in
    ``recovery_info``, the WAL bytes compared through each package's own
    ``encode_record``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_differential import KB, MB, fingerprint  # noqa: E402
from test_recovery import (KEY_SPACE, TREES, _replay_oracle_only,  # noqa: E402
                           apply_batch, gen_batches)

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS as REF_EXACT, recover as ref_recover)
from repro.core.durability.wal import (  # noqa: E402
    WriteBatchRecord as RefWriteBatch, encode_record as ref_encode)
from repro.core.engine.scheduler import (  # noqa: E402
    SEGMENTS as REF_SEGMENTS, enforce_wal as ref_enforce_wal)
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro_torch.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS as PORT_EXACT, recover as port_recover)
from repro_torch.core.durability.wal import (  # noqa: E402
    WriteBatchRecord as PortWriteBatch, encode_record as port_encode)
from repro_torch.core.engine.scheduler import (  # noqa: E402
    SEGMENTS as PORT_SEGMENTS, enforce_wal as port_enforce_wal)
from repro_torch.core.lsm.sstable import (  # noqa: E402
    reset_sst_ids as port_reset)

PKGS = {
    "port": SimpleNamespace(name="port", core=port, recover=port_recover,
                            encode=port_encode, reset=port_reset,
                            exact=PORT_EXACT, segments=PORT_SEGMENTS,
                            enforce_wal=port_enforce_wal,
                            WriteBatch=PortWriteBatch,
                            backend_kw={"device": "cpu"}),
    "ref": SimpleNamespace(name="ref", core=ref, recover=ref_recover,
                           encode=ref_encode, reset=ref_reset,
                           exact=REF_EXACT, segments=REF_SEGMENTS,
                           enforce_wal=ref_enforce_wal,
                           WriteBatch=RefWriteBatch,
                           backend_kw={"backend": "numpy"}),
}


def test_both_packages_guarantee_the_same_counters():
    assert PORT_EXACT == REF_EXACT
    assert PORT_SEGMENTS == REF_SEGMENTS


def small_config(P, **kw):
    """``test_recovery.small_config`` for package ``P``."""
    base = dict(
        total_memory_bytes=32 * MB, write_memory_bytes=256 * KB,
        sim_cache_bytes=1 * MB, page_bytes=4 * KB, entry_bytes=256,
        active_sstable_bytes=32 * KB, sstable_bytes=64 * KB,
        max_log_bytes=512 * KB, scheme="partitioned", flush_policy="lsn")
    base.update(kw)
    return P.core.StoreConfig(**base, **P.backend_kw)


def _stores(store):
    return [sh.store for sh in store.shards] if hasattr(store, "shards") \
        else [store]


def state(P, store) -> dict:
    """What recovery must reproduce exactly, for a live or a recovered
    store of package ``P``."""
    return {"fp": [fingerprint(s) for s in _stores(store)],
            "counters": {k: getattr(store.disk.stats, k) for k in P.exact},
            "log_pos": store.log_pos,
            "write_memory_bytes": store.write_memory_bytes,
            "carried_debt": store.scheduler.carried_debt,
            "wal": [P.encode(r) for r in store.wal.records()],
            "truncated_to": store.wal.truncated_to}


def snap(P, store) -> dict:
    """A crash point: the durable pair as stable storage holds it, and the
    live store's state beside it."""
    return {"wal": store.wal.clone(), "manifest": store.manifest.clone(),
            "live": state(P, store), "tail_bytes": store.wal.tail_bytes,
            "log_length": store.log_length}


def run_both(scenario, **kw):
    """``scenario(P, **kw)`` in each package; returns {name: result}."""
    return {name: scenario(P, **kw) for name, P in PKGS.items()}


def recover_point(P, cfg, point):
    rec = P.recover(cfg, point["wal"].clone(), point["manifest"].clone())
    return rec, {**state(P, rec), "info": rec.recovery_info}


def assert_recovers(runs):
    """At every crash point of ``runs`` (``run_both``'s results, each a
    dict with ``cfg`` and a list of crash ``points``), recover in both
    packages: the port's recovered store equals the port's live store at
    that point and the reference's recovered store. Returns the port's
    recovered stores and their ``recovery_info``."""
    p, r = runs["port"], runs["ref"]
    assert len(p["points"]) == len(r["points"]) > 0
    out = []
    for i, (pp, rp) in enumerate(zip(p["points"], r["points"])):
        assert pp["live"] == rp["live"], f"point {i}: live stores differ"
        p_rec, p_st = recover_point(PKGS["port"], p["cfg"], pp)
        _, r_st = recover_point(PKGS["ref"], r["cfg"], rp)
        info = p_st.pop("info")
        assert p_st == pp["live"], f"point {i}: port recovery diverged"
        assert {**p_st, "info": info} == r_st, \
            f"point {i}: port and reference recoveries differ"
        out.append((p_rec, info))
    return out


# --------------------------- workload driver ----------------------------------
def run_workload(P, *, seed, n_batches, shards, cfg_kw=None):
    """``test_recovery.run_workload`` in package ``P``, a crash point at
    every batch boundary."""
    cfg = small_config(P, **(cfg_kw or {}))
    batches = gen_batches(seed=seed, n_batches=n_batches)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=shards)
    for t in TREES:
        store.create_tree(t)
    oracle = {t: {} for t in TREES}
    outputs: list = []
    points = []
    for batch in batches:
        apply_batch(store, batch, oracle, outputs)
        points.append(snap(P, store))
    return {"cfg": cfg, "store": store, "points": points,
            "outputs": outputs, "batches": batches,
            "final": state(P, store)}


# --------------------------- crash-point matrix -------------------------------
@pytest.mark.parametrize("shards", [1, 4])
def test_crash_recovery_matrix(shards):
    runs = run_both(run_workload, seed=11, n_batches=25, shards=shards)
    for bi, pt in enumerate(runs["port"]["points"]):
        assert pt["tail_bytes"] == pt["log_length"], f"boundary {bi}"
    recs = assert_recovers(runs)
    for rec, _ in recs:
        assert rec.n_shards == shards
    assert sum(p["live"]["truncated_to"] > 0
               for p in runs["port"]["points"]) > 0
    assert any(info["from_checkpoint"] for _, info in recs)


def _continue(P, rec, batches, crash_at):
    oracle = {t: {} for t in TREES}
    outputs: list = []
    for b in batches[:crash_at + 1]:
        _replay_oracle_only(b, oracle, outputs)
    for b in batches[crash_at + 1:]:
        apply_batch(rec, b, oracle, outputs)
    return outputs


@pytest.mark.parametrize("shards", [1, 4])
def test_crash_recovery_continuation_bit_identical(shards):
    """Recover at a few crash points, continue the workload on the
    recovered store: results and final state equal the uncrashed run's
    and the reference's continuation."""
    runs = run_both(run_workload, seed=29, n_batches=22, shards=shards)
    p, r = runs["port"], runs["ref"]
    for crash_at in (0, len(p["batches"]) // 2, len(p["batches"]) - 2):
        finals = {}
        for name, run in runs.items():
            P = PKGS[name]
            rec, _ = recover_point(P, run["cfg"], run["points"][crash_at])
            out = _continue(P, rec, run["batches"], crash_at)
            assert out == run["outputs"], f"{name}, crash at {crash_at}"
            finals[name] = state(P, rec)
        assert finals["port"] == p["final"] == finals["ref"], \
            f"crash at {crash_at}"
    assert p["final"] == r["final"]


def _crash_twice(P):
    run = run_workload(P, seed=5, n_batches=12, shards=2)
    rec1, _ = recover_point(P, run["cfg"], run["points"][6])
    _continue(P, rec1, run["batches"], 6)
    return {"cfg": run["cfg"], "points": [snap(P, rec1)]}


def test_recovered_store_can_crash_and_recover_again():
    assert_recovers(run_both(_crash_twice))


# --------------------------- schemes / policies -------------------------------
@pytest.mark.parametrize("scheme", ["btree-dynamic", "accordion-data"])
def test_crash_recovery_other_schemes(scheme):
    runs = run_both(run_workload, seed=13, n_batches=16, shards=2,
                    cfg_kw={"scheme": scheme, "flush_policy": "mem"})
    for run in runs.values():
        run["points"] = [run["points"][i] for i in (3, 9, 15)]
    assert_recovers(runs)


def test_crash_recovery_opt_policy_rate_windows():
    """OPT's per-tree write-rate windows and share EWMAs round-trip
    (checkpoint) and rebuild (replay) in both packages alike."""
    runs = run_both(run_workload, seed=17, n_batches=18, shards=1,
                    cfg_kw={"flush_policy": "opt"})
    crash_at = 9
    got = {}
    for name, run in runs.items():
        P = PKGS[name]
        rec, _ = recover_point(P, run["cfg"], run["points"][crash_at])
        assert _continue(P, rec, run["batches"], crash_at) == run["outputs"]
        assert state(P, rec) == run["final"]
        live, s = run["store"].shards[0].store, rec.shards[0].store
        windows = {n: list(w) for n, w in s._rate_win.items()}
        assert windows == {n: list(w) for n, w in live._rate_win.items()}
        assert s._share_ewma == live._share_ewma
        got[name] = (windows, s._share_ewma, state(P, rec))
    assert got["port"] == got["ref"]
    assert_recovers({n: {**r, "points": [r["points"][crash_at]]}
                     for n, r in runs.items()})


# --------------------------- truncation / checkpoint --------------------------
def _truncation(P):
    cfg = small_config(P, max_log_bytes=2 * MB)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=2)
    store.create_tree("a")
    rng = np.random.default_rng(0)
    points = []
    for _ in range(60):
        ks = rng.integers(0, KEY_SPACE, 300)
        store.write_batch("a", ks, ks + 1)
        assert store.wal.tail_bytes == store.log_length
        if store.wal.truncated_to > 0:
            assert all(r.lsn_end > store.wal.truncated_to
                       for r in store.wal.records())
    points.append(snap(P, store))
    ck = store.manifest.latest_checkpoint
    assert ck is not None and ck.watermark >= store.wal.truncated_to
    return {"cfg": cfg, "points": points}


def test_scheduler_truncation_physically_drops_records():
    runs = run_both(_truncation)
    assert runs["port"]["points"][0]["live"]["truncated_to"] > 0
    (_, info), = assert_recovers(runs)
    assert info["from_checkpoint"]


def _interval(P, interval):
    cfg = small_config(P, max_log_bytes=64 * MB,
                       checkpoint_interval_bytes=interval)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=1)
    store.create_tree("a")
    oracle = {"a": {}, "b": {}}
    for s in range(40):
        apply_batch(store, ("write", "a", s, 100), oracle, [])
    return {"cfg": cfg, "points": [snap(P, store)]}


def test_checkpoint_interval_bounds_replay_tail():
    (_, unbounded), = assert_recovers(run_both(_interval, interval=None))
    (_, bounded), = assert_recovers(run_both(_interval, interval=256 * KB))
    assert bounded["replayed_records"] < unbounded["replayed_records"]


# --------------------------- segment-boundary crash matrix --------------------
def _segment_boundaries(P, shards):
    cfg = small_config(P)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=shards)
    for t in TREES:
        store.create_tree(t)
    rng = np.random.default_rng(41)
    points = []
    for _ in range(12):
        t = TREES[int(rng.integers(0, 2))]
        ks = rng.integers(0, KEY_SPACE, int(rng.integers(80, 260)))
        store.write_batch(t, ks, ks + 3, tick=False)
        for name in P.segments:
            if name == "merge":
                store.scheduler.run_segment(name, merge_budget=2)
            else:
                store.scheduler.run_segment(name)
            points.append(snap(P, store))
    return {"cfg": cfg, "points": points}


@pytest.mark.parametrize("shards", [1, 4])
def test_crash_at_every_segment_boundary(shards):
    runs = run_both(_segment_boundaries, shards=shards)
    assert len(runs["port"]["points"]) == 12 * len(PORT_SEGMENTS)
    assert_recovers(runs)


def _mid_segment(P):
    cfg = small_config(P)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=2)
    store.create_tree("a")
    rng = np.random.default_rng(6)
    for _ in range(6):
        store.write_batch("a", rng.integers(0, KEY_SPACE, 300),
                          rng.integers(0, 2**31, 300), tick=False)
        store.scheduler.run_segment("upkeep")
    sch = store.scheduler
    points = []
    # the "mem" segment logged write-ahead, the crash before its phase ran
    store.wal.append_tick("default", segment="mem")
    sch.segments += 1
    wal_c, man_c = store.wal.clone(), store.manifest.clone()
    sch._enforce_memory()
    points.append({"wal": wal_c, "manifest": man_c,
                   "live": state(P, store), "segments": sch.segments})
    # a bounded merge segment: record down, phase not yet run
    store.wal.append_tick(2, segment="merge")
    sch.segments += 1
    wal_c, man_c = store.wal.clone(), store.manifest.clone()
    sch._run_merges(2)
    points.append({"wal": wal_c, "manifest": man_c,
                   "live": state(P, store), "segments": sch.segments})
    return {"cfg": cfg, "points": points}


def test_crash_mid_segment_redoes_the_segment():
    runs = run_both(_mid_segment)
    for (rec, _), pt in zip(assert_recovers(runs), runs["port"]["points"]):
        assert rec.scheduler.segments == pt["segments"]


def _mid_tick(P):
    cfg = small_config(P)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=2)
    store.create_tree("a")
    rng = np.random.default_rng(4)
    for _ in range(6):
        store.write_batch("a", rng.integers(0, KEY_SPACE, 300),
                          rng.integers(0, 2**31, 300))
    # one tick by hand: logged write-ahead, its flush phases run, then the
    # crash before the merge pass and the WAL enforcement
    sch = store.scheduler
    store.wal.append_tick("default")
    sch.ticks += 1
    for s in sch.stores:
        s.scheduler._mem_upkeep()
    sch._enforce_memory()
    sch._enforce_log()
    wal_c, man_c = store.wal.clone(), store.manifest.clone()
    sch._run_merges(sch.merge_budget)
    P.enforce_wal(store.arena, sch)
    return {"cfg": cfg, "points": [{"wal": wal_c, "manifest": man_c,
                                    "live": state(P, store)}]}


def test_crash_mid_maintenance_redoes_the_tick():
    """The tick is logged write-ahead, so recovery redoes the WHOLE tick
    and lands on the completed-tick state."""
    assert_recovers(run_both(_mid_tick))


# --------------------------- WAL replay safety --------------------------------
def _four_shards(P):
    cfg = small_config(P)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=4)
    store.create_tree("a")
    store.write_batch("a", np.arange(100), np.arange(100))
    return {"cfg": cfg, "points": [snap(P, store)], "store": store}


def test_recover_rejects_wrong_router_and_config():
    runs = run_both(_four_shards)
    for name, run in runs.items():
        P = PKGS[name]
        pt = run["points"][0]
        with pytest.raises((ValueError, RuntimeError)):
            P.recover(run["cfg"], pt["wal"].clone(), pt["manifest"].clone(),
                      router=P.core.ShardRouter(3))
        with pytest.raises(ValueError, match="manifest"):
            P.recover(small_config(P, entry_bytes=512), pt["wal"].clone(),
                      pt["manifest"].clone())
    # the undamaged pair still recovers
    assert_recovers(runs)


def _bare(P):
    P.reset()
    cfg = small_config(P)
    store = P.core.LSMStore(cfg)
    store.create_tree("a", dataset="ds0")
    store.create_tree("b", entry_bytes=128)
    rng = np.random.default_rng(1)
    for _ in range(20):
        t = TREES[int(rng.integers(0, 2))]
        ks = rng.integers(0, KEY_SPACE, 150)
        store.write_batch(t, ks, ks + 7)
    store.delete_batch("a", rng.integers(0, KEY_SPACE, 60))
    return {"cfg": cfg, "points": [snap(P, store)], "store": store}


def test_bare_lsmstore_recovers_as_one_shard_store():
    runs = run_both(_bare)
    (rec, _), = assert_recovers(runs)
    assert rec.n_shards == 1
    s = rec.shards[0].store
    assert s.tree_dataset == runs["port"]["store"].tree_dataset
    assert s.trees["b"].entry_bytes == 128


def _control_records(P):
    P.reset()
    cfg = small_config(P, total_memory_bytes=64 * MB,
                       write_memory_bytes=4 * MB, max_log_bytes=64 * MB,
                       scheme="btree-dynamic", flush_policy="mem")
    store = P.core.ShardedStore(cfg, shards=1)
    store.create_tree("a")
    rng = np.random.default_rng(8)
    for _ in range(8):
        ks = rng.integers(0, 20_000, 1000)
        store.write_batch("a", ks, ks + 1)
    assert store.write_memory_used() > 1 * MB
    store.checkpoint()
    store.set_write_memory(1 * MB)           # control record AT watermark
    store.scheduler.tick()                   # full flush -> min_lsn=INF
    store.scheduler.tick()                   # -> trunc == head == watermark
    assert store.min_lsn() >= 2**62
    assert store.wal.truncated_to == store.log_pos
    return {"cfg": cfg, "points": [snap(P, store)], "store": store}


def test_control_records_at_watermark_survive_truncation():
    runs = run_both(_control_records)
    (rec, _), = assert_recovers(runs)
    assert rec.write_memory_bytes == 1 * MB
    assert rec.scheduler.ticks == runs["port"]["store"].scheduler.ticks


def _late_tree(P):
    P.reset()
    cfg = small_config(P)
    store = P.core.ShardedStore(cfg, shards=2)
    store.create_tree("a")
    rng = np.random.default_rng(3)
    for _ in range(20):
        ks = rng.integers(0, KEY_SPACE, 250)
        store.write_batch("a", ks, ks + 1)
    assert store.manifest.latest_checkpoint is not None
    store.create_tree("late", dataset="dsl", entry_bytes=128)
    store.write_batch("late", np.arange(50), np.arange(50) * 2)
    return {"cfg": cfg, "points": [snap(P, store)]}


def test_tree_created_after_checkpoint_recovers_via_tail():
    (rec, info), = assert_recovers(run_both(_late_tree))
    assert info["from_checkpoint"]
    s = rec.shards[0].store
    assert s.trees["late"].entry_bytes == 128
    assert s.tree_dataset["late"] == "dsl"
    found, vals = rec.read_batch("late", np.arange(50))
    assert found.all() and (vals == np.arange(50) * 2).all()


def _empty(P):
    P.reset()
    cfg = small_config(P)
    store = P.core.ShardedStore(cfg, shards=3)
    return {"cfg": cfg, "points": [snap(P, store)]}


def test_empty_store_recovers():
    (rec, info), = assert_recovers(run_both(_empty))
    assert rec.n_shards == 3 and rec.log_pos == 0
    assert info["replayed_records"] == 0


def test_recover_runs_on_the_configured_device(monkeypatch):
    """``recover`` opens its store on ``cfg.device``: a CUDA config on a
    machine without a GPU raises instead of carrying on on the CPU."""
    run = _empty(PKGS["port"])
    pt = run["points"][0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.StoreConfig(**{**vars(run["cfg"]), "device": "cuda"})
    with pytest.raises(RuntimeError, match="is_available"):
        port.StorageService.recover(cfg, pt["wal"].clone(),
                                    pt["manifest"].clone())
    with pytest.raises(RuntimeError, match="is_available"):
        port_recover(cfg, pt["wal"].clone(), pt["manifest"].clone())


# --------------------------- service front door -------------------------------
def _deferred(P):
    P.reset()
    cfg = small_config(P)
    c = P.core
    store = c.ShardedStore(cfg, router=c.ShardRouter.ranges(2, KEY_SPACE))
    svc = c.StorageService(store, config=c.ServiceConfig(admission=True))
    svc.create_tree("a")
    hot = store.shard_tree(0, "a")
    for _ in range(cfg.l0_max_groups):        # stall shard 0's tree
        ks = np.arange(0, 900)
        store.shards[0].store.write_batch("a", ks, ks + 1, tick=False)
        store.shards[0].store.scheduler.flush_tree(
            hot, trigger="mem", forced_kind="full")
    assert svc.stalled_trees() == ["a@0"]
    appended: set = set()
    orig_append = store.wal.append_batch

    def spy(tree, keys, vals, **kw):
        if vals is not None:
            appended.update(zip(np.asarray(keys).tolist(),
                                np.asarray(vals).tolist()))
        return orig_append(tree, keys, vals, **kw)

    store.wal.append_batch = spy
    keys = np.array([10, 1500, 20, 1600])      # 2 hot (deferred), 2 cold
    res = svc.submit([c.Put("a", keys, keys + 5)])
    store.wal.append_batch = orig_append
    assert isinstance(res[0], c.Deferred) and res[0].reason == "l0-stall"
    assert set(res[0].request.keys.tolist()) == {10, 20}
    assert not ({(10, 15), (20, 25)} & appended)
    assert {(1500, 1505), (1600, 1605)} <= appended
    for rec in store.wal.records():
        if isinstance(rec, P.WriteBatch):
            assert not ({(10, 15), (20, 25)}
                        & set(zip(rec.keys.tolist(), rec.vals.tolist())))
    svc2 = c.StorageService.recover(cfg, store.wal.clone(),
                                    store.manifest.clone())
    found, vals = svc2.store.read_batch("a", keys)
    return {"cfg": cfg, "points": [snap(P, store)],
            "read": (found.tolist(), vals.tolist()),
            "info": svc2.store.recovery_info,
            "recovered": state(P, svc2.store)}


def test_deferred_writes_provably_absent_from_log():
    """Admission refuses a write before the WAL append, so a Deferred
    request's keys are in no WriteBatch record and recovery through the
    service's front door cannot resurrect them."""
    runs = run_both(_deferred)
    p = runs["port"]
    assert p["read"] == ([True] * 4, [11, 1505, 21, 1605])
    assert p["info"]["from_checkpoint"]
    assert p["recovered"] == p["points"][0]["live"]
    assert (p["read"], p["info"], p["recovered"]) \
        == tuple(runs["ref"][k] for k in ("read", "info", "recovered"))
    assert_recovers(runs)


def _front_door(P):
    P.reset()
    cfg = small_config(P)
    c = P.core
    svc = c.StorageService(c.ShardedStore(cfg, shards=3),
                           config=c.ServiceConfig(admission=False))
    for t in TREES:
        svc.create_tree(t)
    rng = np.random.default_rng(2)
    oracle = {t: {} for t in TREES}
    for _ in range(12):
        t = TREES[int(rng.integers(0, 2))]
        ks = rng.integers(0, KEY_SPACE, 120)
        vs = rng.integers(0, 2**31, 120)
        dk = rng.integers(0, KEY_SPACE, 30)
        svc.submit([c.Put(t, ks, vs), c.Delete(t, dk)])
        oracle[t].update(zip(ks.tolist(), vs.tolist()))
        for k in dk.tolist():
            oracle[t][k] = None
    point = snap(P, svc.store)
    svc2 = c.StorageService.recover(cfg, svc.store.wal.clone(),
                                    svc.store.manifest.clone())
    reads = []
    for t, d in oracle.items():
        ks = np.fromiter(d.keys(), np.int64, len(d))
        res = svc2.submit([c.Get(t, ks)])[0]
        for i, k in enumerate(ks.tolist()):
            want = d[k]
            assert bool(res.found[i]) == (want is not None)
            if want is not None:
                assert int(res.vals[i]) == want
        reads.append((res.found.tolist(), res.vals.tolist()))
    svc2.submit([c.Put("a", np.array([42]), np.array([43]))])
    found, vals = svc2.store.read_batch("a", np.array([42]))
    assert found[0] and vals[0] == 43
    return {"cfg": cfg, "points": [point], "reads": reads,
            "after": state(P, svc2.store)}


def test_service_workload_recovers_through_front_door():
    runs = run_both(_front_door)
    assert runs["port"]["reads"] == runs["ref"]["reads"]
    assert runs["port"]["after"] == runs["ref"]["after"]
    assert_recovers(runs)


# --------------------------- manifest consistency -----------------------------
def test_manifest_live_set_matches_tree_state():
    run = run_workload(PKGS["port"], seed=23, n_batches=15, shards=2)
    store = run["store"]
    reachable = {s.sst_id
                 for sh in store.shards
                 for t in sh.store.trees.values()
                 for s in t.l0.all_tables()
                 + [x for lvl in t.levels.levels for x in lvl]}
    assert set(store.manifest.live) == reachable
    assert store.manifest.version >= len(store.manifest.edits)
