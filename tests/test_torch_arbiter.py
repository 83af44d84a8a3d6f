"""The port's HBM arbiter against the reference, on the CPU.

Twins of ``tests/test_hbm_arbiter.py``: the same synthetic pressure windows
and the same read-heavy -> serving-heavy flip go through
``repro.runtime.hbm_arbiter.HBMArbiter`` and
``repro_torch.runtime.hbm_arbiter.HBMArbiter``. The leases, every decision
record, the plans, and the KV pool's regions after ``set_regions`` must be
equal; the lease sum equals the total byte for byte after every decision.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro.runtime import hbm_arbiter as ref_arb  # noqa: E402
from repro.runtime import kvcache as ref_kv  # noqa: E402
from repro_torch.core.lsm.sstable import reset_sst_ids as port_reset  # noqa: E402
from repro_torch.runtime import hbm_arbiter as port_arb  # noqa: E402
from repro_torch.runtime import kvcache as port_kv  # noqa: E402
from repro_torch.runtime.hbm_arbiter import HBMArbiter, HBMArbiterConfig  # noqa: E402
from repro_torch.runtime.kvcache import KVPoolConfig, PagedKVPool  # noqa: E402

KB, MB = 1 << 10, 1 << 20
SIDES = {"port": (port, port_reset, port_arb, port_kv),
         "ref": (ref, ref_reset, ref_arb, ref_kv)}


# --------------------------- unit level (stubbed pressure) -------------------
class _StubPool:
    def __init__(self):
        self.budget_bytes = 4 * MB
        self.st = dict(tier_hits=0, tier_misses=0, store_hits=0,
                       store_misses=0, resident_pages=0,
                       capacity_pages=1024)

    def stats(self):
        return dict(self.st)


def _stub_service(pool):
    disk = SimpleNamespace(stats=SimpleNamespace(ops=0))
    return SimpleNamespace(store=SimpleNamespace(disk=disk,
                                                 device_pool=pool))


def _kv_pool(kv, total=2048):
    return kv.PagedKVPool(kv.KVPoolConfig(page_tokens=16, total_pages=total,
                                          pool_pages=total // 2,
                                          sim_pages=64))


def _tick(arb, svc, pool, *, dev_miss=0, kv_off=0, pfx_miss=0,
          resident=None):
    """One decision window of synthetic pressure."""
    pool.st["tier_misses"] += dev_miss
    if resident is not None:
        pool.st["resident_pages"] = resident
    svc.store.disk.stats.ops += arb.cfg.ops_cycle
    if arb.kv_pool is not None:
        arb.kv_pool.stats["offload_pages"] += kv_off
        arb.kv_pool.stats["prefix_misses"] += pfx_miss
    return arb.observe(svc)


def kv_state(kvp):
    return (kvp.total_pages, kvp.cfg.pool_pages, list(kvp.free),
            dict(kvp.stats),
            {s: list(st.pages) for s, st in kvp.streams.items()})


def _scripted(which, script, **cfg_kw):
    """Run one pressure script on one side; returns everything it decided."""
    _, _, arb_mod, kv = SIDES[which]
    kvp = _kv_pool(kv)
    arb = arb_mod.HBMArbiter(kvp, arb_mod.HBMArbiterConfig(**cfg_kw))
    pool = _StubPool()
    svc = _stub_service(pool)
    arb.attach(svc.store)
    total = arb.cfg.total_bytes
    plans, sums = [], []
    for kw in script:
        plan = _tick(arb, svc, pool, **kw)
        plans.append(None if plan is None else vars(plan))
        sums.append(arb.total_leased())
        assert arb.total_leased() == total, "lease sum drifted"
        assert all(arb.leases[r] >= arb.cfg.min_lease_bytes
                   for r in arb.REGIONS), "a region starved below floor"
    return dict(leases=dict(arb.leases), records=arb.records, plans=plans,
                sums=sums, shift=arb.shift_bytes_total, kv=kv_state(kvp))


def _mixed_script(seed, n=40):
    rng = np.random.default_rng(seed)
    return [dict(dev_miss=int(rng.integers(0, 200)) if i % 13 < 6 else 0,
                 kv_off=int(rng.integers(0, 200)) if i % 13 >= 6 else 0,
                 pfx_miss=int(rng.integers(0, 50)) if i % 5 == 0 else 0,
                 resident=int(rng.integers(0, 1024)) if i % 7 == 3 else None)
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leases_conserve_total_byte_exactly(seed):
    got = _scripted("port", _mixed_script(seed), total_bytes=48 * MB,
                    ops_cycle=64)
    assert got["shift"] > 0, "arbiter never shifted"
    assert sum(1 for r in got["records"] if r["shift_bytes"]) > 0
    assert set(got["sums"]) == {48 * MB}
    want = _scripted("ref", _mixed_script(seed), total_bytes=48 * MB,
                     ops_cycle=64)
    assert got == want


def test_budget_migrates_with_workload_flip():
    """Device-only pressure pulls the device lease up; flipping to
    KV-offload pressure sends bytes back toward the KV pool."""
    script = [dict(dev_miss=500)] * 6 + [dict(kv_off=500)] * 6
    got = _scripted("port", script, total_bytes=48 * MB, ops_cycle=64)
    recs = got["records"]
    dev0 = 16 * MB
    dev_read = recs[5]["leases"]["device"]
    kv_read = recs[5]["leases"]["kv"]
    assert dev_read > dev0, "device lease did not grow under read pressure"
    assert got["leases"]["kv"] > kv_read, "kv lease did not grow on the flip"
    assert got["leases"]["device"] < dev_read, "device lease never donated"
    assert got == _scripted("ref", script, total_bytes=48 * MB, ops_cycle=64)


def test_zero_pressure_holds_all_leases():
    got = _scripted("port", [{}] * 5, total_bytes=48 * MB, ops_cycle=64)
    assert got["plans"] == [None] * 5
    assert got["shift"] == 0
    assert got == _scripted("ref", [{}] * 5, total_bytes=48 * MB,
                            ops_cycle=64)


def test_default_leases_and_config_match_reference():
    assert vars(HBMArbiterConfig()) == vars(ref_arb.HBMArbiterConfig())
    for total in (48 * MB, 64 * MB + 1, 2 << 30):
        a = HBMArbiter(None, HBMArbiterConfig(total_bytes=total))
        b = ref_arb.HBMArbiter(None, ref_arb.HBMArbiterConfig(
            total_bytes=total))
        assert a.leases == b.leases and a.total_leased() == total
    with pytest.raises(AssertionError):
        HBMArbiter(None, HBMArbiterConfig(total_bytes=3 * MB),
                   leases={"device": MB, "kv": MB, "prefix": 2 * MB})


# --------------------------- end to end (real store + kv pool) ---------------
def _store_cfg(which, device_pool_bytes):
    pkg, reset, _, _ = SIDES[which]
    reset()
    kw = dict(total_memory_bytes=32 * MB, write_memory_bytes=256 * KB,
              sim_cache_bytes=1 * MB, page_bytes=4 * KB, entry_bytes=256,
              active_sstable_bytes=64 * KB, sstable_bytes=128 * KB,
              max_log_bytes=8 * MB, flush_policy="opt",
              device_pool_bytes=device_pool_bytes)
    if which == "port":
        return pkg.StoreConfig(device="cpu", fused_scope="store", **kw)
    return pkg.StoreConfig(backend="numpy", fused_scope="store", **kw)


def _flip_cost(which, device_bytes, kv_pages, prefix_pages, leases=None,
               *, n_reads=24, n_serve=1200, key_max=80_000, seed=5):
    """``test_hbm_arbiter._flip_cost`` on one side: a read-heavy phase then
    a serving-heavy one; returns the aggregate miss cost per op and what
    the arbiter (if any) decided."""
    pkg, _, arb_mod, kv = SIDES[which]
    arb = None
    if leases is not None:
        arb = arb_mod.HBMArbiter(None, arb_mod.HBMArbiterConfig(
            total_bytes=sum(leases.values()), kv_page_bytes=16 * KB,
            ops_cycle=512), leases=leases)
    kvp = kv.PagedKVPool(kv.KVPoolConfig(page_tokens=16,
                                         total_pages=kv_pages + prefix_pages,
                                         pool_pages=kv_pages, sim_pages=64))
    if arb is not None:
        arb.kv_pool = kvp
    svc = pkg.StorageService(pkg.LSMStore(_store_cfg(which, device_bytes)),
                             governor=arb)
    svc.create_tree("t")
    pool = svc.store.device_pool
    rng = np.random.default_rng(seed)
    for _ in range(80):
        ks = rng.integers(0, key_max, 256)
        svc.submit_strict([pkg.Put("t", ks, ks * 3)])
    cost = 0
    outs = []

    def fused_get(batch):
        nonlocal cost
        h0 = pool.stats()
        res = svc.submit_strict([pkg.Get("t", rng.integers(0, key_max,
                                                            batch))])
        outs.append((res[0].found.tobytes(), res[0].vals.tobytes()))
        h1 = pool.stats()
        missed = (h1["tier_misses"] - h0["tier_misses"]
                  + h1["store_misses"] - h0["store_misses"]) > 0
        served = (h1["tier_hits"] - h0["tier_hits"]
                  + h1["store_hits"] - h0["store_hits"]) > 0
        if missed or not served:
            cost += batch

    k0 = dict(kvp.stats)
    ops0 = svc.store.disk.stats.ops
    for _ in range(n_reads):
        fused_get(256)
    streams = {}
    for i in range(n_serve):
        if rng.random() < 0.4:
            kvp.lookup_prefix(int(rng.integers(0, 180)))
        else:
            s = f"s{rng.integers(0, 8)}"
            kvp.append_tokens(s, 16)
            streams[s] = streams.get(s, 0) + 1
            if streams[s] >= 40:
                kvp.finish_stream(s)
                streams[s] = 0
        if i % 64 == 0:
            fused_get(32)
    k1 = kvp.stats
    ops = (svc.store.disk.stats.ops - ops0 + k1["ops"] - k0.get("ops", 0))
    cost += (k1["offload_pages"] - k0["offload_pages"]
             + k1["prefix_misses"] - k0["prefix_misses"])
    return dict(cost=cost / max(1, ops), outs=outs,
                records=None if arb is None else arb.records,
                leases=None if arb is None else dict(arb.leases),
                shift=None if arb is None else arb.shift_bytes_total,
                plans=[vars(p) for p in svc.plans], kv=kv_state(kvp),
                pool=pool.stats(), budget=pool.budget_bytes,
                io=vars(svc.stats))


def test_arbiter_flip_matches_reference():
    """The adaptive split on the read-heavy -> serving-heavy flip: every
    decision, plan, result and pool count equals the reference's, the
    leases stay byte-exact, and the device lease moved."""
    leases = {"device": 4 * MB, "kv": 4 * MB, "prefix": 4 * MB}
    got = _flip_cost("port", 4 * MB, 256, 256, dict(leases))
    want = _flip_cost("ref", 4 * MB, 256, 256, dict(leases))
    assert got == want
    assert got["shift"] > 0, "arbiter never adapted"
    assert sum(got["leases"].values()) == 12 * MB
    assert all(sum(r["leases"].values()) == 12 * MB for r in got["records"])
    assert got["budget"] == got["leases"]["device"]


@pytest.mark.parametrize("split", [(8 * MB, 128, 128), (2 * MB, 320, 320)])
def test_static_splits_match_reference(split):
    assert _flip_cost("port", *split) == _flip_cost("ref", *split)


# --------------------------- region actuator ---------------------------------
def _grow(kv):
    kvp = _kv_pool(kv, total=256)
    for s in range(4):
        kvp.append_tokens(f"s{s}", 16 * 20)       # 20 pages per stream
    live = {pid for st in kvp.streams.values() for pid, _ in st.pages}
    old_ids = set(kvp.free) | live
    kvp.set_regions(256, 128)                     # grow 256 -> 384
    return kvp, old_ids


def test_set_regions_grow_mints_fresh_ids():
    kvp, old_ids = _grow(port_kv)
    assert kvp.total_pages == 384
    minted = set(kvp.free) - old_ids
    assert len(minted) == 128, "grow must mint exactly the delta"
    assert min(minted) >= 256, "grow reused a page id handed out before"
    assert len(kvp.free) == len(set(kvp.free)), "duplicate free ids"
    assert kv_state(kvp) == kv_state(_grow(ref_kv)[0])


def _shrink(kv):
    kvp = _kv_pool(kv, total=512)
    for s in range(4):
        kvp.append_tokens(f"s{s}", 16 * 30)
    live_before = {pid for st in kvp.streams.values() for pid, _ in st.pages}
    kvp.set_regions(128, 64)                      # shrink 512 -> 192
    return kvp, live_before


def test_set_regions_shrink_never_invalidates_live_pages():
    kvp, live_before = _shrink(port_kv)
    live_after = {pid for st in kvp.streams.values() for pid, _ in st.pages}
    assert kvp.total_pages <= 512
    assert live_after <= live_before, "shrink must only flush, never mint"
    assert live_after.isdisjoint(set(kvp.free)), \
        "a live page id landed on the free list"
    assert len(kvp.free) + len(live_after) <= kvp.total_pages \
        + len(kvp.prefix_store)
    r_kvp, _ = _shrink(ref_kv)
    assert kv_state(kvp) == kv_state(r_kvp)
    kvp.set_regions(1, 1)                         # floors hold
    r_kvp.set_regions(1, 1)
    assert kvp.cfg.pool_pages >= 64
    assert kvp.total_pages - kvp.cfg.pool_pages >= 64
    assert kv_state(kvp) == kv_state(r_kvp)
    assert isinstance(kvp, PagedKVPool)
    assert isinstance(kvp.cfg, KVPoolConfig)
