"""The port's device page pool and fused read path against the reference,
on the CPU. The same seeded inputs go through ``repro`` (``NumpyBackend``,
plus ``PallasBackend(interpret=True)`` where that backend takes them) and
through ``repro_torch`` with ``device="cpu"``, where the K3/K4 wrappers
run their plain versions: backend fields, store and service results,
IOStats including the ``fused_*`` counters, page pins, ``pool.stats()``,
WAL bytes and manifest edits must be bit-identical. Keys beyond int32 are
compared with ``NumpyBackend`` only: the Pallas backend refuses them."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402
from test_differential import fingerprint  # noqa: E402
from test_torch_store import gen_stream, run, small_kw  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.core.durability.wal import encode_record as ref_encode  # noqa: E402
from repro.core.engine import NumpyBackend, PallasBackend  # noqa: E402
from repro.core.engine.backend import (StoreView as RefStoreView,  # noqa: E402
                                       TierView as RefTierView)
from repro.core.lsm.sstable import partition_run as ref_partition  # noqa: E402
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro.core.service.governor import (  # noqa: E402
    DevicePoolGovernor as RefPoolGovernor)
from repro_torch.core.durability.wal import encode_record as port_encode  # noqa: E402
from repro_torch.core.engine.torch_backend import TorchBackend  # noqa: E402
from repro_torch.core.lsm.sstable import partition_run as port_partition  # noqa: E402
from repro_torch.core.lsm.sstable import reset_sst_ids as port_reset  # noqa: E402
from repro_torch.core.service import (DevicePoolGovernor,  # noqa: E402
                                      MemoryGovernor, MemoryPlan)
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.kernels.lookup import lookup as lookup_k  # noqa: E402

KB, MB = 1 << 10, 1 << 20
K_HASHES = 7
FIELDS = ("ti", "ok", "positive", "pos", "hit", "vals")


@pytest.fixture(scope="module")
def backends():
    return TorchBackend(device="cpu"), NumpyBackend(), PallasBackend(
        interpret=True)


def tier_of(keys, vals, per_table=700):
    """The same disjoint, min_key-sorted tier in both packages."""
    ref_reset()
    port_reset()
    args = (0, 0, 256, 4 * KB, per_table * 256)
    return (port_partition(keys, vals, *args),
            ref_partition(keys, vals, *args))


def make_tier(rng, n_tables, per_table=700, hi=200_000):
    keys = np.sort(rng.choice(hi, size=n_tables * per_table,
                              replace=False)).astype(np.int64)
    vals = rng.integers(1, 2**30, size=len(keys)).astype(np.int64)
    return tier_of(keys, vals, per_table)


def bloom_of(b):
    return lambda s: b.bloom_build(s.keys)


def assert_fields(got, want, fields=FIELDS, msg=""):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f"{msg} {f}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} field={f}")


# --------------------------- (a) backend seam --------------------------------
@pytest.mark.parametrize("n_tables", [1, 3, 7])
def test_lookup_fused_bit_identical(backends, n_tables):
    """prepare_tier + lookup_fused, field by field, against both reference
    backends: hits, misses inside the tier and keys outside it."""
    tb, nb, pb = backends
    rng = np.random.default_rng(n_tables)
    pt, rt = make_tier(rng, n_tables)
    allk = np.concatenate([t.keys for t in pt])
    q = np.concatenate([rng.choice(allk, 300), rng.integers(0, 220_000, 200),
                        [0, 300_000]]).astype(np.int64)
    got = tb.lookup_fused(tb.prepare_tier(pt, bloom_of(tb)), q)
    assert got.hit.any() and not got.hit.all() and not got.ok.all()
    for b in (nb, pb):
        want = b.lookup_fused(b.prepare_tier(rt, bloom_of(b)), q)
        assert_fields(got, want, msg=b.name)


@pytest.mark.parametrize("shape", [(3, 2, 5), (1,), (2, 2), (1, 3, 7)])
def test_lookup_store_fused_bit_identical(backends, shape):
    """prepare_store + lookup_store_fused, field by field per tier and the
    winner, against both reference backends."""
    tb, nb, pb = backends
    rng = np.random.default_rng(sum(shape))
    tiers = [make_tier(rng, n) for n in shape]
    pts, rts = [t[0] for t in tiers], [t[1] for t in tiers]
    allk = np.concatenate([t.keys for tier in pts for t in tier])
    q = np.concatenate([rng.choice(allk, 300),
                        rng.integers(0, 220_000, 200)]).astype(np.int64)
    sview = tb.prepare_store(pts, bloom_of(tb))
    assert sview.num_tiers == len(shape) and sview.num_tables == sum(shape)
    got = tb.lookup_store_fused(sview, q)
    assert (got.win >= 0).any() and (got.win == -1).any()
    for b in (nb, pb):
        want = b.lookup_store_fused(b.prepare_store(rts, bloom_of(b)), q)
        assert_fields(got, want, FIELDS + ("win",), msg=b.name)


def test_store_fused_newest_wins_three_tiers(backends):
    """The same key in three tiers resolves from tier 0, the newest."""
    tb, nb, pb = backends
    keys = np.arange(0, 4000, 4, dtype=np.int64)
    tiers = [tier_of(keys, keys * 10 + r, per_table=256) for r in range(3)]
    q = keys[::7]
    got = tb.lookup_store_fused(
        tb.prepare_store([t[0] for t in tiers], bloom_of(tb)), q)
    assert (got.win == 0).all()
    np.testing.assert_array_equal(got.vals[0], q * 10)
    assert got.hit.all()                 # every tier's fields are written
    for b in (nb, pb):
        want = b.lookup_store_fused(
            b.prepare_store([t[1] for t in tiers], bloom_of(b)), q)
        assert_fields(got, want, FIELDS + ("win",), msg=b.name)


def test_store_fused_empty_view_and_all_miss(backends):
    """An empty tier list (R = 0) gives a (0, K) lookup without a launch;
    an all-miss batch resolves nothing."""
    tb, nb, pb = backends
    rng = np.random.default_rng(1)
    pt, rt = make_tier(rng, 2)
    q = rng.integers(300_000, 400_000, 128).astype(np.int64)
    before = dict(LAUNCHES)
    got0 = tb.lookup_store_fused(tb.prepare_store([], bloom_of(tb)), q)
    assert got0.ti.shape == (0, len(q)) and (got0.win == -1).all()
    got1 = tb.lookup_store_fused(tb.prepare_store([pt], bloom_of(tb)), q)
    assert (got1.win == -1).all() and not got1.hit.any()
    got2 = tb.lookup_fused(tb.prepare_tier(pt, bloom_of(tb)), q)
    assert not got2.hit.any()
    assert LAUNCHES == before                 # plain versions on the CPU
    for b in (nb, pb):
        assert_fields(got0, b.lookup_store_fused(
            b.prepare_store([], bloom_of(b)), q), FIELDS + ("win",), b.name)
        assert_fields(got1, b.lookup_store_fused(
            b.prepare_store([rt], bloom_of(b)), q), FIELDS + ("win",), b.name)
        assert_fields(got2, b.lookup_fused(b.prepare_tier(rt, bloom_of(b)),
                                           q), msg=b.name)


def test_wide_keys_match_numpy(backends):
    """Keys and queries beyond int32 (negative ones too): the port takes
    them as they are; the reference serves them on NumpyBackend."""
    tb, nb, _ = backends
    rng = np.random.default_rng(9)
    tiers = []
    for r in range(3):
        k = np.unique(rng.integers(-2**50, 2**50, 1500)).astype(np.int64)
        tiers.append(tier_of(k, rng.integers(-2**60, 2**60, len(k)),
                             per_table=300))
    allk = np.concatenate([t.keys for tier, _ in tiers for t in tier])
    q = np.concatenate([rng.choice(allk, 400),
                        rng.integers(-2**50, 2**50, 300)]).astype(np.int64)
    got = tb.lookup_store_fused(
        tb.prepare_store([t[0] for t in tiers], bloom_of(tb)), q)
    want = nb.lookup_store_fused(
        nb.prepare_store([t[1] for t in tiers], bloom_of(nb)), q)
    assert_fields(got, want, FIELDS + ("win",))
    assert got.hit.any()
    for pt, rt in tiers:
        assert_fields(tb.lookup_fused(tb.prepare_tier(pt, bloom_of(tb)), q),
                      nb.lookup_fused(nb.prepare_tier(rt, bloom_of(nb)), q))


# --------------------------- (b) plain versions, property -------------------
def _random_tier(data, rng, lo, hi):
    """Ragged tables over sorted unique keys in [lo, hi), each with a random
    slot count and random filter bits."""
    n_tables = data.draw(st.integers(1, 5))
    lens = [data.draw(st.integers(1, 40)) for _ in range(n_tables)]
    pool = np.unique(rng.integers(lo, hi, 2 * sum(lens)))
    keys = np.sort(rng.choice(pool, sum(lens), replace=False))
    nslots = [128 * data.draw(st.integers(1, 12)) for _ in range(n_tables)]
    fbits = rng.random(sum(nslots)) < 0.8
    return keys, rng.integers(-2**62, 2**62, len(keys)), lens, nslots, fbits


def _np_payload(keys, vals, lens, nslots, fbits):
    lens, nslots = np.array(lens, np.int64), np.array(nslots, np.int64)
    offs = np.cumsum(lens) - lens
    starts = keys[offs]
    ends = keys[offs + lens - 1]
    return starts, ends, offs, lens, {
        "keys": keys, "vals": vals, "fbits": fbits,
        "f_offs": np.cumsum(nslots) - nslots, "nslots": nslots}


def _torch_view(p, offs, lens, starts, ends, t_off):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return lookup_k.View(T(p["keys"]), T(p["vals"]), T(p["fbits"]),
                         [p["f_offs"], p["nslots"], offs, lens, starts,
                          ends], t_off)


def _assert_lookup(got: dict, want, store: bool):
    """The plain version's fields, widened, against a reference lookup."""
    for f in ("positive", "hit", "ok", "pos", "ti", "vals"):
        g = got[f]
        if not store:
            g = g[0]
        np.testing.assert_array_equal(g.numpy().astype(getattr(want,
                                                               f).dtype),
                                      getattr(want, f), err_msg=f)
    if store:
        np.testing.assert_array_equal(got["win"].numpy(), want.win)


@settings(database=None, max_examples=40, deadline=None)
@given(st.data(), st.integers(0, 2**32 - 1), st.integers(1, 4))
def test_property_plain_versions_match_numpy_math(data, seed, n_tiers):
    """``probe_tier_plain``/``probe_store_plain`` against the numpy
    backend's fused math, assignment included: per-query slot counts,
    ragged tables, keys over the whole int64 range, tiers that overlap
    each other."""
    rng = np.random.default_rng(seed)
    nb = NumpyBackend()
    tiers = [_random_tier(data, rng, -2**40, 2**40) for _ in range(n_tiers)]
    allk = np.concatenate([t[0] for t in tiers])
    q = np.concatenate([rng.choice(allk, 50),
                        rng.integers(-2**41, 2**41, 50)]).astype(np.int64)
    qt = torch.from_numpy(q)
    for keys, vals, lens, nslots, fbits in tiers:
        starts, ends, offs, ln, p = _np_payload(keys, vals, lens, nslots,
                                                fbits)
        want = nb.lookup_fused(RefTierView("numpy", tuple(range(len(ln))),
                                           starts, ends, offs, ln, p), q)
        view = _torch_view(p, offs, ln, starts, ends, [0, len(ln)])
        got = lookup_k.probe_tier_plain(view, qt, K_HASHES)
        _assert_lookup(lookup_k.unpack(got, 1, len(q), False), want, False)
    # The same tiers stacked tier-major into one store view.
    cat = [_np_payload(*t) for t in tiers]
    counts = np.array([len(c[3]) for c in cat], np.int64)
    n_ent = np.array([len(t[0]) for t in tiers], np.int64)
    base = np.cumsum(n_ent) - n_ent
    offs = np.concatenate([c[2] + b for c, b in zip(cat, base)])
    lens = np.concatenate([c[3] for c in cat])
    nslots = np.concatenate([c[4]["nslots"] for c in cat])
    p = {"keys": np.concatenate([t[0] for t in tiers]),
         "vals": np.concatenate([t[1] for t in tiers]),
         "fbits": np.concatenate([t[4] for t in tiers]),
         "f_offs": np.cumsum(nslots) - nslots, "nslots": nslots,
         "t_off": np.cumsum(counts) - counts}
    t_off = p["t_off"]
    sview = RefStoreView(
        "numpy", tuple(tuple(range(c)) for c in counts),
        tuple(c[0] for c in cat), tuple(c[1] for c in cat),
        tuple(offs[t_off[r]:t_off[r] + counts[r]] for r in range(n_tiers)),
        tuple(c[3] for c in cat), p)
    want = nb.lookup_store_fused(sview, q)
    view = _torch_view(p, offs, lens, np.concatenate([c[0] for c in cat]),
                       np.concatenate([c[1] for c in cat]),
                       np.append(t_off, len(lens)))
    got = lookup_k.probe_store_plain(view, qt, K_HASHES)
    _assert_lookup(lookup_k.unpack(got, n_tiers, len(q), True), want, True)


def test_lookup_wrappers_take_the_plain_version_only_on_cpu(backends):
    tb = backends[0]
    pt, _ = make_tier(np.random.default_rng(3), 2)
    view = tb.prepare_tier(pt, bloom_of(tb)).payload
    store = tb.prepare_store([pt, pt[:1]], bloom_of(tb)).payload
    q = torch.arange(10, dtype=torch.int64)
    before = dict(LAUNCHES)
    lookup_k.probe_tier(view, q, K_HASHES)
    lookup_k.probe_store(store, q, K_HASHES)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="int64"):
        lookup_k.probe_tier(view, q.int(), K_HASHES)
    with pytest.raises(ValueError, match="one-tier view"):
        lookup_k.probe_tier(store, q, K_HASHES)
    with pytest.raises(ValueError, match="no kernel for device"):
        lookup_k.View(view.keys.to("meta"), view.vals.to("meta"),
                      view.fbits.to("meta"),
                      [getattr(view, n).numpy() for n in lookup_k.META_ROWS],
                      [0, view.n_tables])


# --------------------------- (c) store and service vs the reference ---------
def drive_store(store, batches=60, read_tail=10, key_max=30_000, seed=0):
    """Mixed churn (flushes and merges retire SSTables under the pool),
    then a read-only tail (tiers settle, the pool warms, fused serves)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(batches):
        ks = rng.integers(0, key_max, 256)
        if i % 3 != 2:
            store.write_batch("t", ks, ks * 3)
        out.append(store.read_batch("t", rng.integers(0, key_max, 256)))
    for _ in range(read_tail):
        out.append(store.read_batch("t", rng.integers(0, key_max, 256)))
    return out


def pool_kw(scheme="partitioned", **kw):
    return dict(small_kw(scheme, "opt"), **kw)


def port_store(**kw):
    port_reset()
    s = port.LSMStore(port.StoreConfig(device="cpu", **pool_kw(**kw)))
    s.create_tree("t")
    return s


def ref_store(backend="numpy", **kw):
    ref_reset()
    s = ref.LSMStore(ref.StoreConfig(backend=backend, **pool_kw(**kw)))
    s.create_tree("t")
    return s


def same_outputs(o0, o1):
    assert len(o0) == len(o1)
    for (f0, v0), (f1, v1) in zip(o0, o1):
        np.testing.assert_array_equal(f0, f1)
        np.testing.assert_array_equal(v0, v1)


def assert_store_identical(p, r):
    """Everything but the outputs: structure, IOStats (fused_* included),
    buffer-cache counts, pool state, WAL bytes, manifest edits."""
    assert fingerprint(p) == fingerprint(r)
    assert vars(p.disk.stats) == vars(r.disk.stats)
    assert (p.disk.cache.hits, p.disk.cache.misses) \
        == (r.disk.cache.hits, r.disk.cache.misses)
    assert p.device_pool.stats() == r.device_pool.stats()
    assert ([port_encode(x) for x in p.wal.records()]
            == [ref_encode(x) for x in r.wal.records()])
    assert ([vars(e) for e in p.manifest.edits]
            == [vars(e) for e in r.manifest.edits])


@pytest.mark.parametrize("scope", ["store", "tier"])
@pytest.mark.parametrize("scheme", ["partitioned", "accordion-data"])
def test_store_pool_bit_identical_to_reference(scheme, scope):
    kw = dict(scheme=scheme, device_pool_bytes=32 * MB, fused_scope=scope)
    p, r = port_store(**kw), ref_store(**kw)
    same_outputs(drive_store(p), drive_store(r))
    assert_store_identical(p, r)
    st_ = p.device_pool.stats()
    assert st_["tier_hits"] > 0
    assert (st_["store_hits"] > 0) == (scope == "store")


def test_store_pool_bit_identical_to_pallas_reference():
    kw = dict(device_pool_bytes=32 * MB, fused_scope="store")
    p, r = port_store(**kw), ref_store("pallas", **kw)
    same_outputs(drive_store(p, batches=16), drive_store(r, batches=16))
    assert_store_identical(p, r)
    assert p.device_pool.stats()["store_hits"] > 0


@pytest.mark.parametrize("scope", ["store", "tier"])
@pytest.mark.parametrize("scheme", ["partitioned", "accordion-data"])
def test_service_pool_bit_identical_to_reference(scheme, scope):
    kw = pool_kw(scheme, device_pool_bytes=32 * MB, fused_scope=scope)
    steps = gen_stream(sum(map(ord, scheme + scope)), 60)
    r_svc, r_out = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                       steps)
    p_svc, p_out = run(port, port_reset, port.StoreConfig(device="cpu", **kw),
                       steps)
    assert p_out == r_out
    assert vars(p_svc.stats) == vars(r_svc.stats)
    assert_store_identical(p_svc.store, r_svc.store)
    assert p_svc.store.device_pool.stats()["tier_hits"] > 0


# --------------------------- (d) pool on vs pool off in the port ------------
def _io_stats(s):
    """IOStats without the ``fused_*`` counters, which record which path
    served, not I/O."""
    return {k: v for k, v in vars(s.disk.stats).items()
            if not k.startswith("fused_")}


def assert_same_as_staged(s0, o0, s1, o1):
    same_outputs(o0, o1)
    assert _io_stats(s0) == _io_stats(s1)
    assert (s0.disk.cache.hits, s0.disk.cache.misses) \
        == (s1.disk.cache.hits, s1.disk.cache.misses)
    assert fingerprint(s0) == fingerprint(s1)


@pytest.mark.parametrize("scope", ["store", "tier"])
def test_pool_on_equals_pool_off(scope):
    s0 = port_store()
    o0 = drive_store(s0)
    s1 = port_store(device_pool_bytes=32 * MB, fused_scope=scope)
    o1 = drive_store(s1)
    assert_same_as_staged(s0, o0, s1, o1)
    assert s1.disk.stats.fused_launches > 0 == s0.disk.stats.fused_launches


# --------------------------- (e) twins of the reference's tests -------------
def test_store_scope_reads_before_any_flush():
    """Reads served from the memory component alone (no disk tier yet)
    take the store path's empty branch without touching the pool."""
    s = port_store(device_pool_bytes=32 * MB)
    ks = np.arange(100, dtype=np.int64)
    s.write_batch("t", ks, ks + 1)
    f, v = s.read_batch("t", np.arange(200, dtype=np.int64))
    assert f[:100].all() and not f[100:].any()
    np.testing.assert_array_equal(v[:100], ks + 1)
    st_ = s.device_pool.stats()
    assert st_["store_hits"] == 0 and st_["store_misses"] == 0


def test_budget_shrink_races_prepare_store():
    """A budget shrink that lands while prepare_store is staging: the
    acquire returns None and caches nothing."""
    s = port_store(device_pool_bytes=32 * MB)
    drive_store(s, batches=30, read_tail=4)
    pool, t = s.device_pool, s.trees["t"]
    tiers = [x for x in t.l0.lookup_tiers() + t.levels.lookup_tiers() if x]
    assert tiers
    pool._views.clear()                   # force a fresh prepare
    calls = {"n": 0}

    def tripwire(sst):
        calls["n"] += 1
        if calls["n"] == 1:               # shrink lands mid-prepare
            pool.set_budget_bytes(16 * MB)
        return t._bloom(sst)

    assert pool.acquire_store(tiers, tripwire) is None
    assert not pool._views, "stale store view cached across a shrink"
    view = pool.acquire_store(tiers, t._bloom) \
        or pool.acquire_store(tiers, t._bloom)
    assert view is not None and pool._views


def test_shrink_mid_workload_falls_back_staged():
    """Shrinking and then disabling the budget mid-run leaves results and
    accounting identical to a staged-only twin."""
    s0 = port_store()
    s1 = port_store(device_pool_bytes=32 * MB)
    rng0, rng1 = (np.random.default_rng(4) for _ in range(2))
    outs = [[], []]
    for i in range(60):
        for s, rng, out in ((s0, rng0, outs[0]), (s1, rng1, outs[1])):
            ks = rng.integers(0, 30_000, 256)
            if i % 3 != 2:
                s.write_batch("t", ks, ks * 3)
            out.append(s.read_batch("t", rng.integers(0, 30_000, 256)))
        if i == 30:
            assert s1.device_pool.stats()["resident_pages"] > 16
            s1.set_device_pool_bytes(16 * 4 * KB)   # violent shrink
            assert s1.device_pool.stats()["resident_pages"] <= 16
        if i == 45:
            s1.set_device_pool_bytes(0)             # disable entirely
            assert not s1.device_pool.enabled
    assert_same_as_staged(s0, outs[0], s1, outs[1])
    assert s1.disk.stats.fused_launches > 0


def test_drop_sst_invalidates_pages_and_views():
    s = port_store(device_pool_bytes=32 * MB)
    drive_store(s, batches=60, read_tail=8)
    pool = s.device_pool
    assert pool.stats()["tier_hits"] > 0
    live = {sst.sst_id for t in s.trees.values()
            for tier in t.l0.lookup_tiers() + t.levels.lookup_tiers()
            for sst in tier}
    assert pool._views
    for key in pool._views:
        assert set(pool._key_ssts(key)) <= live, \
            "view over a retired SSTable survived"
    tier = next(t for t in s.trees["t"].levels.lookup_tiers() if t)
    sst = tier[0]
    before = pool.stats()["resident_pages"]
    s.disk.drop_sst(sst)
    assert pool.stats()["resident_pages"] < before
    assert all(sst.sst_id not in pool._key_ssts(key) for key in pool._views)


def test_bloom_memoized_and_invalidated():
    s = port_store()
    t = s.trees["t"]
    drive_store(s, batches=40, read_tail=2)
    tier = next(x for x in t.levels.lookup_tiers() if x)
    assert t._bloom(tier[0]) is t._bloom(tier[0])
    drive_store(s, batches=40, read_tail=0, seed=1)
    live = {sst.sst_id for x in t.l0.lookup_tiers() + t.levels.lookup_tiers()
            for sst in x}
    assert set(t._bloom_cache) <= live, "stale Bloom memo entries"


def test_memory_plan_actuates_device_pool_budget():
    class PinPool(MemoryGovernor):
        def observe(self, service):
            return MemoryPlan(device_pool_bytes=8 * MB, note="test-pin")

    port_reset()
    svc = port.StorageService(
        port.LSMStore(port.StoreConfig(device="cpu", **pool_kw())),
        governor=PinPool())
    svc.create_tree("t")
    assert not svc.store.device_pool.enabled
    ks = np.arange(256, dtype=np.int64)
    svc.submit_strict([port.Put("t", ks, ks)])
    assert svc.store.device_pool.budget_bytes == 8 * MB
    assert svc.store.device_pool.enabled


def _governed(pkg, reset, gov, cfg):
    reset()
    svc = pkg.StorageService(pkg.LSMStore(cfg), governor=gov)
    svc.create_tree("t")
    rng = np.random.default_rng(0)
    for i in range(45):
        ks = rng.integers(0, 30_000, 256)
        if i % 3 != 2:
            svc.submit_strict([pkg.Put("t", ks, ks * 3)])
        svc.submit_strict([pkg.Get("t", rng.integers(0, 30_000, 256))])
    return svc


def test_device_pool_governor_grows_on_misses_like_reference():
    kw = dict(min_bytes=1 * MB, max_bytes=8 * MB, ops_cycle=256)
    gov, rgov = DevicePoolGovernor(**kw), RefPoolGovernor(**kw)
    cfg = pool_kw(device_pool_bytes=1 * MB)
    svc = _governed(port, port_reset, gov,
                    port.StoreConfig(device="cpu", **cfg))
    rsvc = _governed(ref, ref_reset, rgov,
                     ref.StoreConfig(backend="numpy", **cfg))
    assert svc.store.device_pool.budget_bytes > 1 * MB
    assert gov.records and gov.records == rgov.records
    assert svc.store.device_pool.stats() == rsvc.store.device_pool.stats()
    assert vars(svc.store.disk.stats) == vars(rsvc.store.disk.stats)


class _StubPool:
    def __init__(self, budget=8 * MB):
        self.budget_bytes = budget
        self.st = dict(tier_hits=0, tier_misses=0, store_hits=0,
                       store_misses=0, resident_pages=0,
                       capacity_pages=4096)

    def stats(self):
        return dict(self.st)


def _replay_governor(cls, cycles):
    """Feed one governor a stream of synthetic (hits, misses, resident)
    decision windows, applying each plan as the service would; returns
    the budgets after each window and the governor's records."""
    pool = _StubPool()
    gov = cls(min_bytes=1 * MB, max_bytes=64 * MB, ops_cycle=256,
              deadband=0.15, min_dwell=2)
    disk = SimpleNamespace(stats=SimpleNamespace(ops=0))
    svc = SimpleNamespace(store=SimpleNamespace(disk=disk, device_pool=pool))
    gov.attach(svc.store)
    budgets = []
    for hits, misses, resident in cycles:
        pool.st["tier_hits"] += hits
        pool.st["tier_misses"] += misses
        pool.st["resident_pages"] = resident
        disk.stats.ops += gov.ops_cycle
        plan = gov.observe(svc)
        if plan is not None and plan.device_pool_bytes is not None:
            pool.budget_bytes = plan.device_pool_bytes
        budgets.append(pool.budget_bytes)
    return budgets, gov.records


@pytest.mark.parametrize("stream", ["deadband", "dwell", "alternation"])
def test_device_pool_governor_matches_reference(stream):
    cycles = {
        "deadband": [(100, 100, 100), (110, 90, 100), (90, 110, 100),
                     (104, 96, 100), (96, 104, 100), (100, 100, 100)],
        "dwell": [(20, 180, 0), (180, 20, 10), (180, 20, 10)],
        "alternation": [((20, 180) if i % 2 == 0 else (180, 20)) + (10,)
                        for i in range(12)],
    }[stream]
    budgets, records = _replay_governor(DevicePoolGovernor, cycles)
    assert (budgets, records) == _replay_governor(RefPoolGovernor, cycles)
    if stream == "deadband":              # holds inside the band
        assert set(budgets) == {8 * MB} and not records
    elif stream == "dwell":               # one blip is held, then shrinks
        assert budgets == [16 * MB, 16 * MB, 8 * MB]
        assert [r["held"] for r in records] == [False, True, False]
    else:                                 # never bounces A -> B -> A
        steps = [b for i, b in enumerate(budgets)
                 if i == 0 or b != budgets[i - 1]]
        for a, b, c in zip(steps, steps[1:], steps[2:]):
            assert not (a == c and a != b), f"bounced {a}->{b}->{c}"


@pytest.mark.parametrize("knob,value", [("device_pool_bytes", -1),
                                        ("fused_scope", "bogus")])
def test_pool_knobs_validated(knob, value):
    with pytest.raises(ValueError, match=knob):
        port.StoreConfig(device="cpu", **{knob: value}).validate()
    with pytest.raises(ValueError, match=knob):
        ref.StoreConfig(**{knob: value}).validate()
    port.StoreConfig(device="cpu", device_pool_bytes=1 << 20,
                     fused_scope="tier").validate()
