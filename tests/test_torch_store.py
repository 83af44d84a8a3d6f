"""The port's storage service against the reference, end to end on the
CPU: the same seeded op streams (Put/Get/Delete/Scan submits, forced
ticks and flushes) go through ``repro.core.StorageService`` on the numpy
backend and through ``repro_torch.core.StorageService`` on the torch
backend with ``device="cpu"``. Store structure, every result, IOStats,
WAL record bytes and manifest edits must be bit-identical. Also checks
the port's device rules and the knobs it rejects."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_differential import fingerprint  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.core.durability.wal import encode_record as ref_encode  # noqa: E402
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro_torch.core.durability.wal import encode_record as port_encode  # noqa: E402
from repro_torch.core.engine import (available_backends,  # noqa: E402
                                     get_backend)
from repro_torch.core.lsm.sstable import reset_sst_ids as port_reset  # noqa: E402

KB, MB = 1 << 10, 1 << 20
TREES = ("a", "b")


def small_kw(scheme, policy):
    # The differential suite's small store: short streams exercise seals,
    # memory merges, flushes and L0/level merges.
    return dict(total_memory_bytes=32 * MB, write_memory_bytes=256 * KB,
                sim_cache_bytes=1 * MB, page_bytes=4 * KB, entry_bytes=256,
                active_sstable_bytes=32 * KB, sstable_bytes=64 * KB,
                max_log_bytes=8 * MB, scheme=scheme, flush_policy=policy)


def gen_stream(seed, n_steps):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        r = rng.random()
        tree = TREES[int(rng.random() < 0.3)]
        if r < 0.80:
            n = int(rng.integers(20, 300))
            steps.append(("submit", tree, rng.integers(0, 3000, 60),
                          int(rng.integers(0, 3000)), int(rng.integers(5, 300)),
                          rng.integers(0, 3000, n),
                          rng.integers(0, 2**40, n),
                          rng.integers(0, 3000, int(rng.integers(0, 40)))))
        elif r < 0.90:
            steps.append(("tick",))
        else:
            steps.append(("flush", tree))
    return steps


def run(pkg, reset, cfg, steps):
    reset()
    svc = pkg.StorageService.open(cfg)
    for t in TREES:
        svc.create_tree(t)
    outs = []
    for st in steps:
        if st[0] == "submit":
            _, tree, gk, lo, width, pk, pv, dk = st
            res = svc.submit([pkg.Get(tree, gk), pkg.Scan(tree, lo, width),
                              pkg.Put(tree, pk, pv), pkg.Delete(tree, dk),
                              pkg.Get(TREES[1 - TREES.index(tree)], gk)])
            for r in res:
                if hasattr(r, "found"):
                    outs.append(("get", r.found.tobytes(), r.vals.tobytes()))
                elif hasattr(r, "count"):
                    outs.append(("scan", r.count))
                else:
                    outs.append((type(r).__name__, getattr(r, "n", None),
                                 getattr(r, "reason", None)))
        elif st[0] == "tick":
            svc.store.scheduler.tick()
        else:
            t = svc.store.trees[st[1]]
            if not t.mem.is_empty():
                svc.store.scheduler.flush_tree(t, trigger="mem")
    return svc, outs


@pytest.mark.parametrize("policy", ["mem", "lsn", "opt"])
@pytest.mark.parametrize("scheme", ["partitioned", "btree-dynamic",
                                    "accordion-data"])
def test_service_bit_identical_to_reference(scheme, policy):
    steps = gen_stream(sum(map(ord, scheme + policy)), 60)
    kw = small_kw(scheme, policy)
    r_svc, r_out = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                       steps)
    p_svc, p_out = run(port, port_reset, port.StoreConfig(device="cpu", **kw),
                       steps)
    assert p_svc.store.backend.name == "torch"
    assert p_out == r_out
    assert fingerprint(p_svc.store) == fingerprint(r_svc.store)
    assert vars(p_svc.stats) == vars(r_svc.stats)
    assert p_svc.stats.flushes_mem + p_svc.stats.flushes_log > 0
    assert ([port_encode(r) for r in p_svc.store.wal.records()]
            == [ref_encode(r) for r in r_svc.store.wal.records()])
    assert ([vars(e) for e in p_svc.store.manifest.edits]
            == [vars(e) for e in r_svc.store.manifest.edits])
    assert len(p_svc.store.manifest.checkpoints) \
        == len(r_svc.store.manifest.checkpoints)


@pytest.mark.parametrize("scheme", ["partitioned", "accordion-data"])
def test_log_triggered_flushes_bit_identical_to_reference(scheme):
    # A small log cap makes log-triggered flushes (min-LSN partial flushes
    # of the partitioned component) part of the stream.
    kw = dict(small_kw(scheme, "opt"), max_log_bytes=192 * KB)
    steps = gen_stream(5, 60)
    r_svc, r_out = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                       steps)
    p_svc, p_out = run(port, port_reset, port.StoreConfig(device="cpu", **kw),
                       steps)
    assert p_svc.stats.flushes_log > 0
    assert p_out == r_out
    assert fingerprint(p_svc.store) == fingerprint(r_svc.store)
    assert vars(p_svc.stats) == vars(r_svc.stats)
    assert ([port_encode(r) for r in p_svc.store.wal.records()]
            == [ref_encode(r) for r in r_svc.store.wal.records()])


def test_paced_service_bit_identical_to_reference():
    kw = dict(small_kw("partitioned", "opt"), pacer_interval_bytes=64 * KB,
              pacer_flush_threshold=0.5, merge_budget=2)
    steps = gen_stream(11, 50)
    r_svc, r_out = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                       steps)
    p_svc, p_out = run(port, port_reset, port.StoreConfig(device="cpu", **kw),
                       steps)
    assert p_out == r_out
    assert fingerprint(p_svc.store) == fingerprint(r_svc.store)
    assert vars(p_svc.stats) == vars(r_svc.stats)
    assert p_svc.pacer.slices == r_svc.pacer.slices > 0


# --------------------------- staged Bloom gate: one call per tier -----------
def test_staged_reads_probe_each_tier_once_per_batch(monkeypatch):
    # The staged path (pool off) gates a tier's tables in one backend call
    # per (tier, Get batch): one call wherever the reference's per-table
    # loop probes at least one table, the same tables as its per-table
    # calls, and everything else bit-identical.
    from repro.core.engine import NumpyBackend as RefNumpy
    from repro_torch.core.engine.torch_backend import TorchBackend
    from repro_torch.core.lsm import sstable as port_sstable
    from repro_torch.core.lsm import tree as port_tree
    seen = {"pairs": 0, "tier_calls": 0, "tables": 0, "single": 0,
            "ref_tables": 0}

    def pairs(tables, keys, found, vals, unresolved, lookup_batch, **kw):
        if kw.get("bloom_gate") is not None and tables:
            _, ok = port_sstable.assign_queries(tables,
                                                 keys[unresolved])
            seen["pairs"] += bool(ok.any())
        return port_sstable.probe_tier(tables, keys, found, vals,
                                       unresolved, lookup_batch, **kw)

    def counting(cls, name, key, per_call):
        fn = getattr(cls, name)

        def wrapped(self, *a):
            seen[key] += per_call(*a)
            return fn(self, *a)
        monkeypatch.setattr(cls, name, wrapped)

    monkeypatch.setattr(port_tree, "probe_tier", pairs)
    counting(TorchBackend, "bloom_probe_tier", "tier_calls", lambda *a: 1)
    counting(TorchBackend, "bloom_probe_tier", "tables",
             lambda fs, *a: len(fs))
    counting(TorchBackend, "bloom_probe", "single", lambda *a: 1)
    counting(RefNumpy, "bloom_probe", "ref_tables", lambda *a: 1)
    steps = gen_stream(23, 60)
    kw = small_kw("partitioned", "opt")
    r_svc, r_out = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                       steps)
    p_svc, p_out = run(port, port_reset, port.StoreConfig(device="cpu", **kw),
                       steps)
    assert p_out == r_out
    assert fingerprint(p_svc.store) == fingerprint(r_svc.store)
    assert vars(p_svc.store.disk.stats) == vars(r_svc.store.disk.stats)
    assert (p_svc.store.disk.cache.hits, p_svc.store.disk.cache.misses) \
        == (r_svc.store.disk.cache.hits, r_svc.store.disk.cache.misses)
    assert ([port_encode(r) for r in p_svc.store.wal.records()]
            == [ref_encode(r) for r in r_svc.store.wal.records()])
    assert seen["tier_calls"] == seen["pairs"] > 0
    assert seen["tables"] == seen["ref_tables"] > seen["tier_calls"]
    assert seen["single"] == 0


def test_tier_probe_mixes_negative_and_positive_tables(monkeypatch):
    # One Get batch whose tier probe is all-negative for some tables (keys
    # never written, Bloom-negative there) and positive for others: the
    # port skips the same tables' binary searches as the reference's
    # per-table loop, with the same results, page pins and IOStats.
    from repro.core.engine import NumpyBackend as RefNumpy
    from repro_torch.core.engine.torch_backend import TorchBackend
    calls = []
    fn = TorchBackend.bloom_probe_tier

    def recording(self, filts, keys, tidx):
        out = fn(self, filts, keys, tidx)
        calls.append((np.asarray(tidx).copy(), out.copy()))
        return out
    monkeypatch.setattr(TorchBackend, "bloom_probe_tier", recording)
    kw = small_kw("partitioned", "opt")
    stores = []
    for pkg, reset, cfg in (
            (ref, ref_reset, ref.StoreConfig(backend="numpy", **kw)),
            (port, port_reset, port.StoreConfig(device="cpu", **kw))):
        reset()
        st = pkg.LSMStore(cfg)
        st.create_tree("t")
        rng = np.random.default_rng(3)
        for _ in range(60):
            ks = rng.integers(0, 20_000, 256) * 2       # even keys only
            st.write_batch("t", ks, ks * 3)
        st.scheduler.flush_tree(st.trees["t"], trigger="mem")
        stores.append(st)
    r_st, p_st = stores
    tier = max(p_st.trees["t"].levels.lookup_tiers(), key=len)
    assert len(tier) >= 3
    nb = RefNumpy()
    odd = np.arange(tier[0].min_key + 1, tier[0].max_key, 2)
    neg = odd[~nb.bloom_probe(nb.bloom_build(tier[0].keys), odd)][:40]
    q = np.concatenate([neg, tier[1].keys[::3], tier[2].keys[::5]])
    calls.clear()
    got = p_st.read_batch("t", q)
    want = r_st.read_batch("t", q)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0][len(neg):].any() and not got[0][:len(neg)].any()
    assert vars(p_st.disk.stats) == vars(r_st.disk.stats)
    assert (p_st.disk.cache.hits, p_st.disk.cache.misses) \
        == (r_st.disk.cache.hits, r_st.disk.cache.misses)
    assert fingerprint(p_st) == fingerprint(r_st)
    mixed = [(t, m) for t, m in calls
             if any(not m[t == i].any() for i in np.unique(t))
             and any(m[t == i].any() for i in np.unique(t))]
    assert mixed, "no tier probe was negative for one table and positive " \
                  "for another"


# --------------------------- device rules ------------------------------------
@pytest.mark.parametrize("knobs,slice_name", [
    ({"wal_async_fsync": True, "fsync_policy": "group"},
     "async-commit slice"),
    ({"maintenance_workers": -1}, "maintenance_workers must be >= 0"),
])
def test_rejected_knobs_name_their_slice(knobs, slice_name):
    with pytest.raises(ValueError, match=slice_name):
        port.StoreConfig(device="cpu", **knobs).validate()


def test_files_medium_is_accepted(tmp_path):
    """The files medium opens a store whose writes reach real files."""
    cfg = port.StoreConfig(device="cpu", storage_medium="files",
                           storage_dir=str(tmp_path))
    svc = port.StorageService.open(cfg.validate())
    svc.create_tree("t")
    svc.submit_strict([port.Put("t", np.arange(8))])
    assert svc.store.disk.page_store is not None
    assert svc.stats.fsyncs > 0
    assert sorted(os.listdir(tmp_path)) == ["MANIFEST", "sst", "wal"]


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port.StorageService.open(port.StoreConfig())
    with pytest.raises(RuntimeError, match="is_available"):
        port.StorageService.open(port.StoreConfig(backend="torch"))


def test_backend_defaults_to_torch_and_ignores_env(monkeypatch):
    monkeypatch.setenv("REPRO_LSM_BACKEND", "pallas")
    assert get_backend(None, "cpu").name == "torch"
    svc = port.StorageService.open(port.StoreConfig(device="cpu"))
    assert svc.store.backend.name == "torch"
    assert str(svc.store.backend.device) == "cpu"
    assert available_backends() == ("torch",)
    for name in ("numpy", "pallas"):
        with pytest.raises(ValueError, match="unknown LSM backend"):
            get_backend(name, "cpu")
        with pytest.raises(ValueError, match="unknown backend"):
            port.StoreConfig(device="cpu", backend=name).validate()
