"""The port's sharded data plane against the reference, on the CPU.

Twins of ``tests/test_sharded.py``: the same seeded op streams go through
``repro``'s ``ShardedStore`` (numpy backend) and ``repro_torch``'s
(``device="cpu"``), every read against a dict oracle. ``shards=1`` must be
bit-identical to the port's own ``LSMStore`` and to the reference's
``ShardedStore``; shards 2 and 4 must match the oracle, conserve the
shared IOStats and equal the reference bit for bit (state, results,
IOStats, WAL bytes). Also the router (hash and range kinds, the same
Fibonacci constant), the global enforcement of log and memory, and the
hot-shard deferral of the service's admission gate.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_differential import (KB, KEY_SPACE, MB, TREES,  # noqa: E402
                               _batch_keys, fingerprint, gen_ops,
                               gen_request_batches)

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.core.durability.wal import encode_record as ref_encode  # noqa: E402
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro.core.shard import ShardRouter as RefRouter  # noqa: E402
from repro_torch.core.durability.wal import encode_record as port_encode  # noqa: E402
from repro_torch.core.lsm.sstable import reset_sst_ids as port_reset  # noqa: E402
from repro_torch.core.service import (Deferred, Put,  # noqa: E402
                                      ServiceConfig, StorageService,
                                      WriteAck)
from repro_torch.core.shard import ShardedStore, ShardRouter  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

PKGS = {"port": (port, port_reset), "ref": (ref, ref_reset)}


def small_config(pkg, scheme="partitioned", policy="lsn"):
    """``test_differential.small_config`` for either package."""
    kw = dict(total_memory_bytes=32 * MB, write_memory_bytes=256 * KB,
              sim_cache_bytes=1 * MB, page_bytes=4 * KB, entry_bytes=256,
              active_sstable_bytes=32 * KB, sstable_bytes=64 * KB,
              max_log_bytes=8 * MB, scheme=scheme, flush_policy=policy)
    if pkg is port:
        return port.StoreConfig(device="cpu", **kw)
    return ref.StoreConfig(backend="numpy", **kw)


def router_for(pkg, router):
    """The same router spec in the other package."""
    if router is None or pkg is port:
        return router
    return RefRouter(router.n_shards, kind=router.kind,
                     boundaries=router.boundaries)


def replay(ops, *, which="port", shards=None, router=None,
           scheme="partitioned", policy="lsn"):
    """``test_sharded.replay_sharded`` (``shards=None``: a bare ``LSMStore``,
    ``test_differential.replay``) on either package. Asserts every read
    against the dict oracle; returns (store, outputs)."""
    pkg, reset = PKGS[which]
    reset()
    cfg = small_config(pkg, scheme, policy)
    if shards is None:
        store = pkg.LSMStore(cfg)
    else:
        store = pkg.ShardedStore(cfg, shards=shards,
                                 router=router_for(pkg, router))
    for t in TREES:
        store.create_tree(t)
    ctrl = pkg.AdaptiveMemoryController(store, pkg.TunerConfig(
        min_step_bytes=64 * KB, min_write_mem=1 * MB, ops_cycle=10**9))
    oracle = {t: {} for t in TREES}
    outputs = []
    for op in ops:
        kind = op[0]
        if kind == "write":
            _, t, seed, size = op
            ks, vs = _batch_keys(seed, size)
            store.write_batch(t, ks, vs, tick=False)
            store.scheduler.tick()
            oracle[t].update(zip(ks.tolist(), vs.tolist()))
        elif kind == "delete":
            _, t, seed, size = op
            ks, _ = _batch_keys(seed, size)
            store.delete_batch(t, ks, tick=False)
            store.scheduler.tick()
            for k in ks.tolist():
                oracle[t][k] = None
        elif kind == "lookup":
            _, t, seed, size = op
            rng = np.random.default_rng(seed)
            ks = rng.integers(0, KEY_SPACE + 500, size=size)
            found, vals = store.read_batch(t, ks)
            for i, k in enumerate(ks.tolist()):
                want = oracle[t].get(k)
                assert bool(found[i]) == (want is not None), (t, k)
                if want is not None:
                    assert int(vals[i]) == want, (t, k)
            outputs.append(("lookup", found.tolist(), vals.tolist()))
        elif kind == "scan":
            _, t, lo, width = op
            n = store.scan(t, lo, width)
            want = sum(1 for k, v in oracle[t].items()
                       if lo <= k < lo + width and v is not None)
            assert n == want, (t, lo, width)
            outputs.append(("scan", n))
        elif kind == "flush":
            for s in (store.shards if shards is not None else [None]):
                st_ = store if s is None else s.store
                tree = st_.trees[op[1]]
                if not tree.mem.is_empty():
                    st_.scheduler.flush_tree(tree, trigger="mem")
        elif kind == "tick":
            store.scheduler.tick()
        elif kind == "tune":
            ctrl.tune_now()
    return store, outputs


def shard_fingerprints(store):
    return [fingerprint(sh.store) for sh in store.shards]


def assert_conserved(store):
    """All shards account through ONE shared Disk: per-shard counter sums
    equal the global counters exactly."""
    agg = store.shard_tree_stats()
    st_ = store.disk.stats
    assert sum(a["entries_written"] for a in agg) == st_.entries_written
    assert sum(a["bytes_flushed_mem"] for a in agg) == st_.bytes_flushed_mem
    assert sum(a["bytes_flushed_log"] for a in agg) == st_.bytes_flushed_log
    assert sum(a["merge_pages_written"] for a in agg) \
        == st_.pages_merge_written
    assert sum(a["mem_bytes"] for a in agg) == store.write_memory_used()


def assert_same_as_reference(p_store, p_out, r_store, r_out):
    assert p_out == r_out
    assert shard_fingerprints(p_store) == shard_fingerprints(r_store)
    assert vars(p_store.disk.stats) == vars(r_store.disk.stats)
    assert p_store.shard_tree_stats() == r_store.shard_tree_stats()
    assert ([port_encode(x) for x in p_store.wal.records()]
            == [ref_encode(x) for x in r_store.wal.records()])


# --------------------------- shards=1 bit-identity ----------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme", ["partitioned", "btree-dynamic",
                                    "accordion-data"])
def test_one_shard_bit_identical_to_lsmstore(seed, scheme):
    ops = gen_ops(np.random.default_rng(seed))
    direct, out_d = replay(ops, scheme=scheme)
    sharded, out_s = replay(ops, shards=1, scheme=scheme)
    assert out_d == out_s
    assert fingerprint(direct) == fingerprint(sharded.shards[0].store)
    assert vars(direct.disk.stats) == vars(sharded.disk.stats)
    r_store, r_out = replay(ops, which="ref", shards=1, scheme=scheme)
    assert_same_as_reference(sharded, out_s, r_store, r_out)


@pytest.mark.parametrize("policy", ["mem", "opt"])
def test_one_shard_bit_identical_across_policies(policy):
    ops = gen_ops(np.random.default_rng(17), n_ops=12)
    direct, out_d = replay(ops, policy=policy)
    sharded, out_s = replay(ops, shards=1, policy=policy)
    assert out_d == out_s
    assert fingerprint(direct) == fingerprint(sharded.shards[0].store)
    assert vars(direct.disk.stats) == vars(sharded.disk.stats)
    r_store, r_out = replay(ops, which="ref", shards=1, policy=policy)
    assert_same_as_reference(sharded, out_s, r_store, r_out)


# --------------------------- shards=N vs oracle and reference -----------------
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("seed", [3, 4])
def test_sharded_matches_oracle_hash(shards, seed):
    ops = gen_ops(np.random.default_rng(seed), n_ops=14)
    store, out = replay(ops, shards=shards)
    assert_conserved(store)
    r_store, r_out = replay(ops, which="ref", shards=shards)
    assert_same_as_reference(store, out, r_store, r_out)


@pytest.mark.parametrize("scheme", ["btree-dynamic", "accordion-data"])
def test_sharded_other_schemes_match_reference(scheme):
    ops = gen_ops(np.random.default_rng(21), n_ops=14)
    store, out = replay(ops, shards=4, scheme=scheme)
    assert_conserved(store)
    r_store, r_out = replay(ops, which="ref", shards=4, scheme=scheme)
    assert_same_as_reference(store, out, r_store, r_out)


def test_sharded_matches_oracle_range_router():
    ops = gen_ops(np.random.default_rng(6), n_ops=14)
    router = ShardRouter.ranges(4, KEY_SPACE + 500)
    store, out = replay(ops, shards=4, router=router)
    assert_conserved(store)
    r_store, r_out = replay(ops, which="ref", shards=4, router=router)
    assert_same_as_reference(store, out, r_store, r_out)


def test_sharded_log_and_memory_enforced_globally():
    """The arena's budgets are global: after any tick, total write memory
    respects the shared threshold and the shared log respects its cap,
    whichever shards the data landed on."""
    ops = gen_ops(np.random.default_rng(12), n_ops=20)
    store, _ = replay(ops, shards=4)
    cfg = store.cfg
    assert store.write_memory_used() \
        <= cfg.mem_flush_threshold * store.write_memory_bytes + \
        cfg.active_sstable_bytes * store.n_shards * len(TREES)
    assert store.log_length <= cfg.max_log_bytes
    assert store.log_pos == store.disk.stats.entries_written * cfg.entry_bytes


def test_sharded_small_log_cap_flushes_the_global_min_lsn():
    """With a log cap the shards' writes cross, the log phase flushes the
    globally minimal-LSN tree: state and flush counts equal the
    reference's."""
    ops = gen_ops(np.random.default_rng(8), n_ops=24)

    def run(which):
        pkg, reset = PKGS[which]
        reset()
        cfg = small_config(pkg, "partitioned", "opt")
        cfg.max_log_bytes = 192 * KB
        store = pkg.ShardedStore(cfg, shards=4)
        for t in TREES:
            store.create_tree(t)
        for op in ops:
            if op[0] == "write":
                ks, vs = _batch_keys(op[2], op[3])
                store.write_batch(op[1], ks, vs)
        return store

    p, r = run("port"), run("ref")
    assert p.disk.stats.flushes_log > 0
    assert shard_fingerprints(p) == shard_fingerprints(r)
    assert vars(p.disk.stats) == vars(r.disk.stats)
    assert p.log_length <= p.cfg.max_log_bytes


def test_sharded_checkpoint_truncates_below_the_global_min_lsn():
    ops = gen_ops(np.random.default_rng(2), n_ops=14)
    store, _ = replay(ops, shards=3)
    r_store, _ = replay(ops, which="ref", shards=3)
    ck, rck = store.checkpoint(), r_store.checkpoint()
    assert (ck.version, ck.wal_seq, ck.watermark, ck.man_watermark) \
        == (rck.version, rck.wal_seq, rck.watermark, rck.man_watermark)
    assert store.wal.tail_bytes == r_store.wal.tail_bytes
    assert store.min_lsn() == r_store.min_lsn()
    assert store.manifest.router_spec == ("hash", 3, None)


# --------------------------- service over shards ------------------------------
def _service_outputs(which, shards, batches):
    pkg, reset = PKGS[which]
    reset()
    store = pkg.LSMStore(small_config(pkg)) if shards is None \
        else pkg.ShardedStore(small_config(pkg), shards=shards)
    svc = pkg.StorageService(store,
                             config=pkg.ServiceConfig(admission=False))
    for t in TREES:
        svc.create_tree(t)
    out = []
    for reqs in batches:
        reqs = [_convert(pkg, r) for r in reqs]
        for res in svc.submit(reqs):
            assert not isinstance(res, pkg.Deferred)
            if hasattr(res, "found"):
                out.append((res.found.tolist(), res.vals.tolist()))
            elif hasattr(res, "count"):
                out.append(res.count)
    return svc, out


def _convert(pkg, req):
    """A reference request as the same request of ``pkg``."""
    kind = type(req).__name__
    cls = getattr(pkg, kind)
    if kind == "Put":
        return cls(req.tree, req.keys, req.vals)
    if kind == "Scan":
        return cls(req.tree, req.lo, req.n)
    return cls(req.tree, req.keys)


@pytest.mark.parametrize("shards", [1, 3])
def test_service_over_sharded_store_matches_oracle(shards):
    batches = gen_request_batches(np.random.default_rng(31), n_batches=8)
    svc, out = _service_outputs("port", shards, batches)
    r_svc, r_out = _service_outputs("ref", shards, batches)
    assert out == r_out
    assert shard_fingerprints(svc.store) == shard_fingerprints(r_svc.store)
    assert vars(svc.stats) == vars(r_svc.stats)
    oracle = {t: {} for t in TREES}
    for reqs in batches:
        for req in reqs:
            kind = type(req).__name__
            if kind == "Put":
                vals = req.keys if req.vals is None else req.vals
                oracle[req.tree].update(
                    zip(req.keys.tolist(), vals.tolist()))
            elif kind == "Delete":
                for k in req.keys.tolist():
                    oracle[req.tree][k] = None
    for t in TREES:
        ks = np.arange(0, KEY_SPACE + 500)
        found, vals = svc.store.read_batch(t, ks)
        for k in ks.tolist():
            want = oracle[t].get(k)
            assert bool(found[k]) == (want is not None), (t, k)
            if want is not None:
                assert int(vals[k]) == want, (t, k)
    if shards > 1:
        assert_conserved(svc.store)


def test_one_shard_service_bit_identical_to_direct_service():
    batches = gen_request_batches(np.random.default_rng(33), n_batches=6)
    svc_d, out_d = _service_outputs("port", None, batches)
    svc_s, out_s = _service_outputs("port", 1, batches)
    assert out_d == out_s
    assert fingerprint(svc_d.store) == fingerprint(svc_s.store.shards[0].store)
    assert vars(svc_d.store.disk.stats) == vars(svc_s.store.disk.stats)


def _hot_shard_run(which):
    """Admission gates per (tree, shard): an L0 pile-up on the hot shard
    defers exactly the keys routed there."""
    pkg, reset = PKGS[which]
    reset()
    cfg = small_config(pkg)
    router = ShardRouter.ranges(2, KEY_SPACE)
    store = pkg.ShardedStore(cfg, router=router_for(pkg, router))
    svc = pkg.StorageService(store, config=pkg.ServiceConfig(admission=True))
    svc.create_tree("a")
    hot = store.shard_tree(0, "a")

    def pile_up():
        for _ in range(cfg.l0_max_groups):  # one new L0 group each round
            ks = np.arange(0, 900)
            store.shards[0].store.write_batch("a", ks, ks + 1, tick=False)
            store.shards[0].store.scheduler.flush_tree(
                hot, trigger="mem", forced_kind="full")

    trace = []
    pile_up()
    assert hot.l0.num_groups >= cfg.l0_max_groups
    assert svc.stalled_trees() == ["a@0"]
    keys = np.array([10, 1500, 20, 1600])          # 2 hot, 2 cold
    res = svc.submit([pkg.Put("a", keys, keys + 5)])
    assert isinstance(res[0], pkg.Deferred) and res[0].reason == "l0-stall"
    assert sorted(res[0].request.keys.tolist()) == [10, 20]
    found, vals = store.read_batch("a", np.array([1500, 1600]))
    assert found.all() and vals.tolist() == [1505, 1605]
    out = svc.submit_all([res[0].request])        # drain + retry
    assert isinstance(out[0], pkg.WriteAck)
    found, vals = store.read_batch("a", keys)
    assert found.all() and vals.tolist() == (keys + 5).tolist()
    trace.append((found.tolist(), vals.tolist()))
    pile_up()                                     # rebuild the stall
    assert svc.stalled_trees() == ["a@0"]
    out = svc.submit_all([pkg.Put("a", keys, keys + 9)])
    assert isinstance(out[0], pkg.WriteAck) and out[0].n == len(keys)
    found, vals = store.read_batch("a", keys)
    assert found.all() and vals.tolist() == (keys + 9).tolist()
    trace.append((found.tolist(), vals.tolist()))
    return store, trace


def test_hot_shard_stall_defers_only_hot_keys():
    store, trace = _hot_shard_run("port")
    r_store, r_trace = _hot_shard_run("ref")
    assert trace == r_trace
    assert shard_fingerprints(store) == shard_fingerprints(r_store)
    assert vars(store.disk.stats) == vars(r_store.disk.stats)
    assert Deferred is port.Deferred and WriteAck is port.WriteAck
    assert StorageService is port.StorageService
    assert Put is port.Put and ServiceConfig is port.ServiceConfig


def test_sharded_store_rejects_disagreeing_shard_count():
    with pytest.raises(ValueError):
        ShardedStore(small_config(port), shards=3, router=ShardRouter(2))


# --------------------------- router properties --------------------------------
ROUTERS = [
    ShardRouter(1),
    ShardRouter(4),
    ShardRouter(7),
    ShardRouter.ranges(4, KEY_SPACE),
    ShardRouter(3, kind="range", boundaries=(-50, 1000)),
]


@pytest.mark.parametrize("router", ROUTERS)
def test_router_partitions_every_key(router):
    rng = np.random.default_rng(0)
    keys = rng.integers(-(2**40), 2**40, size=5000)
    sid = router.shard_of_batch(keys)
    assert sid.shape == keys.shape
    assert ((sid >= 0) & (sid < router.n_shards)).all()
    pieces = list(router.split(keys))
    all_pos = np.concatenate([sel for _, sel in pieces])
    assert len(all_pos) == len(keys)
    assert np.array_equal(np.sort(all_pos), np.arange(len(keys)))
    for si, sel in pieces:
        assert (np.diff(sel) > 0).all() or len(sel) == 1
        assert (sid[sel] == si).all()
    for k in keys[:64].tolist():
        assert router.shard_of(k) == sid[np.flatnonzero(keys == k)[0]]
    # the reference places every key on the same shard
    rr = router_for(ref, router)
    assert np.array_equal(sid, rr.shard_of_batch(keys))
    assert [(si, sel.tolist()) for si, sel in pieces] \
        == [(si, sel.tolist()) for si, sel in rr.split(keys)]


def test_router_degenerate_single_shard():
    keys = np.array([-10, 0, 999, 10**12])
    for r in (ShardRouter(1), ShardRouter.ranges(1, 1000)):
        assert r.shard_of_batch(keys).tolist() == [0, 0, 0, 0]


def test_router_range_boundaries():
    r = ShardRouter(3, kind="range", boundaries=(100, 200))
    assert r.shard_of(-5) == 0 and r.shard_of(99) == 0
    assert r.shard_of(100) == 1 and r.shard_of(199) == 1
    assert r.shard_of(200) == 2 and r.shard_of(10**9) == 2
    with pytest.raises(ValueError):
        ShardRouter(3, kind="range", boundaries=(5,))
    with pytest.raises(ValueError):
        ShardRouter(3, kind="range", boundaries=(200, 100))
    with pytest.raises(ValueError):
        ShardRouter(2, kind="hash", boundaries=(1,))
    with pytest.raises(ValueError):
        ShardRouter(0)
    with pytest.raises(ValueError):
        ShardRouter(2, kind="modulo")


def test_router_deterministic_across_processes():
    """A fresh interpreter computes the identical placement (no ``hash()``
    salt), and it is the reference's."""
    keys = (np.arange(-3000, 3000, dtype=np.int64) * 2654435761) % (2**50)
    local = ShardRouter(5).shard_of_batch(keys)
    digest = int(np.sum(local * np.arange(len(keys), dtype=np.int64)))
    code = (
        "import numpy as np\n"
        "from repro_torch.core.shard import ShardRouter\n"
        "keys = (np.arange(-3000, 3000, dtype=np.int64) * 2654435761)"
        " % (2**50)\n"
        "sid = ShardRouter(5).shard_of_batch(keys)\n"
        "print(int(np.sum(sid * np.arange(len(keys), dtype=np.int64))))\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) \
        + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=240)
    assert int(out.stdout.strip()) == digest
    assert np.array_equal(local, RefRouter(5).shard_of_batch(keys))


if HAVE_HYPOTHESIS:
    @settings(max_examples=50, deadline=None)
    @given(st.lists(st.integers(-2**62, 2**62 - 1), min_size=1,
                    max_size=200),
           st.integers(1, 9))
    def test_hypothesis_router_partition(keys, n_shards):
        router = ShardRouter(n_shards)
        keys = np.array(keys, np.int64)
        sid = router.shard_of_batch(keys)
        assert ((sid >= 0) & (sid < n_shards)).all()
        pieces = list(router.split(keys))
        got = np.concatenate([sel for _, sel in pieces]) if pieces else []
        assert np.array_equal(np.sort(got), np.arange(len(keys)))
        for si, sel in pieces:
            assert (sid[sel] == si).all()
        assert np.array_equal(sid, RefRouter(n_shards).shard_of_batch(keys))

    @settings(max_examples=6, deadline=None)
    @given(st.integers(0, 2**31 - 1), st.integers(2, 4))
    def test_hypothesis_sharded_oracle(seed, shards):
        ops = gen_ops(np.random.default_rng(seed), n_ops=8)
        store, out = replay(ops, shards=shards)
        assert_conserved(store)
        r_store, r_out = replay(ops, which="ref", shards=shards)
        assert_same_as_reference(store, out, r_store, r_out)
