"""The port's §5 memory tuner against the reference, bit for bit on the CPU.

The derivatives (``write_derivative``, ``read_derivative``,
``cost_derivative``), the cost model and XLA's float32 ``log`` go through
``repro`` (jitted on the CPU) and through ``repro_torch`` (numpy float32
following XLA:CPU's arithmetic) on seeded inputs, and must agree in their
float32 bits. Tuned service streams (``AdaptiveGovernor`` over an
``LSMStore`` or a ``ShardedStore``) and hand-driven
``AdaptiveMemoryController`` runs must give the same ``TuneRecord``s, store
state, results, IOStats and WAL bytes. The reference's own derivative
tests (``tests/test_tuner_derivatives.py``) have twins here on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_differential import fingerprint  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro.core.durability.wal import encode_record as ref_encode  # noqa: E402
from repro.core.lsm import cost_model as ref_cost  # noqa: E402
from repro.core.lsm.sstable import partition_run as ref_partition  # noqa: E402
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro.core.tuner import derivatives as ref_der  # noqa: E402
from repro.core.tuner.tuner import (  # noqa: E402
    AdaptiveMemoryController as RefController, TunerConfig as RefTunerConfig)
from repro_torch.core.durability.wal import encode_record as port_encode  # noqa: E402
from repro_torch.core.lsm import cost_model as port_cost  # noqa: E402
from repro_torch.core.lsm.sstable import partition_run  # noqa: E402
from repro_torch.core.lsm.sstable import reset_sst_ids as port_reset  # noqa: E402
from repro_torch.core.tuner import f32 as xf32  # noqa: E402
from repro_torch.core.tuner.derivatives import (  # noqa: E402
    TunerStats, cost_derivative, read_derivative, write_derivative)
from repro_torch.core.tuner.tuner import (  # noqa: E402
    AdaptiveMemoryController, TunerConfig)

KB, MB, GiB = 1 << 10, 1 << 20, 1 << 30
MiB = MB
TREES = ("a", "b")


def bits(v):
    """A float32 value's bit pattern (so -0.0 and 0.0 differ)."""
    return int(np.asarray(v, np.float32).reshape(()).view(np.uint32))


def all_bits(v):
    return np.asarray(v, np.float32).view(np.uint32).tolist()


# --------------------------- twins of test_tuner_derivatives -----------------
def example_51_stats():
    """Two LSM-trees, x=128MB; tree1 a=0.8, |L_N|=100GB, merge=1 page/op;
    tree2 a=0.2, |L_N|=50GB, merge=0.8 page/op; all memory-triggered."""
    return TunerStats(
        x=128 * MiB,
        merge_pages_per_op=np.array([1.0, 0.8]),
        last_level_bytes=np.array([100.0 * GiB, 50.0 * GiB]),
        alloc=np.array([0.8, 0.2]),
        flush_mem_bytes=np.array([1.0, 1.0]),
        flush_log_bytes=np.array([0.0, 0.0]),
        sim_bytes=32 * MiB,
        saved_q_per_op=0.01,
        saved_m_per_op=0.008,
        read_m_per_op=2.4,
        merge_per_op=1.8,
    )


def _wd(s, sl=slice(None), fm=None, fl=None, x=None, mod=None):
    mod = mod or write_derivative
    return mod(s.x if x is None else x, s.merge_pages_per_op[sl],
               s.last_level_bytes[sl], s.alloc[sl],
               s.flush_mem_bytes[sl] if fm is None else fm,
               s.flush_log_bytes[sl] if fl is None else fl)


def test_example_5_1_write_derivative():
    s = example_51_stats()
    wp = _wd(s)
    # paper: write'_1 ~ -1.08e-9, write'_2 ~ -0.78e-9, total ~ -1.86e-9
    assert float(wp) == pytest.approx(-1.86e-9, rel=0.02)
    assert bits(wp) == bits(_wd(s, mod=ref_der.write_derivative))


def test_example_5_1_per_tree_terms():
    s = example_51_stats()
    w1, w2 = _wd(s, slice(0, 1)), _wd(s, slice(1, 2))
    assert float(w1) == pytest.approx(-1.08e-9, rel=0.02)
    assert float(w2) == pytest.approx(-0.78e-9, rel=0.03)
    assert bits(w1) == bits(_wd(s, slice(0, 1), mod=ref_der.write_derivative))
    assert bits(w2) == bits(_wd(s, slice(1, 2), mod=ref_der.write_derivative))


def test_example_5_2_read_derivative():
    s = example_51_stats()
    wp = _wd(s)
    args = (s.saved_q_per_op, s.saved_m_per_op, s.sim_bytes,
            s.read_m_per_op, s.merge_per_op)
    rp = read_derivative(wp, *args)
    assert float(rp) == pytest.approx(-1.94e-9, rel=0.02)
    assert bits(rp) == bits(ref_der.read_derivative(
        _wd(s, mod=ref_der.write_derivative), *args))


def test_cost_derivative_weights():
    s = example_51_stats()
    cp, wp, rp = cost_derivative(s, omega=1.0, gamma=1.0)
    assert cp == pytest.approx(wp + rp, rel=1e-6)
    cp2, _, _ = cost_derivative(s, omega=2.0, gamma=1.0)
    assert cp2 == pytest.approx(2 * wp + rp, rel=1e-6)
    for om, ga in ((1.0, 1.0), (2.0, 1.0), (0.3, 1.7)):
        assert cost_derivative(s, om, ga) \
            == ref_der.cost_derivative(s, om, ga)


def test_log_triggered_flushes_zero_the_write_derivative():
    """§5.2: the scale factor kills write'(x) when flushes are log-bound."""
    s = example_51_stats()
    one, zero = np.array([1.0, 1.0]), np.array([0.0, 0.0])
    got = [_wd(s, fm=fm, fl=fl) for fm, fl in
           ((one, zero), (zero, one), (one, one))]
    wp_mem, wp_log, wp_half = map(float, got)
    assert wp_log == 0.0
    assert wp_half == pytest.approx(wp_mem / 2, rel=1e-5)
    assert wp_mem < wp_half < wp_log
    want = [_wd(s, fm=fm, fl=fl, mod=ref_der.write_derivative) for fm, fl in
            ((one, zero), (zero, one), (one, one))]
    assert list(map(bits, got)) == list(map(bits, want))


def _fig15_store(pkg, reset, cfg_cls, kw, partition):
    reset()
    store = pkg.LSMStore(cfg_cls(
        total_memory_bytes=32 * MB, write_memory_bytes=2 * MB,
        sim_cache_bytes=1 * MB, page_bytes=4 * KB, entry_bytes=256,
        active_sstable_bytes=256 * KB, sstable_bytes=512 * KB,
        max_log_bytes=6 * MB, scheme="partitioned", flush_policy="lsn",
        **kw))
    tree = store.create_tree("t")
    # pre-install a populated last level (fig15's bulk load, no I/O)
    keys = np.arange(0, 120_000, dtype=np.int64)
    tree.levels.levels = [partition(
        keys, keys, 0, 0, tree.entry_bytes, store.cfg.page_bytes,
        store.cfg.sstable_bytes)]
    tree.levels.adjust(store.cfg.active_sstable_bytes)
    return store


def _fig15_run(store, ctrl, n_ticks):
    rng = np.random.default_rng(0)
    while len(ctrl.tuner.records) < n_ticks:
        ks = rng.integers(0, 120_000, size=256)
        store.write_batch("t", ks, ks)
        ctrl.maybe_tune()
    return ctrl.tuner.records[:n_ticks]


def test_tuner_moves_write_memory_in_cost_decreasing_direction():
    """Tiny fig15-style workload (write-heavy YCSB, one tree): within N
    tuning ticks ``MemoryTuner.propose`` only ever steps *against* the sign
    of cost'(x) and grows the write memory -- and every record equals the
    reference's on the same workload."""
    tkw = dict(min_step_bytes=128 * KB, min_write_mem=1 * MB,
               ops_cycle=8_000)
    store = _fig15_store(port, port_reset, port.StoreConfig,
                         {"device": "cpu"}, partition_run)
    ctrl = AdaptiveMemoryController(store, TunerConfig(**tkw))
    x0 = store.write_memory_bytes
    recs = _fig15_run(store, ctrl, 10)
    stepped = [r for r in recs if not r.stopped]
    assert stepped, "tuner never moved within N ticks"
    for r in stepped:      # every step goes downhill on the fitted cost
        assert np.sign(r.x_next - r.x) == -np.sign(r.cost_prime), vars(r)
    assert stepped[0].cost_prime < 0
    assert store.write_memory_bytes > x0
    rstore = _fig15_store(ref, ref_reset, ref.StoreConfig,
                          {"backend": "numpy"}, ref_partition)
    rrecs = _fig15_run(rstore, RefController(rstore, RefTunerConfig(**tkw)),
                       10)
    assert [vars(r) for r in recs] == [vars(r) for r in rrecs]
    assert fingerprint(store) == fingerprint(rstore)


def test_write_derivative_negative_and_decreasing_in_x():
    """More write memory always helps (Eq. 4 is negative), with diminishing
    returns (|write'| decreases as x grows)."""
    s = example_51_stats()
    grads = []
    for x in [64 * MiB, 128 * MiB, 256 * MiB, 1 * GiB]:
        g = _wd(s, x=x)
        assert g < 0
        assert bits(g) == bits(_wd(s, x=x, mod=ref_der.write_derivative))
        grads.append(float(g))
    assert all(grads[i] < grads[i + 1] for i in range(len(grads) - 1))


# --------------------------- derivatives, bit for bit -------------------------
def seeded_stats(rng, k):
    """A tuning cycle's statistics with the edge cases the estimators clamp:
    trees with no merges, no flushes, log-only flushes, tiny last levels."""
    fm = rng.uniform(0, 1e7, k) * (rng.random(k) < 0.8)
    fl = rng.uniform(0, 1e7, k) * (rng.random(k) < 0.5)
    used = rng.uniform(1, 1e6, k)
    return TunerStats(
        x=float(rng.integers(1 << 20, 1 << 30)),
        merge_pages_per_op=rng.uniform(0, 3, k) * (rng.random(k) < 0.9),
        last_level_bytes=np.exp(rng.uniform(0, 30, k)),
        alloc=used / used.sum(), flush_mem_bytes=fm, flush_log_bytes=fl,
        sim_bytes=float(rng.integers(1 << 20, 64 << 20)),
        saved_q_per_op=float(rng.uniform(0, 0.1)) * (rng.random() < 0.8),
        saved_m_per_op=float(rng.uniform(0, 0.1)) * (rng.random() < 0.8),
        read_m_per_op=float(rng.uniform(0, 3)),
        merge_per_op=float(rng.uniform(0, 3)) * (rng.random() < 0.9))


# K = trees x shards: 2 and 8 are the smoke run's stores, 40 the example's
# 10 trees over 4 shards. Every K up to 100 runs, so each entry of the plan
# tables, the scalar loops around them and the windowed sums above 32
# terms are held against XLA.
KS = list(range(1, 101))


@pytest.mark.parametrize("k", KS)
def test_derivatives_bit_identical_to_reference(k):
    rng = np.random.default_rng(1000 + k)
    for _ in range(60):
        s = seeded_stats(rng, k)
        args = (s.x, s.merge_pages_per_op, s.last_level_bytes, s.alloc,
                s.flush_mem_bytes, s.flush_log_bytes)
        wp, rwp = write_derivative(*args), ref_der.write_derivative(*args)
        assert bits(wp) == bits(rwp), vars(s)
        rargs = (s.saved_q_per_op, s.saved_m_per_op, s.sim_bytes,
                 s.read_m_per_op, s.merge_per_op)
        assert bits(read_derivative(wp, *rargs)) \
            == bits(ref_der.read_derivative(rwp, *rargs))
        for om, ga in ((1.0, 1.0), (2.0, 0.5)):
            got = cost_derivative(s, om, ga)
            want = ref_der.cost_derivative(s, om, ga)
            assert list(map(bits, got)) == list(map(bits, want)), vars(s)


def test_xla_log_bit_identical_over_the_tuners_range():
    """write'(x) takes the log of a ratio clamped to [e, ...): a sweep over
    [e, 2^40], log-uniform and uniform, against XLA's float32 log."""
    rng = np.random.default_rng(7)
    xs = np.concatenate([
        np.exp(rng.uniform(1.0, 40 * np.log(2), 100_000)),
        rng.uniform(np.e, 2.0 ** 40, 100_000),
        [np.e, 2.0 ** 40, 4.0, 8.0, 0.70710677 * 8]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(xs))
    assert all_bits(xf32.log32(xs)) == all_bits(want)
    # libm's log misses XLA's in a few percent of these inputs: the sweep
    # would catch a port that called torch.log.
    assert (torch.log(torch.from_numpy(xs)).numpy() != want).sum() > 1000


def test_xla_log_edge_values():
    xs = np.array([0.0, -1.0, np.inf, np.nan, 1e-45, 1e-38, 1.0, 0.5, 2.0,
                   3.4e38], np.float32)
    want = np.asarray(jax.jit(jnp.log)(xs))
    got = xf32.log32(xs)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert all_bits(got[ok]) == all_bits(want[ok])


def test_fma32_is_one_rounding():
    """The emulated fused multiply-add rounds once: against exact rational
    arithmetic on seeded inputs, and on a case where rounding through
    float64 first would land on a float32 tie and go the wrong way."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(2000).astype(np.float32) for _ in "abc")
    c[::3] *= np.float32(2.0 ** -30)
    once = np.array([np.float32(float(Fraction(float(x)) * Fraction(float(y))
                                      + Fraction(float(z))))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert all_bits(xf32.fma32(a, b, c)) == all_bits(once)
    # (1 + 2^-12)^2 + 2^-70 lies just above the float32 midpoint
    # 1 + 2^-11 + 2^-24; float64 drops the 2^-70 and the tie rounds down.
    a1 = np.float32(1 + 2 ** -12)
    c1 = np.float32(2.0 ** -70)
    assert float(xf32.fma32(a1, a1, c1)) == 1 + 2 ** -11 + 2 ** -23
    assert float(np.float32(np.float64(a1) * np.float64(a1)
                            + np.float64(c1))) == 1 + 2 ** -11


# --------------------------- cost model, bit for bit --------------------------


@pytest.mark.parametrize("k", KS)
def test_cost_model_bit_identical_to_reference(k):
    rng = np.random.default_rng(2000 + k)
    for i in range(25):
        rates = rng.uniform(0, 1e4, k) * (rng.random(k) < 0.9)
        if i == 0:
            rates = np.zeros(k)             # the 0-safe branch
        assert all_bits(port_cost.optimal_allocation(rates)) \
            == all_bits(ref_cost.optimal_allocation(rates))
        e = rng.choice([64, 256, 1024], k).astype(np.float64)
        lN = np.exp(rng.uniform(10, 35, k))
        alloc = np.asarray(ref_cost.optimal_allocation(rates + 1))
        wm = float(rng.integers(1 << 20, 1 << 30))
        T = float(rng.choice([2, 4, 10]))
        assert all_bits(port_cost.write_cost_per_entry(e, 4096, T, lN, wm)) \
            == all_bits(ref_cost.write_cost_per_entry(e, 4096, T, lN, wm))
        assert bits(port_cost.total_write_cost(rates, e, 4096, T, lN, alloc,
                                               wm)) \
            == bits(ref_cost.total_write_cost(rates, e, 4096, T, lN, alloc,
                                              wm))


def test_cost_model_scalars_bit_identical():
    rng = np.random.default_rng(5)
    for _ in range(200):
        args = (float(rng.choice([64, 256, 1024])), 4096.0,
                float(rng.choice([2, 4, 10])),
                float(np.exp(rng.uniform(10, 35))),
                float(rng.integers(1 << 20, 1 << 30)))
        assert bits(port_cost.write_cost_per_entry(*args)) \
            == bits(ref_cost.write_cost_per_entry(*args))


def test_optimal_allocation_sums_to_one():
    a = port_cost.optimal_allocation(np.array([3.0, 1.0, 0.0], np.float32))
    assert float(np.sum(a)) == pytest.approx(1.0, abs=1e-6)
    z = port_cost.optimal_allocation(np.zeros(4, np.float32))
    assert all_bits(z) == all_bits(np.full(4, 0.25, np.float32))


# --------------------------- tuned service streams -----------------------------
TUNE_KW = dict(min_step_bytes=16 << 10, ops_cycle=1_500,
               min_write_mem=512 * KB, min_rel_gain=0.0)


def store_kw(scheme):
    # A buffer cache smaller than the data, so reads miss and merges run in
    # every tuning cycle: cost'(x) is nonzero and the tuner moves.
    return dict(total_memory_bytes=10 * MB, write_memory_bytes=2 * MB,
                sim_cache_bytes=1 * MB, page_bytes=4 * KB, entry_bytes=256,
                active_sstable_bytes=32 * KB, sstable_bytes=64 * KB,
                max_log_bytes=8 * MB, scheme=scheme, flush_policy="opt")


KEYS = 40_000


def gen_stream(seed, n):
    """Submits with a 90/10 tree skew, write-heavy then read-heavy, so the
    tuner first grows the write memory, then hands it back."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(n):
        wf = 0.85 if i < n // 2 else 0.1
        reqs = []
        for t, share in (("a", 0.9), ("b", 0.1)):
            m = max(8, int(512 * share))
            if rng.random() < wf:
                reqs.append(("put", t, rng.integers(0, KEYS, m),
                             rng.integers(0, 2 ** 40, m)))
            else:
                reqs.append(("get", t, rng.integers(0, KEYS, m)))
        if rng.random() < 0.1:
            reqs.append(("scan", "a", int(rng.integers(0, KEYS)), 200))
        if rng.random() < 0.05:
            reqs.append(("delete", "b", rng.integers(0, KEYS, 20)))
        steps.append(reqs)
    return steps


def _requests(pkg, reqs):
    out = []
    for r in reqs:
        if r[0] == "put":
            out.append(pkg.Put(r[1], r[2], r[3]))
        elif r[0] == "get":
            out.append(pkg.Get(r[1], r[2]))
        elif r[0] == "scan":
            out.append(pkg.Scan(r[1], r[2], r[3]))
        else:
            out.append(pkg.Delete(r[1], r[2]))
    return out


def result_bits(res):
    if hasattr(res, "found"):
        return ("get", res.found.tobytes(), res.vals.tobytes())
    if hasattr(res, "count"):
        return ("scan", res.count)
    return (type(res).__name__, getattr(res, "n", None),
            getattr(res, "reason", None))


def run_tuned(pkg, reset, cfg, shards, steps, tuner_cfg):
    reset()
    store = pkg.LSMStore(cfg) if shards is None \
        else pkg.ShardedStore(cfg, shards=shards)
    gov = pkg.AdaptiveGovernor(tuner_cfg)
    svc = pkg.StorageService(store, governor=gov)
    for t in TREES:
        svc.create_tree(t)
    outs = []
    for reqs in steps:
        outs.extend(result_bits(r) for r in svc.submit(_requests(pkg, reqs)))
    return svc, gov, outs


def store_fingerprint(store):
    if hasattr(store, "shards"):
        return [fingerprint(sh.store) for sh in store.shards] \
            + [store.write_memory_bytes, store.log_pos]
    return fingerprint(store)


def assert_tuned_runs_equal(p, r):
    p_svc, p_gov, p_out = p
    r_svc, r_gov, r_out = r
    assert [vars(x) for x in p_gov.records] \
        == [vars(x) for x in r_gov.records]
    assert [vars(x) for x in p_svc.plans] == [vars(x) for x in r_svc.plans]
    assert p_out == r_out
    assert store_fingerprint(p_svc.store) == store_fingerprint(r_svc.store)
    assert vars(p_svc.stats) == vars(r_svc.stats)
    assert ([port_encode(x) for x in p_svc.store.wal.records()]
            == [ref_encode(x) for x in r_svc.store.wal.records()])


@pytest.mark.parametrize("shards", [None, 1, 4])
@pytest.mark.parametrize("scheme", ["partitioned", "btree-dynamic"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_governor_bit_identical_to_reference(seed, scheme, shards):
    steps = gen_stream(seed, 110)
    kw = store_kw(scheme)
    p = run_tuned(port, port_reset, port.StoreConfig(device="cpu", **kw),
                  shards, steps, port.TunerConfig(**TUNE_KW))
    r = run_tuned(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                  shards, steps, ref.TunerConfig(**TUNE_KW))
    assert_tuned_runs_equal(p, r)
    recs = p[1].records
    assert len(recs) >= 5
    assert sum(rec.x_next != rec.x for rec in recs) >= 2, \
        "the tuner must actuate for the comparison to mean anything"
    assert p[0].store.write_memory_bytes != kw["write_memory_bytes"]


def test_examples_tuner_settings_bit_identical_at_40_terms():
    """``examples/multi_tenant_store.py``'s tuner settings over 10 trees and
    4 shards: 40 (shard, tree) terms, the windowed sum of XLA's reduce."""
    names = [f"t{i}" for i in range(10)]
    tkw = dict(min_step_bytes=256 << 10, ops_cycle=15_000,
               min_write_mem=1 * MB, min_rel_gain=0.0002)
    kw = dict(store_kw("partitioned"), write_memory_bytes=8 * MB,
              total_memory_bytes=48 * MB, max_log_bytes=6 * MB)
    rng = np.random.default_rng(9)
    probs = np.full(10, 0.2 / 8)
    probs[:2] = 0.4
    steps = []
    for i in range(120):
        wf = 0.9 if i < 60 else 0.05
        tree = names[int(rng.choice(10, p=probs))]
        ks = rng.integers(0, 40_000, 512)
        steps.append([("put", tree, ks, ks + 1)] if rng.random() < wf
                     else [("get", tree, ks)])

    def run(pkg, reset, cfg):
        reset()
        gov = pkg.AdaptiveGovernor(pkg.TunerConfig(**tkw))
        svc = pkg.StorageService(pkg.ShardedStore(cfg, shards=4),
                                 governor=gov)
        for n in names:
            svc.create_tree(n)
        outs = []
        for reqs in steps:
            outs.extend(result_bits(r)
                        for r in svc.submit(_requests(pkg, reqs)))
        return svc, gov, outs

    p = run(port, port_reset, port.StoreConfig(device="cpu", **kw))
    r = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw))
    assert len(p[0].store.trees) == 40
    assert len(p[1].records) >= 3
    assert_tuned_runs_equal(p, r)


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_controller_records_bit_identical_to_reference(seed, shards):
    """``AdaptiveMemoryController`` driven by hand (``maybe_tune`` after
    every batch, ``tune_now`` at random points) over a bare store."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(160):
        r = rng.random()
        t = TREES[int(rng.random() < 0.2)]
        ks = rng.integers(0, KEYS, int(rng.integers(50, 600)))
        ops.append(("w", t, ks) if r < 0.6 else ("r", t, ks) if r < 0.95
                   else ("tune",))

    def run(pkg, reset, cfg, tcfg):
        reset()
        store = pkg.LSMStore(cfg) if shards is None \
            else pkg.ShardedStore(cfg, shards=shards)
        for t in TREES:
            store.create_tree(t)
        ctrl = pkg.AdaptiveMemoryController(store, tcfg)
        outs = []
        for op in ops:
            if op[0] == "w":
                store.write_batch(op[1], op[2], op[2] * 7)
            elif op[0] == "r":
                f, v = store.read_batch(op[1], op[2])
                outs.append((f.tobytes(), v.tobytes()))
            else:
                ctrl.tune_now()
            ctrl.maybe_tune()
        return store, ctrl, outs

    kw = store_kw("partitioned")
    ps, pc, po = run(port, port_reset, port.StoreConfig(device="cpu", **kw),
                     port.TunerConfig(**TUNE_KW))
    rs, rc, ro = run(ref, ref_reset, ref.StoreConfig(backend="numpy", **kw),
                     ref.TunerConfig(**TUNE_KW))
    assert [vars(x) for x in pc.tuner.records] \
        == [vars(x) for x in rc.tuner.records]
    assert sum(x.x_next != x.x for x in pc.tuner.records) >= 2
    assert po == ro
    assert store_fingerprint(ps) == store_fingerprint(rs)
    assert vars(ps.disk.stats) == vars(rs.disk.stats)


def test_service_default_governor_is_static():
    svc = port.StorageService(port.LSMStore(port.StoreConfig(
        device="cpu", **store_kw("partitioned"))))
    assert type(svc.governor).__name__ == "StaticGovernor"
    # Exported where the reference exports it: core and core.service.
    import repro.core.service as ref_service
    import repro_torch.core.service as port_service
    assert port_service.AdaptiveGovernor is port.AdaptiveGovernor
    assert ref_service.AdaptiveGovernor is ref.AdaptiveGovernor
