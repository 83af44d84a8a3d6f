"""The port's kernels on the CPU (their plain PyTorch versions, reached
through the wrappers and through ``TorchBackend(device="cpu")``) against
the reference: the Pallas kernels in interpret mode and ``NumpyBackend``.
All data is integer, so every comparison is exact. Keys beyond int32 are
compared with ``NumpyBackend`` only: the reference routes them there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.engine.numpy_backend import (  # noqa: E402
    NumpyBackend as RefNumpy, _bloom_slots as ref_bloom_slots,
    ingest_order as ref_ingest_order)
from repro.kernels.bloom import ops as bloom_ops  # noqa: E402
from repro.kernels.merge import ops as merge_ops  # noqa: E402
from repro_torch.core.engine.backend import bloom_sizing  # noqa: E402
from repro_torch.core.engine.torch_backend import TorchBackend  # noqa: E402
from repro_torch.core.lsm.sstable import TOMBSTONE  # noqa: E402
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.kernels.bloom import bloom as bloom_k  # noqa: E402
from repro_torch.kernels.merge import merge as merge_k  # noqa: E402

INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def tb():
    return TorchBackend(device="cpu")


@pytest.fixture(scope="module")
def nb():
    return RefNumpy()


def _runs(rng, lens, hi=INT32_MAX - 1, vlo=-2**31 + 1, vhi=2**31 - 1):
    """Newest-first sorted unique runs that share keys across runs."""
    pool = np.unique(rng.integers(0, hi, 2 * sum(lens) + 1))
    runs = []
    for n in lens:
        k = np.sort(rng.choice(pool, size=n, replace=False)).astype(np.int64)
        runs.append((k, rng.integers(vlo, vhi, n).astype(np.int64)))
    return runs


# --------------------------- K1: merge ---------------------------------------
@pytest.mark.parametrize("lens", [[], [7], [0, 5], [300, 1],
                                  [513, 1000, 77], [129, 0, 700, 260, 31]])
def test_merge_runs_matches_pallas_and_numpy(tb, nb, lens):
    runs = _runs(np.random.default_rng(len(lens) * 31 + sum(lens)), lens)
    k, v = tb.merge_runs(runs)
    rk, rv = nb.merge_runs(runs)
    np.testing.assert_array_equal(k, rk)
    np.testing.assert_array_equal(v, rv)
    assert k.dtype == np.int64 and v.dtype == np.int64
    pk, pv = merge_ops.merge_runs_device(runs, interpret=True)
    np.testing.assert_array_equal(k, pk.astype(np.int64))
    np.testing.assert_array_equal(v, pv.astype(np.int64))


@pytest.mark.parametrize("n,dup_hi", [(1, 10), (2, 1), (3, 2), (600, 150),
                                      (1023, 4000)])
def test_ingest_run_matches_pallas_and_numpy(tb, nb, n, dup_hi):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, dup_hi, n).astype(np.int64)   # in-batch dups
    vals = rng.integers(-2**31 + 1, 2**31 - 1, n).astype(np.int64)
    got = tb.ingest_run(keys, vals)
    want = nb.ingest_run(keys, vals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if n >= 2:
        order = ref_ingest_order(keys)
        pk, psrc = merge_ops.ingest_run(keys[order].astype(np.int32),
                                        order.astype(np.int32),
                                        interpret=True)
        np.testing.assert_array_equal(got[0], pk.astype(np.int64))
        np.testing.assert_array_equal(got[2], psrc.astype(np.int64))


def test_ingest_duplicates_across_the_split_keep_newest(tb):
    # The same key in both halves and several times inside one half: the
    # newest occurrence (highest batch position) must survive.
    keys = np.array([5, 9, 5, 1, 9, 5, 9, 1], np.int64)
    vals = np.arange(8, dtype=np.int64) * 10
    k, v, src = tb.ingest_run(keys, vals)
    np.testing.assert_array_equal(k, [1, 5, 9])
    np.testing.assert_array_equal(src, [7, 5, 6])
    np.testing.assert_array_equal(v, [70, 50, 60])


def test_merge_pair_plain_is_a_stable_rank_merge():
    a = torch.tensor([1, 3, 3, 8], dtype=torch.int64)
    b = torch.tensor([3, 4, 8, 8, 9], dtype=torch.int64)
    av = torch.arange(4, dtype=torch.int64)
    bv = torch.arange(10, 15, dtype=torch.int64)
    k, v, keep = merge_k.merge_pair(a, av, b, bv)
    assert k.tolist() == [1, 3, 3, 3, 4, 8, 8, 8, 9]
    assert v.tolist() == [0, 1, 2, 10, 11, 3, 12, 13, 14]
    assert keep.tolist() == [True, True, False, False, True, True, False,
                             False, True]


# --------------------------- K2 / K5: Bloom ----------------------------------
@pytest.mark.parametrize("n", [1, 100, 257, 2048, 3000])
def test_bloom_build_matches_pallas_and_numpy(tb, nb, n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, INT32_MAX - 1, n)).astype(np.int64)
    kind, f = tb.bloom_build(keys)
    assert kind == "torch" and f.dtype == torch.bool and f.shape[0] == 128
    np.testing.assert_array_equal(f.numpy().reshape(-1), nb.bloom_build(keys))
    n_pad, n_slots = bloom_sizing(n)
    pf = bloom_ops.bloom_build_run(keys, n_keys_padded=n_pad,
                                   n_slots=n_slots, interpret=True)
    np.testing.assert_array_equal(f.numpy(), np.asarray(pf) != 0)


@pytest.mark.parametrize("n_keys,n_q", [(50, 1), (300, 17), (2048, 255),
                                        (2048, 300)])
def test_bloom_probe_matches_pallas_and_numpy(tb, nb, n_keys, n_q):
    rng = np.random.default_rng(n_keys + n_q)
    keys = np.sort(rng.choice(1 << 20, n_keys, replace=False)).astype(
        np.int64)
    q = np.concatenate([keys[: n_q // 2],
                        rng.integers(0, 1 << 20, n_q - n_q // 2)])
    filt = tb.bloom_build(keys)
    got = tb.bloom_probe(filt, q)
    assert got.dtype == bool and got.shape == (n_q,)
    np.testing.assert_array_equal(got, nb.bloom_probe(nb.bloom_build(keys), q))
    pp = bloom_ops.bloom_probe_run(filt[1].numpy(), q, interpret=True)
    np.testing.assert_array_equal(got, pp)
    assert got[: n_q // 2].all()                       # no false negatives


def test_bloom_probe_false_positives_match_numpy(tb, nb):
    keys = np.arange(0, 2560, 10, dtype=np.int64)
    q = np.arange(100_000, 140_000, dtype=np.int64)     # none inserted
    got = tb.bloom_probe(tb.bloom_build(keys), q)
    want = nb.bloom_probe(nb.bloom_build(keys), q)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(q)                       # real FPs, same set


def test_bloom_slot_of_key_one():
    # key 1 at n_slots=1280: h1 = 0x9E3779B1 as int32 floor-mod 1280 = 945
    # (a truncating % would give -335).
    s = bloom_k.bloom_slots_plain(torch.tensor([1], dtype=torch.int64),
                                  1280, 7)
    assert int(s[0, 0]) == 945
    np.testing.assert_array_equal(s.numpy(),
                                  ref_bloom_slots(np.array([1]), 1280, 7))


def _tier(rng, sizes, hi=INT32_MAX - 1):
    """Disjoint sorted tables of ``sizes`` keys (several slot counts) and
    queries: half present, half random, each with its covering table
    (clipped into the tier, as the engine assigns them)."""
    keys = np.sort(rng.choice(hi, sum(sizes), replace=False)).astype(np.int64)
    cuts = np.cumsum([0, *sizes])
    tables = [keys[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    q = np.concatenate([rng.choice(keys, 150),
                        rng.integers(0, hi, 150)]).astype(np.int64)
    starts = np.array([t[0] for t in tables])
    tidx = np.clip(np.searchsorted(starts, q, side="right") - 1, 0,
                   len(tables) - 1).astype(np.int64)
    return tables, q, tidx


@pytest.mark.parametrize("sizes", [[2048], [100, 300, 2048, 5000],
                                   [17, 700, 1000, 1, 260, 3000, 40]])
def test_bloom_probe_tier_matches_pallas_and_numpy(tb, nb, sizes):
    rng = np.random.default_rng(sum(sizes))
    tables, q, tidx = _tier(rng, sizes)
    filts = [tb.bloom_build(k) for k in tables]
    got = tb.bloom_probe_tier(filts, q, tidx)
    assert got.dtype == bool and got.shape == q.shape
    fs = [f for _, f in filts]
    np.testing.assert_array_equal(
        bloom_k.bloom_probe_tier(fs, torch.from_numpy(q),
                                 torch.from_numpy(tidx), 7).numpy(), got)
    for t, keys in enumerate(tables):
        rows = tidx == t
        if not rows.any():
            continue
        np.testing.assert_array_equal(
            got[rows], nb.bloom_probe(nb.bloom_build(keys), q[rows]))
        np.testing.assert_array_equal(
            got[rows], bloom_ops.bloom_probe_run(fs[t].numpy(), q[rows],
                                                 interpret=True))
    assert got[:150].all()                              # no false negatives
    assert len({f.numel() for f in fs}) == len({bloom_sizing(len(k))[1]
                                                for k in tables})


def test_bloom_probe_tier_wide_keys_match_numpy(tb, nb):
    rng = np.random.default_rng(17)
    keys = np.unique(np.concatenate([WIDE, rng.integers(-2**62, 2**62,
                                                        600)]))
    tables = [keys[:5], keys[5:300], keys[300:]]
    q = np.concatenate([keys, keys + 3, [5, 2**33 + 7]]).astype(np.int64)
    tidx = rng.integers(0, 3, len(q)).astype(np.int64)
    got = tb.bloom_probe_tier([tb.bloom_build(k) for k in tables], q, tidx)
    want = np.zeros(len(q), bool)
    for t, k in enumerate(tables):
        want[tidx == t] = nb.bloom_probe(nb.bloom_build(k), q[tidx == t])
    np.testing.assert_array_equal(got, want)
    own = np.array([np.isin(k, tables[t]) for k, t in zip(q, tidx)])
    assert own.sum() > 100 and got[own].all()          # no false negatives
# --------------------------- keys beyond int32 -------------------------------
WIDE = np.array([0, 1, -1, -7, 2**31 - 1, 2**31, 2**31 + 5, 2**32,
                 2**32 + 1, -(2**31), TOMBSTONE, 2**40 + 3, -(2**45),
                 2**63 - 1, -(2**63)], np.int64)


def test_wide_keys_bloom_and_lookup_match_numpy(tb, nb):
    keys = np.unique(WIDE)
    np.testing.assert_array_equal(
        bloom_k.bloom_slots_plain(torch.from_numpy(keys), 1280, 7).numpy(),
        ref_bloom_slots(keys, 1280, 7))
    f = tb.bloom_build(keys)
    np.testing.assert_array_equal(f[1].numpy().reshape(-1),
                                  nb.bloom_build(keys))
    q = np.concatenate([keys, keys + 3, [5, 2**33 + 7]])
    np.testing.assert_array_equal(tb.bloom_probe(f, q),
                                  nb.bloom_probe(nb.bloom_build(keys), q))
    assert tb.bloom_probe(f, keys).all()
    for a, b in zip(tb.lookup_batch(keys, q), nb.lookup_batch(keys, q)):
        np.testing.assert_array_equal(a, b)


def test_wide_keys_merge_and_ingest_match_numpy(tb, nb):
    rng = np.random.default_rng(7)
    runs = [(np.unique(rng.choice(WIDE, 9)), None) for _ in range(3)]
    runs = [(k, rng.integers(-2**62, 2**62, len(k))) for k, _ in runs]
    for a, b in zip(tb.merge_runs(runs), nb.merge_runs(runs)):
        np.testing.assert_array_equal(a, b)
    keys = rng.choice(WIDE, 40)
    vals = rng.integers(-2**62, 2**62, 40)
    for a, b in zip(tb.ingest_run(keys, vals), nb.ingest_run(keys, vals)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,q", [(0, 5), (1, 3), (1000, 0), (1000, 777)])
def test_lookup_batch_matches_numpy(tb, nb, n, q):
    rng = np.random.default_rng(n + q)
    sk = np.unique(rng.integers(0, 5000, n)).astype(np.int64)
    qs = rng.integers(-5, 5010, q).astype(np.int64)
    (p1, f1), (p2, f2) = tb.lookup_batch(sk, qs), nb.lookup_batch(sk, qs)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(f1, f2)
    assert p1.dtype == np.int64 and f1.dtype == bool


@settings(database=None, max_examples=40, deadline=None)
@given(st.lists(st.lists(st.integers(-2**63, 2**63 - 1), max_size=40),
                max_size=5),
       st.lists(st.integers(-2**40, 2**40), min_size=1, max_size=120))
def test_property_backend_matches_numpy(runs, batch):
    tb, nb = TorchBackend(device="cpu"), RefNumpy()
    rs = [(np.unique(np.array(r, np.int64)),) for r in runs]
    rs = [(k[0], k[0] * 3) for k in rs]
    for a, b in zip(tb.merge_runs(rs), nb.merge_runs(rs)):
        np.testing.assert_array_equal(a, b)
    keys = np.array(batch, np.int64)
    vals = np.arange(len(keys), dtype=np.int64)
    for a, b in zip(tb.ingest_run(keys, vals), nb.ingest_run(keys, vals)):
        np.testing.assert_array_equal(a, b)
    uk = np.unique(keys)
    np.testing.assert_array_equal(tb.bloom_build(uk)[1].numpy().reshape(-1),
                                  nb.bloom_build(uk))
    np.testing.assert_array_equal(
        tb.bloom_probe(tb.bloom_build(uk), keys + 1),
        nb.bloom_probe(nb.bloom_build(uk), keys + 1))


@settings(database=None, max_examples=40, deadline=None)
@given(st.lists(st.lists(st.integers(-2**63, 2**63 - 1), min_size=1,
                         max_size=60), min_size=1, max_size=6),
       st.lists(st.tuples(st.integers(-2**40, 2**40), st.integers(0, 5)),
                max_size=80))
def test_property_bloom_probe_tier_matches_numpy(tables, probes):
    tb, nb = TorchBackend(device="cpu"), RefNumpy()
    tables = [np.unique(np.array(t, np.int64)) for t in tables]
    q = np.array([k for k, _ in probes], np.int64)
    tidx = np.array([t % len(tables) for _, t in probes], np.int64)
    got = tb.bloom_probe_tier([tb.bloom_build(k) for k in tables], q, tidx)
    assert got.shape == q.shape
    for t, k in enumerate(tables):
        np.testing.assert_array_equal(
            got[tidx == t], nb.bloom_probe(nb.bloom_build(k), q[tidx == t]))


@pytest.mark.parametrize("n_slots", [128, 1280, 20480, 2**31 - 128])
def test_mod_free_slot_walk_equals_reference(n_slots):
    # The kernels' slot walk (bloom_hash.cuh): h1, h2 from the reference's
    # floor-mod, then each slot is the last plus h2, less n_slots where
    # the uint32 sum reaches it. It must give (h1 + j * h2) mod n_slots.
    keys = np.concatenate([WIDE, np.random.default_rng(n_slots).integers(
        -2**63, 2**63 - 1, 5000)])
    want = ref_bloom_slots(keys, n_slots, 7)
    s = want[:, 0].astype(np.uint32)
    h2 = ((keys.astype(np.int32) * np.int32(0x85EBCA77 - 2**32))
          | np.int32(1)) % np.int32(n_slots)
    h2 = h2.astype(np.uint32)
    n = np.uint32(n_slots)
    for j in range(7):
        np.testing.assert_array_equal(s, want[:, j])
        s = s + h2                                  # < 2**32: no wrap
        s = np.where(s >= n, s - n, s).astype(np.uint32)


# --------------------------- wrapper contract --------------------------------
def test_wrappers_take_the_plain_version_only_on_cpu(tb):
    before = dict(LAUNCHES)
    k = torch.arange(5, dtype=torch.int64)
    merge_k.merge_pair(k, k, k, k)
    f = bloom_k.bloom_build(k, 1280, 7)
    bloom_k.bloom_probe(f, k, 7)
    assert LAUNCHES == before                  # the plain versions ran
    assert tb.launches is LAUNCHES and set(LAUNCHES) == {
        "merge_pair", "bloom_build", "bloom_probe", "probe_tier",
        "probe_store", "flash_attention", "flash_attention_bwd_prep",
        "flash_attention_bwd_dkv", "flash_attention_bwd_dq"}
    m = torch.empty(5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        merge_k.merge_pair(m, m, m, m)
    with pytest.raises(ValueError, match="int64"):
        merge_k.merge_pair(k.int(), k, k, k)
    with pytest.raises(ValueError, match="multiple of 128"):
        bloom_k.bloom_build(k, 1000, 7)


def test_tier_wrapper_contract():
    before = dict(LAUNCHES)
    k = torch.arange(5, dtype=torch.int64)
    fs = [bloom_k.bloom_build(k, 1280, 7), bloom_k.bloom_build(k + 9, 256, 7)]
    t = torch.tensor([0, 1, 1, 0, 1])
    got = bloom_k.bloom_probe_tier(fs, k, t, 7)
    assert got.tolist() == [True, False, False, True, False]
    assert LAUNCHES == before                  # the plain versions ran
    assert bloom_k.tier_table(fs) == [fs[0].data_ptr(), fs[1].data_ptr(),
                                      1280, 256]
    with pytest.raises(ValueError, match="tidx 4"):
        bloom_k.bloom_probe_tier(fs, k, t[:4], 7)
    with pytest.raises(ValueError, match="no filters"):
        bloom_k.bloom_probe_tier([], k, t, 7)
    with pytest.raises(ValueError, match=r"filts\[1\]"):
        bloom_k.bloom_probe_tier([fs[0], fs[1].reshape(-1)], k, t, 7)
    with pytest.raises(ValueError, match=r"filts\[1\] lies on meta"):
        bloom_k.bloom_probe_tier([fs[0], fs[1].to("meta")], k, t, 7)
    assert bloom_k.bloom_probe_tier([], k[:0], t[:0], 7).shape == (0,)
    m = torch.empty(5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        bloom_k.bloom_probe_tier([fs[0].to("meta")], m, m, 7)
    # Host keys go with filters on a device; CPU filters take no keys
    # from a device.
    with pytest.raises(ValueError, match="no kernel for device"):
        bloom_k.bloom_probe_tier([fs[0].to("meta")], k, t, 7)
    with pytest.raises(ValueError, match="several devices"):
        bloom_k.bloom_probe_tier(fs, m, m, 7)
    with pytest.raises(ValueError, match="several devices"):
        bloom_k.bloom_probe_tier([fs[0].to("meta")], k, m, 7)
