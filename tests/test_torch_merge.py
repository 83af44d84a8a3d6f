"""K1's k-run form on the CPU against the reference: the port's engine call
(``TorchBackend(device="cpu").merge_runs``/``ingest_run``: joining, packing,
``merge_runs_plain``, the copy back and the host compaction), its plain
functions, and ``repro``'s Pallas composition in interpret mode
(``merge_runs_device``, ``ingest_run``, ``_diag_splits``) or, for keys
beyond int32, ``merge_runs_numpy``. Every comparison is bit for bit."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine.numpy_backend import (  # noqa: E402
    NumpyBackend as RefNumpy, ingest_order as ref_ingest_order,
    merge_runs_numpy as ref_merge_runs_numpy)
from repro.kernels.merge import ops as merge_ops  # noqa: E402
from repro_torch.core.engine.torch_backend import TorchBackend  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.kernels.merge import merge as merge_k  # noqa: E402

INT32_MAX = 2**31 - 1
MERGE_CU = Path(merge_k.__file__).resolve().parents[2] / "csrc" / "merge.cu"


@pytest.fixture(scope="module")
def tb():
    return TorchBackend(device="cpu")


def _runs(rng, lens, *, lo=0, hi=400, dups=True, tie=None):
    """Newest-first sorted runs of ``lens`` keys in [lo, hi): in-run
    duplicates where ``dups``, and where ``tie`` is given that key in every
    non-empty run. Values are int32-range, as the Pallas path needs."""
    runs = []
    for n in lens:
        k = rng.integers(lo, hi, n)
        if dups and n > 3:
            k[1::4] = k[0::4][: len(k[1::4])]
        if tie is not None and n:
            k[0] = tie
        runs.append((np.sort(k).astype(np.int64),
                     rng.integers(-2**31 + 1, 2**31 - 1, n).astype(np.int64)))
    return runs


def _slots_by_rank_rule(runs):
    """The k-run rank rule spelled out: element j of run r with key x goes
    to slot j + #{keys <= x in newer runs} + #{keys < x in older runs}, and
    keeps its flag iff it is the first x of its run and no newer run holds
    x. Returns keys, values and flags by slot."""
    n = sum(len(k) for k, _ in runs)
    keys, vals, keep = (np.full(n, -1, np.int64), np.zeros(n, np.int64),
                        np.zeros(n, bool))
    for r, (kr, vr) in enumerate(runs):
        for j, x in enumerate(kr):
            slot = j
            first = j == 0 or kr[j - 1] != x
            for s, (ks, _) in enumerate(runs):
                if s < r:
                    slot += np.searchsorted(ks, x, side="right")
                    first = first and x not in ks
                elif s > r:
                    slot += np.searchsorted(ks, x, side="left")
            keys[slot], vals[slot], keep[slot] = x, vr[j], first
    return keys, vals, keep


def _packed(runs):
    offs = np.cumsum([0] + [len(k) for k, _ in runs]).astype(np.int64)
    buf = np.empty(len(offs) + 2 * int(offs[-1]), np.int64)
    merge_k.pack_runs(runs, offs, buf)
    return torch.from_numpy(buf), len(runs), int(offs[-1])


def _fold(runs):
    """The pairwise fold the engine's call replaces: ``merge_pair`` on the
    host tensors, each merge's keep mask applied before the next."""
    runs = [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in runs
            if len(k)]
    if len(runs) == 1:
        return runs[0][0].numpy(), runs[0][1].numpy()
    ka, va = runs[0]
    for kb, vb in runs[1:]:
        mk, mv, keep = merge_k.merge_pair(ka, va, kb, vb)
        ka, va = mk[keep], mv[keep]
    return ka.numpy(), va.numpy()


# --------------------------- k-run merges ------------------------------------
K_RUN_CASES = {
    "k2": [40, 33],
    "k2_empty": [0, 57],
    "k3": [25, 0, 31],
    "k3_ones": [1, 1, 1],
    "k5": [20, 9, 0, 44, 13],
    "k5_tie": [17, 3, 29, 1, 8],
    "k12": [11, 0, 7, 23, 5, 1, 19, 9, 14, 0, 6, 30],
    "k12_tie": [4] * 12,
}


@pytest.mark.parametrize("name", sorted(K_RUN_CASES))
def test_k_run_merge_matches_pallas_and_numpy(tb, name):
    rng = np.random.default_rng(len(name) * 7 + sum(K_RUN_CASES[name]))
    runs = _runs(rng, K_RUN_CASES[name], tie=77 if "tie" in name else None)
    k, v = tb.merge_runs(runs)
    assert k.dtype == np.int64 and v.dtype == np.int64
    for got, want in zip((k, v), ref_merge_runs_numpy(runs)):
        np.testing.assert_array_equal(got, want)
    pk, pv = merge_ops.merge_runs_device(runs, interpret=True)
    np.testing.assert_array_equal(k, pk.astype(np.int64))
    np.testing.assert_array_equal(v, pv.astype(np.int64))
    for got, want in zip((k, v), _fold(runs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lens", [[40, 33], [25, 0, 31], [20, 9, 0, 44, 13],
                                  [11, 0, 7, 23, 5, 1, 19, 9, 14, 0, 6, 30]])
def test_k_run_merge_beyond_int32_matches_numpy(tb, lens):
    rng = np.random.default_rng(sum(lens))
    runs = _runs(rng, lens, lo=-2**62, hi=2**62, tie=-(2**40) - 1)
    runs = [(k, rng.integers(-2**62, 2**62, len(k))) for k, _ in runs]
    for got, want in zip(tb.merge_runs(runs), ref_merge_runs_numpy(runs)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tb.merge_runs(runs), RefNumpy().merge_runs(runs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(K_RUN_CASES))
def test_merge_runs_plain_follows_the_rank_rule(name):
    # The plain k-run form (a stable sort) and the kernel's rank rule give
    # the same slots and flags, in-run duplicates and cross-run ties too.
    rng = np.random.default_rng(sum(K_RUN_CASES[name]) + 3)
    runs = _runs(rng, K_RUN_CASES[name], lo=-2**40, hi=2**40,
                 tie=2**33 + 1 if "tie" in name else None)
    p, k, n = _packed(runs)
    out = merge_k.merge_runs(p, k, n)           # the plain version on the CPU
    assert out.shape == (merge_k.out_words(n),)
    for got, want in zip(merge_k.unpack(out, n), _slots_by_rank_rule(runs)):
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------- joining adjacent runs ---------------------------
def _level(rng, n_olds, *, touching=False):
    """A victim table and ``n_olds`` adjacent disjoint tables of the next
    level (with in-run duplicates); with ``touching``, two neighbours share
    their boundary key, so they must not join."""
    old = np.unique(rng.integers(0, 10**6, 60 * n_olds))
    olds = []
    for c in np.array_split(old, n_olds):
        c = np.sort(np.concatenate([c, c[1:3]]))
        olds.append((c, rng.integers(-2**31 + 1, 2**31 - 1, len(c))))
    if touching:
        k0 = olds[1][0]
        k0[0] = olds[0][0][-1]
    victim = np.sort(rng.choice(old, 50))
    return [(victim, rng.integers(-2**31 + 1, 2**31 - 1, 50))] + olds


JOIN_CASES = {
    "level_k11": (lambda rng: _level(rng, 10), 2),
    "level_touching": (lambda rng: _level(rng, 4, touching=True), 3),
    "disjoint_to_one_run": (
        lambda rng: [(np.array([1, 1, 2, 5], np.int64), np.arange(4)),
                     (np.array([7, 8, 8], np.int64), np.arange(3) + 10),
                     (np.array([9, 9], np.int64), np.arange(2) + 20)], 1),
    "empty_between": (
        lambda rng: [(np.array([3, 4], np.int64), np.arange(2)),
                     (np.zeros(0, np.int64), np.zeros(0, np.int64)),
                     (np.array([5, 5, 6], np.int64), np.arange(3) + 5)], 1),
    "newer_above_older": (
        lambda rng: [(np.array([50, 60], np.int64), np.arange(2)),
                     (np.array([1, 2, 2], np.int64), np.arange(3) + 5)], 2),
}


@pytest.mark.parametrize("name", sorted(JOIN_CASES))
def test_joining_runs_matches_the_fold(tb, name):
    make, k_joined = JOIN_CASES[name]
    runs = make(np.random.default_rng(len(name)))
    runs = [(np.asarray(k, np.int64), np.asarray(v, np.int64))
            for k, v in runs]
    offs = merge_k.run_offsets(runs)
    assert len(offs) - 1 == k_joined and offs[-1] == sum(
        len(k) for k, _ in runs)
    got = tb.merge_runs(runs)
    for g, w in zip(got, _fold(runs)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, ref_merge_runs_numpy(runs)):
        np.testing.assert_array_equal(g, w)
    assert np.all(np.diff(got[0]) > 0)          # in-run duplicates dropped


# --------------------------- the merge-path split rule -----------------------
SPLIT_CASES = {
    "distinct": dict(na=700, nb=900, hi=10**6),
    "dups": dict(na=1500, nb=1300, hi=40),
    "all_equal": dict(na=1100, nb=1600, hi=1),
    "one_empty": dict(na=0, nb=1500, hi=100),
    "short_newer": dict(na=3, nb=2100, hi=50),
}


@pytest.mark.parametrize("tile", [512, merge_k.TILE])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_rule_matches_diag_splits(name, tile):
    c = SPLIT_CASES[name]
    rng = np.random.default_rng(c["na"] + c["nb"] + tile)
    ka = np.sort(rng.integers(0, c["hi"], c["na"])).astype(np.int64)
    kb = np.sort(rng.integers(0, c["hi"], c["nb"])).astype(np.int64)
    n = len(ka) + len(kb)
    diags = np.minimum(np.arange(-(-n // tile) + 1) * tile, n)
    got = merge_k.merge_path_splits_plain(
        torch.from_numpy(ka), torch.from_numpy(kb), torch.from_numpy(diags))
    if len(ka) and len(kb):         # the reference handles an empty run apart
        want = merge_ops._diag_splits(jnp.asarray(ka, jnp.int32),
                                      jnp.asarray(kb, jnp.int32),
                                      jnp.asarray(diags, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ai = got.numpy()
    bi = diags - ai
    a_len, b_len = np.diff(ai), np.diff(bi)
    assert (a_len >= 0).all() and (b_len >= 0).all()
    np.testing.assert_array_equal(a_len + b_len, np.diff(diags))
    assert (a_len[:-1] + b_len[:-1] == tile).all()
    # Each tile's windows merge to exactly that tile of the whole merge.
    va, vb = (torch.arange(len(x), dtype=torch.int64) for x in (ka, kb))
    ta, tb_ = torch.from_numpy(ka), torch.from_numpy(kb)
    whole = merge_k.merge_pair_plain(ta, va, tb_, vb + len(ka))
    for t in range(len(diags) - 1):
        part = merge_k.merge_pair_plain(
            ta[ai[t]:ai[t + 1]], va[ai[t]:ai[t + 1]],
            tb_[bi[t]:bi[t + 1]], vb[bi[t]:bi[t + 1]] + len(ka))
        for p, w in zip(part[:2], whole[:2]):
            np.testing.assert_array_equal(p.numpy(),
                                          w[diags[t]:diags[t + 1]].numpy())


# --------------------------- ingest ------------------------------------------
INGEST_CASES = {
    "dup_spans_split": np.array([5, 9, 5, 1, 9, 5, 9, 1, 5, 5], np.int64),
    "all_one_key": np.full(33, 4, np.int64),
    "halves_disjoint": np.arange(40, dtype=np.int64)[::-1].copy(),
    "many_dups": np.random.default_rng(4).integers(0, 30, 301),
    "split_key_repeated": np.concatenate([np.arange(20), np.full(20, 20),
                                          np.arange(21, 41)]),
}


@pytest.mark.parametrize("name", sorted(INGEST_CASES))
def test_ingest_run_across_the_split_matches_pallas_and_numpy(tb, name):
    keys = np.asarray(INGEST_CASES[name], np.int64)
    rng = np.random.default_rng(len(keys))
    rng.shuffle(keys)
    vals = rng.integers(-2**31 + 1, 2**31 - 1, len(keys)).astype(np.int64)
    got = tb.ingest_run(keys, vals)
    for g, w in zip(got, RefNumpy().ingest_run(keys, vals)):
        np.testing.assert_array_equal(g, w)
    order = ref_ingest_order(keys)
    pk, psrc = merge_ops.ingest_run(keys[order].astype(np.int32),
                                    order.astype(np.int32), interpret=True)
    np.testing.assert_array_equal(got[0], pk.astype(np.int64))
    np.testing.assert_array_equal(got[2], psrc.astype(np.int64))


# --------------------------- the engine call's host side ---------------------
def test_engine_call_reuses_one_staging_buffer_and_launches_nothing_on_cpu():
    tb = TorchBackend(device="cpu")
    before = dict(LAUNCHES), dict(merge_k.ROUTES)
    rng = np.random.default_rng(0)
    tb.merge_runs(_runs(rng, [50, 60, 70]))
    buf = tb._staging.buf
    assert not buf.is_pinned()                  # pinned only for a GPU
    tb.merge_runs(_runs(rng, [5, 6]))
    tb.ingest_run(rng.integers(0, 9, 100), np.arange(100))
    assert tb._staging.buf is buf               # reused, not reallocated
    big = [(np.arange(40000, dtype=np.int64) * 2, np.zeros(40000, np.int64)),
           (np.arange(5, dtype=np.int64), np.zeros(5, np.int64))]
    tb.merge_runs(big)
    assert len(tb._staging.buf) >= 2 * 40005 * 2  # grew to fit
    assert (dict(LAUNCHES), dict(merge_k.ROUTES)) == before


def test_merge_runs_wrapper_contract():
    p, k, n = _packed(_runs(np.random.default_rng(1), [3, 4]))
    with pytest.raises(ValueError, match="k >= 1"):
        merge_k.merge_runs(p, 0, n)
    with pytest.raises(ValueError, match="words"):
        merge_k.merge_runs(p[:-1], k, n)
    with pytest.raises(ValueError, match="int64"):
        merge_k.merge_runs(p.int(), k, n)
    m = torch.empty(len(p), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        merge_k.merge_runs(m, k, n)


def test_tile_matches_merge_cu():
    src = MERGE_CU.read_text()
    threads = int(re.search(r"constexpr int kTileThreads = (\d+);",
                            src).group(1))
    items = int(re.search(r"constexpr int kTileItems = (\d+);", src).group(1))
    assert threads * items == merge_k.TILE


# --------------------------- the pair form and the C entry -------------------
@pytest.mark.parametrize("na,nb", [(5, 7), (0, 4), (4, 0), (0, 0), (300, 1)])
def test_pair_packs_as_two_runs(na, nb):
    rng = np.random.default_rng(na * 10 + nb)
    runs = _runs(rng, [na, nb], tie=3)
    args = [torch.from_numpy(x) for run in runs for x in run]
    p = merge_k.pack_pair(*args)
    want, k, n = _packed(runs)
    assert k == 2 and torch.equal(p, want)
    got = merge_k.unpack(merge_k.merge_runs_plain(p, 2, n), n)
    for g, w in zip(got, merge_k.merge_pair_plain(*args)):
        assert torch.equal(g, w)


def _c_entries():
    """Name -> argument count of every ``extern "C"`` entry in csrc."""
    out = {}
    for src in MERGE_CU.parent.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            out[name] = len(params.split(","))
    return out


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_c_entry_takes_the_arguments_build_declares(name):
    assert _c_entries()[name] == len(build.SIGNATURES[name])


def test_every_c_entry_is_declared():
    assert set(_c_entries()) == set(build.SIGNATURES)


# --------------------------- tools/variants.py -------------------------------
_vspec = importlib.util.spec_from_file_location(
    "variants", MERGE_CU.parents[3] / "tools" / "variants.py")
variants = importlib.util.module_from_spec(_vspec)
_vspec.loader.exec_module(variants)


@pytest.mark.parametrize("source,name", [
    ("merge.cu", "kSharedMaxKeys"), ("merge.cu", "kSharedMaxPairKeys"),
    ("merge.cu", "kTileThreads"), ("merge.cu", "kTileItems"),
    ("merge.cu", "kMaxSharedBytes"), ("merge.cu", "kSharedMaxRuns"),
    ("bloom.cu", "kSharedMaxSlots"), ("bloom.cu", "kMaxSharedSlots")])
def test_tools_set_each_constant_they_move(source, name):
    text = (MERGE_CU.parent / source).read_text()
    moved = variants.with_constant(text, name, 12345)
    assert variants.constant(moved, name) == 12345
    assert len(moved.splitlines()) == len(text.splitlines())
    assert sum(a != b for a, b in zip(moved.splitlines(),
                                      text.splitlines())) == 1


def test_tools_refuse_a_constant_that_is_not_declared_once():
    with pytest.raises(ValueError):
        variants.with_constant(MERGE_CU.read_text(), "kNoSuchConstant", 1)
