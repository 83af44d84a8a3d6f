"""K4 (``probe_tier``) and K3 (``probe_store``) on the CPU: the plain
versions (assignment on the device side included) and the engine's call
``lookup.probe_host`` against the host's ``assign_bounds`` and against
``repro``'s ``NumpyBackend``, plus ``PallasBackend(interpret=True)`` where
that backend takes the keys (0 to 2**31 - 2). The kernels return ``pos`` and
``ti`` as int32 and the flags as bytes; the backend widens them, and
every comparison is of the widened fields, bit for bit."""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.engine import NumpyBackend, PallasBackend  # noqa: E402
from repro.core.lsm.sstable import partition_run as ref_partition  # noqa: E402
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro_torch.core.engine import backend as port_backend  # noqa: E402
from repro_torch.core.engine.backend import assign_bounds  # noqa: E402
from repro_torch.core.engine.torch_backend import TorchBackend  # noqa: E402
from repro_torch.core.lsm.sstable import TOMBSTONE  # noqa: E402
from repro_torch.core.lsm.sstable import partition_run as port_partition  # noqa: E402
from repro_torch.core.lsm.sstable import reset_sst_ids as port_reset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.kernels.lookup import lookup as lookup_k  # noqa: E402
from repro_torch.kernels.merge import merge as merge_k  # noqa: E402

K_HASHES = 7
FIELDS = ("ti", "ok", "positive", "pos", "hit", "vals")
LOOKUP_CU = Path(lookup_k.__file__).resolve().parents[2] / "csrc" / \
    "lookup.cu"
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def tb():
    return TorchBackend(device="cpu")


def bloom_of(b):
    return lambda s: b.bloom_build(s.keys)


def tier_of(keys, vals, per_table):
    """The same disjoint, min_key-sorted tier in both packages."""
    ref_reset()
    port_reset()
    args = (0, 0, 256, 4 << 10, per_table * 256)
    return (port_partition(keys, vals, *args),
            ref_partition(keys, vals, *args))


def edge_queries(tables, rng, n_present=40):
    """Keys below the first start, above the last end, in every gap
    between tables, equal to every start and end, present keys, absent
    keys inside tables, the int64 extremes and ``TOMBSTONE``."""
    starts = np.array([t.min_key for t in tables])
    ends = np.array([t.max_key for t in tables])
    allk = np.concatenate([t.keys for t in tables])
    gaps = ends[:-1][ends[:-1] + 1 < starts[1:]] + 1
    return np.concatenate([
        [starts[0] - 1, ends[-1] + 1, I64.min, I64.max, TOMBSTONE, 0, -1],
        starts, ends, gaps, rng.choice(allk, n_present), allk[:5] + 1,
    ]).astype(np.int64)


def assert_fields(got, want, fields=FIELDS, msg=""):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f"{msg} {f}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} field={f}")


def spaced_tier(lo, n, step, per_table):
    """Keys lo, lo + step, ... (n of them): every query between two keys
    misses, and the tables' bounds leave gaps of step - 1 keys."""
    keys = (lo + step * np.arange(n)).astype(np.int64)
    return tier_of(keys, keys * 3 + 1, per_table)


def _layouts():
    rng = np.random.default_rng(0)
    wide = np.unique(rng.integers(-2**50, 2**50, 900)).astype(np.int64)
    neg = np.sort(rng.choice(np.arange(-5000, 0), 400,
                             replace=False)).astype(np.int64)
    with_tomb = np.unique(np.concatenate([[TOMBSTONE, -7, 2**31 + 5],
                                          rng.integers(-2**40, 2**40, 300)]))
    return {
        "one_table": [lambda: spaced_tier(100, 50, 4, 256)],
        "gaps": [lambda: spaced_tier(0, 600, 7, 100),
                 lambda: spaced_tier(3, 300, 11, 64)],
        "negative": [lambda: tier_of(neg, neg, 64),
                     lambda: spaced_tier(-3000, 200, 5, 50)],
        "beyond_int32": [lambda: tier_of(wide, wide ^ 5, 128),
                         lambda: tier_of(with_tomb, with_tomb, 100)],
    }


# Layouts whose keys the Pallas backend takes (0 <= key < 2**31 - 1).
PALLAS_LAYOUTS = ("one_table", "gaps")


@pytest.mark.parametrize("layout", sorted(_layouts()))
def test_edge_queries_match_the_reference(tb, layout):
    """Per tier (K4) and over the whole store (K3), field by field,
    assignment included, against NumpyBackend (and Pallas in interpret
    mode where it takes the keys)."""
    tiers = [make() for make in _layouts()[layout]]
    rng = np.random.default_rng(1)
    q = np.concatenate([edge_queries(p, rng) for p, _ in tiers])
    if layout in PALLAS_LAYOUTS:
        q = q[(q >= 0) & (q < 2**31 - 1)]
    refs = [NumpyBackend()] + ([PallasBackend(interpret=True)]
                               if layout in PALLAS_LAYOUTS else [])
    got = tb.lookup_store_fused(
        tb.prepare_store([p for p, _ in tiers], bloom_of(tb)), q)
    for b in refs:
        want = b.lookup_store_fused(
            b.prepare_store([r for _, r in tiers], bloom_of(b)), q)
        assert_fields(got, want, FIELDS + ("win",), msg=b.name)
    assert got.hit.any() and not got.ok.all()
    for p, r in tiers:
        got = tb.lookup_fused(tb.prepare_tier(p, bloom_of(tb)), q)
        for b in refs:
            assert_fields(got, b.lookup_fused(b.prepare_tier(r, bloom_of(b)),
                                              q), msg=b.name)


@pytest.mark.parametrize("layout", sorted(_layouts()))
def test_plain_assignment_is_assign_bounds(tb, layout):
    """The plain versions' ti/ok rows, narrowed to int32 and bytes, equal
    the host's assign_bounds on every tier, and K3's rows equal K4's."""
    tiers = [make()[0] for make in _layouts()[layout]]
    rng = np.random.default_rng(2)
    q = np.concatenate([edge_queries(p, rng) for p in tiers])
    qt = torch.from_numpy(q)
    sview = tb.prepare_store(tiers, bloom_of(tb)).payload
    store = lookup_k.unpack(lookup_k.probe_store_plain(sview, qt, K_HASHES),
                            len(tiers), len(q), True)
    assert store["ti"].dtype == torch.int32 and store["ok"].dtype == torch.bool
    for r, tier in enumerate(tiers):
        ti, ok = assign_bounds(np.array([t.min_key for t in tier]),
                               np.array([t.max_key for t in tier]), q)
        view = tb.prepare_tier(tier, bloom_of(tb)).payload
        one = lookup_k.unpack(lookup_k.probe_tier_plain(view, qt, K_HASHES),
                              1, len(q), False)
        np.testing.assert_array_equal(one["ti"][0].numpy(), ti)
        np.testing.assert_array_equal(one["ok"][0].numpy(), ok)
        for f in ("ti", "ok", "positive", "pos", "hit", "vals"):
            assert torch.equal(one[f][0], store[f][r]), f


def test_no_tiers_and_no_queries(tb):
    """R = 0 gives a (0, K) lookup without a launch; K = 0 gives (R, 0)
    fields of the reference's types, on both kernels."""
    tiers = [spaced_tier(0, 300, 3, 64), spaced_tier(1, 100, 5, 64)]
    rng = np.random.default_rng(3)
    q = rng.integers(-100, 2000, 64).astype(np.int64)
    empty = np.zeros(0, np.int64)
    nb = NumpyBackend()
    before = dict(LAUNCHES)
    for queries in (q, empty):
        assert_fields(tb.lookup_store_fused(tb.prepare_store([], bloom_of(tb)),
                                            queries),
                      nb.lookup_store_fused(nb.prepare_store([], bloom_of(nb)),
                                            queries), FIELDS + ("win",))
    got = tb.lookup_store_fused(
        tb.prepare_store([p for p, _ in tiers], bloom_of(tb)), empty)
    want = nb.lookup_store_fused(
        nb.prepare_store([r for _, r in tiers], bloom_of(nb)), empty)
    assert got.ti.shape == (2, 0)
    assert_fields(got, want, FIELDS + ("win",))
    got = tb.lookup_fused(tb.prepare_tier(tiers[0][0], bloom_of(tb)), empty)
    assert_fields(got, nb.lookup_fused(
        nb.prepare_tier(tiers[0][1], bloom_of(nb)), empty))
    assert LAUNCHES == before


@st.composite
def _tiers(draw):
    """1-4 tiers of 1-6 tables each, of 1-40 keys, drawn from a range
    that may be negative or beyond int32, so tiers overlap or not."""
    out = []
    for _ in range(draw(st.integers(1, 4))):
        lo = draw(st.sampled_from([-2**45, -5000, 0, 2**31 - 200, 2**40]))
        span = draw(st.sampled_from([300, 10_000, 2**33]))
        n_tables = draw(st.integers(1, 6))
        per = draw(st.integers(1, 40))
        seed = draw(st.integers(0, 2**32 - 1))
        rng = np.random.default_rng(seed)
        n = n_tables * per
        keys = np.unique(rng.integers(lo, lo + span, 2 * n + 4))[:n]
        out.append((keys.astype(np.int64), per,
                    rng.integers(-2**62, 2**62, len(keys))))
    return out


@settings(database=None, max_examples=30, deadline=None)
@given(_tiers(), st.integers(0, 2**32 - 1))
def test_property_random_tiers_match_numpy(tb, tiers, seed):
    """Random tiers and queries (boundaries, gaps, present and absent
    keys): the engine's call over the store and over each tier equals
    NumpyBackend field by field, and its ti/ok equal assign_bounds."""
    rng = np.random.default_rng(seed)
    built = [tier_of(k, v, per) for k, per, v in tiers]
    nb = NumpyBackend()
    q = np.concatenate([edge_queries(p, rng, 10) for p, _ in built]
                       + [rng.integers(-2**46, 2**46, 20)]).astype(np.int64)
    got = tb.lookup_store_fused(
        tb.prepare_store([p for p, _ in built], bloom_of(tb)), q)
    want = nb.lookup_store_fused(
        nb.prepare_store([r for _, r in built], bloom_of(nb)), q)
    assert_fields(got, want, FIELDS + ("win",))
    for r, (p, _) in enumerate(built):
        ti, ok = assign_bounds(np.array([t.min_key for t in p]),
                               np.array([t.max_key for t in p]), q)
        np.testing.assert_array_equal(got.ti[r], ti)
        np.testing.assert_array_equal(got.ok[r], ok)
        one = tb.lookup_fused(tb.prepare_tier(p, bloom_of(tb)), q)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(one, f),
                                          getattr(got, f)[r], err_msg=f)


# --------------------------- layout and engine call --------------------------
@pytest.mark.parametrize("R,K,store", [(1, 5, False), (3, 7, True),
                                       (8, 4096, True), (2, 0, True)])
def test_output_layout(R, K, store):
    """19 bytes a (tier, query) pair and 4 a query for K3's winner, in one
    int64 buffer; the fields tile it in order without overlap."""
    assert lookup_k.out_bytes(R, K, store) == 19 * R * K + 4 * K * store
    out = torch.zeros(lookup_k.out_words(R, K, store), dtype=torch.int64)
    f = lookup_k.unpack(out, R, K, store)
    raw = out.view(torch.uint8)
    for i, t in enumerate(f.values()):
        t.view(torch.uint8).fill_(i + 1)
    counts = torch.bincount(raw.long(), minlength=len(f) + 1)
    sizes = [t.numel() * t.element_size() for t in f.values()]
    assert counts[1:].tolist() == sizes
    assert int(counts[0]) == len(raw) - sum(sizes) < 8
    assert [t.dtype for t in f.values()] == (
        [torch.int64, torch.int32, torch.int32]
        + [torch.int32] * store + [torch.bool] * 3)


def test_engine_call_owns_its_result(tb):
    """Two lookups in a row: the first result is not overwritten by the
    second; no launch on the CPU."""
    p, _ = spaced_tier(0, 400, 3, 64)
    view = tb.prepare_tier(p, bloom_of(tb))
    q1 = np.arange(0, 1200, 3, dtype=np.int64)
    q2 = q1 + 1
    before = dict(LAUNCHES)
    r1 = tb.lookup_fused(view, q1)
    keep = {f: getattr(r1, f).copy() for f in FIELDS}
    r2 = tb.lookup_fused(view, q2)
    assert r1.hit.all() and not r2.hit.any()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(r1, f), keep[f])
    assert LAUNCHES == before


def test_staging_grows_its_device_buffer_only():
    st = merge_k.Staging("cpu")
    d = st.take_device(10)
    assert len(d) >= 10 and st.take_device(len(d)) is d
    assert len(st.take_device(len(d) + 1)) >= 2 * len(d)


def test_lookup_path_never_assigns_on_the_host(tb, monkeypatch):
    """The backend's fused lookups call no assign_bounds, and a lookup
    checks only its queries: the view was checked when it was made."""
    tiers = [spaced_tier(0, 300, 3, 64)[0], spaced_tier(1, 200, 5, 64)[0]]
    tview = tb.prepare_tier(tiers[0], bloom_of(tb))
    sview = tb.prepare_store(tiers, bloom_of(tb))

    def refuse(*a):
        raise AssertionError("assign_bounds on the lookup path")
    checked = []
    real = lookup_k.expect
    monkeypatch.setattr(port_backend, "assign_bounds", refuse)
    monkeypatch.setattr(lookup_k, "expect",
                        lambda t, name, *a: (checked.append(name),
                                             real(t, name, *a)))
    q = np.arange(-5, 1000, 2, dtype=np.int64)
    tb.lookup_fused(tview, q)
    tb.lookup_store_fused(sview, q)
    assert checked == ["q", "q"]


def test_view_is_checked_once_when_made(tb):
    p, _ = spaced_tier(0, 300, 3, 64)
    view = tb.prepare_tier(p, bloom_of(tb)).payload
    tables = np.stack([getattr(view, n).numpy() for n in lookup_k.META_ROWS])
    args = (view.keys, view.vals, view.fbits)
    lookup_k.View(*args, tables, [0, view.n_tables])
    bad = {
        "every tier needs a table": (tables, [0, 0, view.n_tables]),
        "cover all": (tables, [0, view.n_tables - 1]),
        "run is empty or outside": (tables + np.array(
            [[0], [0], [1], [0], [0], [0]]), [0, view.n_tables]),
        "filter is empty or outside": (tables + np.array(
            [[1], [0], [0], [0], [0], [0]]), [0, view.n_tables]),
    }
    for msg, (tab, t_off) in bad.items():
        with pytest.raises(ValueError, match=msg):
            lookup_k.View(*args, tab, t_off)
    with pytest.raises(ValueError, match="vals"):
        lookup_k.View(view.keys, view.vals[:-1], view.fbits, tables,
                      [0, view.n_tables])
    with pytest.raises(ValueError, match="bool"):
        lookup_k.View(view.keys, view.vals, view.fbits.long(), tables,
                      [0, view.n_tables])
    q = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="lies on"):
        lookup_k.probe_tier(view, q.to("meta"), K_HASHES)
    with pytest.raises(ValueError, match="k_hashes"):
        lookup_k.probe_tier(view, q, lookup_k.MAX_HASHES + 1)


# --------------------------- the C entries and constants ---------------------
def _c_entries():
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   LOOKUP_CU.read_text()):
        out[name] = len(params.split(","))
    return out


@pytest.mark.parametrize("name", ["probe_tier", "probe_store",
                                  "probe_floor"])
def test_lookup_c_entry_takes_the_arguments_build_declares(name):
    assert _c_entries()[name] == len(build.SIGNATURES[name])


def test_lookup_constants_match_lookup_cu():
    text = LOOKUP_CU.read_text()
    assert variants.constant(text, "kMaxHashes") == lookup_k.MAX_HASHES
    bands = [variants.constant(text, f"kPairsFor{m}Lanes")
             for m in (32, 16, 8)]
    assert 0 < bands[0] <= bands[1] <= bands[2]


_vspec = importlib.util.spec_from_file_location(
    "variants", LOOKUP_CU.parents[3] / "tools" / "variants.py")
variants = importlib.util.module_from_spec(_vspec)
_vspec.loader.exec_module(variants)


@pytest.mark.parametrize("name", ["kPairsFor32Lanes", "kPairsFor16Lanes",
                                  "kPairsFor8Lanes"])
def test_lookup_paths_moves_each_constant(name):
    text = LOOKUP_CU.read_text()
    moved = variants.with_constant(text, name, 12345)
    assert variants.constant(moved, name) == 12345
    assert sum(a != b for a, b in zip(moved.splitlines(),
                                      text.splitlines())) == 1


def _lookup_paths():
    tools = str(LOOKUP_CU.parents[3] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        "lookup_paths", LOOKUP_CU.parents[3] / "tools" / "lookup_paths.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pairs, lanes", [(1, 32), (2048, 32), (2049, 16),
                                          (8192, 16), (8193, 8),
                                          (16384, 8), (16385, 4),
                                          (10**6, 4)])
def test_lookup_paths_reads_the_lane_rule_of_lookup_cu(pairs, lanes):
    """The tool's ``rule_lanes`` follow ``lookup.cu``'s ``lanes_for``: the
    first of 32, 16 and 8 lanes whose pair count holds the call's pairs,
    else 4; and each of its forced settings gives every call one count."""
    tool = _lookup_paths()
    text = LOOKUP_CU.read_text()
    here = {c: variants.constant(text, c)
            for c in tool.LANE_CONSTANTS.values()}
    body = re.search(r"int lanes_for\(int64_t pairs\) \{(.*?)\}", text,
                     re.S).group(1)
    assert re.findall(r"pairs <= (\w+)\s*\?\s*(\d+)", body) == [
        (c, str(m)) for m, c in tool.LANE_CONSTANTS.items()]
    assert tool.lanes_for(here, pairs) == lanes
    for forced in tool.LANES:
        setting = {c: tool.ALL_PAIRS if m <= forced else 0
                   for m, c in tool.LANE_CONSTANTS.items()}
        assert tool.lanes_for(setting, pairs) == forced
