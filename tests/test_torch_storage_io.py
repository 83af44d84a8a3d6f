"""The port's files medium (``repro_torch.core.storage_io``) against the
reference's (``repro.core.storage_io``), on the CPU.

* A twin of every case of ``tests/test_storage_io.py``: the same inputs
  through both packages, their results equal and the files they leave
  equal byte for byte.
* Byte identity of whole planes: the seeded kill workload on the files
  medium in both packages, with the replay store's 192 KB log cap
  (log-triggered flushes, checkpoints, truncation and segment rollover),
  over 1 and 4 shards and under each fsync policy, leaves the same files
  under ``storage_dir``. The CHECKPOINT frame pickles ``IOStats``, whose
  ``fsync_wait_us`` reads the wall clock, so these runs give both
  packages' ``wal_files`` one deterministic clock; on the real clock that
  float is the only byte that may differ (``test_real_clock_...``).
* Cross-open both ways: a plane written by one package, recovered by the
  other, equals the writer's own recovery.
* Every pickled frame (ROUTER, CHECKPOINT) names only builtins and numpy.
* ``StoreConfig``'s files knobs: the reference's checks and messages.
"""
import itertools
import os
import pickletools
import shutil
from dataclasses import astuple
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kill_workload as ref_kw  # noqa: E402
import torch_kill_workload as port_kw  # noqa: E402
from test_config_validation import CASES as REF_CONFIG_CASES  # noqa: E402
from test_config_validation import base as ref_base  # noqa: E402
from test_config_validation import KB as CV_KB, MB as CV_MB  # noqa: E402
from test_differential import fingerprint  # noqa: E402

import repro.core as ref  # noqa: E402
import repro.core.storage_io as ref_io  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.core.storage_io as port_io  # noqa: E402
from repro.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS as REF_EXACT, recover as ref_recover)
from repro.core.durability.manifest import (  # noqa: E402
    ManifestEdit as RefEdit)
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro.core.storage_io import wal_files as ref_wal_files  # noqa: E402
from repro_torch.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS as PORT_EXACT, recover as port_recover)
from repro_torch.core.durability.manifest import (  # noqa: E402
    ManifestEdit as PortEdit)
from repro_torch.core.lsm.sstable import (  # noqa: E402
    reset_sst_ids as port_reset)
from repro_torch.core.storage_io import (  # noqa: E402
    wal_files as port_wal_files)
from repro_torch.core.storage_io.manifest_files import (  # noqa: E402
    TAG_CHECKPOINT, TAG_ROUTER)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

KB = 1024
# The card-vs-CPU replay store's log cap (chip_smoke.REPLAY_MAX_LOG_BYTES)
REPLAY_CAP = 192 * KB

PKGS = {
    "ref": SimpleNamespace(name="ref", io=ref_io, core=ref, kw=ref_kw,
                           wal_files=ref_wal_files, recover=ref_recover,
                           reset=ref_reset, Edit=RefEdit, exact=REF_EXACT),
    "port": SimpleNamespace(name="port", io=port_io, core=port, kw=port_kw,
                            wal_files=port_wal_files, recover=port_recover,
                            reset=port_reset, Edit=PortEdit,
                            exact=PORT_EXACT),
}
OTHER = {"ref": "port", "port": "ref"}


def files_of(root) -> dict:
    """{path under root: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def same_files(a, b) -> None:
    fa, fb = files_of(a), files_of(b)
    assert sorted(fa) == sorted(fb)
    bad = [k for k in fa if fa[k] != fb[k]]
    assert not bad, f"files differ: {bad}"


def run_both(tmp_path, fn):
    """``fn(P, root)`` in each package, each in its own directory; the
    results must be equal. Returns {name: result}."""
    out = {n: fn(P, str(tmp_path / n)) for n, P in PKGS.items()}
    assert out["port"] == out["ref"]
    return out


@pytest.fixture
def one_clock(monkeypatch):
    """``clock()`` gives both packages' ``wal_files`` a fresh deterministic
    ``perf_counter`` (1 us a call), so the clock readings that reach the
    files are the same when both make the same calls."""
    def clock():
        for P in PKGS.values():
            c = itertools.count()
            monkeypatch.setattr(P.wal_files, "time", SimpleNamespace(
                perf_counter=lambda c=c: next(c) * 1e-6))
    return clock


# ------------------------------ frame codec -----------------------------------
def test_frame_roundtrip_and_tail_offsets():
    frames = [(7, b"hello"), (0, b""), (2**40, b"x" * 1000)]
    blobs = {n: b"".join(P.io.build_frame(t, p) for t, p in frames)
             for n, P in PKGS.items()}
    assert blobs["port"] == blobs["ref"]
    for P in PKGS.values():
        out, end = P.io.scan_frames(blobs["ref"])
        assert out == frames and end == len(blobs["ref"])


@pytest.mark.parametrize("junk", [
    b"\x00" * 5,                         # partial header
    ref_io.build_frame(1, b"abc")[:-2],  # payload cut short
    b"\xff" * 40,                        # bad magic
], ids=["short-header", "cut-payload", "bad-magic"])
def test_scan_stops_at_torn_tail(junk):
    good = port_io.build_frame(3, b"keep me")
    for P in PKGS.values():
        out, end = P.io.scan_frames(good + junk)
        assert out == [(3, b"keep me")] and end == len(good)


def test_scan_stops_at_crc_mismatch():
    f = bytearray(port_io.build_frame(1, b"payload"))
    f[-3] ^= 0xFF                        # flip a payload bit
    for P in PKGS.values():
        assert P.io.scan_frames(bytes(f)) == ([], 0)


# ------------------------------ FileWAL ---------------------------------------
def _fill(wal, n=12, tree="t", entry_bytes=256, keys_per=16):
    rng = np.random.default_rng(0)
    wal.append_tree_create(tree, dataset=None, entry_bytes=None)
    for _ in range(n):
        keys = rng.integers(0, 1000, size=keys_per)
        wal.append_batch(tree, keys, keys * 2, entry_bytes=entry_bytes,
                         op=True)
        wal.commit(keys_per)


def _wal_state(w) -> tuple:
    return (w.head_lsn, w.next_seq, w.num_records, w.truncated_to,
            [r.seq for r in w._records], [r.buf for r in w._records],
            w.all_durable, w.durable_lsn)


def test_filewal_create_refuses_nonempty(tmp_path):
    for P in PKGS.values():
        root = tmp_path / P.name
        root.mkdir()
        (root / "stray").write_text("x")
        with pytest.raises(FileExistsError, match="not empty"):
            P.io.FileWAL.create(str(root))


def test_filewal_segments_roll_and_reopen(tmp_path):
    def run(P, root):
        wal = P.io.FileWAL.create(root, segment_bytes=2 * KB)
        _fill(wal, n=12)
        assert wal.segment_count > 1, "workload must roll segments"
        wal.close()
        return _wal_state(wal), wal.segment_count
    got = run_both(tmp_path, run)
    same_files(tmp_path / "ref", tmp_path / "port")
    # each package reopens the other's log as its own
    for n, P in PKGS.items():
        re = P.io.FileWAL.open(str(tmp_path / OTHER[n]),
                               segment_bytes=2 * KB)
        assert _wal_state(re) == got[n][0]
        assert re.all_durable and re.durable_lsn == re.head_lsn
        re.close()


def test_filewal_truncate_unlinks_sealed_segments(tmp_path):
    def run(P, root):
        wal = P.io.FileWAL.create(root, segment_bytes=2 * KB)
        _fill(wal, n=12)
        n_before = len(os.listdir(root))
        mid_rec = wal._records[len(wal._records) // 2]
        wal.truncate(mid_rec.lsn0, keep_after_seq=mid_rec.seq - 1)
        assert len(os.listdir(root)) < n_before, \
            "truncation must unlink whole dead segments"
        assert wal.truncated_to == mid_rec.lsn0
        wal.close()
        re = P.io.FileWAL.open(root, segment_bytes=2 * KB)
        assert _wal_state(re)[:5] == _wal_state(wal)[:5]
        return _wal_state(re), sorted(os.listdir(root))
    run_both(tmp_path, run)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_filewal_truncate_all_preserves_head_via_meta(tmp_path):
    def run(P, root):
        wal = P.io.FileWAL.create(root)
        _fill(wal, n=4)
        head = wal.head_lsn
        wal.truncate(head, keep_after_seq=wal.next_seq - 1)
        assert wal.num_records == 0
        wal.close()
        re = P.io.FileWAL.open(root)
        assert re.head_lsn == head and re.next_seq == wal.next_seq
        assert re.num_records == len(wal._records)
        return _wal_state(re)
    run_both(tmp_path, run)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_filewal_torn_tail_last_segment_only(tmp_path):
    def run(P, root):
        wal = P.io.FileWAL.create(root, segment_bytes=2 * KB)
        _fill(wal, n=12)
        wal.close()
        paths = sorted(p for p in os.listdir(root) if p.startswith("seg-"))
        with open(os.path.join(root, paths[-1]), "ab") as f:
            f.write(b"\xfftorn!")
        re = P.io.FileWAL.open(root, segment_bytes=2 * KB)
        assert re.num_records == wal.num_records    # tail dropped, healed
        re.close()
        healed = files_of(root)
        with open(os.path.join(root, paths[0]), "ab") as f:  # sealed file
            f.write(b"\xffbad")
        with pytest.raises(P.io.CorruptFrameError,
                           match="interior corruption"):
            P.io.FileWAL.open(root, segment_bytes=2 * KB)
        return _wal_state(re), healed
    run_both(tmp_path, run)


def test_fsync_policy_counts(tmp_path):
    n = 10

    def run(P, root):
        counts = {}
        for policy in ("per_record", "per_batch", "group"):
            wal = P.io.FileWAL.create(os.path.join(root, policy),
                                      fsync_policy=policy,
                                      group_bytes=16 * KB,
                                      group_max_wait_s=3600.0)
            _fill(wal, n=n)
            counts[policy] = [wal.fsyncs, wal.commit_hist.count]
            if policy == "group":
                assert not wal.all_durable           # tail still buffered
                assert wal.durable_lsn < wal.head_lsn
                wal.sync()
                assert wal.all_durable and wal.durable_lsn == wal.head_lsn
            else:
                assert wal.all_durable
            assert wal.commit_hist.count > 0
            wal.close()
        assert counts["per_record"][0] == n + 1
        assert counts["per_batch"][0] == n
        assert counts["group"][0] < counts["per_batch"][0] / 2
        return counts
    run_both(tmp_path, run)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_group_commit_latency_accounting(tmp_path):
    def run(P, root):
        wal = P.io.FileWAL.create(root, fsync_policy="group", group_bytes=1,
                                  group_max_wait_s=3600.0)
        keys = np.arange(8)
        wal.append_batch("t", keys, keys, entry_bytes=64, op=True)
        wal.commit(8)                     # group_bytes=1: fsyncs instantly
        assert wal.commit_hist.quantile(0.99) >= 0
        return wal.fsyncs, wal.commit_hist.count
    assert run_both(tmp_path, run)["port"] == (1, 8)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_filewal_refuses_async_fsync(tmp_path):
    """The port's one departure: async group commit waits for its slice."""
    with pytest.raises(ValueError, match="async-commit slice"):
        port_io.FileWAL.create(str(tmp_path / "g"), fsync_policy="group",
                               async_fsync=True)
    for P in PKGS.values():
        with pytest.raises(ValueError, match="requires fsync_policy='group'"):
            P.io.FileWAL(str(tmp_path / "b"), async_fsync=True)


# ---------------------------- FilePageStore -----------------------------------
def _sst(sst_id, n=64, entry_bytes=256, page_bytes=4 * KB):
    keys = np.arange(n, dtype=np.int64)
    return SimpleNamespace(sst_id=sst_id, keys=keys, vals=keys * 3,
                           lsn_min=10, lsn_max=99, entry_bytes=entry_bytes,
                           page_bytes=page_bytes)


def test_page_store_write_load_roundtrip(tmp_path):
    def run(P, root):
        ps = P.io.FilePageStore(root)
        sst = _sst(7)
        ps.write(sst)
        got = ps.load(7)
        np.testing.assert_array_equal(got["keys"], sst.keys)
        np.testing.assert_array_equal(got["vals"], sst.vals)
        assert (got["lsn_min"], got["lsn_max"]) == (10, 99)
        assert (got["entry_bytes"], got["page_bytes"]) == (256, 4 * KB)
        assert ps.fsyncs == 1 and ps.ids() == {7}
        return ({k: v.tobytes() if hasattr(v, "tobytes") else v
                 for k, v in got.items()}, ps.bytes_written, ps.bytes_read)
    run_both(tmp_path, run)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_page_store_read_page_geometry(tmp_path):
    def run(P, root):
        ps = P.io.FilePageStore(root)
        ps.write(_sst(1, n=20, entry_bytes=256, page_bytes=4 * KB))
        got = [ps.read_page(1, 0), ps.read_page(1, 1), ps.read_page(1, 2),
               ps.read_page(1, -1), ps.read_page(999, 0)]
        epp = 4 * KB // 256               # 16 entries per page
        assert got[:3] == [2 * epp * 8, 2 * (20 - epp) * 8, 0]
        assert got[3] > 0 and got[4] == 0
        return got, ps.bytes_read
    run_both(tmp_path, run)


def test_page_store_load_detects_corruption(tmp_path):
    for P in PKGS.values():
        ps = P.io.FilePageStore(str(tmp_path / P.name))
        ps.write(_sst(3))
        with open(ps.path(3), "r+b") as f:
            f.seek(60)
            f.write(b"\xff")
        with pytest.raises(RuntimeError, match="CRC mismatch"):
            ps.load(3)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_page_store_pin_defers_unlink(tmp_path):
    def run(P, root):
        ps = P.io.FilePageStore(root)
        for i in (1, 2, 3):
            ps.write(_sst(i))
        ps.set_pinned({1, 2})
        ps.mark_dropped(1)                # pinned: defer
        ps.mark_dropped(3)                # unpinned: immediate
        seen = [ps.ids()]
        ps.set_pinned({2})                # pin moves on -> deferred unlink
        seen.append(ps.ids())
        seen.append(ps.gc(live_ids=set()))   # 2 still pinned: spared
        ps.set_pinned(set())
        seen.append(ps.gc(live_ids=set()))
        seen.append(ps.ids())
        assert seen == [{1, 2}, {2}, [], [2], set()]
        return seen
    run_both(tmp_path, run)


# --------------------------- manifest edit codec ------------------------------
def _edit_both(fields) -> None:
    """Both codecs encode ``fields`` to the same bytes, and each decodes
    the other's bytes back to the same edit."""
    enc = {n: P.io.encode_edit(P.Edit(*fields)) for n, P in PKGS.items()}
    assert enc["port"] == enc["ref"]
    assert len(enc["port"]) % 8 == 0
    for n, P in PKGS.items():
        assert P.io.decode_edit(enc[OTHER[n]]) == P.Edit(*fields)
    assert astuple(port_io.decode_edit(enc["ref"])) == tuple(fields)


def test_edit_codec_fixed_cases():
    for fields in ((1, "add", 0, "orders", 17, 4096, 1 << 40),
                   (9, "watermark", 3, "", -1, 0, 0),
                   (0, "drop", 2, "tree/with-punct", 2**50, 1, -5)):
        _edit_both(fields)


if HAVE_HYPOTHESIS:
    names = st.text(max_size=32).map(lambda s: s.replace("\x00", ""))

    @settings(max_examples=80, deadline=None)
    @given(st.integers(0, 2**60), names, st.integers(0, 255), names,
           st.integers(-1, 2**60), st.integers(0, 2**31),
           st.integers(-2**60, 2**60))
    def test_hypothesis_edit_roundtrip(version, kind, shard, tree, sst_id,
                                       n_entries, lsn):
        """The reference's property over its strategy: both codecs agree
        byte for byte and round-trip arbitrary edits."""
        _edit_both((version, kind, shard, tree, sst_id, n_entries, lsn))


# ----------------------- the store on the files medium ------------------------
def kill_cfg(P, shards, root=None, **kw):
    """``kill_config`` of package ``P`` (``medium`` defaults to files)."""
    kw.setdefault("medium", "files")
    return P.kw.kill_config(shards, root=root, **kw)


def with_fields(P, cfg, **fields):
    return P.core.StoreConfig(**{**vars(cfg), **fields})


def snapshot(P, store) -> dict:
    """What the recovery contract promises (``test_crash_kill.snapshot``)."""
    return {"fp": [fingerprint(sh.store) for sh in store.shards],
            "counters": [{k: getattr(sh.store.disk.stats, k)
                          for k in P.exact} for sh in store.shards],
            "log_pos": store.log_pos}


def write_plane(P, root, shards, policy="per_batch", cap=REPLAY_CAP):
    """The kill workload on the files medium with the replay store's log
    cap, synced; returns the live store (its files stay open)."""
    cfg = with_fields(P, kill_cfg(P, shards, root, fsync_policy=policy),
                      max_log_bytes=cap)
    P.reset()
    store = P.core.ShardedStore(cfg, shards=shards)
    P.kw.drive(store)
    store.wal.sync()
    return store


def test_both_packages_run_the_same_kill_workload():
    for k in ("SEGMENTS", "TREES", "N_BATCHES", "BATCH", "N_BOUNDARIES"):
        assert getattr(port_kw, k) == getattr(ref_kw, k)
    r = vars(ref_kw.kill_config(4, medium="files", root="x",
                                fsync_policy="group", mode="group",
                                workers=2))
    p = vars(port_kw.kill_config(4, medium="files", root="x",
                                 fsync_policy="group", mode="group",
                                 workers=2))
    for k in r:
        if k not in ("backend", "time_model"):
            assert p[k] == r[k], k
    assert p["device"] == "cpu"


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("policy", ["per_record", "per_batch", "group"])
def test_planes_byte_identical(tmp_path, one_clock, policy, shards):
    """The test of record: both packages leave the same files, byte for
    byte, and the workload crossed every durable edge."""
    one_clock()
    stores = {n: write_plane(P, str(tmp_path / n), shards, policy)
              for n, P in PKGS.items()}
    same_files(tmp_path / "ref", tmp_path / "port")
    names = sorted(files_of(tmp_path / "port"))
    assert "MANIFEST" in names and "wal/META" in names
    assert any(n.startswith("wal/seg-") for n in names)
    assert any(n.startswith("sst/sst-") and n.endswith(".run")
               for n in names)
    assert "wal/seg-0000000000.wal" not in names, "no segment was unlinked"
    p, r = stores["port"], stores["ref"]
    assert p.wal.truncated_to > 0 and p.disk.stats.flushes_log > 0
    assert p.manifest.latest_checkpoint is not None
    assert snapshot(PKGS["port"], p) == snapshot(PKGS["ref"], r)
    assert vars(p.disk.stats) == vars(r.disk.stats)
    assert (p.wal.fsyncs, p.wal.commit_hist.count) \
        == (r.wal.fsyncs, r.wal.commit_hist.count)


def test_real_clock_leaves_only_the_fsync_clock_different(tmp_path):
    """On the wall clock, the planes differ at most in the CHECKPOINT
    frames' ``iostats["fsync_wait_us"]``, which ``chip_smoke.plane_digest``
    (the card-vs-CPU comparison) sets to 0 before it hashes."""
    from chip_smoke import plane_digest
    for n, P in PKGS.items():
        write_plane(P, str(tmp_path / n), 4)
    a, b = (plane_digest(str(tmp_path / n)) for n in ("ref", "port"))
    assert a == b and "MANIFEST" in a and len(a) > 3


def _recover_copy(P, src, dst, shards, policy="per_batch"):
    """Recover package ``P`` over a copy of the plane at ``src``."""
    shutil.copytree(src, dst)
    cfg = kill_cfg(P, shards, str(dst), fsync_policy=policy)
    cfg = with_fields(P, cfg, max_log_bytes=REPLAY_CAP)
    P.reset()
    wal, manifest = P.io.open_plane(cfg)
    rec = P.recover(cfg, wal, manifest)
    return rec, {**snapshot(P, rec), "info": rec.recovery_info,
                 "files": files_of(dst)}


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_open_recovers_like_the_writer(tmp_path, one_clock, writer,
                                             shards):
    """A plane one package wrote, recovered by the other, equals the
    writer's own recovery (state, counters, log position, recovery_info
    and the files recovery leaves behind), and the live store."""
    W, R = PKGS[writer], PKGS[OTHER[writer]]
    one_clock()
    live = write_plane(W, str(tmp_path / "plane"), shards)
    want = snapshot(W, live)
    one_clock()
    _, own = _recover_copy(W, tmp_path / "plane", tmp_path / "own", shards)
    one_clock()
    _, other = _recover_copy(R, tmp_path / "plane", tmp_path / "other",
                             shards)
    assert own == other
    assert {k: own[k] for k in want} == want
    assert own["info"]["from_checkpoint"]


_ALLOWED_MODULES = ("builtins", "collections", "numpy", "numpy.core",
                    "numpy._core")


def pickled_globals(blob: bytes) -> set:
    """(module, name) of every global a pickle names, from
    ``pickletools.genops``: GLOBAL carries both; STACK_GLOBAL takes the
    two strings pushed (or fetched from the memo) just before it."""
    found, memo, pushed = set(), [], []
    for op, arg, _ in pickletools.genops(blob):
        if op.name == "GLOBAL":
            found.add(tuple(arg.split(" ", 1)))
        elif op.name == "STACK_GLOBAL":
            found.add((pushed[-2], pushed[-1]))
        elif op.name == "MEMOIZE":
            memo.append(pushed[-1] if pushed else None)
        elif op.name in ("BINGET", "LONG_BINGET", "GET"):
            pushed.append(memo[int(arg)])
        elif op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE",
                         "BINUNICODE8"):
            pushed.append(arg)
        elif op.name in ("BINPUT", "LONG_BINPUT", "PUT"):
            raise AssertionError(f"unexpected {op.name}: the manifest "
                                 f"pickles with protocol >= 4")
        else:
            pushed.append(None)
    return found


def test_pickled_globals_reads_every_global():
    import collections
    import pickle
    blob = pickle.dumps({"a": np.int64(3), "b": [np.arange(3)],
                         "c": collections.OrderedDict(x=np.float64(1))})
    got = pickled_globals(blob)
    assert ("collections", "OrderedDict") in got
    assert {m.split(".")[0] for m, _ in got} == {"collections", "numpy"}
    assert {n for _, n in got} >= {"scalar", "_reconstruct", "ndarray"}


@pytest.mark.parametrize("shards", [1, 4])
def test_pickled_frames_name_only_builtins_and_numpy(tmp_path, shards):
    seen = {}
    for n, P in PKGS.items():
        write_plane(P, str(tmp_path / n), shards)
        frames = P.io.format.read_frames(
            str(tmp_path / n / "MANIFEST"), allow_torn_tail=False)
        blobs = [(t, b) for t, b in frames
                 if t in (TAG_ROUTER, TAG_CHECKPOINT)]
        assert {t for t, _ in blobs} == {TAG_ROUTER, TAG_CHECKPOINT}
        names = set()
        for _, blob in blobs:
            names |= pickled_globals(blob)
        bad = {m for m, _ in names if not (
            m in _ALLOWED_MODULES
            or m.startswith(("numpy.core.", "numpy._core.")))}
        assert not bad, f"{n}: pickled frames name {bad}"
        seen[n] = names
    assert seen["port"] == seen["ref"]


def test_files_medium_is_state_transparent(tmp_path):
    """The port's files medium equals its memory medium: fingerprints, WAL
    record streams, and IOStats except the fsync counter and the
    durability-blocking clock (which the memory medium never moves)."""
    P = PKGS["port"]
    P.reset()
    sf = port.ShardedStore(kill_cfg(P, 2, str(tmp_path)), shards=2)
    port_kw.drive(sf)
    sf.wal.sync()
    P.reset()
    sm = port.ShardedStore(kill_cfg(P, 2, medium="memory"), shards=2)
    port_kw.drive(sm)
    assert [fingerprint(sh.store) for sh in sf.shards] \
        == [fingerprint(sh.store) for sh in sm.shards]
    assert [r.buf for r in sf.wal._records] \
        == [r.buf for r in sm.wal._records]
    vf, vm = dict(vars(sf.arena.disk.stats)), dict(vars(sm.arena.disk.stats))
    assert vf.pop("fsyncs") > 0 and vm.pop("fsyncs") == 0
    assert vf.pop("fsync_wait_us") > 0 and vm.pop("fsync_wait_us") == 0
    assert vf == vm
    assert sf.arena.disk.page_store is not None
    assert sm.arena.disk.page_store is None


def test_page_files_track_live_set(tmp_path):
    def run(P, root):
        P.reset()
        s = P.core.ShardedStore(kill_cfg(P, 1, root), shards=1)
        P.kw.drive(s)
        ps = s.arena.disk.page_store
        live = set(s.arena.manifest.live)
        assert ps.ids() == live | (ps.ids() & ps._pinned)
        assert live <= ps.ids()
        return sorted(ps.ids()), sorted(ps._pinned)
    run_both(tmp_path, run)


def test_open_plane_refuses_fresh_create_over_existing(tmp_path):
    def run(P, root):
        P.reset()
        cfg = kill_cfg(P, 1, root)
        s = P.core.ShardedStore(cfg, shards=1)
        P.kw.drive(s)
        s.wal.sync()
        with pytest.raises(FileExistsError):
            P.io.create_plane(cfg)
        wal, man = P.io.open_plane(cfg)
        assert wal.head_lsn == s.arena.wal.head_lsn
        assert man.latest_checkpoint is not None
        return wal.head_lsn, man.version
    run_both(tmp_path, run)


def test_manifest_create_refuses_existing(tmp_path):
    for P in PKGS.values():
        p = str(tmp_path / P.name / "MANIFEST")
        ps = P.io.FilePageStore(str(tmp_path / P.name / "sst"))
        m = P.io.FileManifest.create(p, ps)
        m.close()
        with pytest.raises(FileExistsError, match="already exists"):
            P.io.FileManifest.create(p, ps)


def test_group_pending_never_leaks_into_meta_or_checkpoint(tmp_path):
    """Under group commit, truncation META rewrites and checkpoint frames
    anchor only to durable WAL state: the abandoned store's files (its
    pending frames are userspace-only) recover in both packages alike."""
    def run(P, root):
        P.reset()
        cfg = with_fields(P, kill_cfg(P, 1, root, fsync_policy="group"),
                          group_commit_bytes=1 << 20,
                          group_commit_max_wait_s=3600.0)
        s = P.core.LSMStore(cfg)
        s.create_tree("t")
        keys = np.arange(512)
        s.write_batch("t", keys, keys * 5, tick=False)
        s.wal.sync()
        durable = s.arena.wal.durable_lsn
        s.write_batch("t", np.arange(512, 600), np.arange(512, 600),
                      tick=False)
        s.scheduler.tick()                # truncation + maybe checkpoint
        assert not s.arena.wal.all_durable
        P.reset()
        rec = P.recover(cfg, *P.io.open_plane(cfg))
        assert durable <= rec.arena.wal.head_lsn <= s.arena.wal.head_lsn
        found, _ = rec.read_batch("t", keys)
        assert found.all(), "synced records must survive"
        return fingerprint(rec), rec.arena.wal.head_lsn
    run_both(tmp_path, run)


# ---------------------------- WriteAck.durable --------------------------------
def _ack_service(P, root, policy):
    P.reset()
    svc = P.core.StorageService(P.core.LSMStore(
        kill_cfg(P, 1, root, fsync_policy=policy, mode="group")))
    svc.store.create_tree("t")
    return svc


def test_writeack_durable_per_batch(tmp_path):
    def run(P, root):
        svc = _ack_service(P, root, "per_batch")
        (ack,) = svc.submit([P.core.Put("t", np.arange(32))])
        assert ack.durable is True
        return ack.durable
    run_both(tmp_path, run)


def test_writeack_durable_group_then_sync(tmp_path):
    def run(P, root):
        svc = _ack_service(P, root, "group")
        svc.sync()                        # tree-create frame out of the way
        (ack,) = svc.submit([P.core.Put("t", np.arange(32))])
        assert ack.durable is False, \
            "group commit: ack precedes the group's fsync"
        svc.sync()
        assert svc.store.wal.all_durable
        (ack2,) = svc.submit([P.core.Put("t", np.arange(32, 64))])
        assert ack2.durable is False
        svc.sync()
        return ack.durable, ack2.durable, svc.store.wal.fsyncs
    run_both(tmp_path, run)
    same_files(tmp_path / "ref", tmp_path / "port")


def test_memory_medium_acks_always_durable():
    for P in PKGS.values():
        P.reset()
        svc = P.core.StorageService(P.core.LSMStore(
            kill_cfg(P, 1, medium="memory", mode="group")))
        svc.store.create_tree("t")
        (ack,) = svc.submit([P.core.Put("t", np.arange(8))])
        assert ack.durable is True


# ------------------------- StoreConfig's files knobs --------------------------
_FILES_KNOBS = {"wal_async_fsync", "storage_medium", "storage_dir",
                "fsync_policy", "wal_segment_bytes", "group_commit_bytes",
                "group_commit_max_wait_s"}
FILES_CASES = [c for c in REF_CONFIG_CASES if set(c[0]) <= _FILES_KNOBS]


def port_base(**kw):
    """``test_config_validation.base`` for the port, on the CPU."""
    d = dict(total_memory_bytes=32 * CV_MB, write_memory_bytes=1 * CV_MB,
             sim_cache_bytes=1 * CV_MB, page_bytes=4 * CV_KB,
             entry_bytes=256, active_sstable_bytes=64 * CV_KB,
             sstable_bytes=128 * CV_KB, device="cpu")
    d.update(kw)
    return port.StoreConfig(**d)


@pytest.mark.parametrize(
    "overrides,fragments", FILES_CASES,
    ids=[",".join(f"{k}={v!r}" for k, v in c[0].items())
         for c in FILES_CASES])
def test_files_knobs_refused_like_the_reference(overrides, fragments):
    msgs = []
    for make in (ref_base, port_base):
        with pytest.raises(ValueError) as ei:
            make(**overrides).validate()
        msgs.append(str(ei.value))
    for frag in fragments:
        assert frag in msgs[1], f"message {msgs[1]!r} missing {frag!r}"
    assert msgs[0] == msgs[1]


def test_files_cases_cover_every_knob():
    assert len(FILES_CASES) == 11
    assert set().union(*(c[0] for c in FILES_CASES)) == _FILES_KNOBS


def test_files_configs_pass_and_async_waits_for_its_slice(tmp_path):
    for policy in ("per_record", "per_batch", "group"):
        port_base(storage_medium="files", storage_dir=str(tmp_path),
                  fsync_policy=policy).validate()
    ref_base(storage_medium="files", storage_dir=str(tmp_path),
             fsync_policy="group", wal_async_fsync=True).validate()
    with pytest.raises(ValueError, match="async-commit slice") as ei:
        port_base(storage_medium="files", storage_dir=str(tmp_path),
                  fsync_policy="group", wal_async_fsync=True).validate()
    assert "wal_async_fsync" in str(ei.value)
    cfg = port.StoreConfig()
    assert (cfg.storage_dir, cfg.fsync_policy, cfg.wal_segment_bytes,
            cfg.group_commit_bytes, cfg.group_commit_max_wait_s,
            cfg.wal_async_fsync) == (None, "per_batch", 1 << 20, 64 << 10,
                                     1e-3, False)


def test_unusable_storage_dir_raises_and_never_falls_back(tmp_path):
    """Nothing quietly runs on the memory medium: a storage_dir that is a
    file, or one that already holds a plane, raises as in the
    reference."""
    (tmp_path / "file").write_text("x")
    for P in PKGS.values():
        with pytest.raises((FileExistsError, NotADirectoryError)):
            P.core.LSMStore(kill_cfg(P, 1, str(tmp_path / "file")))
    live = write_plane(PKGS["port"], str(tmp_path / "plane"), 1)
    for P in PKGS.values():
        with pytest.raises(FileExistsError, match="already exists"):
            P.core.LSMStore(kill_cfg(P, 1, str(tmp_path / "plane")))
    assert live.arena.disk.page_store is not None


# ---------------------- chip_smoke's files phase, rehearsed -------------------
def test_chip_smoke_files_phase_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.files_phase`` end to end at a small size with
    ``dev="cpu"`` (the policies part CPU against CPU): every check of its
    four parts passes. The CPU launches no kernel, so the launch counts
    are set to 1 where the script zeroes them."""
    import json

    import chip_smoke as cs
    from repro_torch.kernels._launch import LAUNCHES

    monkeypatch.setattr(cs, "zero_counts",
                        lambda: LAUNCHES.update(dict.fromkeys(LAUNCHES, 1)))
    monkeypatch.setattr(cs, "FILES_SUBMITS", 6)
    service_kw = dict(n_keys=1 << 14, batch=1024, n_mixed=12, gets=256,
                      puts=256, deletes=8, scans=4, profile_submits=0)
    small = {"write_memory_bytes": 2 << 20, "sstable_bytes": 128 << 10}
    run_service = cs.run_service
    monkeypatch.setattr(cs, "run_service", lambda dev, cfg_kw, **kw:
                        run_service(dev, cfg_kw={**cfg_kw, **small}, **kw))
    mark = {}

    def on_part(part, svc, oracle):
        if part == "mark":
            mark.update(cs.durable(svc.store))

    cs.reset_sst_ids()
    staged = cs.run_service("cpu", cfg_kw={
        "max_log_bytes": cs.SERVICE_MAX_LOG_BYTES}, on_part=on_part,
        mark_at=cs.FILES_SUBMITS, **service_kw)
    out = cs.files_phase("cpu", staged, mark, service_kw, dev="cpu",
                         policies_kw={"n_submits": 60,
                                      "devs": ("cpu", "cpu")})
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    parts = [r["part"] for r in rows if r.get("phase") == "files"]
    assert parts == ["stream", "reopen", "sigkill", "policies"]
    assert rows[-1] == out and out["phase"] == "files_seconds"
    assert rows[0]["files"]["fsyncs"] > 0 and rows[1]["identical"]
    assert all(p["identical"] for p in rows[2]["points"])
    assert set(rows[3]["policies"]) == set(cs.FSYNC_POLICIES)
