"""The port's process-kill crash matrix over its files medium, on the CPU.

Twins of ``tests/test_crash_kill.py``'s blocking-commit cases: a
*subprocess* (``torch_crash_child.py``) runs the deterministic
``torch_kill_workload.drive`` on a files-medium ``repro_torch`` store and
SIGKILLs itself at a chosen boundary -- only fsynced bytes survive. The
parent reopens the plane and holds the recovered store to a port
memory-medium oracle at that boundary, bit for bit (fingerprint,
``RECOVERY_EXACT_COUNTERS``, ``log_pos``). One more case recovers a port
child's plane in both packages.

Default: the reference's spread of kill points x shards {1, 4};
``DURABILITY_KILL_MATRIX=full`` runs every boundary, as in the reference.
The children of the whole module start together on first use, four at a
time, and each test works on its own copy of its child's plane.
"""
import os
import shutil
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("torch")

import kill_workload as ref_kw  # noqa: E402
from test_differential import fingerprint  # noqa: E402
from torch_kill_workload import (N_BOUNDARIES, drive,  # noqa: E402
                                 kill_config)

from repro.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS as REF_EXACT, recover as ref_recover)
from repro.core.lsm.sstable import reset_sst_ids as ref_reset  # noqa: E402
from repro.core.shard.sharded import ShardedStore as RefSharded  # noqa: E402
from repro.core.storage_io import open_plane as ref_open  # noqa: E402
from repro_torch.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS, recover)
from repro_torch.core.lsm.sstable import reset_sst_ids  # noqa: E402
from repro_torch.core.shard.sharded import ShardedStore  # noqa: E402
from repro_torch.core.storage_io import open_plane, plane_paths  # noqa: E402
from repro_torch.core.storage_io.format import build_frame  # noqa: E402

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(os.path.dirname(TESTS_DIR), "src")

FULL = os.environ.get("DURABILITY_KILL_MATRIX") == "full"
KILL_POINTS = list(range(N_BOUNDARIES)) if FULL else [0, 5, 11, 17, 23]
WORKER_POINTS = KILL_POINTS if FULL else [5, 17, 23]
GROUP_POINTS = [2, 5, 9]
BOTH_POINT = (4, 11)              # (shards, kill_at) recovered by both


def snapshot(store, exact=RECOVERY_EXACT_COUNTERS):
    """Value-snapshot of everything the recovery contract promises."""
    return {
        "fp": [fingerprint(sh.store) for sh in store.shards],
        "counters": [{k: getattr(sh.store.disk.stats, k) for k in exact}
                     for sh in store.shards],
        "log_pos": store.log_pos,
    }


_ORACLES: dict = {}


def oracle_run(shards: int, mode: str = "full"):
    """Port memory-medium run; snapshots at every boundary."""
    key = (shards, mode)
    if key not in _ORACLES:
        reset_sst_ids()
        store = ShardedStore(kill_config(shards, medium="memory",
                                         mode=mode), shards=shards)
        snaps = []
        drive(store, lambda i: snaps.append(snapshot(store)), mode=mode)
        snaps.append(snapshot(store))          # post-run (clean shutdown)
        _ORACLES[key] = snaps
    return _ORACLES[key]


# ------------------------------ the children ----------------------------------
def _spec(shards, kill_at, policy="per_batch", mode="full", workers=0):
    return (shards, kill_at, policy, mode, workers)


def child_specs() -> list:
    """Every child this module runs."""
    specs = []
    for shards in (1, 4):
        specs += [_spec(shards, k) for k in KILL_POINTS]
        specs += [_spec(shards, k, workers=2) for k in WORKER_POINTS]
        specs.append(_spec(shards, -1))
    specs.append(_spec(4, -1, workers=2))
    specs += [_spec(1, k, "group", "group") for k in GROUP_POINTS]
    specs.append(_spec(1, -1, "group", "group"))
    return specs


def run_child(root, spec):
    shards, kill_at, policy, mode, workers = spec
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC_DIR + os.pathsep + TESTS_DIR
    argv = [sys.executable, os.path.join(TESTS_DIR, "torch_crash_child.py"),
            "--root", str(root), "--shards", str(shards),
            "--kill-at", str(kill_at), "--policy", policy, "--mode", mode,
            "--workers", str(workers), "--device", "cpu"]
    return subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Start every child of the module, four at a time; ``plane(dst,
    *spec)`` waits for that child, checks how it ended, and copies its
    plane to ``dst``."""
    base = tmp_path_factory.mktemp("children")
    pool = ThreadPoolExecutor(4)
    runs = {}
    for i, spec in enumerate(child_specs()):
        root = base / f"c{i}"
        runs[spec] = (root, pool.submit(run_child, root, spec))

    def plane(dst, *args, **kw):
        spec = _spec(*args, **kw)
        root, fut = runs[spec]
        proc = fut.result()
        if spec[1] < 0:
            assert proc.returncode == 0, proc.stderr
        else:
            assert proc.returncode == -signal.SIGKILL, (
                f"child should die by SIGKILL, got rc={proc.returncode}\n"
                f"{proc.stderr}")
        shutil.copytree(root, dst)
        return dst

    yield plane
    pool.shutdown(wait=True)


def recover_from(root, *, shards, policy="per_batch", mode="full",
                 workers=0):
    reset_sst_ids()
    cfg = kill_config(shards, medium="files", root=str(root),
                      fsync_policy=policy, mode=mode, workers=workers)
    wal, manifest = open_plane(cfg)
    return recover(cfg, wal, manifest)


# ------------------------------ kill matrix -----------------------------------
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("kill_at", KILL_POINTS)
def test_sigkill_recovers_bit_identical(tmp_path, children, shards,
                                        kill_at):
    root = children(tmp_path / "plane", shards, kill_at)
    rec = recover_from(root, shards=shards)
    # per_batch: every boundary is an fsync edge, so the recovered store
    # must land exactly on the oracle state at the kill boundary
    assert snapshot(rec) == oracle_run(shards)[kill_at]


def test_clean_shutdown_reopens_final_state(tmp_path, children):
    root = children(tmp_path / "plane", 4, -1)
    rec = recover_from(root, shards=4)
    assert snapshot(rec) == oracle_run(4)[-1]
    # the workload must actually have exercised the physical edges the
    # matrix claims to cover: segment rollovers and truncation unlinks
    assert rec.arena.wal.truncated_to > 0, "log truncation never fired"
    names = sorted(p.name for p in (root / "wal").iterdir()
                   if p.name.startswith("seg-"))
    assert names and names[0] != "seg-0000000000.wal", \
        "no sealed segment was ever unlinked"


def test_recovered_store_keeps_working(tmp_path, children):
    """A post-kill store is a full citizen: it serves reads and survives a
    second open."""
    root = children(tmp_path / "plane", 1, KILL_POINTS[-1])
    rec = recover_from(root, shards=1)
    keys = np.arange(100, 140)
    rec.write_batch("alpha", keys, keys * 11)
    found, vals = rec.read_batch("alpha", keys)
    assert found.all() and (vals == keys * 11).all()
    post = snapshot(rec)
    rec.wal.sync()
    rec2 = recover_from(root, shards=1)
    assert snapshot(rec2) == post


# ------------------------- background workers on ------------------------------
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("kill_at", WORKER_POINTS)
def test_sigkill_with_workers_recovers_bit_identical(tmp_path, children,
                                                     shards, kill_at):
    """A child running with maintenance_workers=2 dies at a boundary, and
    recovery (itself worker-enabled) lands on EXACTLY the workers=0
    oracle state."""
    root = children(tmp_path / "plane", shards, kill_at, workers=2)
    rec = recover_from(root, shards=shards, workers=2)
    assert snapshot(rec) == oracle_run(shards)[kill_at]


def test_clean_shutdown_with_workers_matches_oracle(tmp_path, children):
    root = children(tmp_path / "plane", 4, -1, workers=2)
    rec = recover_from(root, shards=4, workers=2)
    assert snapshot(rec) == oracle_run(4)[-1]


# -------------------------------- torn tail -----------------------------------
def _last_segment(root):
    wal_dir = plane_paths(str(root))["wal"]
    segs = sorted(n for n in os.listdir(wal_dir)
                  if n.startswith("seg-") and n.endswith(".wal"))
    return os.path.join(wal_dir, segs[-1])


@pytest.mark.parametrize("junk", [
    b"\x00" * 37,                                  # zero tail (lost write)
    build_frame(10**6, b"x" * 64)[:-11],           # torn frame (cut short)
    b"\xde\xad\xbe\xef" + b"junk" * 8,             # garbage bytes
], ids=["zeros", "torn-frame", "garbage"])
def test_torn_tail_ignored(tmp_path, children, junk):
    root = children(tmp_path / "plane", 1, -1)
    with open(_last_segment(root), "ab") as f:
        f.write(junk)
    rec = recover_from(root, shards=1)
    assert snapshot(rec) == oracle_run(1)[-1]


# ------------------------------ group commit ----------------------------------
@pytest.mark.parametrize("kill_at", GROUP_POINTS)
def test_group_commit_kill_lands_on_group_boundary(tmp_path, children,
                                                   kill_at):
    """Under group commit an un-fsynced tail of <= one group may be lost:
    recovery lands on the most recent *fsynced* boundary j <= kill point,
    within the group window, and is bit-identical to the oracle there."""
    root = children(tmp_path / "plane", 1, kill_at, "group", "group")
    rec = recover_from(root, shards=1, policy="group", mode="group")
    snaps = oracle_run(1, mode="group")
    got = snapshot(rec)
    js = [j for j in range(kill_at + 1)
          if snaps[j]["log_pos"] == got["log_pos"]]
    assert js, (f"recovered log_pos {got['log_pos']} matches no oracle "
                f"boundary <= {kill_at}")
    j = js[-1]
    # group_commit_bytes admits ~3 batch frames before forcing an fsync
    assert kill_at - j <= 3, f"lost more than one group: j={j}"
    assert got == snaps[j]


def test_group_commit_sync_makes_all_durable(tmp_path, children):
    root = children(tmp_path / "plane", 1, -1, "group", "group")
    rec = recover_from(root, shards=1, policy="group", mode="group")
    assert snapshot(rec) == oracle_run(1, mode="group")[-1]


# ------------------------- a port plane, both packages ------------------------
def test_port_child_recovers_alike_in_both_packages(tmp_path, children):
    """A port child killed mid-maintenance: its plane, recovered by the
    reference and by the port, gives the same store, and both equal the
    reference's own memory-medium oracle at that boundary."""
    shards, kill_at = BOTH_POINT
    mine = recover_from(children(tmp_path / "port", shards, kill_at),
                        shards=shards)
    ref_root = children(tmp_path / "ref", shards, kill_at)
    ref_reset()
    cfg = ref_kw.kill_config(shards, medium="files", root=str(ref_root))
    theirs = ref_recover(cfg, *ref_open(cfg))
    assert RECOVERY_EXACT_COUNTERS == REF_EXACT
    assert snapshot(mine) == snapshot(theirs, REF_EXACT)
    assert mine.recovery_info == theirs.recovery_info
    ref_reset()
    oracle = RefSharded(ref_kw.kill_config(shards, medium="memory"),
                        shards=shards)
    snaps = []
    ref_kw.drive(oracle, lambda i: snaps.append(snapshot(oracle, REF_EXACT)))
    assert snapshot(mine) == snaps[kill_at]
