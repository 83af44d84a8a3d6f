"""Subprocess side of the port's process-kill crash matrix.

The twin of ``crash_child.py`` over ``repro_torch``: runs
``torch_kill_workload.drive`` against a *files*-medium store rooted at
``--root`` on ``--device`` and SIGKILLs its own process -- no atexit, no
flush, no Python teardown -- the instant boundary ``--kill-at``
completes. The parent reopens the plane from the surviving files and
holds the recovered store to a memory-medium oracle at that boundary.

``--kill-at -1`` runs to completion, fsyncs, and exits 0 (clean-shutdown
control case).

    python tests/torch_crash_child.py --root DIR --kill-at 5 [--shards 4]
        [--policy per_batch|per_record|group] [--mode full|group]
        [--workers N] [--device cpu|cuda]

(``src`` and ``tests`` on ``PYTHONPATH``.)
"""
import argparse
import os
import signal
import sys

from torch_kill_workload import drive, kill_config


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--kill-at", type=int, required=True)
    ap.add_argument("--policy", default="per_batch")
    ap.add_argument("--mode", default="full")
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    from repro_torch.core.lsm.sstable import reset_sst_ids
    from repro_torch.core.shard.sharded import ShardedStore

    reset_sst_ids()
    cfg = kill_config(args.shards, medium="files", root=args.root,
                      fsync_policy=args.policy, mode=args.mode,
                      workers=args.workers, device=args.device)
    store = ShardedStore(cfg, shards=args.shards)

    def on_boundary(i):
        if i == args.kill_at:
            # hard kill: bypasses buffered file objects, atexit hooks and
            # interpreter shutdown -- only fsynced bytes survive
            os.kill(os.getpid(), signal.SIGKILL)

    drive(store, on_boundary, mode=args.mode)
    store.wal.sync()
    return 0


if __name__ == "__main__":
    sys.exit(main())
