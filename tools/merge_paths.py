#!/usr/bin/env python3
"""K1's routes (``csrc/merge.cu``) side by side on one GPU.

    python3 tools/merge_paths.py [--tiles] [--out FILE]

``merge_runs`` picks its route by size: the shared route up to
``kSharedMaxPairKeys`` keys for two runs and ``kSharedMaxKeys`` for any
other number, above them merge-path tiles for two runs and the global
route for the rest. This builds the kernel library twice, each time from
a copy of ``src/repro_torch/csrc`` in a temporary directory with both
constants changed: ``shared`` (as many keys as one block's shared memory
holds, ``kMaxSharedKeys``) and ``tiles`` (0). For k = 2, 3, 4 and 8 runs
(keys beyond int32, in-run duplicates, a quarter of each run's keys
shared with newer runs) of 256 to 2**16 keys in all it merges the runs
through each route that can take them, holds the result exactly against
``merge_runs_plain``, and times it: the device time of a call in a
stream of calls (a CUDA graph of ``--reps`` calls replayed between CUDA
events, divided by the count) and the call between CUDA events. Prints
one JSON line per (k, size) with the route this checkout's constants
pick there, and, last, for each k the smallest size at which the other
route's graph time is below the shared route's at that size and every
larger one: the crossovers the two constants follow.

``--tiles`` also times the pair at 2**20 + 2**20 keys, the timed shape of
``chip_smoke.py`` (merge-path tiles), with the tile's shape
(``kTileThreads`` x ``kTileItems``) changed the same way, each held
exactly against ``merge_runs_plain``. ``--out`` also writes every line
to FILE.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from variants import (card, constant, cuda_ms, graph_ms_per_call,
                      use_variant, with_constant)

ROOT = Path(__file__).resolve().parent.parent
RUN_COUNTS = (2, 3, 4, 8)
# (threads, items) of a merge-path tile; a block's shared memory (19 B a
# slot) must stay within the 48 KB of static shared memory.
TILE_SHAPES = ((256, 4), (256, 8), (128, 8), (512, 4), (128, 16))
SIZES = (*(1 << e for e in range(8, 15)), 24576, 1 << 15, 1 << 16)


def packed_runs(k: int, n: int, lens=None):
    """k runs of n keys in all (or of ``lens``), packed for ``merge_runs``
    on the card."""
    rng = np.random.default_rng(k * n)
    runs, pool = [], np.zeros(0, np.int64)
    for size in lens or [n // k + (r < n % k) for r in range(k)]:
        x = rng.integers(-2**40, 2**40, size)
        if len(pool) and size >= 4:
            x[: size // 4] = rng.choice(pool, size // 4)
        x[1::9] = x[0::9][: len(x[1::9])]
        x = np.sort(x)
        runs.append((x, rng.integers(-2**62, 2**62, size)))
        pool = np.concatenate([pool, x])
    buf = np.empty(k + 1 + 2 * n, np.int64)
    offs = np.cumsum([0] + [len(x) for x, _ in runs]).astype(np.int64)
    buf[:k + 1] = offs
    buf[k + 1:k + 1 + n] = np.concatenate([x for x, _ in runs])
    buf[k + 1 + n:] = np.concatenate([v for _, v in runs])
    return torch.from_numpy(buf).cuda()


def reading(merge_k, p, k: int, n: int, reps: int, what: str) -> dict:
    """Exactness against the plain version, the route taken, then device
    and call time."""
    def fn():
        return merge_k.merge_runs(p, k, n)
    before = dict(merge_k.ROUTES)
    got = merge_k.unpack(fn(), n)
    route = next(r for r in merge_k.ROUTE_NAMES
                 if merge_k.ROUTES[r] != before[r])
    want = merge_k.unpack(merge_k.merge_runs_plain(p, k, n), n)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"merge_runs ({what}) differs from its plain "
                             f"version at k={k}, n={n}")
    return {"route": route, "graph_ms": graph_ms_per_call(fn, reps),
            "call_ms": cuda_ms(fn)}


def sweep_tiles(reps: int):
    """The pair at 2**20 + 2**20 keys for each of TILE_SHAPES."""
    from repro_torch.kernels import build
    from repro_torch.kernels.merge import merge as merge_k
    source = (build.CSRC / "merge.cu").read_text()
    here = (constant(source, "kTileThreads"), constant(source, "kTileItems"))
    n = 1 << 21
    p = packed_runs(2, n, lens=[n // 2, n // 2])
    rows = []
    original = build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for threads, items in TILE_SHAPES:
            text = with_constant(source, "kTileThreads", threads)
            text = with_constant(text, "kTileItems", items)
            use_variant(build, original, Path(tmp) / f"t{threads}x{items}",
                        {"merge.cu": text})
            r = reading(merge_k, p, 2, n, reps, f"{threads} x {items} tiles")
            rows.append({"tile": [threads, items], "keys": [n // 2, n // 2],
                         "this_checkout": (threads, items) == here, **r})
    return rows


def sweep(reps: int):
    from repro_torch.kernels import build
    from repro_torch.kernels.merge import merge as merge_k
    source = (build.CSRC / "merge.cu").read_text()
    cross = constant(source, "kSharedMaxKeys")
    pair = constant(source, "kSharedMaxPairKeys")
    most = (constant(source, "kMaxSharedBytes") // 8
            - (constant(source, "kSharedMaxRuns") + 1))
    rows = {(k, n): {"k": k, "keys": n, "this_checkout": (
                ("shared" if n <= pair else "merge_path") if k == 2
                else ("shared" if n <= cross else "global"))}
            for k in RUN_COUNTS for n in SIZES}
    original = build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for variant, value in (("shared", most), ("tiles", 0)):
            text = with_constant(source, "kSharedMaxKeys", value)
            text = with_constant(text, "kSharedMaxPairKeys", value)
            use_variant(build, original, Path(tmp) / variant,
                        {"merge.cu": text})
            for (k, n), row in rows.items():
                if n <= value or variant == "tiles":
                    row[variant] = reading(merge_k, packed_runs(k, n), k, n,
                                           reps, variant)
    return list(rows.values())


def crossover(rows):
    """The smallest size from which the other route's graph time is below
    the shared route's at every larger size measured (None: nowhere)."""
    at = None
    for r in reversed(rows):
        if r["tiles"]["graph_ms"] >= r["shared"]["graph_ms"]:
            break
        at = r["keys"]
    return at


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", action="store_true",
                    help="also time the merge-path tile shapes")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("merge_paths: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    csrc = build.CSRC
    rows = sweep(args.reps)
    lines = [{"card": card()}, *rows]
    if args.tiles:
        build.CSRC = csrc
        lines += sweep_tiles(args.reps)
    for k in RUN_COUNTS:
        lines.append({"k": k, "crossover_keys": crossover(
            [r for r in rows if r["k"] == k and "shared" in r])})
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
