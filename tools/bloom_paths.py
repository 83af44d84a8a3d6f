#!/usr/bin/env python3
"""K2's two paths (``csrc/bloom.cu``) side by side on one GPU.

    python3 tools/bloom_paths.py [--src DIR] [--out FILE]

``bloom_build`` picks its path by the filter's size: the shared path up
to ``kSharedMaxSlots`` slots, the global path above. This builds the
kernel library twice, each time from a copy of ``src/repro_torch/csrc``
in a temporary directory with that constant changed: ``shared`` (as
large as one block's shared memory allows, ``kMaxSharedSlots``) and
``global`` (0). For every padded key count from 256 to 2**20 (powers of
two; 10 bits a key, the engine's ``bloom_sizing``) it builds one filter
through each path that can take it, holds it exactly against
``bloom_build_plain``, and times it: the device time of a call (every
device event of the call, the memset included, from the CUDA profiler)
and the call between CUDA events. Prints one JSON line per size with the
path this checkout's constant picks there, and, last, the smallest size
at which the global path's device time is below the shared path's: the
crossover that ``kSharedMaxSlots`` follows.

``--src DIR`` times another checkout's ``repro_torch`` (under DIR) as it
is instead, one ``default`` entry a size. ``--out`` also writes every
line to FILE.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from variants import (card, constant, cuda_ms, profiled_ms_per_call,
                      use_variant, with_constant)

ROOT = Path(__file__).resolve().parent.parent
K_HASHES = 7
TOMBSTONE = -(2**31) + 1


def inputs(bloom_sizing):
    """(key count, keys on the card, n_slots) from 256 to 2**20 keys,
    with keys beyond int32, a negative key and the tombstone payload."""
    rng = np.random.default_rng(0)
    for e in range(8, 21):
        n = 1 << e
        keys = torch.from_numpy(np.unique(np.concatenate([
            rng.integers(0, 2**40, n - 3), [2**31 + 5, -7, TOMBSTONE]]))).cuda()
        yield n, keys, bloom_sizing(n)[1]


def reading(bloom_k, keys, n_slots: int, reps: int, what: str) -> dict:
    """Exactness against the plain version, then device and call time."""
    def fn():
        return bloom_k.bloom_build(keys, n_slots, K_HASHES)
    if not torch.equal(fn(), bloom_k.bloom_build_plain(keys, n_slots,
                                                       K_HASHES)):
        raise AssertionError(f"bloom_build ({what}) differs from its plain "
                             f"version at {len(keys)} keys")
    return {"device_ms": profiled_ms_per_call(fn, reps),
            "call_ms": cuda_ms(fn)}


def sweep_variants(reps: int):
    from repro_torch.core.engine.backend import bloom_sizing
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import bloom as bloom_k
    source = (build.CSRC / "bloom.cu").read_text()
    cross = constant(source, "kSharedMaxSlots")
    most = constant(source, "kMaxSharedSlots")
    rows = {n: {"keys": n, "n_slots": ns,
                "this_checkout": "shared" if ns <= cross else "global"}
            for n, _, ns in inputs(bloom_sizing)}
    original = build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for variant, value in (("shared", most), ("global", 0)):
            use_variant(build, original, Path(tmp) / variant, {
                "bloom.cu": with_constant(source, "kSharedMaxSlots", value)})
            for n, keys, ns in inputs(bloom_sizing):
                if ns <= value or variant == "global":
                    rows[n][variant] = reading(bloom_k, keys, ns, reps,
                                               variant)
    return list(rows.values())


def sweep_checkout(src: str, reps: int):
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core.engine.backend import bloom_sizing
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import bloom as bloom_k
    build.build()
    return [{"keys": n, "n_slots": ns,
             "default": reading(bloom_k, keys, ns, reps, "default")}
            for n, keys, ns in inputs(bloom_sizing)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=None,
                    help="time this checkout's src as it is")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bloom_paths: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    lines = [{"card": card(), "src": args.src or "this checkout"}]
    if args.src:
        lines += sweep_checkout(args.src, args.reps)
    else:
        sys.path.insert(0, str(ROOT / "src"))
        rows = sweep_variants(args.reps)
        lines += rows
        lines.append({"crossover_keys": next(
            (r["keys"] for r in rows if "shared" in r
             and r["global"]["device_ms"] < r["shared"]["device_ms"]),
            None)})
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
