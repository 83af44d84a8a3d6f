#!/usr/bin/env python3
"""K4's and K3's constants (``csrc/lookup.cu``) side by side on one GPU.

    python3 tools/lookup_paths.py [--out FILE] [--reps N]

``lookup.cu`` picks the lanes that serve one (tier, query) pair from the
call's pairs (R times its queries) by a rule no caller chooses: 32 lanes
up to ``kPairsFor32Lanes`` pairs, 16 up to ``kPairsFor16Lanes``, 8 up to
``kPairsFor8Lanes``, 4 above. This builds the kernel library from copies
of ``src/repro_torch/csrc`` in a temporary directory with the three pair
counts set so that 4, 8, 16 or 32 lanes serve every call.

On views made on the card (sorted keys beyond int32, tables of equal
length, random filter bits at the engine's slot counts; half the queries
present) it holds each copy exactly against the plain versions, field by
field, and times it: the device time of a call in a stream of calls (a
CUDA graph of ``--reps`` calls replayed between CUDA events, divided by
the count). The shapes (``SHAPES``) are ``chip_smoke.py``'s timed ones and
the pool phase's: its median K4 call (560 queries, 75 tables of 2,048
keys) and K3 call (two tiers of 50 and 462 tables, 560 queries), their
largest query counts, and K3 at more queries, so that the lanes' best
choice can be read against the number of pairs. Prints one JSON line
per (lanes, shape), then, for each shape, its pairs, the time at each
lane count, the lanes with the least time and the lanes this checkout's
rule gives it: the readings that the rule follows.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from variants import card, constant, graph_ms_per_call, use_variant, \
    with_constant

ROOT = Path(__file__).resolve().parent.parent
# The pairs up to which 32, 16 and 8 lanes serve a pair (4 above).
LANE_CONSTANTS = {32: "kPairsFor32Lanes", 16: "kPairsFor16Lanes",
                  8: "kPairsFor8Lanes"}
LANES = (4, 8, 16, 32)
ALL_PAIRS = 1 << 40
POOL_TIER, POOL_STORE = [75], [50, 462]
RUN_K_TIER, RUN_K_STORE = [512], [4, 4, 8, 32, 96, 368]
# name: (kernel, tier sizes in tables, queries); 2,048 keys a table.
SHAPES = {
    "tier_run_k": ("probe_tier", RUN_K_TIER, 4096),
    "tier_pool": ("probe_tier", POOL_TIER, 560),
    "tier_pool_max": ("probe_tier", POOL_TIER, 1839),
    "tier_pool_one": ("probe_tier", [1], 560),
    "tier_pool_451": ("probe_tier", [451], 560),
    "store_run_k": ("probe_store", RUN_K_STORE, 4096),
    "store_run_k_2048": ("probe_store", RUN_K_STORE, 2048),
    "store_run_k_1024": ("probe_store", RUN_K_STORE, 1024),
    "store_pool": ("probe_store", POOL_STORE, 560),
    "store_pool_max": ("probe_store", POOL_STORE, 1380),
    "store_pool_2048": ("probe_store", POOL_STORE, 2048),
    "store_pool_4096": ("probe_store", POOL_STORE, 4096),
    "store_pool_8192": ("probe_store", POOL_STORE, 8192),
}
TABLE_KEYS = 2048


def make_view(lookup_k, bloom_sizing, sizes, table_keys: int, seed: int):
    """A ``lookup.View`` on the card of ``len(sizes)`` tiers of ``sizes[r]``
    tables of ``table_keys`` keys, and the generator that drew it."""
    rng = np.random.default_rng(seed)
    keys = []
    for n in sizes:
        k = np.unique(rng.integers(-2**40, 2**40, 2 * n * table_keys))
        keys.append(np.sort(rng.choice(k, n * table_keys, replace=False)))
    keys = np.concatenate(keys)
    T = sum(sizes)
    lens = np.full(T, table_keys, np.int64)
    offs = np.cumsum(lens) - lens
    nslots = np.full(T, bloom_sizing(table_keys)[1], np.int64)
    tables = np.stack([np.cumsum(nslots) - nslots, nslots, offs, lens,
                       keys[offs], keys[offs + lens - 1]])
    t_off = np.cumsum([0, *sizes])
    dev = torch.device("cuda")
    view = lookup_k.View(
        torch.from_numpy(keys).to(dev),
        torch.from_numpy(rng.integers(-2**62, 2**62, len(keys))).to(dev),
        torch.from_numpy(rng.random(int(nslots.sum())) < 0.6).to(dev),
        tables, t_off)
    return view, keys, rng


def queries(keys, rng, n: int):
    """``n`` queries on the card, half of them present in ``keys``."""
    q = np.concatenate([rng.choice(keys, n // 2),
                        rng.integers(-2**40, 2**40, n - n // 2)])
    return torch.from_numpy(q).to("cuda")


def reading(lookup_k, view, q, store: bool, reps: int, what: str) -> dict:
    """Exactness against the plain version and the device time of a
    call."""
    name = "probe_store" if store else "probe_tier"
    R, K = view.n_tiers, len(q)
    out = torch.empty(lookup_k.out_words(R, K, store), dtype=torch.int64,
                      device=q.device)

    def fn():
        return getattr(lookup_k, name)(view, q, 7, out=out)
    got = lookup_k.unpack(fn(), R, K, store)
    want = lookup_k.unpack(getattr(lookup_k, name + "_plain")(view, q, 7),
                           R, K, store)
    if not all(torch.equal(got[f], want[f]) for f in got):
        raise AssertionError(f"{name} ({what}) differs from its plain "
                             f"version on {R} tiers of {view.n_tables} "
                             f"tables")
    return {"graph_ms": graph_ms_per_call(fn, reps)}


def sweep(reps: int):
    from repro_torch.core.engine.backend import bloom_sizing
    from repro_torch.kernels import build
    from repro_torch.kernels.lookup import lookup as lookup_k
    source = (build.CSRC / "lookup.cu").read_text()
    here = {n: constant(source, n) for n in LANE_CONSTANTS.values()}
    views = {}
    for i, (_, sizes, _) in enumerate(SHAPES.values()):
        if tuple(sizes) not in views:
            views[tuple(sizes)] = make_view(lookup_k, bloom_sizing, sizes,
                                            TABLE_KEYS, i)
    shapes = {}
    for name, (kernel, sizes, n) in SHAPES.items():
        view, keys, rng = views[tuple(sizes)]
        shapes[name] = (view, queries(keys, rng, n), kernel == "probe_store")
    rows = []
    original = build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for lanes in LANES:
            setting = {c: ALL_PAIRS if m <= lanes else 0
                       for m, c in LANE_CONSTANTS.items()}
            text = source
            for n, v in setting.items():
                text = with_constant(text, n, v)
            use_variant(build, original, Path(tmp) / f"lanes{lanes}",
                        {"lookup.cu": text})
            for shape, (view, q, store) in shapes.items():
                rows.append({"lanes": lanes, "shape": shape,
                             "tiers": view.n_tiers, "tables": view.n_tables,
                             "queries": len(q),
                             "pairs": view.n_tiers * len(q),
                             **reading(lookup_k, view, q, store, reps,
                                       f"{lanes} lanes")})
    return rows, here


def lanes_for(setting: dict, pairs: int) -> int:
    """The lanes a pair that ``lookup.cu``'s rule gives a call of
    ``pairs`` (tier, query) pairs under the constants ``setting``."""
    return next((m for m, c in LANE_CONSTANTS.items()
                 if pairs <= setting[c]), 4)


def summary(rows, here) -> list:
    out = []
    for shape in SHAPES:
        lanes = {r["lanes"]: r["graph_ms"] for r in rows
                 if r["shape"] == shape}
        pairs = next(r["pairs"] for r in rows if r["shape"] == shape)
        out.append({"shape": shape, "pairs": pairs,
                    "graph_ms_by_lanes": lanes,
                    "best_lanes": min(lanes, key=lanes.get),
                    "rule_lanes": lanes_for(here, pairs)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lookup_paths: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    rows, here = sweep(args.reps)
    lines = [{"card": card(), "this_checkout": here}, *rows,
             *summary(rows, here)]
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
