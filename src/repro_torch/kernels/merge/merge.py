"""K1: merge of two sorted int64 runs by rank (``csrc/merge.cu``).

``merge_pair`` is the wrapper: on CUDA tensors it launches the kernel, on
CPU tensors it runs ``merge_pair_plain``, the same function in plain
PyTorch. ``merge_runs`` and ``ingest_run`` compose it into the engine's
two uses, as ``repro.kernels.merge.ops`` composes the TPU kernel:

  * ``merge_runs`` folds k runs newest-first, one merge per older run;
  * ``ingest_run`` merges the two halves of a write batch that the host
    put in ingest order, carrying batch positions in the value channel.

Keys and values are int64 with explicit lengths: no sentinel padding and
no domain limit.
"""
from __future__ import annotations

import torch

from .. import build
from .._launch import LAUNCHES, expect, on_card, stream_of


def merge_pair_plain(ak, av, bk, bv):
    """Plain version of the kernel: a stable sort of A then B (A, the
    newer run, wins ties), and the first-occurrence flag of every slot."""
    k = torch.cat([ak, bk])
    v = torch.cat([av, bv])
    order = torch.sort(k, stable=True).indices
    out_k, out_v = k[order], v[order]
    keep = torch.ones(len(out_k), dtype=torch.bool, device=k.device)
    keep[1:] = out_k[1:] != out_k[:-1]
    return out_k, out_v, keep


def merge_pair(ak, av, bk, bv):
    """Merge sorted run A (newer) with sorted run B (older).

    Returns ``(keys, vals, keep)`` of length ``len(A) + len(B)``: the
    stable merge, and True where a slot holds the first (newest)
    occurrence of its key."""
    for t, name in ((ak, "ak"), (av, "av"), (bk, "bk"), (bv, "bv")):
        expect(t, name, torch.int64)
    if len(ak) != len(av) or len(bk) != len(bv):
        raise ValueError(f"keys and values differ in length: A {len(ak)} vs "
                         f"{len(av)}, B {len(bk)} vs {len(bv)}")
    if not on_card(ak, av, bk, bv):
        return merge_pair_plain(ak, av, bk, bv)
    n = len(ak) + len(bk)
    out_k = torch.empty(n, dtype=torch.int64, device=ak.device)
    out_v = torch.empty(n, dtype=torch.int64, device=ak.device)
    keep = torch.empty(n, dtype=torch.bool, device=ak.device)
    if n == 0:
        return out_k, out_v, keep
    rc = build.library().merge_pair(
        ak.data_ptr(), av.data_ptr(), len(ak), bk.data_ptr(), bv.data_ptr(),
        len(bk), out_k.data_ptr(), out_v.data_ptr(), keep.data_ptr(),
        stream_of(ak))
    build.check(rc, "merge_pair")
    LAUNCHES["merge_pair"] += 1
    return out_k, out_v, keep


def merge_runs(keys, vals, lens):
    """Fold k sorted runs, stored back to back in ``keys``/``vals`` with
    run lengths ``lens`` (newest run first), into one sorted unique run:
    newest wins. Returns ``(keys, vals)`` on the input's device."""
    offs = [0]
    for n in lens:
        offs.append(offs[-1] + int(n))
    ka, va = keys[:offs[1]], vals[:offs[1]]
    for i in range(1, len(lens)):
        kb, vb = keys[offs[i]:offs[i + 1]], vals[offs[i]:offs[i + 1]]
        mk, mv, keep = merge_pair(ka, va, kb, vb)
        ka, va = mk[keep], mv[keep]
    return ka, va


def ingest_run(ordered_keys, positions):
    """Dedup a write batch the host put in ingest order (ascending keys,
    newest occurrence first among equals; ``positions`` are the batch
    positions in that order). The batch is split at its midpoint and the
    halves merged: A-first ties and the keep flags keep exactly the first,
    i.e. newest, occurrence of every key, whether its copies sit in one
    half or span the split. Returns ``(unique_keys, surviving_positions)``.
    """
    h = len(ordered_keys) // 2
    mk, mp, keep = merge_pair(ordered_keys[:h], positions[:h],
                              ordered_keys[h:], positions[h:])
    return mk[keep], mp[keep]
