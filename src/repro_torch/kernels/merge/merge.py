"""K1: stable merge of sorted int64 runs by rank (``csrc/merge.cu``).

Two wrappers of one C entry point. On CUDA tensors they launch it, on
CPU tensors they run the plain version beside them:

  * ``merge_runs(packed, k, n)``: k runs, newest first, packed with their
    offsets in one int64 tensor (``pack_runs``); the C entry point picks
    its route by size (``ROUTES``); plain ``merge_runs_plain``.
  * ``merge_pair(ak, av, bk, bv)``: run A (newer) with run B (older) in
    separate tensors, packed on their device (``pack_pair``) for
    ``merge_runs`` with k = 2; plain ``merge_pair_plain``.

Both return the stable merge (the newest run wins ties) and the keep flag
of every slot: True at the first, i.e. newest, occurrence of its key.

``merge_runs_host`` is the engine's call, the same on the card and on the
CPU: it joins adjacent runs that are disjoint and in order
(``run_offsets``), packs the runs into one host buffer, copies it to the
device once, launches once, copies the keys, values and flags back once,
and compacts on the host (``compact``), as the reference compacts on the
host. Keys and values are int64 with explicit lengths: no sentinel
padding and no domain limit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from .._launch import count, expect, on_card, stream_of

# merge.cu's kTileThreads x kTileItems: the outputs of one merge-path block.
TILE = 1024
# Launches by the route the C entry point reported, one per call.
ROUTE_NAMES = ("shared", "merge_path", "global")
ROUTES = dict.fromkeys(ROUTE_NAMES, 0)


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


def merge_path_splits_plain(ka, kb, diags):
    """For each output diagonal ``d`` of the merge of sorted ``ka`` (newer)
    and ``kb``, how many of the first ``d`` slots come from ``ka``: the
    largest ``ai`` with ``ka[ai-1] <= kb[d-ai]`` (A wins ties), the split
    that ``merge.cu``'s tiles search for. Computed from the rank rule: A's
    element i lands in slot ``i + #{kb < ka[i]}``, so the split is the
    number of those slots below ``d``."""
    slot_a = (torch.arange(len(ka), device=ka.device)
              + torch.searchsorted(kb, ka))
    return torch.searchsorted(slot_a, diags)


def pack_pair(ak, av, bk, bv):
    """Runs A (newer) and B packed for ``merge_runs`` with k = 2, on their
    device: the offsets 0, len(A), len(A) + len(B), the keys, the values."""
    na, n = len(ak), len(ak) + len(bk)
    offs = torch.tensor([0, na, n], dtype=torch.int64).to(ak.device)
    return torch.cat([offs, ak, bk, av, bv])


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
    return unpack(merge_runs(pack_pair(ak, av, bk, bv), 2, n), n)


# --------------------------- the k-run form ----------------------------------
def out_words(n: int) -> int:
    """Length of a k-run result: n keys, n values, n keep bytes."""
    return 2 * n + (n + 7) // 8


def unpack(out, n: int):
    """``(keys, vals, keep)`` views of a k-run result ``out``."""
    return (out[:n], out[n:2 * n],
            out[2 * n:].view(torch.uint8)[:n].view(torch.bool))


def merge_runs_plain(packed, k: int, n: int):
    """Plain version of the k-run form: a stable sort of the runs' keys,
    which are packed newest run first, and the first-occurrence flags, in
    the kernel's output layout (``out_words(n)``, flag padding zero)."""
    keys, vals = packed[k + 1:k + 1 + n], packed[k + 1 + n:]
    order = torch.sort(keys, stable=True).indices
    out = torch.zeros(out_words(n), dtype=torch.int64, device=packed.device)
    ok, ov, keep = unpack(out, n)
    ok.copy_(keys[order])
    ov.copy_(vals[order])
    keep[:1] = True
    keep[1:] = ok[1:] != ok[:-1]
    return out


def merge_runs(packed, k: int, n: int):
    """Merge the k sorted runs in ``packed`` (int64 ``[k + 1 + 2n]``: the
    offsets ``0 = offs[0] <= ... <= offs[k] = n``, the keys, the values;
    runs newest first). Returns int64 ``[out_words(n)]`` on the same
    device: the merged keys, the merged values, then one keep byte a slot
    (``unpack``)."""
    expect(packed, "packed", torch.int64)
    if k < 1 or len(packed) != k + 1 + 2 * n:
        raise ValueError(f"packed holds {len(packed)} words, not the "
                         f"k + 1 + 2n = {k + 1 + 2 * n} of k={k} runs of "
                         f"n={n} keys (k >= 1)")
    if not on_card(packed):
        return merge_runs_plain(packed, k, n)
    out = torch.empty(out_words(n), dtype=torch.int64, device=packed.device)
    if n == 0:
        return out
    route = ctypes.c_int()
    rc = build.library().merge_runs(packed.data_ptr(), k, n, out.data_ptr(),
                                    stream_of(packed), ctypes.byref(route))
    build.check(rc, "merge_runs")
    count("merge_pair")
    count(ROUTE_NAMES[route.value], ROUTES)
    return out


# --------------------------- the engine's call -------------------------------
def run_offsets(runs) -> np.ndarray:
    """Offsets of ``runs`` (sorted ``(keys, vals)``, newest first) packed
    back to back, with adjacent runs joined wherever the last key of one
    is below the first key of the next (empty runs vanish): the tables of
    one level or one tier become one run. Joining moves no element, so the
    merge is the same; a call that joins down to one run still drops
    duplicates."""
    offs, n, last = [0], 0, None
    for k, _ in runs:
        if len(k) == 0:
            continue
        if last is not None and last >= k[0]:
            offs.append(n)
        n += len(k)
        last = k[-1]
    offs.append(n)
    return np.array(offs, np.int64)


def pack_runs(runs, offs, buf) -> None:
    """Write ``offs``, then the keys and the values of ``runs`` into the
    int64 numpy array ``buf`` (``len(offs) + 2 * offs[-1]`` long)."""
    k1, n = len(offs), int(offs[-1])
    buf[:k1] = offs
    np.concatenate([k for k, _ in runs], out=buf[k1:k1 + n])
    np.concatenate([v for _, v in runs], out=buf[k1 + n:k1 + 2 * n])


def compact(out, n: int):
    """Numpy copies of the kept keys and values of a k-run result held in
    the int64 numpy array ``out`` (the views of ``unpack``, in numpy)."""
    keep = out[2 * n:].view(np.uint8)[:n].view(bool)
    return out[:n][keep], out[n:2 * n][keep]


class Staging:
    """One grow-only int64 host buffer for the engine's calls on
    ``device``, pinned when that is a GPU (pinned allocations cost far
    more than they save when made per call), and its numpy view; and one
    grow-only int64 buffer on ``device`` for calls that copy in and back
    themselves (``lookup.probe_host``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.buf = torch.empty(0, dtype=torch.int64)
        self.host = self.buf.numpy()
        self.dev = None

    def take(self, words: int):
        """The whole buffer, at least ``words`` long: (tensor, numpy)."""
        if words > len(self.buf):
            size = max(words, 2 * len(self.buf), 1 << 16)
            self.buf = torch.empty(size, dtype=torch.int64,
                                   pin_memory=self.pin)
            self.host = self.buf.numpy()
        return self.buf, self.host

    def take_device(self, words: int):
        """The whole device buffer, at least ``words`` long."""
        if self.dev is None or words > len(self.dev):
            size = max(words, 0 if self.dev is None else 2 * len(self.dev),
                       1 << 16)
            self.dev = torch.empty(size, dtype=torch.int64,
                                   device=self.device)
        return self.dev


def merge_runs_host(runs, device, staging: Staging):
    """Merge host ``runs`` (numpy int64 ``(keys, vals)``, sorted, newest
    first, at least one key in all) into sorted unique numpy ``(keys,
    vals)``, the newest copy of each key kept: one copy to ``device``, one
    ``merge_runs`` launch, one copy back."""
    offs = run_offsets(runs)
    k, n = len(offs) - 1, int(offs[-1])
    m, w = k + 1 + 2 * n, out_words(n)
    buf, host = staging.take(m + w)
    pack_runs(runs, offs, host[:m])
    out = merge_runs(buf[:m].to(device, non_blocking=True), k, n)
    # The one copy back. It returns once the copy in and the launch before
    # it on the stream have run, so the next call may refill the buffer.
    buf[m:m + w].copy_(out)
    return compact(host[m:m + w], n)
