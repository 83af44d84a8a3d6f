"""K4 and K3: the fused read path over a device-resident view
(``csrc/lookup.cu``).

A view is a mapping of device tensors over one lookup tier, or over every
lookup tier of a tree stacked tier-major (``VIEW_FIELDS``):

  * ``keys``/``vals`` -- int64 ``[N]``: the tables' runs concatenated; each
    tier's segment is sorted (its tables are disjoint and min_key-ordered);
  * ``fbits`` -- bool ``[S]``: the tables' Bloom filters concatenated flat;
  * ``f_offs``/``nslots`` -- int64 ``[T]``: each table's first slot in
    ``fbits`` and its slot count;
  * ``offs``/``lens`` -- int64 ``[T]``: each table's run in ``keys``.

Every query comes with its assigned table of each tier (the host's
``assign_bounds``, clipped into the tier). Per (tier, query) the kernels
compute, from that table alone: ``positive`` (all k Bloom slots set, with
the table's own slot count as the modulus, the hash math of
``kernels.bloom``), ``pos`` (the lower bound of the query in the table's
run, relative to the run), ``hit`` and ``val`` (0 where no hit).

``probe_tier`` (K4) returns int64 ``[4, K]``: rows positive, pos, hit, val.
``probe_store`` (K3) returns int64 ``[4 * R + 1, K]``: R rows of each field
in that order, then ``win``, the lowest (newest) tier rank with a hit or
-1. Both fields and the winner come back in one buffer, so the host reads
a lookup batch back in one copy. On CUDA tensors the wrappers launch the
kernels; on CPU tensors they run the plain versions beside them.
"""
from __future__ import annotations

import torch

from .. import build
from .._launch import LAUNCHES, expect, on_card, stream_of
from ..bloom.bloom import bloom_slots_plain

VIEW_FIELDS = ("keys", "vals", "fbits", "f_offs", "nslots", "offs", "lens")


def _fields_plain(view, q, gti, seg_pos, k_hashes: int):
    """The four fields of each query against global table ``gti`` (same
    shape as ``q``), given its lower bound ``seg_pos`` in the sorted
    segment of its tier."""
    keys = view["keys"]
    slots = bloom_slots_plain(q, view["nslots"][gti], k_hashes)
    positive = view["fbits"][view["f_offs"][gti][..., None]
                             + slots].all(dim=-1)
    lo = view["offs"][gti]
    ln = view["lens"][gti]
    abs_pos = torch.minimum(torch.maximum(seg_pos, lo), lo + ln)
    pos = abs_pos - lo
    safe = abs_pos.clamp(max=len(keys) - 1)
    hit = (pos < ln) & (keys[safe] == q)
    val = torch.where(hit, view["vals"][safe], torch.zeros_like(safe))
    return torch.stack([positive.long(), pos, hit.long(), val])


def probe_tier_plain(view, q, ti, k_hashes: int):
    """Plain version of K4: the tier's concatenation is one sorted
    segment, so the lower bound inside a table's run is the global
    ``searchsorted`` clipped to that run."""
    return _fields_plain(view, q, ti, torch.searchsorted(view["keys"], q),
                         k_hashes)


def probe_store_plain(view, t_off, q, ti, k_hashes: int):
    """Plain version of K3: K4's fields for every tier (a clipped
    ``searchsorted`` in each tier's sorted segment), then the winner."""
    R, K = ti.shape
    if R == 0:
        return torch.full((1, K), -1, dtype=torch.int64, device=q.device)
    starts = view["offs"][t_off].tolist() + [len(view["keys"])]
    seg_pos = torch.stack([
        starts[r] + torch.searchsorted(view["keys"][starts[r]:starts[r + 1]],
                                       q)
        for r in range(R)])
    f = _fields_plain(view, q.expand(R, K), t_off[:, None] + ti, seg_pos,
                      k_hashes)
    hit = f[2].bool()
    rank = torch.arange(R, dtype=torch.int64, device=q.device)[:, None]
    win = torch.where(hit, rank, R).min(dim=0).values
    win = torch.where(win == R, torch.full_like(win, -1), win)
    return torch.cat([f.reshape(4 * R, K), win[None]])


def _check_view(view) -> None:
    for name in VIEW_FIELDS:
        expect(view[name], name, torch.bool if name == "fbits"
               else torch.int64)
    T = len(view["f_offs"])
    for name in ("nslots", "offs", "lens"):
        if len(view[name]) != T:
            raise ValueError(f"{name}: {len(view[name])} tables, f_offs {T}")
    if len(view["vals"]) != len(view["keys"]):
        raise ValueError("keys and vals differ in length")


def probe_tier(view, q, ti, k_hashes: int):
    """Fused probe of int64 queries ``q`` [K], each against its assigned
    table ``ti`` [K] of a tier view. Returns int64 ``[4, K]``."""
    _check_view(view)
    expect(q, "q", torch.int64)
    expect(ti, "ti", torch.int64)
    if len(q) != len(ti):
        raise ValueError(f"q has {len(q)} queries, ti {len(ti)}")
    tensors = [view[n] for n in VIEW_FIELDS] + [q, ti]
    if not on_card(*tensors):
        return probe_tier_plain(view, q, ti, k_hashes)
    out = torch.empty((4, len(q)), dtype=torch.int64, device=q.device)
    if len(q) == 0:
        return out
    rc = build.library().probe_tier(
        *[t.data_ptr() for t in tensors[:7]], k_hashes, q.data_ptr(),
        ti.data_ptr(), len(q), out.data_ptr(), stream_of(q))
    build.check(rc, "probe_tier")
    LAUNCHES["probe_tier"] += 1
    return out


def probe_store(view, t_off, q, ti, k_hashes: int):
    """Fused probe of int64 queries ``q`` [K] against every tier of a
    store view: ``t_off`` [R] is each tier's first global table, ``ti``
    [R, K] each query's assigned table within each tier. Returns int64
    ``[4 * R + 1, K]``."""
    _check_view(view)
    expect(t_off, "t_off", torch.int64)
    expect(q, "q", torch.int64)
    expect(ti, "ti", torch.int64, ndim=2)
    R, K = ti.shape
    if len(t_off) != R or len(q) != K:
        raise ValueError(f"ti {tuple(ti.shape)} does not match t_off "
                         f"[{len(t_off)}] and q [{len(q)}]")
    tensors = [view[n] for n in VIEW_FIELDS] + [t_off, q, ti]
    if not on_card(*tensors):
        return probe_store_plain(view, t_off, q, ti, k_hashes)
    out = torch.empty((4 * R + 1, K), dtype=torch.int64, device=q.device)
    if R == 0 or K == 0:
        return out.fill_(-1)
    rc = build.library().probe_store(
        *[t.data_ptr() for t in tensors[:8]], R, k_hashes, q.data_ptr(),
        ti.data_ptr(), K, out.data_ptr(), stream_of(q))
    build.check(rc, "probe_store")
    LAUNCHES["probe_store"] += 1
    return out
